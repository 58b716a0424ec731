// Secret anchor screen for Hopper (sm_90a), bitset bank.
//
// Replaces the TPU kernel trivy_tpu/ops/secret_nfa.py:_anchor_kernel (a
// jax.jit function): pred = table[byte] is each byte's NW-word class
// bitset (NW <= 4, so at most 128 classes), zero for the K-1 positions
// past the chunk's end; rule r hits at position i when, for every active
// tap j, bit bit_idx[r, j] of word bit_word[r, j] of pred[i + j] is set;
// a rule with no active tap hits everywhere; the rule's bit is the
// any-hit over the chunk, packed 32 rules per uint32 word.
//
// What bounds it: the chunk bytes are the only large input (16 KiB per
// chunk; the table, taps and output words are a few KB), so the least
// time is the bytes over the memory rate. The TPU kernel evaluated every
// rule at every position (R x L x K predicate tests); done the same way
// here that is ~27M tests per chunk at the builtin R = 204.
//
// What the design does about it (secret_screen.cuh):
//  - grid = chunks x tiles of 2048 positions (8 tiles per chunk, so 256
//    chunks are 2048 blocks, many waves over 132 SMs);
//  - the block reads its tile's bytes once (plus a 32-position halo),
//    looks each up in the class table in shared memory, and transposes
//    the predicates into one 2048-bit position bitmap per class with warp
//    ballots (~33 KB of shared memory at 128 classes);
//  - a rule is then 8 funnel shifts and ANDs per 32 positions, one warp
//    per rule over the tile's 64 words, and an atomicOr of its bit into
//    the zeroed output row when the warp saw a hit (order-free, so the
//    result is deterministic).
// The wrapper (ops/secret_nfa.py:anchor_words) zeroes the output and
// checks shapes, types and NW.

#include "secret_screen.cuh"

namespace {

constexpr int kTileWords = 64;  // 2048 positions per tile
constexpr int kWpt = kTileWords + 1;  // odd: conflict-free transposes
constexpr int kMaxWords = 4;  // MAX_CLASS_WORDS

__global__ void __launch_bounds__(screen::kThreads)
anchor_kernel(const uint8_t* __restrict__ chunks,
              const uint32_t* __restrict__ table,  // [256, nw]
              const int32_t* __restrict__ bit_word,  // [r, 8]
              const uint32_t* __restrict__ bit_idx,  // [r, 8]
              const uint8_t* __restrict__ active,  // [r, 8] bool
              uint32_t* __restrict__ out,  // [c, rw], zeroed
              int len, int nw, int n_rules, int rw, int tiles) {
  __shared__ uint32_t bm[kMaxWords * 32 * kWpt];
  __shared__ uint32_t tab[256 * kMaxWords];
  const long long c = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * (kTileWords * 32);
  for (int i = threadIdx.x; i < 256 * nw; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  screen::build_class_bitmaps(chunks + c * len, len, t0, tab, nw, bm, kWpt);
  __syncthreads();
  const int n_words = min(kTileWords, (len - t0 + 31) / 32);
  auto tap = [&](int r, int j) -> int {
    const int i = r * screen::kTaps + j;
    if (!active[i]) return screen::kInactive;
    const int w = bit_word[i];
    const uint32_t b = bit_idx[i];
    if (w < 0 || w >= nw || b >= 32u) return screen::kNever;
    return w * 32 + static_cast<int>(b);
  };
  screen::screen_rules(bm, kWpt, len, t0, n_words, n_rules, tap,
                       out + c * rw);
}

}  // namespace

extern "C" int trivy_anchor_words(const void* chunks, const void* table,
                                  const void* bit_word, const void* bit_idx,
                                  const void* active, void* out, int c,
                                  int len, int nw, int n_rules, int rw,
                                  void* stream) {
  if (c <= 0 || len <= 0 || n_rules <= 0) return 0;
  if (nw < 1 || nw > kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (len + kTileWords * 32 - 1) / (kTileWords * 32);
  const long long blocks = static_cast<long long>(c) * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  anchor_kernel<<<static_cast<unsigned>(blocks), screen::kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(chunks),
      static_cast<const uint32_t*>(table),
      static_cast<const int32_t*>(bit_word),
      static_cast<const uint32_t*>(bit_idx),
      static_cast<const uint8_t*>(active), static_cast<uint32_t*>(out), len,
      nw, n_rules, rw, tiles);
  return static_cast<int>(cudaGetLastError());
}
