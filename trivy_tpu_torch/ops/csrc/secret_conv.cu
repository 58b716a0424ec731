// Secret anchor screen for Hopper (sm_90a), conv bank (no class budget).
//
// Replaces the TPU kernel trivy_tpu/ops/secret_nfa.py:_conv_anchor_kernel
// (a jax.jit function). The TPU formulation is a K-tap convolution over
// one-hot bytes, two matrix products per tile:
//   S[i, r] = sum_j onehot(byte[i + j]) . classtab . taps[j][:, r],
// a hit when S >= n_active[r]; bytes past the chunk read as the sentinel
// 256, which is in no class. With one-hot taps (one class per active
// (rule, tap)) that is exactly "every active tap's class holds", the
// contract of the bitset kernel without its 128-class budget.
//
// What bounds it: as a GEMM, 2 x L x 8 x nc x r_pad operations per chunk
// (8.6 GFLOP at nc = 128, r_pad = 256) on 0/1 values. Evaluated directly
// the only large input is the chunk bytes, so the least time is the
// bytes over the memory rate, far below the GEMM's operation time.
//
// What the design does about it: it evaluates directly, from the bank's
// compact form (ConvAnchorBank.cls_bits / tap_cls / tap_act: the class
// table as a bitset of ncw = ceil(nc / 32) words, and the class index
// and active flag of each (rule, tap)), with the bit-sliced screen of
// secret_screen.cuh: per tile, one position bitmap per class in shared
// memory, then 8 funnel shifts and ANDs per 32 positions per rule. nc is
// unbounded, so the tile shrinks as nc grows to keep the bitmaps within
// kSmemBudget of dynamic shared memory (2048 positions up to nc = 384).
// Rule bits at or past n stay zero: only rules [0, n) are screened, into
// an output the wrapper (ops/secret_nfa.py:conv_anchor_words) zeroes.

#include "secret_screen.cuh"

namespace {

constexpr int kMaxTileWords = 64;  // at most 2048 positions per tile
constexpr int kSmemBudget = 100 * 1024;

__global__ void __launch_bounds__(screen::kThreads)
conv_kernel(const uint8_t* __restrict__ chunks,
            const uint32_t* __restrict__ cls_bits,  // [256, ncw]
            const int32_t* __restrict__ tap_cls,  // [n, 8]
            const uint8_t* __restrict__ tap_act,  // [n, 8] bool
            uint32_t* __restrict__ out,  // [c, rw], zeroed
            int len, int ncw, int n_rules, int rw, int tiles,
            int tile_words) {
  extern __shared__ uint32_t bm[];  // [ncw * 32, tile_words + 1]
  const int wpt = tile_words + 1;
  const long long c = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * (tile_words * 32);
  screen::build_class_bitmaps(chunks + c * len, len, t0, cls_bits, ncw, bm,
                              wpt);
  __syncthreads();
  const int n_words = min(tile_words, (len - t0 + 31) / 32);
  const int n_cls = ncw * 32;
  auto tap = [&](int r, int j) -> int {
    const int i = r * screen::kTaps + j;
    if (!tap_act[i]) return screen::kInactive;
    const int k = tap_cls[i];
    return (k < 0 || k >= n_cls) ? screen::kNever : k;
  };
  screen::screen_rules(bm, wpt, len, t0, n_words, n_rules, tap,
                       out + c * rw);
}

}  // namespace

extern "C" int trivy_conv_anchor_words(const void* chunks,
                                       const void* cls_bits,
                                       const void* tap_cls,
                                       const void* tap_act, void* out, int c,
                                       int len, int ncw, int n_rules, int rw,
                                       void* stream) {
  if (c <= 0 || len <= 0 || n_rules <= 0) return 0;
  if (ncw < 1) return static_cast<int>(cudaErrorInvalidValue);
  // the largest even tile (odd row pitch: conflict-free transposes)
  // whose bitmaps fit the budget
  int tile_words = kSmemBudget / (ncw * 32 * 4) - 1;
  tile_words = min(kMaxTileWords, tile_words) & ~1;
  if (tile_words < 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(ncw) * 32 * (tile_words + 1) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (len + tile_words * 32 - 1) / (tile_words * 32);
  const long long blocks = static_cast<long long>(c) * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  conv_kernel<<<static_cast<unsigned>(blocks), screen::kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(chunks),
      static_cast<const uint32_t*>(cls_bits),
      static_cast<const int32_t*>(tap_cls),
      static_cast<const uint8_t*>(tap_act), static_cast<uint32_t*>(out), len,
      ncw, n_rules, rw, tiles, tile_words);
  return static_cast<int>(cudaGetLastError());
}
