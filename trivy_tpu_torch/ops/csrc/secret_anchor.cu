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
// time is the bytes over the memory rate: 1.26 us for 256 chunks at
// 3.35 TB/s. The bit-sliced design has its own floor (chip_smoke.py
// screen_floor), counted at that shape (256 chunks, the builtin bank's
// 204 rules and 1,340 taps, NW 3) with every tap of every rule on every
// 32-position word and no early exit: 176M tap-words, 0.80 GB of
// shared-memory reads and 0.61 G integer operations with the class
// bitmaps, 0.036 ms at 132 SMs x 128 B a clock.
//
// What the design does about it (secret_screen.cuh): one screen for both
// banks on the host-built compact form (class table, class and shift of
// each tap, rarest class first, inactive and "never" folded into the
// tap count), rule metadata and class table staged in shared memory
// once per block, the chunk's bytes by cp.async with the next tile in
// flight, a shuffle transpose to build the class bitmaps, one shared
// load per tap per word (the neighbour word by shuffle), a warp per rule
// over the whole tile with an early exit when no lane has a candidate
// left, and a per-chunk hit mask that skips rules already hit. The grid
// is chunks x runs of tiles, as many runs per chunk as fill the card
// (ops/secret_nfa.py:screen_layout); a bank whose rules do not fit a
// block's shared memory at once is split into slices, one a block. On
// the H100 the kernel sits at about 2.5x that floor. Of its 0.088 ms,
// the ablations in PERF.md give about 0.029 ms to the bitmap build
// (0.035 ms with the rule screen cut out, less a 0.006 ms skeleton of
// copies and syncs), 0.020 ms of that to its transposes (five shuffles
// per 32 positions per class word), and about 0.053 ms to the rule
// screen.

#include "secret_screen.cuh"

namespace {

__global__ void __launch_bounds__(screen::kThreads, screen::kMinBlocks)
anchor_kernel(const uint8_t* __restrict__ chunks,
              const uint32_t* __restrict__ cls_bits,  // [256, nw]
              const int32_t* __restrict__ taps,  // [r, 8]
              const int32_t* __restrict__ n_taps,  // [r]
              uint32_t* __restrict__ out,  // [c, rw], zeroed
              uint8_t* __restrict__ hits,  // unused (keyword banks)
              int len, int nw, int n_rules, int rw, int tile_words,
              int tiles_per_block, int rules_per_slice, int tab_in_smem) {
  screen::screen_block<screen::AnchorCfg>(
      chunks, cls_bits, taps, n_taps, out, hits, len, nw, n_rules, rw,
      tile_words, tiles_per_block, rules_per_slice, tab_in_smem);
}

}  // namespace

extern "C" int trivy_anchor_words(const void* chunks, const void* cls_bits,
                                  const void* taps, const void* n_taps,
                                  void* out, int c, int len, int nw,
                                  int n_rules, int rw, int tile_words,
                                  int tiles_per_block, int rules_per_slice,
                                  int tab_in_smem, void* stream) {
  if (nw > 4) return static_cast<int>(cudaErrorInvalidValue);  // 128 classes
  return screen::launch<screen::AnchorCfg>(
      anchor_kernel, chunks, cls_bits, taps, n_taps, out, nullptr, c, len,
      nw, n_rules, rw, tile_words, tiles_per_block, rules_per_slice,
      tab_in_smem, stream);
}
