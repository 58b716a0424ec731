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
// (3.57 TFLOP for 128 chunks at nc 256, r_pad 384) on 0/1 values.
// Evaluated directly the only large input is the chunk bytes, so the
// least time is the bytes over the memory rate: 0.63 us for 128 chunks
// at 3.35 TB/s. The bit-sliced design's own floor at that shape (128
// chunks, 332 rules; the dense form pads its classes to nc 256, the
// compact form holds them in 6 class words; chip_smoke.py screen_floor)
// with every tap of every rule on every word: 151M tap-words, about
// 0.7 GB of shared-memory reads and 0.56 G integer operations, about
// 0.034 ms at 132 SMs x 128 B a clock.
//
// What the design does about it: the same screen as the bitset bank
// (secret_screen.cuh), on the bank's compact form (ConvAnchorBank
// cls_bits, and its tap_cls / tap_act ordered rarest class first by
// ops/secret_nfa.py:screen_taps). The bank has no class budget, and the
// screen takes any rule count and up to about 870 class words (27,800
// classes): ops/secret_nfa.py:screen_layout keeps 2,048-position tiles
// while two blocks fit an SM, then splits the rules into slices (one a
// block), shrinks the tile down to 32 positions and, past that, reads
// the class table from global memory. Rule bits at or past n stay zero: only rules
// [0, n) are screened, into an output the wrapper
// (ops/secret_nfa.py:conv_anchor_words) zeroes.

#include "secret_screen.cuh"

namespace {

__global__ void __launch_bounds__(screen::kThreads, screen::kMinBlocks)
conv_kernel(const uint8_t* __restrict__ chunks,
            const uint32_t* __restrict__ cls_bits,  // [256, ncw]
            const int32_t* __restrict__ taps,  // [n, 8]
            const int32_t* __restrict__ n_taps,  // [n]
            uint32_t* __restrict__ out,  // [c, rw], zeroed
            uint8_t* __restrict__ hits,  // unused (keyword banks)
            int len, int ncw, int n_rules, int rw, int tile_words,
            int tiles_per_block, int rules_per_slice, int tab_in_smem) {
  screen::screen_block<screen::AnchorCfg>(
      chunks, cls_bits, taps, n_taps, out, hits, len, ncw, n_rules, rw,
      tile_words, tiles_per_block, rules_per_slice, tab_in_smem);
}

}  // namespace

extern "C" int trivy_conv_anchor_words(const void* chunks,
                                       const void* cls_bits,
                                       const void* taps, const void* n_taps,
                                       void* out, int c, int len, int ncw,
                                       int n_rules, int rw, int tile_words,
                                       int tiles_per_block,
                                       int rules_per_slice, int tab_in_smem,
                                       void* stream) {
  return screen::launch<screen::AnchorCfg>(
      conv_kernel, chunks, cls_bits, taps, n_taps, out, nullptr, c, len, ncw,
      n_rules, rw, tile_words, tiles_per_block, rules_per_slice, tab_in_smem,
      stream);
}
