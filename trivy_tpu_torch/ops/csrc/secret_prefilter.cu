// Secret keyword prefilter for Hopper (sm_90a), on the shared screen.
//
// Replaces the TPU kernel trivy_tpu/ops/secret_prefilter.py:_kernel (a
// jax.jit function): for lowercased chunks padded with max_len - 1 zero
// bytes, does keyword k (its first min(kw_len[k], max_len) bytes) start
// at any position < len? -> bool[c, K]. The zero pad compares equal to a
// keyword byte 0; a keyword of length 0 matches everywhere.
//
// What bounds it: the chunk bytes are the only large input (16 KiB per
// chunk; the keywords are K x 24 bytes), so the least time is the bytes
// over the memory rate: 5.0 us for 1,024 chunks at 3.35 TB/s. The TPU
// kernel compared every keyword at every position (K x len x max_len
// byte compares: about 45M per chunk at the builtin 114 keywords).
//
// What the design does about it: the keyword bank is the anchor
// screen's problem with other inputs, so it runs through the same screen
// (secret_screen.cuh, KeywordCfg). On the host (ops/secret_prefilter.py
// KeywordTensors, once per DevicePrefilter) the classes are the distinct
// byte values of the bank's keywords (38 for the builtin 114) and each
// keyword's taps are its (byte class, offset) pairs, rarest byte first
// by a fixed rank of byte values. The screen copies each 2,048-position
// tile in by cp.async, builds position bitmaps for only those classes
// (two class words for the builtin bank) by the shuffle transpose,
// stages the keywords once a block, drops a keyword from a warp as soon
// as no lane has a candidate left, and skips keywords already found in
// an earlier tile of the chunk. What the keyword bank adds to the
// screen: up to 24 taps and shifts up to 23 (still inside the tile's one
// halo word), byte 0's class at and past the chunk's end, hits only at
// start positions < len, rows of any length and alignment, and the
// hits written as bytes into the zeroed bool[c, K] output (every block
// that knows a hit stores the same 1), beside the packed words the
// blocks of a chunk share.

#include "secret_screen.cuh"

namespace {

__global__ void __launch_bounds__(screen::kThreads, screen::kMinBlocks)
prefilter_kernel(const uint8_t* __restrict__ chunks,  // [c, len]
                 const uint32_t* __restrict__ cls_bits,  // [256, ncw]
                 const int32_t* __restrict__ taps,  // [k, 24]
                 const int32_t* __restrict__ n_taps,  // [k]
                 uint32_t* __restrict__ words,  // [c, rw], zeroed
                 uint8_t* __restrict__ hits,  // [c, k] bool, zeroed
                 int len, int ncw, int n_kw, int rw, int tile_words,
                 int tiles_per_block, int kw_per_slice, int tab_in_smem) {
  screen::screen_block<screen::KeywordCfg>(
      chunks, cls_bits, taps, n_taps, words, hits, len, ncw, n_kw, rw,
      tile_words, tiles_per_block, kw_per_slice, tab_in_smem);
}

}  // namespace

extern "C" int trivy_prefilter_hits(const void* chunks, const void* cls_bits,
                                    const void* taps, const void* n_taps,
                                    void* words, void* hits, int c, int len,
                                    int ncw, int n_kw, int rw, int tile_words,
                                    int tiles_per_block, int kw_per_slice,
                                    int tab_in_smem, void* stream) {
  return screen::launch<screen::KeywordCfg>(
      prefilter_kernel, chunks, cls_bits, taps, n_taps, words, hits, c, len,
      ncw, n_kw, rw, tile_words, tiles_per_block, kw_per_slice, tab_in_smem,
      stream);
}
