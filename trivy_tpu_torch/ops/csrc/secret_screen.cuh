// Bit-sliced anchor screen shared by secret_anchor.cu (AnchorBank) and
// secret_conv.cu (ConvAnchorBank).
//
// A block screens one tile of positions of one chunk. It first turns the
// tile's bytes into one position bitmap per byte class, in shared memory:
//   bit q of bm[cls * wpt + k] = class cls holds at position t0 + 32k + q,
// with k in [0, tile_words] (the last word is the halo: anchors starting
// in the tile read up to K-1 = 7 positions past it). Positions at or past
// the chunk's end hold no class, which is the reference's zero predicate
// past the chunk (and its sentinel byte 256 for the conv bank). A byte 0
// inside the chunk is a real byte and maps through the class table.
//
// Then rule r hits in word k iff
//   AND over active taps j of (bm[cls(r, j)] >> j, funnel-shifted across
//   words k and k + 1)
// is non-zero within the positions of the chunk: 32 positions per
// instruction instead of one, so the screen reads each chunk byte once
// and spends a few word operations per 32 positions per rule. A rule with
// no active tap hits wherever the tile has a position.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace screen {

constexpr int kTaps = 8;  // K_ANCHOR
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kInactive = -1;  // tap contributes nothing (always holds)
constexpr int kNever = -2;     // tap names a class outside the table

// Fill bm[ncw * 32][wpt] for the tile at t0 of `chunk` (len bytes) from
// the class table cls_words[256][ncw] (class i = bit i % 32 of word
// i / 32). One warp per position word: each lane looks up its byte's
// class words, and 32 ballots per class word transpose them into
// position bitmaps; lane q keeps the bitmap of class 32w + q.
__device__ __forceinline__ void build_class_bitmaps(
    const uint8_t* __restrict__ chunk, int len, int t0,
    const uint32_t* __restrict__ cls_words, int ncw, uint32_t* bm,
    int wpt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int k = warp; k < wpt; k += nwarps) {  // uniform across the warp
    const int p = t0 + 32 * k + lane;
    const bool valid = p < len;
    const int b = valid ? chunk[p] : 0;
    for (int w = 0; w < ncw; ++w) {
      const uint32_t v = valid ? cls_words[b * ncw + w] : 0u;
      uint32_t mine = 0;
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const uint32_t m = __ballot_sync(kFull, (v >> q) & 1u);
        if (lane == q) mine = m;
      }
      bm[(32 * w + lane) * wpt + k] = mine;
    }
  }
}

// Positions of word k of the tile at t0 that lie inside the chunk.
__device__ __forceinline__ uint32_t valid_mask(int len, int t0, int k) {
  const int n = len - (t0 + 32 * k);
  return n >= 32 ? kFull : (n > 0 ? (1u << n) - 1u : 0u);
}

// Screen rules [0, n_rules) against the tile's bitmaps, one warp per rule
// (lanes over the tile's words), and OR each hitting rule's bit into the
// chunk's output row. tap(r, j) -> class index, kInactive or kNever.
template <class Tap>
__device__ __forceinline__ void screen_rules(const uint32_t* bm, int wpt,
                                             int len, int t0, int n_words,
                                             int n_rules, Tap tap,
                                             uint32_t* __restrict__ out_row) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < n_rules; r += nwarps) {  // uniform across the warp
    const int mine = lane < kTaps ? tap(r, lane) : kInactive;
    int cls[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) cls[j] = __shfl_sync(kFull, mine, j);
    bool any = false;
    for (int k = lane; k < n_words; k += 32) {
      uint32_t h = valid_mask(len, t0, k);
#pragma unroll
      for (int j = 0; j < kTaps; ++j) {
        if (cls[j] >= 0) {
          const uint32_t* row = bm + cls[j] * wpt;
          h &= __funnelshift_r(row[k], row[k + 1], j);
        } else if (cls[j] == kNever) {
          h = 0;
        }
      }
      any |= h != 0;
    }
    if (__any_sync(kFull, any) && lane == 0) {
      atomicOr(out_row + (r >> 5), 1u << (r & 31));
    }
  }
}

}  // namespace screen
