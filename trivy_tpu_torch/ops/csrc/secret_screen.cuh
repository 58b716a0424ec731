// Bit-sliced screen shared by secret_anchor.cu (AnchorBank),
// secret_conv.cu (ConvAnchorBank) and secret_prefilter.cu (KeywordBank).
//
// Every bank reduces, on the host (ops/secret_nfa.py:screen_taps), to one
// compact form:
//   cls_bits[256][ncw]  byte -> class bitset (class i = bit i % 32 of
//                       word i / 32);
//   taps[r][Cfg::kTaps] (class << Cfg::kShiftBits) | shift of each
//                       active tap of rule r, rarest class first, slots
//                       at or past n_taps[r] unused;
//   n_taps[r]           active taps; 0 = no active tap (hits wherever
//                       the chunk has a position), -1 = a tap names no
//                       class (never hits).
// Rule r hits at position i of a chunk when every tap's class holds at
// i + shift; its output bit is the any-hit over the chunk.
//
// The anchor banks (AnchorCfg: 8 taps, shifts < 8) read no class past
// the chunk's end. The keyword bank (KeywordCfg: a keyword's bytes are
// its taps, byte values its classes, up to 24 taps and shifts < 24)
// reads byte 0 there, the prefilter reference's zero pad, counts only
// hits that start before the chunk's end, takes chunk rows of any
// length and alignment, and also writes its hits as bytes.
//
// A block owns one slice of the rules and a run of tiles (tile_words *
// 32 positions each) of one chunk, and walks the tiles in order:
//  - the tile's bytes (plus one 32-byte halo word) arrive in shared
//    memory by cp.async, 16 B a thread; the next tile's copy is in flight
//    while the current tile is screened (a keyword bank's rows that are
//    not 16-byte aligned are copied byte by byte instead);
//  - the bytes become one position bitmap per class: each lane looks up
//    its byte's class word and a five-step shuffle transpose turns 32
//    lanes x 32 classes into 32 classes x 32 positions. Positions at or
//    past the chunk's end hold no class (the reference's zero predicate
//    and conv sentinel 256), or byte 0's for a keyword bank; a byte 0
//    inside the chunk maps normally;
//  - tiles of 32 or 64 words: one warp per rule over the whole tile,
//    tile_words / 32 position words a lane; smaller tiles: a warp takes
//    32 / tile_words rules at once, one word a lane. AND over the taps
//    of the class bitmap funnel-shifted by the tap's shift, the
//    neighbour word taken from the next lane by a shuffle (the last
//    lane's from lane 0's next word, or the tile's halo word); the warp
//    leaves as soon as no lane has a candidate left (__any_sync);
//  - a per-chunk hit mask in shared memory skips rules already hit in
//    an earlier tile, and picks up bits other blocks of the chunk have
//    published; after each tile the block ORs its mask into the zeroed
//    output row (atomicOr: blocks finish in any order, a bit once set is
//    never cleared, so the result does not depend on the order).
// Skipping is a speed-up only: every rule not yet hit is screened on
// every tile.
//
// No bank is too large for the screen. The host (ops/secret_nfa.py:
// screen_layout) sizes the block's shared memory (Layout) to fit:
//  - rule metadata in slices of rules_per_slice rules, one slice a
//    block, staged once: the grid is chunks x slices x runs of tiles;
//  - the class table in shared memory, or read from global memory
//    (tab_in_smem 0) when it does not fit;
//  - tiles of 2,048 positions down to 32, so that the class bitmaps of
//    every class word fit: 32 positions hold 256 B a class word, so a
//    block takes up to about 870 class words (27,800 classes).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace screen {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // per SM: caps registers at 64 a thread
constexpr unsigned kFull = 0xffffffffu;

// What differs between the screen's users, fixed at compile time so that
// each instantiation carries only its own code.
struct AnchorCfg {  // secret_anchor.cu, secret_conv.cu
  static constexpr int kTaps = 8;  // taps a rule (K_ANCHOR)
  static constexpr int kShiftBits = 3;  // shifts 0..7
  static constexpr bool kKeywords = false;
};
struct KeywordCfg {  // secret_prefilter.cu
  static constexpr int kTaps = 24;  // MAX_KW: the halo word still holds
  static constexpr int kShiftBits = 5;  // shifts 0..23
  static constexpr bool kKeywords = true;
};

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// Byte offsets of the block's dynamic shared memory: two tile byte
// buffers, the class table (when in shared memory), the block's slice
// of rule metadata, the chunk's hit mask and the tile's class bitmaps.
// ops/secret_nfa.py (screen_smem) computes the same total to choose the
// layout; the launch sizes the block from this one.
struct Layout {
  int tile_bytes, tab, taps, counts, mask, bm, total;
  __host__ __device__ Layout(int ncw, int rw, int tile_words, int slice,
                             bool tab_in_smem, int taps_per_rule)
      : tile_bytes(align16(tile_words * 32 + 32)),
        tab(2 * tile_bytes),
        taps(tab + (tab_in_smem ? align16(256 * ncw * 4) : 0)),
        counts(taps + align16(slice * taps_per_rule * 4)),
        mask(counts + align16(slice)),
        bm(mask + align16(rw * 4)),
        total(bm + ncw * 32 * (tile_words + 1) * 4) {}
};

// 16 bytes from global to shared memory, asynchronously; zero-filled and
// nothing read when !valid.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Lane i holds row i of a 32 x 32 bit matrix (bit q = column q); returns
// column `lane` (bit i = bit `lane` of row i).
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  const uint32_t masks[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                             0x33333333u, 0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int s = 16 >> i;
    const uint32_t m = masks[i];
    const uint32_t y = __shfl_xor_sync(kFull, x, s);
    x = (lane & s) ? ((x & ~m) | ((y >> s) & m)) : ((x & m) | ((y & m) << s));
  }
  return x;
}

// bm[cls * wpt + k], bit q = class cls holds at tile position 32k + q,
// for k in [0, tile_words] (the last word is the halo). `tab` is the
// class table in shared or global memory. A warp takes two position
// words at a time, so that their transposes interleave; a tile of fewer
// words than warps is split over (position word, class word) pairs.
// Positions at or past `len` hold no class, or with kPadByte0 the class
// of byte 0 (the tile's bytes there are zero).
template <bool kPadByte0>
__device__ __forceinline__ void build_class_bitmaps(
    const uint8_t* bytes, int len, int t0, const uint32_t* tab, int ncw,
    uint32_t* bm, int tile_words) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int wpt = tile_words + 1;
  if (tile_words < 32) {
    for (int p = threadIdx.x >> 5; p < wpt * ncw; p += kWarps) {
      const int k = p / ncw, w = p - k * ncw;
      const bool valid = kPadByte0 || t0 + 32 * k + lane < len;
      const uint32_t v = valid ? tab[bytes[32 * k + lane] * ncw + w] : 0u;
      bm[(32 * w + lane) * wpt + k] = transpose32(v, lane);
    }
    return;
  }
  for (int k = threadIdx.x >> 5; k <= tile_words; k += 2 * kWarps) {
    const int k2 = k + kWarps;
    const bool two = k2 <= tile_words;  // warp-uniform
    const bool valid = kPadByte0 || t0 + 32 * k + lane < len;
    const bool valid2 = two && (kPadByte0 || t0 + 32 * k2 + lane < len);
    const uint32_t* row = tab + bytes[32 * k + lane] * ncw;
    const uint32_t* row2 = tab + (two ? bytes[32 * k2 + lane] : 0) * ncw;
    for (int w = 0; w < ncw; ++w) {
      const uint32_t t = transpose32(valid ? row[w] : 0u, lane);
      const uint32_t t2 = transpose32(valid2 ? row2[w] : 0u, lane);
      bm[(32 * w + lane) * wpt + k] = t;
      if (two) bm[(32 * w + lane) * wpt + k2] = t2;
    }
  }
}

// Start positions of word k of the tile that lie before the chunk's end,
// `left` positions after the tile's start.
__device__ __forceinline__ uint32_t start_mask(int left, int k) {
  const int l = left - 32 * k;
  return l >= 32 ? kFull : (l > 0 ? (1u << l) - 1u : 0u);
}

// AND one tap (its bitmap row offset << S | shift) into the W position
// words h of each lane (words 32i + lane of the tile). -> whether any
// lane still has a candidate.
template <int W, int S>
__device__ __forceinline__ bool and_tap(const uint32_t* bm, uint32_t tap,
                                        uint32_t (&h)[W], int lane) {
  const uint32_t* row = bm + (tap >> S);
  uint32_t lo[W];
#pragma unroll
  for (int i = 0; i < W; ++i) lo[i] = row[32 * i + lane];
  // word 32i + lane + 1: the next lane's, or for the last lane the next
  // group's first word (lane 0's lo[i + 1]), or the halo word
  const uint32_t halo = lane == 31 ? row[32 * W] : 0u;
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint32_t give = (i + 1 < W && lane == 0) ? lo[(i + 1) % W] : lo[i];
    uint32_t hi = __shfl_sync(kFull, give, (lane + 1) & 31);
    if (i + 1 == W && lane == 31) hi = halo;
    h[i] &= __funnelshift_r(lo[i], hi, tap & ((1u << S) - 1u));
    acc |= h[i];
  }
  return __any_sync(kFull, acc != 0) != 0;
}

// Screen every live rule of a slice (rules base + [0, n_rules), its taps
// and counts at slice index r) against the tile's bitmaps, one warp per
// rule, and set the hit ones in `mask`. W = tile_words / 32 position
// words a lane (1 or 2), evaluated together: W independent loads in
// flight per tap and one vote per tap for the whole tile. `left`: start
// positions from the tile's start to the chunk's end (keyword banks).
template <class Cfg, int W>
__device__ __forceinline__ void screen_rules_w(const uint32_t* bm,
                                               const uint32_t* taps,
                                               const int8_t* counts,
                                               int n_rules, int base,
                                               uint32_t* mask, int left) {
  constexpr int S = Cfg::kShiftBits;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < n_rules; r += kThreads / 32) {
    const int n = counts[r];
    const int g = base + r;
    const uint32_t done = __shfl_sync(kFull, mask[g >> 5], 0);
    if (n <= 0 || ((done >> (g & 31)) & 1u)) continue;  // warp-uniform
    uint32_t h[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      h[i] = Cfg::kKeywords ? start_mask(left, 32 * i + lane) : kFull;
    }
    bool any = true;
    if constexpr (Cfg::kTaps == 8) {
      // the rule's taps in registers, two 16-byte loads
      const uint4 a = reinterpret_cast<const uint4*>(taps + r * 8)[0];
      const uint4 b = reinterpret_cast<const uint4*>(taps + r * 8)[1];
      const uint32_t tap[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        if (t == n) break;
        any = and_tap<W, S>(bm, tap[t], h, lane);
        if (!any) break;
      }
    } else {
      // up to 24 taps, each read from shared memory as it is needed
      const uint32_t* tap = taps + r * Cfg::kTaps;
      for (int t = 0; t < n && any; ++t) {
        any = and_tap<W, S>(bm, tap[t], h, lane);
      }
    }
    if (any && lane == 0) atomicOr(mask + (g >> 5), 1u << (g & 31));
  }
}

// screen_rules_w for tiles of tile_words < 32 words: a warp takes
// 32 / tile_words rules at once, lane = slot * tile_words + word; each
// slot's last lane takes its neighbour word from the halo word.
template <class Cfg>
__device__ __forceinline__ void screen_rules_small(const uint32_t* bm,
                                                   int tile_words,
                                                   const uint32_t* taps,
                                                   const int8_t* counts,
                                                   int n_rules, int base,
                                                   uint32_t* mask, int left) {
  constexpr int S = Cfg::kShiftBits;
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / tile_words;
  const int slot = lane / tile_words, k = lane - slot * tile_words;
  const uint32_t slot_lanes = (kFull >> (32 - tile_words))
                              << (slot * tile_words);
  for (int r0 = (threadIdx.x >> 5) * per_warp; r0 < n_rules;
       r0 += (kThreads / 32) * per_warp) {
    const int r = r0 + slot;
    const int g = base + r;
    int n = r < n_rules ? counts[r] : 0;
    if (n > 0 && ((mask[g >> 5] >> (g & 31)) & 1u)) n = 0;
    const int most = __reduce_max_sync(kFull, max(n, 0));
    uint32_t h = n > 0 ? (Cfg::kKeywords ? start_mask(left, k) : kFull) : 0u;
    for (int t = 0; t < most; ++t) {
      const uint32_t tap = t < n ? taps[r * Cfg::kTaps + t] : 0u;
      const uint32_t* row = bm + (tap >> S);
      const uint32_t lo = row[k];
      uint32_t hi = __shfl_down_sync(kFull, lo, 1);
      if (k == tile_words - 1) hi = row[tile_words];  // the halo word
      if (t < n) h &= __funnelshift_r(lo, hi, tap & ((1u << S) - 1u));
      if (!__any_sync(kFull, h != 0)) break;
    }
    const uint32_t hits = __ballot_sync(kFull, h != 0);
    if (k == 0 && n > 0 && (hits & slot_lanes)) {
      atomicOr(mask + (g >> 5), 1u << (g & 31));
    }
  }
}

template <class Cfg>
__device__ __forceinline__ void screen_rules(const uint32_t* bm,
                                             int tile_words,
                                             const uint32_t* taps,
                                             const int8_t* counts,
                                             int n_rules, int base,
                                             uint32_t* mask, int left) {
  if (tile_words == 64) {
    screen_rules_w<Cfg, 2>(bm, taps, counts, n_rules, base, mask, left);
  } else if (tile_words == 32) {
    screen_rules_w<Cfg, 1>(bm, taps, counts, n_rules, base, mask, left);
  } else {
    screen_rules_small<Cfg>(bm, tile_words, taps, counts, n_rules, base,
                            mask, left);
  }
}

// The whole screen of one block: rules [r0, r0 + slice) on tiles
// [first, first + tiles_per_block) of one chunk. Block b is chunk
// b / (slices * runs), slice b / runs % slices, run b % runs. `hits`
// (keyword banks only) gets a 1 byte at [chunk, rule] for each hit rule.
template <class Cfg>
__device__ __forceinline__ void screen_block(
    const uint8_t* __restrict__ chunks, const uint32_t* __restrict__ cls_bits,
    const int32_t* __restrict__ taps_in, const int32_t* __restrict__ n_taps,
    uint32_t* __restrict__ out, uint8_t* __restrict__ hits, int len, int ncw,
    int n_rules, int rw, int tile_words, int tiles_per_block, int slice,
    int tab_in_smem) {
  constexpr int S = Cfg::kShiftBits;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(ncw, rw, tile_words, slice, tab_in_smem, Cfg::kTaps);
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + lay.tab);
  uint32_t* taps = reinterpret_cast<uint32_t*>(smem + lay.taps);
  int8_t* counts = reinterpret_cast<int8_t*>(smem + lay.counts);
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + lay.mask);
  uint32_t* bm = reinterpret_cast<uint32_t*>(smem + lay.bm);

  const int tile_pos = tile_words * 32;
  const int tiles = (len + tile_pos - 1) / tile_pos;
  const int runs = (tiles + tiles_per_block - 1) / tiles_per_block;
  const int slices = (n_rules + slice - 1) / slice;
  const long long c = blockIdx.x / (slices * runs);
  const int r0 = (blockIdx.x / runs % slices) * slice;
  const int n = min(slice, n_rules - r0);
  const int first = (blockIdx.x % runs) * tiles_per_block;
  const int last = min(tiles, first + tiles_per_block);
  const uint8_t* chunk = chunks + c * len;
  uint32_t* out_row = out + c * rw;
  // rows of 16-byte multiples at a 16-byte aligned base go by cp.async
  const bool aligned =
      !Cfg::kKeywords ||
      (len % 16 == 0 && reinterpret_cast<uintptr_t>(chunks) % 16 == 0);

  // the tile's bytes and its halo word into buffer (tile - first) % 2,
  // zero past the chunk's end
  auto fetch = [&](int tile) {
    unsigned char* dst = smem + ((tile - first) & 1) * lay.tile_bytes;
    const int t0 = tile * tile_pos;
    if (!aligned) {  // keyword banks only: byte by byte, synchronously
      for (int s = threadIdx.x; s < tile_pos + 32; s += kThreads) {
        dst[s] = t0 + s < len ? chunk[t0 + s] : 0;
      }
      return;
    }
    for (int s = threadIdx.x; s < (tile_pos + 32) / 16; s += kThreads) {
      const bool valid = t0 + 16 * s < len;  // len % 16 == 0
      copy16(dst + 16 * s, valid ? chunk + t0 + 16 * s : chunk, valid);
    }
    copy_commit();
  };
  fetch(first);

  // the slice's rule metadata (tap offsets resolved to bitmap rows of
  // this tile size) and the class table, once per block
  const int wpt = tile_words + 1;
  for (int i = threadIdx.x; i < n * Cfg::kTaps; i += kThreads) {
    const uint32_t e = static_cast<uint32_t>(taps_in[r0 * Cfg::kTaps + i]);
    taps[i] = (((e >> S) * wpt) << S) | (e & ((1u << S) - 1u));
  }
  for (int r = threadIdx.x; r < n; r += kThreads) {
    counts[r] = static_cast<int8_t>(n_taps[r0 + r]);
  }
  if (tab_in_smem) {
    for (int i = threadIdx.x; i < 256 * ncw; i += kThreads) {
      tab[i] = cls_bits[i];
    }
  }
  for (int w = threadIdx.x; w < rw; w += kThreads) mask[w] = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < n; r += kThreads) {
    const int g = r0 + r;
    if (counts[r] == 0) atomicOr(mask + (g >> 5), 1u << (g & 31));
  }

  for (int tile = first; tile < last; ++tile) {
    copy_wait_all();
    __syncthreads();  // the tile's bytes are in; the last screen is done
    if (tile + 1 < last) fetch(tile + 1);
    const uint8_t* bytes = smem + ((tile - first) & 1) * lay.tile_bytes;
    if (tab_in_smem) {
      build_class_bitmaps<Cfg::kKeywords>(bytes, len, tile * tile_pos, tab,
                                          ncw, bm, tile_words);
    } else {
      build_class_bitmaps<Cfg::kKeywords>(bytes, len, tile * tile_pos,
                                          cls_bits, ncw, bm, tile_words);
    }
    for (int w = threadIdx.x; w < rw; w += kThreads) {
      mask[w] |= *reinterpret_cast<volatile const uint32_t*>(out_row + w);
    }
    __syncthreads();
    screen_rules<Cfg>(bm, tile_words, taps, counts, n, r0, mask,
                      len - tile * tile_pos);
    __syncthreads();
    for (int w = threadIdx.x; w < rw; w += kThreads) {
      if (mask[w]) atomicOr(out_row + w, mask[w]);
    }
  }
  if constexpr (Cfg::kKeywords) {
    // the slice's hits as bytes; every block that knows a hit stores
    // the same 1, so blocks need no order
    for (int r = threadIdx.x; r < n; r += kThreads) {
      const int g = r0 + r;
      if ((mask[g >> 5] >> (g & 31)) & 1u) hits[c * n_rules + g] = 1;
    }
  }
}

// Check the arguments and launch `kernel` (a __global__ wrapper of
// screen_block<Cfg>) on `stream`, its shared memory sized by Layout. ->
// a cudaError_t as an int.
template <class Cfg, class Kernel>
int launch(Kernel kernel, const void* chunks, const void* cls_bits,
           const void* taps, const void* n_taps, void* out, void* hits, int c,
           int len, int ncw, int n_rules, int rw, int tile_words,
           int tiles_per_block, int slice, int tab_in_smem, void* stream) {
  if (c <= 0 || len <= 0 || n_rules <= 0) return 0;
  if (ncw < 1 || rw < 1 || n_rules > 32 * rw || tile_words < 1 ||
      tile_words > 64 || (tile_words & (tile_words - 1)) ||
      tiles_per_block < 1 || slice < 1 ||
      (Cfg::kKeywords ? hits == nullptr
                      : (len % 16 ||
                         reinterpret_cast<uintptr_t>(chunks) % 16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = Layout(ncw, rw, tile_words, min(slice, n_rules),
                          tab_in_smem != 0, Cfg::kTaps).total;
  const int tile_pos = tile_words * 32;
  const int tiles = (len + tile_pos - 1) / tile_pos;
  const int runs = (tiles + tiles_per_block - 1) / tiles_per_block;
  const int slices = (n_rules + slice - 1) / slice;
  const long long blocks = static_cast<long long>(c) * slices * runs;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(chunks),
      static_cast<const uint32_t*>(cls_bits),
      static_cast<const int32_t*>(taps), static_cast<const int32_t*>(n_taps),
      static_cast<uint32_t*>(out), static_cast<uint8_t*>(hits), len, ncw,
      n_rules, rw, tile_words, tiles_per_block, min(slice, n_rules),
      tab_in_smem != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace screen
