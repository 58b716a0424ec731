// Secret keyword prefilter for Hopper (sm_90a).
//
// Replaces the TPU kernel trivy_tpu/ops/secret_prefilter.py:_kernel (a
// jax.jit function): for lowercased chunks padded with max_len - 1 zero
// bytes, does keyword k (its first min(kw_len[k], max_len) bytes) start
// at any position < len? -> bool[c, K]. The zero pad compares equal to a
// keyword byte 0; a keyword of length 0 matches everywhere.
//
// What bounds it: the chunk bytes are the only large input (16 KiB per
// chunk; the keywords are K x 24 bytes), so the least time is the bytes
// over the memory rate. The TPU kernel compared every keyword at every
// position (K x len x max_len byte compares: ~45M per chunk at the
// builtin 114 keywords).
//
// What the design does about it: the same bit slicing as the anchor
// screens (secret_screen.cuh), with byte values as the classes. A block
// takes a tile of 2048 start positions of one chunk; one warp per
// 32-position word groups its lanes by byte value with __match_any_sync,
// and the first lane of each group writes the group's mask into that
// byte value's position bitmap (66.5 KB of dynamic shared memory for 256
// values x 65 words, zeroed first). Positions at or past the chunk's
// end read as byte 0, the reference's zero pad. Keyword k then hits in
// word w iff AND over j < len_k of (bm[kw[k, j]] >> j, funnel-shifted
// across words w and w + 1) is non-zero within the chunk's start
// positions: one warp per keyword over the tile's words. A hit stores 1
// into the zeroed output; every store of a chunk's keyword is the same
// byte, so the tiles need no atomics.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileWords = 64;  // 2048 start positions per tile
constexpr int kWpt = kTileWords + 1;  // odd: conflict-free rows
constexpr int kMaxLen = 24;  // MAX_KW: the halo fits one word
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmem = 256 * kWpt * sizeof(uint32_t);

__global__ void __launch_bounds__(kThreads)
prefilter_kernel(const uint8_t* __restrict__ chunks,
                 const uint8_t* __restrict__ kw,  // [n_kw, kw_stride]
                 const int32_t* __restrict__ kw_len,  // [n_kw]
                 uint8_t* __restrict__ out,  // [c, n_kw] bool, zeroed
                 int len, int n_kw, int kw_stride, int max_len, int tiles) {
  extern __shared__ uint32_t bm[];  // [256, kWpt]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long c = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * (kTileWords * 32);
  const uint8_t* chunk = chunks + c * len;
  for (int i = threadIdx.x; i < 256 * kWpt; i += blockDim.x) bm[i] = 0;
  __syncthreads();
  for (int k = warp; k < kWpt; k += nwarps) {  // uniform across the warp
    const int p = t0 + 32 * k + lane;
    const int b = p < len ? chunk[p] : 0;
    const unsigned group = __match_any_sync(kFull, b);
    if (lane == __ffs(group) - 1) bm[b * kWpt + k] = group;
  }
  __syncthreads();
  const int n_words = min(kTileWords, (len - t0 + 31) / 32);
  for (int kk = warp; kk < n_kw; kk += nwarps) {  // uniform across the warp
    const int n = max(0, min(kw_len[kk], max_len));
    const int mine = lane < n ? kw[static_cast<long long>(kk) * kw_stride +
                                   lane]
                              : 0;
    int bytes[kMaxLen];
#pragma unroll
    for (int j = 0; j < kMaxLen; ++j) bytes[j] = __shfl_sync(kFull, mine, j);
    bool any = false;
    for (int w = lane; w < n_words; w += 32) {
      const int left = len - (t0 + 32 * w);
      uint32_t h = left >= 32 ? kFull : (1u << left) - 1u;
#pragma unroll
      for (int j = 0; j < kMaxLen; ++j) {
        if (j < n) {
          const uint32_t* row = bm + bytes[j] * kWpt;
          h &= __funnelshift_r(row[w], row[w + 1], j);
        }
      }
      any |= h != 0;
    }
    if (__any_sync(kFull, any) && lane == 0) {
      out[c * n_kw + kk] = 1;
    }
  }
}

}  // namespace

extern "C" int trivy_prefilter_hits(const void* chunks, const void* kw,
                                    const void* kw_len, void* out, int c,
                                    int len, int n_kw, int kw_stride,
                                    int max_len, void* stream) {
  if (c <= 0 || len <= 0 || n_kw <= 0) return 0;
  if (max_len < 1 || max_len > kMaxLen || kw_stride < max_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      prefilter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (len + kTileWords * 32 - 1) / (kTileWords * 32);
  const long long blocks = static_cast<long long>(c) * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  prefilter_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(chunks), static_cast<const uint8_t*>(kw),
      static_cast<const int32_t*>(kw_len), static_cast<uint8_t*>(out), len,
      n_kw, kw_stride, max_len, tiles);
  return static_cast<int>(cudaGetLastError());
}
