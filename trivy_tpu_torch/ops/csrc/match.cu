// Vulnerability-match kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel trivy_tpu/ops/match.py:_match_kernel (a
// jax.jit function): for each query, a lower-bound search of its name
// hash h1 in the sorted row_h1 column, then the ceil32(W) consecutive
// 32-byte rows of the interleaved table from there, each tested for
//   hit = row in bounds AND h1 equal AND h2 equal
//         AND (lo <= rank <= hi OR row NEEDS_HOST OR query NEEDS_HOST)
//         AND (row not PRE_ONLY OR query RESCREEN|NEEDS_HOST),
// packed as bit w%32 of word w//32.
//
// What bounds it: memory. Per query it does a few dozen integer
// compares per row read, far below the card's integer rate, so the
// least time is the row bytes that can hold a hit (32 B each, up to the
// end of the query's name group) and the keys the search reads. The
// time a warp takes is a chain of dependent loads: a binary search of
// 1,752,822 rows is 21 of them, and a name group of 4,000 rows walked a
// word at a time is 125 more.
//
// What the design does about it:
//  - the search is warp-cooperative and 32-ary: the 32 lanes read 32
//    evenly spaced keys of the current range and one ballot picks the
//    sub-range, so 1,752,822 rows take 5 dependent steps. The keys a
//    step reads are stored together, in a search index the host builds
//    once per DeviceDB (every 32nd key, every 1,024th, ...; 1/31 of the
//    key column): a step is one 128-byte line, where 32 keys spread
//    over the range would be 32 sectors (on the H100 that gather made
//    the main tier slower than a binary search). The same steps find the end
//    of the name's group (the upper bound, a second ballot on the same
//    step), so the number of words that can hold a hit,
//    min(n_words, ceil((end - start) / 32)), is known before any row is
//    read;
//  - the walk has no chain: a warp issues the row loads of kBatch words
//    at once (lane i reads row start + 32k + i, a contiguous 1 KB span
//    per word), then takes their ballots; the ballot of the per-lane hit
//    bits IS the packed word (lane i -> bit i); words past the group are
//    stored as zeros without a read;
//  - a query's words can be spread over several warps of a block
//    (warps_per_query, word k to warp k % warps_per_query), which the
//    host (ops/match.py:match_layout) picks per tier from the window and
//    the batch size; the words in flight follow from it (kBatch 2 at one
//    warp a query, the main tier's 2-word window, registers for 8 blocks
//    an SM; 4 for a query spread over warps, the hot and tall tiers' long
//    windows, while the grid still fits the card at once);
//  - queries arrive sorted by h1 (the wrapper sorts them), so
//    neighbouring warps read neighbouring keys and rows, and the warps
//    of one block often read the same name's rows, through L1.
//
// Types: h1/h2 travel as int32 bit patterns of uint32 hashes. The search
// compares them as uint32 (row_h1 is sorted unsigned); equality is a bit
// compare; lo/hi/rank are signed int32 (pad rows carry hi = -1).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeedsHost = 1;
constexpr int kRescreen = 2;
constexpr int kPreOnly = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// The search index (ops/match.py:search_index, top level first): level
// l = 1..levels holds keys[32^l * j], size[l] = ceil(n / 32^l) entries
// from h1_index[offset[l]]; `levels` is the fewest whose top level has
// at most 32 entries; level 0 is the keys themselves. Built on the host
// per launch and passed by value; the search unrolls its levels so that
// every array index is a constant.
constexpr int kMaxLevels = 6;  // 32^7 > 2^31 rows
struct SearchIndex {
  int levels;
  unsigned size[kMaxLevels + 1];
  unsigned offset[kMaxLevels + 1];
};

SearchIndex search_index(unsigned n) {
  SearchIndex ix{};
  ix.size[0] = n;
  while (ix.size[ix.levels] > 32) {
    ++ix.levels;
    ix.size[ix.levels] = static_cast<unsigned>(
        (static_cast<unsigned long long>(n) + (1ull << (5 * ix.levels)) -
         1) >> (5 * ix.levels));
  }
  unsigned offset = 0;
  for (int l = ix.levels; l >= 1; --l) {
    ix.offset[l] = offset;
    offset += ix.size[l];
  }
  return ix;
}

// [start, end): the rows of keys[0, n) equal to x, as the lower and the
// upper bound of x in unsigned order. One 32-ary descent per bound, the
// two in step: at each level the warp reads the 32 consecutive entries
// of the current block (one 128-byte line; one load for both bounds
// while their blocks coincide) and a ballot counts those below the
// bound; the block one level down starts 32 entries after the last one
// below. The entry lane i reads at level l is key 32^l * (j + i): the
// 32 evenly spaced keys of the range left, stored together.
__device__ __forceinline__ void find_group(const uint32_t* __restrict__ keys,
                                           const uint32_t* __restrict__ index,
                                           const SearchIndex& ix, uint32_t x,
                                           int lane, unsigned& start,
                                           unsigned& end) {
  unsigned lj = 0, uj = 0;  // block starts at the current level
#pragma unroll
  for (int l = kMaxLevels; l >= 0; --l) {
    if (l > ix.levels) continue;  // uniform
    const uint32_t* entries = l == 0 ? keys : index + ix.offset[l];
    const unsigned size = ix.size[l];
    const uint32_t le = lj + lane < size ? entries[lj + lane] : ~0u;
    const uint32_t ue =
        uj == lj ? le : (uj + lane < size ? entries[uj + lane] : ~0u);
    const int lc =
        __popc(__ballot_sync(kFull, lj + lane < size && le < x));
    const int uc =
        __popc(__ballot_sync(kFull, uj + lane < size && ue <= x));
    if (l == 0) {
      start = lj + lc;
      end = uj + uc;
    } else {
      lj = (lj + max(lc, 1) - 1) * 32;
      uj = (uj + max(uc, 1) - 1) * 32;
    }
  }
}

template <int kBatch, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
match_kernel(const uint32_t* __restrict__ row_h1,
             const uint32_t* __restrict__ h1_index,  // its levels above
             const int4* __restrict__ table,  // [n, 2] int4 = [n, 8] int32
             const uint32_t* __restrict__ q_h1,
             const uint32_t* __restrict__ q_h2,
             const int32_t* __restrict__ q_rank,
             const int32_t* __restrict__ q_flags,
             uint32_t* __restrict__ out,  // [b, n_words]
             const SearchIndex ix, int n, int b, int n_words,
             int warps_per_query) {
  __shared__ unsigned group[kWarps][2];
  const int wq = warps_per_query;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot = warp / wq;  // the block's query slot
  const int sub = warp - slot * wq;  // this warp takes words sub + wq * j
  const int q = blockIdx.x * (kWarps / wq) + slot;
  const bool live = q < b;  // uniform across the warp

  // the query (read before the search, so that these loads overlap it)
  const uint32_t ph1 = live ? q_h1[q] : 0u;
  const uint32_t ph2 = live ? q_h2[q] : 0u;
  const int32_t rank = live ? q_rank[q] : 0;
  const int32_t qfl = live ? q_flags[q] : 0;
  unsigned start = 0, end = 0;
  if (live && sub == 0) {
    find_group(row_h1, h1_index, ix, ph1, lane, start, end);
  }
  if (wq > 1) {  // uniform across the block
    if (sub == 0 && lane == 0) {
      group[slot][0] = start;
      group[slot][1] = end;
    }
    __syncthreads();
    start = group[slot][0];
    end = group[slot][1];
  }
  if (!live) return;

  const bool q_host = (qfl & kNeedsHost) != 0;
  const bool q_pre = (qfl & (kRescreen | kNeedsHost)) != 0;
  // words that reach into the name's group; no later word can hit
  const int live_words =
      static_cast<int>(min(static_cast<unsigned>(n_words),
                           (end - start + 31u) / 32u));
  const int per_warp = (n_words - sub + wq - 1) / wq;
  // this warp's words that can hit: sub + wq * j < live_words
  const int per_warp_live = max(0, (live_words - sub + wq - 1) / wq);
  uint32_t* qout = out + static_cast<long long>(q) * n_words;

  for (int j0 = 0; j0 < per_warp; j0 += 32) {
    uint32_t mine = 0;  // lane i keeps this warp's word j0 + i
    const int j_end = min(per_warp_live, j0 + 32);
    for (int jb = j0; jb < j_end; jb += kBatch) {
      int4 a[kBatch];
      int32_t fl[kBatch];
      bool ok[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {  // every load first, then use
        const int k = sub + wq * (jb + u);
        const long long r = start + 32LL * k + lane;
        ok[u] = jb + u < j_end && r < n;
        a[u] = ok[u] ? table[2 * r] : make_int4(0, 0, 0, 0);  // h1 h2 lo hi
        fl[u] = ok[u] ? table[2 * r + 1].x : 0;  // flags
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool name_eq = static_cast<uint32_t>(a[u].x) == ph1 &&
                             static_cast<uint32_t>(a[u].y) == ph2;
        const bool in_iv = a[u].z <= rank && rank <= a[u].w;
        const bool host = (fl[u] & kNeedsHost) != 0 || q_host;
        const bool pre_ok = (fl[u] & kPreOnly) == 0 || q_pre;
        const uint32_t word =
            __ballot_sync(kFull, ok[u] && name_eq && (in_iv || host) &&
                                     pre_ok);
        if (lane == ((jb + u) & 31)) mine = word;
      }
    }
    if (j0 + lane < per_warp) qout[sub + wq * (j0 + lane)] = mine;
  }
}

}  // namespace

extern "C" int trivy_match_words(const void* row_h1, const void* h1_index,
                                 const void* table, const void* q_h1,
                                 const void* q_h2, const void* q_rank,
                                 const void* q_flags, void* out, int n, int b,
                                 int n_words, int warps_per_query,
                                 void* stream) {
  if (b <= 0) return 0;
  if (n < 0 || n_words < 1 || warps_per_query < 1 ||
      warps_per_query > kWarps || kWarps % warps_per_query) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_block = kWarps / warps_per_query;
  const int blocks = (b + per_block - 1) / per_block;
  // one warp a query: two words in flight, registers for 8 blocks an
  // SM; a query spread over warps (long windows): four, 4 blocks an SM
  auto kernel =
      warps_per_query == 1 ? match_kernel<2, 8> : match_kernel<4, 4>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(row_h1),
      static_cast<const uint32_t*>(h1_index), static_cast<const int4*>(table),
      static_cast<const uint32_t*>(q_h1), static_cast<const uint32_t*>(q_h2),
      static_cast<const int32_t*>(q_rank),
      static_cast<const int32_t*>(q_flags), static_cast<uint32_t*>(out),
      search_index(static_cast<unsigned>(n)), n, b, n_words,
      warps_per_query);
  return static_cast<int>(cudaGetLastError());
}
