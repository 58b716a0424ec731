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
// time is the row bytes (32 B each) plus the dependent loads of the
// search. A full window is ceil32(W) * 32 B per query (16 KB at W=512).
//
// What the design does about it:
//  - one warp per query; every lane runs the same search, so its loads
//    are broadcasts of one address;
//  - lane i reads row start + 32k + i as two 16-byte loads, so a warp
//    reads one contiguous 1 KB span per word: fully coalesced;
//  - __ballot_sync of the per-lane hit bits IS the packed word (lane i
//    -> bit i), no shared memory and no reduction;
//  - early exit: rows are sorted by (h1, h2), so once a word holds a row
//    whose h1 differs from the query's (or runs past the table), no later
//    row can hit. The warp stops reading and stores zeros. Most names
//    have a handful of rows, so a query usually reads one 1 KB word
//    instead of the whole window;
//  - queries arrive sorted by h1 (the wrapper sorts them), so neighbouring
//    warps read neighbouring rows and share cache lines in L2.
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
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
match_kernel(const uint32_t* __restrict__ row_h1,
             const int4* __restrict__ table,  // [n, 2] int4 = [n, 8] int32
             const uint32_t* __restrict__ q_h1,
             const uint32_t* __restrict__ q_h2,
             const int32_t* __restrict__ q_rank,
             const int32_t* __restrict__ q_flags,
             uint32_t* __restrict__ out,  // [b, n_words]
             int n, int b, int n_words) {
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= b) return;  // uniform across the warp

  const uint32_t ph1 = q_h1[q];
  const uint32_t ph2 = q_h2[q];
  const int32_t rank = q_rank[q];
  const int32_t qfl = q_flags[q];
  const bool q_host = (qfl & kNeedsHost) != 0;
  const bool q_pre = (qfl & (kRescreen | kNeedsHost)) != 0;

  // unsigned lower bound: first index with row_h1 >= ph1
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = static_cast<int>((static_cast<unsigned>(lo) +
                                      static_cast<unsigned>(hi)) >> 1);
    if (row_h1[mid] < ph1) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const long long start = lo;

  uint32_t* qout = out + static_cast<long long>(q) * n_words;
  bool done = false;
  uint32_t mine = 0;  // lane j keeps word (32g + j) of the current group
  for (int k = 0; k < n_words; ++k) {
    uint32_t word = 0;
    if (!done) {
      const long long r = start + 32LL * k + lane;
      bool hit = false;
      bool stop = true;
      if (r < n) {
        const int4 a = table[2 * r];      // h1, h2, lo, hi
        const int4 c = table[2 * r + 1];  // flags, pad
        const bool name_eq = static_cast<uint32_t>(a.x) == ph1 &&
                             static_cast<uint32_t>(a.y) == ph2;
        const bool in_iv = a.z <= rank && rank <= a.w;
        const bool host = (c.x & kNeedsHost) != 0 || q_host;
        const bool pre_ok = (c.x & kPreOnly) == 0 || q_pre;
        hit = name_eq && (in_iv || host) && pre_ok;
        stop = static_cast<uint32_t>(a.x) != ph1;
      }
      word = __ballot_sync(kFull, hit);
      done = __any_sync(kFull, stop) != 0;
    }
    if (lane == (k & 31)) mine = word;
    if ((k & 31) == 31 || k == n_words - 1) {
      const int base = k & ~31;
      if (lane <= k - base) qout[base + lane] = mine;
    }
  }
}

}  // namespace

extern "C" int trivy_match_words(const void* row_h1, const void* table,
                                 const void* q_h1, const void* q_h2,
                                 const void* q_rank, const void* q_flags,
                                 void* out, int n, int b, int n_words,
                                 void* stream) {
  if (b <= 0) return 0;
  const int blocks = (b + kWarpsPerBlock - 1) / kWarpsPerBlock;
  match_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(row_h1), static_cast<const int4*>(table),
      static_cast<const uint32_t*>(q_h1), static_cast<const uint32_t*>(q_h2),
      static_cast<const int32_t*>(q_rank),
      static_cast<const int32_t*>(q_flags), static_cast<uint32_t*>(out), n,
      b, n_words);
  return static_cast<int>(cudaGetLastError());
}
