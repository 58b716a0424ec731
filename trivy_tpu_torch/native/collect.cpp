// Match-result decode: bit-packed device hit masks -> screened
// candidate triples (query row, advisory id, rescreen flag).
//
// Copy of trivy_tpu/native/collect.cpp.
//
// Replaces the numpy chain unpackbits -> nonzero -> fancy-gather ->
// token-compare in detector/engine.py MatchEngine._crunch with
// one cache-friendly pass, plus the cross-source (row, id) sort-dedupe
// (was np.lexsort + keep-mask) and the confirmed-hit CSR grouping (was
// searchsorted + per-query slicing). The rescreen memo stays in Python
// where the version comparators live.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 collect.cpp -o libcollect.so

#include <algorithm>
#include <cstdint>

extern "C" {

// Count set bits over the whole mask (capacity for decode_mask).
int64_t count_bits(const uint32_t* words, int64_t n_words) {
    int64_t total = 0;
    for (int64_t i = 0; i < n_words; i++) {
        total += __builtin_popcount(words[i]);
    }
    return total;
}

// words:    uint32[b][w32] bit-packed hit masks (bit k of word j set =>
//           row start[b] + j*32 + k is a hit for query b)
// start:    int64[b] window start row per query
// n_rows:   total DB rows (bits past the end are ignored)
// row_adv:  int32[n_rows] advisory id per row
// row_flags:int32[n_rows]
// adv_tok:  int64[n_adv] (space,name) token per advisory
// q_tok:    int64[b] query name token (-2 = unknown name)
// q_flags:  int32[b] query flags
// flag_mask: NEEDS_HOST|RESCREEN
// out_rows/out_ids/out_resc: capacity >= count_bits(...)
// returns number of screened candidates written
int64_t decode_mask(const uint32_t* words, int64_t b, int64_t w32,
                    const int64_t* start, int64_t n_rows,
                    const int32_t* row_adv, const int32_t* row_flags,
                    const int64_t* adv_tok,
                    const int64_t* q_tok, const int32_t* q_flags,
                    int32_t flag_mask,
                    int64_t* out_rows, int64_t* out_ids,
                    uint8_t* out_resc) {
    int64_t n = 0;
    for (int64_t q = 0; q < b; q++) {
        const uint32_t* row = words + q * w32;
        const int64_t base = start[q];
        const int64_t qt = q_tok[q];
        const int32_t qf = q_flags[q];
        for (int64_t j = 0; j < w32; j++) {
            uint32_t bits = row[j];
            while (bits) {
                const int k = __builtin_ctz(bits);
                bits &= bits - 1;
                const int64_t ridx = base + j * 32 + k;
                if (ridx >= n_rows) continue;
                const int32_t id = row_adv[ridx];
                if (adv_tok[id] != qt) continue;  // hash collision
                out_rows[n] = q;
                out_ids[n] = id;
                out_resc[n] =
                    ((row_flags[ridx] | qf) & flag_mask) != 0;
                n++;
            }
        }
    }
    return n;
}

// In-place sort by (row, id, resc) and dedupe on (row, id), keeping the
// first occurrence (exact hit preferred over its rescreen twin - resc is
// the sort tiebreaker). Requires rows < 2^21 and ids < 2^42 (checked by
// the Python caller); triples pack into one u64 so the sort runs on a
// flat key array instead of a 3-key lexsort.
// Returns the deduped count m; rows/ids/resc are compacted in place.
int64_t sort_dedupe(int64_t* rows, int64_t* ids, uint8_t* resc,
                    int64_t n) {
    if (n <= 0) return 0;
    uint64_t* keys = new uint64_t[n];
    uint64_t key_or = 0;
    for (int64_t i = 0; i < n; i++) {
        keys[i] = (uint64_t(rows[i]) << 43) | (uint64_t(ids[i]) << 1) |
                  uint64_t(resc[i]);
        key_or |= keys[i];
    }
    // LSD radix sort (11-bit digits), skipping all-zero digit positions
    // — ~3x std::sort on the multi-million-candidate dense batches
    if (n > 4096) {
        constexpr int RADIX_BITS = 11;
        constexpr int BUCKETS = 1 << RADIX_BITS;
        uint64_t* tmp = new uint64_t[n];
        int64_t count[BUCKETS];
        uint64_t* src = keys;
        uint64_t* dst = tmp;
        for (int shift = 0; shift < 64; shift += RADIX_BITS) {
            const uint64_t rem = key_or >> shift;
            if (rem == 0) break;  // no key has bits at or above shift
            if ((rem & (BUCKETS - 1)) == 0) continue;  // no-op digit
            for (int b = 0; b < BUCKETS; b++) count[b] = 0;
            for (int64_t i = 0; i < n; i++) {
                count[(src[i] >> shift) & (BUCKETS - 1)]++;
            }
            int64_t sum = 0;
            for (int b = 0; b < BUCKETS; b++) {
                int64_t c = count[b];
                count[b] = sum;
                sum += c;
            }
            for (int64_t i = 0; i < n; i++) {
                dst[count[(src[i] >> shift) & (BUCKETS - 1)]++] = src[i];
            }
            uint64_t* t = src;
            src = dst;
            dst = t;
        }
        if (src != keys) {
            for (int64_t i = 0; i < n; i++) keys[i] = src[i];
        }
        delete[] tmp;
    } else {
        std::sort(keys, keys + n);
    }
    int64_t m = 0;
    uint64_t prev_rowid = ~uint64_t(0);
    for (int64_t i = 0; i < n; i++) {
        const uint64_t rowid = keys[i] >> 1;
        if (rowid == prev_rowid) continue;  // same (row, id): keep first
        prev_rowid = rowid;
        rows[m] = int64_t(keys[i] >> 43);
        ids[m] = int64_t((keys[i] >> 1) & ((uint64_t(1) << 42) - 1));
        resc[m] = uint8_t(keys[i] & 1);
        m++;
    }
    delete[] keys;
    return m;
}

// Compact confirmed hits into a CSR over queries: out_ids gets the
// advisory ids of rows[i] where conf[i] != 0 (already sorted by row
// then id), out_bounds[q]..out_bounds[q+1] brackets query q's slice.
// rows must be sorted ascending (sort_dedupe's postcondition).
// Returns total confirmed count.
int64_t group_confirmed(const int64_t* rows, const int64_t* ids,
                        const uint8_t* conf, int64_t m,
                        int64_t n_queries,
                        int64_t* out_ids, int64_t* out_bounds) {
    int64_t n = 0;
    int64_t q = 0;
    out_bounds[0] = 0;
    for (int64_t i = 0; i < m; i++) {
        if (!conf[i]) continue;
        const int64_t r = rows[i];
        while (q < r && q < n_queries) out_bounds[++q] = n;
        out_ids[n++] = ids[i];
    }
    while (q < n_queries) out_bounds[++q] = n;
    return n;
}

}  // extern "C"
