// Aho-Corasick multi-pattern scanner for the secret-engine host
// prefilter.  The reference's hot loop is rules x files x
// strings.Contains on every keyword (pkg/fanal/secret/scanner.go:174-186);
// this automaton finds every keyword in one pass over the input.
//
// C ABI (used via ctypes from trivy_tpu_torch.native.ac):
//   ac_build(keywords, lengths, n)      -> handle
//   ac_scan(handle, data, len, hits[n]) -> number of distinct keywords hit
//   ac_free(handle)
//
// Matching is case-insensitive: patterns are expected lowercase and
// input bytes are folded with a 256-byte table (no locale).

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

constexpr int ALPHA = 256;

struct Node {
  int32_t next[ALPHA];
  int32_t fail = 0;
  std::vector<int32_t> out;  // keyword ids terminating here
  Node() { memset(next, -1, sizeof(next)); }
};

struct Automaton {
  std::vector<Node> nodes;
  int n_keywords = 0;
  uint8_t fold[ALPHA];

  Automaton() {
    for (int i = 0; i < ALPHA; i++) {
      fold[i] = (i >= 'A' && i <= 'Z') ? uint8_t(i - 'A' + 'a') : uint8_t(i);
    }
    nodes.emplace_back();
  }

  void add(const uint8_t* kw, int len, int id) {
    int cur = 0;
    for (int i = 0; i < len; i++) {
      uint8_t c = fold[kw[i]];
      if (nodes[cur].next[c] < 0) {
        nodes[cur].next[c] = (int32_t)nodes.size();
        nodes.emplace_back();
      }
      cur = nodes[cur].next[c];
    }
    nodes[cur].out.push_back(id);
  }

  void build() {
    std::queue<int> q;
    for (int c = 0; c < ALPHA; c++) {
      int v = nodes[0].next[c];
      if (v < 0) {
        nodes[0].next[c] = 0;
      } else {
        nodes[v].fail = 0;
        q.push(v);
      }
    }
    while (!q.empty()) {
      int u = q.front();
      q.pop();
      for (int c = 0; c < ALPHA; c++) {
        int v = nodes[u].next[c];
        if (v < 0) {
          nodes[u].next[c] = nodes[nodes[u].fail].next[c];
        } else {
          int f = nodes[nodes[u].fail].next[c];
          nodes[v].fail = f;
          // merge output links so one transition reports all suffixes
          const auto& fo = nodes[f].out;
          nodes[v].out.insert(nodes[v].out.end(), fo.begin(), fo.end());
          q.push(v);
        }
      }
    }
  }
};

}  // namespace

extern "C" {

void* ac_build(const uint8_t** keywords, const int32_t* lengths,
               int32_t n) {
  auto* ac = new Automaton();
  ac->n_keywords = n;
  for (int32_t i = 0; i < n; i++) {
    if (lengths[i] > 0) ac->add(keywords[i], lengths[i], i);
  }
  ac->build();
  return ac;
}

// Position-reporting variant: writes (keyword id, END offset) pairs of
// every occurrence (case-folded) into out_ids/out_pos, up to cap.
// Returns the number written, or -1 when the input holds more than cap
// occurrences — the caller must then treat positions as unknown (fall
// back to a whole-buffer scan), never as a truncated-but-trusted set.
int64_t ac_scan_pos(void* handle, const uint8_t* data, int64_t len,
                    int32_t* out_ids, int64_t* out_pos, int64_t cap) {
  auto* ac = static_cast<Automaton*>(handle);
  int64_t found = 0;
  int cur = 0;
  const auto* nodes = ac->nodes.data();
  const uint8_t* fold = ac->fold;
  for (int64_t i = 0; i < len; i++) {
    cur = nodes[cur].next[fold[data[i]]];
    const auto& out = nodes[cur].out;
    if (!out.empty()) {
      for (int32_t id : out) {
        if (found == cap) return -1;
        out_ids[found] = id;
        out_pos[found] = i;  // offset of the occurrence's LAST byte
        found++;
      }
    }
  }
  return found;
}

int32_t ac_scan(void* handle, const uint8_t* data, int64_t len,
                uint8_t* hits) {
  auto* ac = static_cast<Automaton*>(handle);
  memset(hits, 0, ac->n_keywords);
  int32_t found = 0;
  int cur = 0;
  const auto* nodes = ac->nodes.data();
  const uint8_t* fold = ac->fold;
  for (int64_t i = 0; i < len; i++) {
    cur = nodes[cur].next[fold[data[i]]];
    const auto& out = nodes[cur].out;
    if (!out.empty()) {
      for (int32_t id : out) {
        if (!hits[id]) {
          hits[id] = 1;
          if (++found == ac->n_keywords) return found;  // all hit: done
        }
      }
    }
  }
  return found;
}

void ac_free(void* handle) { delete static_cast<Automaton*>(handle); }

}  // extern "C"
