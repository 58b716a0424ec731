// Streaming gunzip + tar-header splitter for container layer analysis.
//
// Feed compressed (gzip) or plain tar bytes incrementally; the splitter
// inflates and frames tar members in one pass, storing member data for
// the analysis lanes.  The Python wrapper (ops/splitter.py) calls feed()
// via ctypes, which releases the GIL, so N analysis lanes can split N
// layers truly concurrently.
//
// Parity contract: this parses the subset of tar that container layers
// actually use (ustar, GNU longname/longlink, pax x/g records) with the
// exact field semantics of CPython's tarfile module.  ANYTHING outside
// that subset — sparse members, hdrcharset overrides, base-256 negative
// numbers, malformed headers, truncated streams — returns an error and
// the caller falls back to the pure-Python tarfile walk, so behavior
// can never diverge: the native path either matches tarfile or defers
// to it.

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr size_t kBlock = 512;
// longname / pax record payloads are tiny in practice; anything bigger
// is suspicious enough to punt to the Python path
constexpr long long kSpecialMax = 1 << 20;

struct Member {
  std::string name;
  long long size = 0;
  long long mode = 0;
  int typeflag = 0;
  bool stored = false;    // data captured (regular member within cap)
  bool from_pax = false;  // name came from a pax path record
  std::string data;
};

struct Pax {
  bool has_path = false;
  std::string path;
  bool has_size = false;
  long long size = 0;
  void clear() { has_path = has_size = false; path.clear(); size = 0; }
};

struct Splitter {
  long long max_member = 0;

  // compression layer
  int comp = -1;  // -1 sniffing, 0 plain tar, 1 gzip
  z_stream strm{};
  bool strm_init = false;
  bool gz_clean = true;  // last inflate ended exactly at a stream end
  unsigned char sniff[2] = {0, 0};
  int sniff_n = 0;

  // tar state machine
  int state = 0;  // 0 reading header, 1 reading data/padding, 2 done
  unsigned char hdr[kBlock];
  size_t hdr_fill = 0;
  long long data_left = 0;
  long long pad_left = 0;
  // 0 member (store data), 5 member (skim data), 1 longname,
  // 2 longlink, 3 pax, 4 pax-global
  int cur_kind = 0;
  Member cur;
  std::string special;
  bool has_longname = false;
  std::string longname;
  Pax pending, global_pax;
  bool saw_member = false;
  bool last_was_special = false;

  std::vector<Member> members;
  std::string err;

  ~Splitter() {
    if (strm_init) inflateEnd(&strm);
  }
};

// tarfile.nti(): octal text (NUL/space padded) or base-256.  Negative
// base-256 (0o377 lead byte) is rejected — tarfile would produce a
// negative size, which only a hostile archive contains.
bool num_field(const unsigned char* p, size_t n, long long* out) {
  if (p[0] == 0x80) {
    unsigned long long v = 0;
    for (size_t i = 1; i < n; i++) v = (v << 8) | p[i];
    if (v > 0x7fffffffffffffffULL) return false;
    *out = static_cast<long long>(v);
    return true;
  }
  if (p[0] == 0xff) return false;
  size_t end = n;
  for (size_t k = 0; k < n; k++) {
    if (p[k] == 0) {
      end = k;
      break;
    }
  }
  size_t i = 0;
  while (i < end && p[i] == ' ') i++;
  while (end > i && p[end - 1] == ' ') end--;
  if (i == end) {
    *out = 0;
    return true;
  }
  long long v = 0;
  for (; i < end; i++) {
    if (p[i] < '0' || p[i] > '7') return false;
    if (v > (0x7fffffffffffffffLL - 7) / 8) return false;
    v = v * 8 + (p[i] - '0');
  }
  *out = v;
  return true;
}

std::string nts(const unsigned char* p, size_t n) {
  size_t end = n;
  for (size_t k = 0; k < n; k++) {
    if (p[k] == 0) {
      end = k;
      break;
    }
  }
  return std::string(reinterpret_cast<const char*>(p), end);
}

bool is_reg_type(int t) { return t == 0 || t == '0' || t == '7'; }

bool is_supported_type(int t) {
  switch (t) {
    case 0:
    case '0':
    case '1':
    case '2':
    case '3':
    case '4':
    case '5':
    case '6':
    case '7':
    case 'L':
    case 'K':
    case 'S':
      return true;
    default:
      return false;
  }
}

int fail(Splitter* s, const char* msg) {
  if (s->err.empty()) s->err = msg;
  return -1;
}

int parse_pax(Splitter* s, const std::string& buf, Pax* out) {
  size_t pos = 0;
  while (pos < buf.size() && static_cast<unsigned char>(buf[pos]) != 0x00) {
    size_t d = pos;
    while (d < buf.size() && buf[d] >= '0' && buf[d] <= '9' &&
           d - pos < 20) {
      d++;
    }
    if (d == pos || d >= buf.size() || buf[d] != ' ')
      return fail(s, "bad pax record length");
    long long length = 0;
    for (size_t k = pos; k < d; k++) length = length * 10 + (buf[k] - '0');
    if (length < 5 || pos + static_cast<size_t>(length) > buf.size())
      return fail(s, "bad pax record framing");
    size_t value_end = pos + length - 1;  // must be the '\n'
    if (buf[value_end] != '\n') return fail(s, "bad pax record newline");
    std::string kv = buf.substr(d + 1, value_end - (d + 1));
    size_t eq = kv.find('=');
    if (eq == std::string::npos || eq == 0)
      return fail(s, "bad pax record keyword");
    std::string key = kv.substr(0, eq);
    std::string value = kv.substr(eq + 1);
    if (key == "hdrcharset") return fail(s, "pax hdrcharset unsupported");
    if (key.rfind("GNU.sparse.", 0) == 0)
      return fail(s, "pax sparse unsupported");
    if (key == "path") {
      out->has_path = true;
      out->path = value;
    } else if (key == "size") {
      if (value.empty()) return fail(s, "bad pax size");
      long long v = 0;
      for (char c : value) {
        if (c < '0' || c > '9') return fail(s, "bad pax size");
        if (v > (0x7fffffffffffffffLL - 9) / 10)
          return fail(s, "bad pax size");
        v = v * 10 + (c - '0');
      }
      out->has_size = true;
      out->size = v;
    }
    pos += length;
  }
  return 0;
}

int finish_record(Splitter* s) {
  switch (s->cur_kind) {
    case 0:
    case 5:
      s->members.push_back(std::move(s->cur));
      s->saw_member = true;
      s->last_was_special = false;
      break;
    case 1: {  // GNU longname: NUL-terminated, binds to the next member
      size_t end = s->special.find('\0');
      s->longname = (end == std::string::npos)
                        ? s->special
                        : s->special.substr(0, end);
      s->has_longname = true;
      s->last_was_special = true;
      break;
    }
    case 2:  // GNU longlink: consumed, irrelevant to the walk
      s->last_was_special = true;
      break;
    case 3:
      if (parse_pax(s, s->special, &s->pending)) return -1;
      s->last_was_special = true;
      break;
    case 4:
      if (parse_pax(s, s->special, &s->global_pax)) return -1;
      s->last_was_special = true;
      break;
  }
  s->special.clear();
  return 0;
}

// One 512-byte header block -> next record state (tarfile.frombuf +
// _proc_member order, minus the paths that fall back).
int parse_header(Splitter* s) {
  const unsigned char* b = s->hdr;
  bool all_zero = true;
  for (size_t i = 0; i < kBlock; i++) {
    if (b[i]) {
      all_zero = false;
      break;
    }
  }
  if (all_zero) {
    // tarfile stream iteration stops at the first zero block; a
    // dangling longname/pax record with no member would make tarfile
    // raise, so defer to it
    if (s->last_was_special) return fail(s, "special record at EOF");
    s->state = 2;
    return 0;
  }

  long long chksum;
  if (!num_field(b + 148, 8, &chksum)) return fail(s, "bad checksum field");
  long long us = 0, ss = 0;
  for (size_t i = 0; i < kBlock; i++) {
    if (i >= 148 && i < 156) {
      us += 0x20;
      ss += 0x20;
    } else {
      us += b[i];
      ss += static_cast<signed char>(b[i]);
    }
  }
  if (chksum != us && chksum != ss) return fail(s, "bad checksum");

  long long mode, size, scratch;
  if (!num_field(b + 100, 8, &mode)) return fail(s, "bad mode field");
  if (!num_field(b + 124, 12, &size) || size < 0)
    return fail(s, "bad size field");
  // tarfile.frombuf parses every number field and raises on garbage;
  // stay exactly as strict so the native path is never *more* lenient
  if (!num_field(b + 108, 8, &scratch) ||   // uid
      !num_field(b + 116, 8, &scratch) ||   // gid
      !num_field(b + 136, 12, &scratch) ||  // mtime
      !num_field(b + 329, 8, &scratch) ||   // devmajor
      !num_field(b + 337, 8, &scratch))     // devminor
    return fail(s, "bad number field");

  std::string name = nts(b, 100);
  int type = b[156];
  // V7: a regular file with a trailing slash is a directory
  if (type == 0 && !name.empty() && name.back() == '/') type = '5';
  if (type == 'S') return fail(s, "sparse member unsupported");
  if (type == '5') {
    while (!name.empty() && name.back() == '/') name.pop_back();
  }
  std::string prefix = nts(b + 345, 155);
  if (!prefix.empty() && type != 'L' && type != 'K') {
    name = prefix + "/" + name;
  }

  s->cur = Member();
  s->special.clear();

  if (type == 'L' || type == 'K' || type == 'x' || type == 'X' ||
      type == 'g') {
    if (size > kSpecialMax) return fail(s, "oversized special record");
    switch (type) {
      case 'L':
        s->cur_kind = 1;
        break;
      case 'K':
        s->cur_kind = 2;
        break;
      case 'g':
        s->cur_kind = 4;
        break;
      default:
        s->cur_kind = 3;  // 'x' and Solaris 'X'
    }
    s->data_left = size;
    s->pad_left = (kBlock - (size % kBlock)) % kBlock;
    return 0;
  }

  // ordinary member: longname first, pax records override it
  if (s->has_longname) {
    name = s->longname;
    if (type == '5' && !name.empty() && name.back() == '/')
      name.pop_back();  // tarfile removesuffix("/") for dirs
    s->has_longname = false;
  }
  bool from_pax = false;
  if (s->pending.has_path) {
    name = s->pending.path;
    from_pax = true;
  } else if (s->global_pax.has_path) {
    name = s->global_pax.path;
    from_pax = true;
  }
  if (s->pending.has_size) {
    size = s->pending.size;
  } else if (s->global_pax.has_size) {
    size = s->global_pax.size;
  }
  s->pending.clear();
  if (type == '5') {
    while (!name.empty() && name.back() == '/') name.pop_back();
  }

  s->cur.name = std::move(name);
  s->cur.size = size;
  s->cur.mode = mode;
  s->cur.typeflag = type;
  s->cur.from_pax = from_pax;
  // data blocks follow for regular members and unknown types
  // (tarfile._proc_builtin); known non-regular types carry none
  bool has_data = is_reg_type(type) || !is_supported_type(type);
  s->cur.stored = is_reg_type(type) && size <= s->max_member;
  s->cur_kind = s->cur.stored ? 0 : 5;
  s->data_left = has_data ? size : 0;
  s->pad_left = has_data ? (kBlock - (size % kBlock)) % kBlock : 0;
  return 0;
}

int consume(Splitter* s, const unsigned char* p, size_t n) {
  while (n) {
    if (s->state == 2) return 0;  // archive done: ignore the tail
    if (s->state == 0) {
      size_t take = kBlock - s->hdr_fill;
      if (take > n) take = n;
      std::memcpy(s->hdr + s->hdr_fill, p, take);
      s->hdr_fill += take;
      p += take;
      n -= take;
      if (s->hdr_fill < kBlock) continue;
      s->hdr_fill = 0;
      if (parse_header(s)) return -1;
      if (s->state == 2) continue;
      if (s->data_left == 0 && s->pad_left == 0) {
        if (finish_record(s)) return -1;
      } else {
        s->state = 1;
      }
      continue;
    }
    // state 1: member data, then padding to the block boundary
    if (s->data_left > 0) {
      size_t take = n;
      if (static_cast<long long>(take) > s->data_left)
        take = static_cast<size_t>(s->data_left);
      if (s->cur_kind == 0) {
        s->cur.data.append(reinterpret_cast<const char*>(p), take);
      } else if (s->cur_kind != 5) {
        s->special.append(reinterpret_cast<const char*>(p), take);
      }
      s->data_left -= take;
      p += take;
      n -= take;
    }
    if (s->data_left == 0 && s->pad_left > 0 && n) {
      size_t take = n;
      if (static_cast<long long>(take) > s->pad_left)
        take = static_cast<size_t>(s->pad_left);
      s->pad_left -= take;
      p += take;
      n -= take;
    }
    if (s->data_left == 0 && s->pad_left == 0) {
      if (finish_record(s)) return -1;
      s->state = 0;
    }
  }
  return 0;
}

int run_inflate(Splitter* s, const unsigned char* p, size_t n) {
  s->strm.next_in = const_cast<unsigned char*>(p);
  s->strm.avail_in = static_cast<uInt>(n);
  std::vector<unsigned char> out(1 << 18);
  while (s->strm.avail_in) {
    if (s->state == 2) return 0;  // tar done: never inflate the tail
    s->gz_clean = false;
    s->strm.next_out = out.data();
    s->strm.avail_out = static_cast<uInt>(out.size());
    int rc = inflate(&s->strm, Z_NO_FLUSH);
    size_t got = out.size() - s->strm.avail_out;
    if (got && consume(s, out.data(), got)) return -1;
    if (rc == Z_STREAM_END) {
      s->gz_clean = true;
      // concatenated gzip members: restart and keep going
      if (inflateReset(&s->strm) != Z_OK)
        return fail(s, "inflate reset failed");
    } else if (rc == Z_BUF_ERROR) {
      if (got == 0) break;  // needs more input
    } else if (rc != Z_OK) {
      return fail(s, "inflate error");
    }
  }
  return 0;
}

}  // namespace

extern "C" {

void* tsp_new(long long max_member) {
  Splitter* s = new (std::nothrow) Splitter();
  if (s) s->max_member = max_member;
  return s;
}

int tsp_feed(void* h, const unsigned char* p, long long n) {
  Splitter* s = static_cast<Splitter*>(h);
  if (!s->err.empty()) return -1;
  if (s->state == 2 || n <= 0) return 0;
  size_t len = static_cast<size_t>(n);
  if (s->comp == -1) {
    while (s->sniff_n < 2 && len) {
      s->sniff[s->sniff_n++] = *p++;
      len--;
    }
    if (s->sniff_n < 2) return 0;
    if (s->sniff[0] == 0x1f && s->sniff[1] == 0x8b) {
      s->comp = 1;
      std::memset(&s->strm, 0, sizeof(s->strm));
      if (inflateInit2(&s->strm, 15 + 16) != Z_OK)
        return fail(s, "inflate init failed");
      s->strm_init = true;
      s->gz_clean = false;
      if (run_inflate(s, s->sniff, 2)) return -1;
    } else {
      s->comp = 0;
      if (consume(s, s->sniff, 2)) return -1;
    }
    if (!len) return 0;
  }
  if (s->comp == 0) return consume(s, p, len);
  return run_inflate(s, p, len);
}

int tsp_finish(void* h) {
  Splitter* s = static_cast<Splitter*>(h);
  if (!s->err.empty()) return -1;
  if (s->state == 2) return 0;
  if (s->comp == -1) return fail(s, "input too short");
  if (s->comp == 1 && !s->gz_clean)
    return fail(s, "truncated gzip stream");
  // EOF exactly at a header boundary with no dangling special record:
  // tarfile stream iteration also stops cleanly here
  if (s->state == 0 && s->hdr_fill == 0 && s->saw_member &&
      !s->last_was_special && !s->has_longname) {
    s->state = 2;
    return 0;
  }
  return fail(s, "truncated archive");
}

long long tsp_count(void* h) {
  Splitter* s = static_cast<Splitter*>(h);
  return static_cast<long long>(s->members.size());
}

int tsp_member(void* h, long long i, long long* size, long long* mode,
               int* typeflag, int* flags) {
  Splitter* s = static_cast<Splitter*>(h);
  if (i < 0 || i >= static_cast<long long>(s->members.size())) return -1;
  const Member& m = s->members[static_cast<size_t>(i)];
  *size = m.size;
  *mode = m.mode;
  *typeflag = m.typeflag;
  *flags = (m.stored ? 1 : 0) | (m.from_pax ? 2 : 0);
  return 0;
}

const char* tsp_name_ptr(void* h, long long i, long long* n) {
  Splitter* s = static_cast<Splitter*>(h);
  if (i < 0 || i >= static_cast<long long>(s->members.size())) {
    *n = 0;
    return nullptr;
  }
  const Member& m = s->members[static_cast<size_t>(i)];
  *n = static_cast<long long>(m.name.size());
  return m.name.data();
}

const unsigned char* tsp_data_ptr(void* h, long long i, long long* n) {
  Splitter* s = static_cast<Splitter*>(h);
  if (i < 0 || i >= static_cast<long long>(s->members.size())) {
    *n = 0;
    return nullptr;
  }
  const Member& m = s->members[static_cast<size_t>(i)];
  *n = static_cast<long long>(m.data.size());
  return reinterpret_cast<const unsigned char*>(m.data.data());
}

const char* tsp_error(void* h) {
  Splitter* s = static_cast<Splitter*>(h);
  return s->err.c_str();
}

void tsp_free(void* h) { delete static_cast<Splitter*>(h); }

}  // extern "C"
