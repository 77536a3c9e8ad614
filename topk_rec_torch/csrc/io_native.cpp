// Native host runtime: fast text IO for the framework's data contracts.
//
// Plays the role the reference's C++ layer plays for its pipeline
// (old/cr/data.cpp sparse readers, old/cr/utils.cpp mtx_fprintf/mtx_fscanf
// text matrix IO): the hot host-side parsing/serialization paths, exposed
// to Python via a C ABI + ctypes (topk_rec_torch/native/io_native.py).
// Grown from a copy of topk_rec_tpu/native/io_native.cpp (so the PyTorch
// package stands alone); tkr_parse_likes is the port's own.
//
//   tkr_parse_ratings: ratings fold text -> (pos_u, pos_i, seen_u, seen_i)
//       index arrays. Semantics identical to the Python spec in
//       topk_rec_torch/data/io.py::parse_ratings (like=='1' => positive; every known
//       (user, item) mention => seen; unknown ids dropped).
//   tkr_parse_likes: test fold text -> each user's liked candidates, as
//       (users, offsets, items). Semantics identical to the Python spec in
//       topk_rec_torch/eval/protocol.py::load_test_likes; a file holding a
//       byte whose text-mode reading it does not copy is left to that spec.
//   tkr_write_dat: "%f "-per-value text matrix writer, byte-compatible
//       with topk_rec_torch/data/io.py::write_dat (and the reference's
//       export_embed_to_file, utils.py:47-55).
//
// Build: at first use, by topk_rec_torch/ops/_build.py (g++, a library of
// its own).

#include <array>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

extern "C" {

static char* read_whole_file(const char* path, size_t* out_len) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long len = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  char* buf = len < 0 ? nullptr : static_cast<char*>(std::malloc(len + 1));
  if (!buf) {
    std::fclose(f);
    return nullptr;
  }
  size_t got = std::fread(buf, 1, len, f);
  std::fclose(f);
  buf[got] = '\0';
  *out_len = got;
  return buf;
}

// Parse one ratings fold file. Returns 0 on success. Output arrays are
// malloc'd; caller frees with tkr_free.
long long tkr_parse_ratings(const char* path, const char** uid_strs,
                            long long n_users, const char** iid_strs,
                            long long n_items, int** out_pos_u,
                            int** out_pos_i, int** out_seen_u,
                            int** out_seen_i, long long* out_n_pos,
                            long long* out_n_seen) {
  std::unordered_map<std::string, int> uids, iids;
  uids.reserve(n_users * 2);
  iids.reserve(n_items * 2);
  for (long long i = 0; i < n_users; ++i) uids.emplace(uid_strs[i], (int)i);
  for (long long i = 0; i < n_items; ++i) iids.emplace(iid_strs[i], (int)i);

  size_t len = 0;
  char* buf = read_whole_file(path, &len);
  if (!buf) return 1;

  std::vector<int> pos_u, pos_i, seen_u, seen_i;
  pos_u.reserve(1 << 20);
  pos_i.reserve(1 << 20);
  seen_u.reserve(1 << 20);
  seen_i.reserve(1 << 20);

  char* p = buf;
  char* end = buf + len;
  std::string tok;
  while (p < end) {
    // line start: user id up to ','
    char* comma = p;
    while (comma < end && *comma != ',' && *comma != '\n') ++comma;
    if (comma >= end || *comma == '\n') {
      p = comma + 1;
      continue;  // no items on this line
    }
    tok.assign(p, comma - p);
    auto uit = uids.find(tok);
    int u = (uit == uids.end()) ? -1 : uit->second;
    p = comma + 1;
    // items: iid:like separated by ','
    while (p < end && *p != '\n') {
      char* colon = p;
      while (colon < end && *colon != ':' && *colon != ',' && *colon != '\n')
        ++colon;
      if (colon >= end || *colon != ':') {
        // malformed term; skip to next separator
        p = colon;
        if (p < end && *p == ',') ++p;
        continue;
      }
      char* term_end = colon + 1;
      while (term_end < end && *term_end != ',' && *term_end != '\n')
        ++term_end;
      if (u >= 0) {
        tok.assign(p, colon - p);
        auto iit = iids.find(tok);
        if (iit != iids.end()) {
          int item = iit->second;
          seen_u.push_back(u);
          seen_i.push_back(item);
          // like field == "1" exactly (ref utils.py:68)
          if (term_end - colon == 2 && colon[1] == '1') {
            pos_u.push_back(u);
            pos_i.push_back(item);
          }
        }
      }
      p = term_end;
      if (p < end && *p == ',') ++p;
    }
    if (p < end) ++p;  // skip newline
  }
  std::free(buf);

  auto dup = [](const std::vector<int>& v) {
    int* arr = static_cast<int*>(std::malloc(v.size() * sizeof(int)));
    std::memcpy(arr, v.data(), v.size() * sizeof(int));
    return arr;
  };
  *out_pos_u = dup(pos_u);
  *out_pos_i = dup(pos_i);
  *out_seen_u = dup(seen_u);
  *out_seen_i = dup(seen_i);
  *out_n_pos = (long long)pos_u.size();
  *out_n_seen = (long long)seen_u.size();
  return 0;
}

static const char* find_byte(const char* p, const char* end, char c) {
  const void* q = std::memchr(p, c, end - p);
  return q ? static_cast<const char*>(q) : end;
}

// A map passed as its n keys joined by '\n' and their values in the same
// order. The views point into `keys`, which outlives the map.
static void key_map(const char* keys, long long keys_len,
                    const long long* vals, long long n,
                    std::unordered_map<std::string_view, long long>* out) {
  out->reserve(n * 2);
  const char* p = keys;
  const char* end = keys + keys_len;
  for (long long i = 0; i < n; ++i) {
    const char* q = find_byte(p, end, '\n');
    out->emplace(std::string_view(p, q - p), vals[i]);
    p = q + 1;
  }
}

// Bytes that Python's text-mode reading does not take as this parser
// does: non-ASCII (decoded), NUL, and \v \f \x1c-\x1f (whitespace to
// str.strip, which strips only ' ', '\t' and '\r' here).
static bool unhandled_byte(unsigned char c) {
  return c >= 0x80 || c == 0 || c == 0x0b || c == 0x0c ||
         (c >= 0x1c && c <= 0x1f);
}

static bool strip_byte(char c) { return c == ' ' || c == '\t' || c == '\r'; }

// Parse one test fold file into each user's liked candidates. Rules of the
// Python spec (eval/protocol.py::load_test_likes): a line of an unknown
// user is skipped; a term is a like when the text after its first ':' is
// exactly "1" and its item is a candidate; duplicates stay; a known user
// with no likes keeps an empty list; a later line of a user (by value)
// replaces its list and keeps its first position. Lines are split on
// '\n' and stripped at both ends.
//
// Outputs (malloc'd; caller frees with tkr_free): out_users, the users in
// order of their first line; out_offsets, n_users + 1 offsets into
// out_items, each user's likes from its last line in file order.
// Returns 0 ok; else the file is left to the Python spec: 1 open or
// allocation failure, 2 a byte above, or a '\r' not followed by '\n' (a
// line break to Python's text mode).
long long tkr_parse_likes(const char* path, const char* user_keys,
                          long long user_keys_len, const long long* user_vals,
                          long long n_users, const char* cand_keys,
                          long long cand_keys_len, const long long* cand_vals,
                          long long n_cands, long long** out_users,
                          long long** out_offsets, long long** out_items,
                          long long* out_n_users, long long* out_n_items) {
  size_t len = 0;
  char* buf = read_whole_file(path, &len);
  if (!buf) return 1;
  static const auto left = [] {  // the bytes above, and '\r'
    std::array<bool, 256> t{};
    for (int c = 0; c < 256; ++c) t[c] = unhandled_byte(c) || c == '\r';
    return t;
  }();
  for (size_t k = 0; k < len; ++k) {
    unsigned char c = buf[k];
    if (left[c] && (c != '\r' || k + 1 == len || buf[k + 1] != '\n')) {
      std::free(buf);
      return 2;
    }
  }
  std::unordered_map<std::string_view, long long> uids, cands;
  key_map(user_keys, user_keys_len, user_vals, n_users, &uids);
  key_map(cand_keys, cand_keys_len, cand_vals, n_cands, &cands);

  std::vector<long long> users, items;
  std::vector<std::pair<size_t, size_t>> lists;  // [begin, end) in items
  std::unordered_map<long long, size_t> slot;     // user -> its index
  items.reserve(len / 8);
  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    const char* b = p;
    const char* e = find_byte(p, end, '\n');
    p = e + 1;
    while (b < e && strip_byte(*b)) ++b;
    while (e > b && strip_byte(e[-1])) --e;
    const char* t = find_byte(b, e, ',');
    auto uit = uids.find(std::string_view(b, t - b));
    if (uit == uids.end()) continue;
    size_t begin = items.size();
    while (t < e) {  // t is at the ',' before a term
      const char* s = t + 1;
      t = find_byte(s, e, ',');
      const char* colon = find_byte(s, t, ':');
      if (t - colon == 2 && colon[1] == '1') {
        auto cit = cands.find(std::string_view(s, colon - s));
        if (cit != cands.end()) items.push_back(cit->second);
      }
    }
    auto [it, fresh] = slot.emplace(uit->second, users.size());
    if (fresh) {
      users.push_back(uit->second);
      lists.emplace_back(begin, items.size());
    } else {
      lists[it->second] = {begin, items.size()};
    }
  }
  std::free(buf);

  size_t n = users.size(), total = 0;
  for (const auto& l : lists) total += l.second - l.first;
  // one element spare each, so no pointer handed back is null
  auto alloc = [](size_t m) {
    return static_cast<long long*>(std::malloc((m + 1) * sizeof(long long)));
  };
  long long* u_out = alloc(n);
  long long* o_out = alloc(n);
  long long* i_out = alloc(total);
  if (!u_out || !o_out || !i_out) {
    std::free(u_out);
    std::free(o_out);
    std::free(i_out);
    return 1;
  }
  size_t at = 0;
  for (size_t k = 0; k < n; ++k) {
    u_out[k] = users[k];
    o_out[k] = (long long)at;
    size_t m = lists[k].second - lists[k].first;
    if (m)
      std::memcpy(i_out + at, items.data() + lists[k].first,
                  m * sizeof(long long));
    at += m;
  }
  o_out[n] = (long long)at;
  *out_users = u_out;
  *out_offsets = o_out;
  *out_items = i_out;
  *out_n_users = (long long)n;
  *out_n_items = (long long)total;
  return 0;
}

void tkr_free(void* p) { std::free(p); }

// Parse a "%f "-style space-separated text matrix (final-*.dat) into a
// flat float32 array. The Python wrapper validates rectangularity from
// (n_vals, n_rows, first_cols), mirroring data/io.py::read_dat. Plays
// the role of the reference's mtx_fscanf (old/cr/utils.cpp:90-113).
// Returns 0 ok, 1 open failure, 2 non-numeric token.
long long tkr_parse_dat(const char* path, float** out_data,
                        long long* out_n_vals, long long* out_n_rows,
                        long long* out_first_cols) {
  size_t len = 0;
  char* buf = read_whole_file(path, &len);
  if (!buf) return 1;
  std::vector<float> vals;
  vals.reserve(len / 9 + 16);  // "%f" floats are ~9 chars
  // Row accounting mirrors the Python spec path (data/io.py): EVERY
  // line counts except the trailing blank run, and first_cols is line
  // 0's token count even when 0 (a leading/interior blank line must
  // fail rectangularity identically whether or not the .so is built).
  long long line_no = 0, last_nonblank = -1;
  long long first_cols = -1, line_tokens = 0;
  char* p = buf;
  char* end = buf + len;
  while (p < end) {
    char c = *p;
    if (c == '\n' || c == '\r') {
      // '\r', '\n' and '\r\n' are each ONE line break, matching Python
      // splitlines (a lone '\r' treated as whitespace silently merged
      // two rows into one)
      if (line_tokens > 0) last_nonblank = line_no;
      if (first_cols < 0) first_cols = line_tokens;
      ++line_no;
      line_tokens = 0;
      ++p;
      if (c == '\r' && p < end && *p == '\n') ++p;
    } else if (c == ' ' || c == '\t') {
      ++p;
    } else {
      // fast path for the writer's own "%f" format ([-]digits.digits):
      // exact digit accumulation in double (<= 13 significant digits
      // fits exactly), one scale, one float32 round — ~5x strtof, which
      // burns time on locale/hex/exponent generality. Any token with an
      // exponent/nan/inf falls back to strtof for full generality.
      char* q = p;
      bool neg = false;
      if (*q == '-' || *q == '+') {
        neg = (*q == '-');
        ++q;
      }
      double acc = 0.0;
      int digits = 0;
      while (q < end && *q >= '0' && *q <= '9') {
        acc = acc * 10.0 + (*q - '0');
        ++digits;
        ++q;
      }
      int frac = 0;
      if (q < end && *q == '.') {
        ++q;
        while (q < end && *q >= '0' && *q <= '9') {
          acc = acc * 10.0 + (*q - '0');
          ++digits;
          ++frac;
          ++q;
        }
      }
      bool plain = digits > 0 && digits <= 15 &&
                   (q >= end || *q == ' ' || *q == '\t' || *q == '\n' ||
                    *q == '\r');
      if (plain) {
        static const double kPow10[16] = {
            1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10,
            1e11, 1e12, 1e13, 1e14, 1e15};
        double v = acc / kPow10[frac];
        vals.push_back((float)(neg ? -v : v));
        ++line_tokens;
        p = q;
      } else {
        float v = std::strtof(p, &q);
        // the whole token must be consumed up to a delimiter — a
        // partial parse ("0.5.5" -> 0.5 + ".5") would silently split
        // corrupt tokens into fabricated values where the Python spec
        // path raises
        bool at_delim = q > p && (q >= end || *q == ' ' || *q == '\t' ||
                                  *q == '\n' || *q == '\r');
        if (!at_delim) {
          std::free(buf);
          return 2;
        }
        // strtof accepts hex floats ("0x10") that the Python spec path
        // rejects — keep the two paths byte-equivalent
        for (char* t = p; t < q; ++t) {
          if (*t == 'x' || *t == 'X') {
            std::free(buf);
            return 2;
          }
        }
        vals.push_back(v);
        ++line_tokens;
        p = q;
      }
    }
  }
  if (line_tokens > 0) {  // final line without trailing newline
    if (first_cols < 0) first_cols = line_tokens;
    last_nonblank = line_no;
  }
  long long rows = last_nonblank + 1;
  std::free(buf);
  float* arr = static_cast<float*>(std::malloc(vals.size() * sizeof(float)));
  if (!arr && !vals.empty()) return 1;
  std::memcpy(arr, vals.data(), vals.size() * sizeof(float));
  *out_data = arr;
  *out_n_vals = (long long)vals.size();
  *out_n_rows = rows;
  *out_first_cols = first_cols < 0 ? 0 : first_cols;
  return 0;
}

// Write a float32 matrix as "%f " text rows (trailing space before \n),
// byte-compatible with the reference format. Returns 0 on success.
int tkr_write_dat(const char* path, const float* data, long long rows,
                  long long cols) {
  FILE* f = std::fopen(path, "w");
  if (!f) return 1;
  // 64 KiB stdio buffer + manual row buffer for speed
  std::vector<char> rowbuf;
  rowbuf.reserve(cols * 16 + 2);
  char num[64];
  for (long long r = 0; r < rows; ++r) {
    rowbuf.clear();
    const float* rp = data + r * cols;
    for (long long c = 0; c < cols; ++c) {
      int n = std::snprintf(num, sizeof(num), "%f", (double)rp[c]);
      rowbuf.insert(rowbuf.end(), num, num + n);
      rowbuf.push_back(c + 1 < cols ? ' ' : ' ');
    }
    rowbuf.push_back('\n');
    if (std::fwrite(rowbuf.data(), 1, rowbuf.size(), f) != rowbuf.size()) {
      std::fclose(f);
      return 2;
    }
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
