// A query request's JSON body: its vector member parsed straight into
// float32, on the host.
//
// The REST routes /vectors/query and /vectors/batch_query take a body such
// as {"user_id": ..., "model_id": ..., "query": [768 numbers], "k": 10}.
// Decoding it with Python's json makes a float object of every number
// through a correctly rounded strtod, then pydantic walks the list and
// numpy casts it to float32: most of the event loop's time a request.
// Here each number is parsed with std::from_chars, which also rounds
// correctly, into a double that is then cast to float32: the same two
// roundings as the Python path, so the same bits.
//
// vdb_scan_vectors walks the top-level object, finds the one member whose
// key is `key` and parses its value as a non-empty array of numbers (rank
// 1) or of equal, non-empty rows of numbers (rank 2). It returns the count
// of numbers written to `out`, and in `info` the value's byte range
// [start, end), its rows and its columns. Every other member is only
// skipped: the caller decodes the body with the value replaced by a
// placeholder, and a body the caller's own parser refuses goes to the
// generic path. The return is -1 (not taken) for anything the scanner
// does not take whole: a first byte other than whitespace or '{', a key
// that appears twice, no such key, an escape it cannot read, a value that
// is not such an array, a number outside strict JSON grammar (NaN,
// Infinity, a leading '+' or zero, a bare '.'), a number from_chars cannot
// represent, or one whose magnitude is above FLT_MAX.
//
// An integer token is a Python int on the generic path, and float(int) of
// -0 is +0.0, so the token -0 is written as +0.0 here; every other integer
// token from_chars rounds as float(int) does (to nearest, ties to even). Not built with -ffast-math, which would flip the process's
// flush-to-zero flags and change the cast of float32 subnormals.

#include <cfloat>
#include <charconv>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <system_error>

namespace {

inline bool is_ws(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && is_ws(*p)) ++p;
  return p;
}

inline int hex_value(char c) {
  if (c >= '0' && c <= '9') return c - '0';
  if (c >= 'a' && c <= 'f') return c - 'a' + 10;
  if (c >= 'A' && c <= 'F') return c - 'A' + 10;
  return -1;
}

// A string from its opening quote at p: the pointer past its closing quote,
// or nullptr for a bad escape, a raw control character or no closing quote.
// With `key`, *equal says whether its decoded text is the ASCII `key`.
const char* scan_string(const char* p, const char* end, const char* key,
                        std::size_t key_len, bool* equal) {
  ++p;
  std::size_t i = 0;
  bool same = key != nullptr;
  while (p < end) {
    unsigned char c = static_cast<unsigned char>(*p);
    if (c == '"') {
      if (key != nullptr) *equal = same && i == key_len;
      return p + 1;
    }
    if (c < 0x20) return nullptr;
    unsigned int unit = c;
    if (c == '\\') {
      if (++p >= end) return nullptr;
      switch (*p) {
        case '"': unit = '"'; break;
        case '\\': unit = '\\'; break;
        case '/': unit = '/'; break;
        case 'b': unit = '\b'; break;
        case 'f': unit = '\f'; break;
        case 'n': unit = '\n'; break;
        case 'r': unit = '\r'; break;
        case 't': unit = '\t'; break;
        case 'u': {
          if (end - p < 5) return nullptr;
          unit = 0;
          for (int j = 1; j <= 4; ++j) {
            int h = hex_value(p[j]);
            if (h < 0) return nullptr;
            unit = unit * 16 + static_cast<unsigned int>(h);
          }
          p += 4;
          break;
        }
        default: return nullptr;
      }
    }
    // a key is ASCII: a byte or an escaped unit of 0x80 or more differs
    if (same) {
      same = unit < 0x80 && i < key_len &&
             static_cast<unsigned char>(key[i]) == unit;
      ++i;
    }
    ++p;
  }
  return nullptr;
}

// Any value from its first byte: the pointer past it, or nullptr. Nested
// values are skipped by their brackets, with strings read as strings; a
// scalar ends at whitespace or a delimiter. What it lets through unchecked
// the caller's own parser refuses.
const char* skip_value(const char* p, const char* end) {
  if (p >= end) return nullptr;
  char c = *p;
  if (c == '"') return scan_string(p, end, nullptr, 0, nullptr);
  if (c == '{' || c == '[') {
    long depth = 0;
    while (p < end) {
      c = *p;
      if (c == '"') {
        p = scan_string(p, end, nullptr, 0, nullptr);
        if (p == nullptr) return nullptr;
        continue;
      }
      if (c == '{' || c == '[') {
        ++depth;
      } else if (c == '}' || c == ']') {
        if (--depth == 0) return p + 1;
      }
      ++p;
    }
    return nullptr;
  }
  const char* s = p;
  while (p < end && !is_ws(*p) && *p != ',' && *p != '}' && *p != ']') ++p;
  return p > s ? p : nullptr;
}

inline bool is_digit(char c) { return c >= '0' && c <= '9'; }

// One number at p, written to *out as float32 after rounding to the
// nearest double; the pointer past it, or nullptr. from_chars takes a
// wider grammar than JSON, so what it read is held to JSON's after: a digit
// first (no inf, nan or bare '.'), no leading zero, a digit after a '.'.
// (An exponent without digits it leaves unread, so the caller sees no
// delimiter after the number.)
const char* parse_number(const char* p, const char* end, float* out) {
  double d = 0.0;
  std::from_chars_result r = std::from_chars(p, end, d);
  if (r.ec != std::errc()) return nullptr;
  const char* t = p + (*p == '-');
  if (!is_digit(*t) || (*t == '0' && t + 1 < r.ptr && is_digit(t[1])))
    return nullptr;
  const char* dot =
      static_cast<const char*>(std::memchr(t, '.', r.ptr - t));
  if (dot != nullptr && (dot + 1 == r.ptr || !is_digit(dot[1])))
    return nullptr;
  if (!(std::fabs(d) <= static_cast<double>(FLT_MAX))) return nullptr;
  // the integer token -0 is float(int(0)) = +0.0 on the generic path
  if (r.ptr - p == 2 && p[0] == '-' && d == 0.0) d = 0.0;
  *out = static_cast<float>(d);
  return r.ptr;
}

// A non-empty array of numbers from its '[' at p: the pointer past its
// ']', or nullptr. Writes the numbers from out[*n] on, at most up to cap.
const char* parse_row(const char* p, const char* end, float* out,
                      std::int64_t cap, std::int64_t* n) {
  p = skip_ws(p + 1, end);
  while (true) {
    if (*n >= cap) return nullptr;
    p = parse_number(p, end, out + *n);
    if (p == nullptr) return nullptr;
    ++*n;
    p = skip_ws(p, end);
    if (p >= end) return nullptr;
    if (*p == ']') return p + 1;
    if (*p != ',') return nullptr;
    p = skip_ws(p + 1, end);
  }
}

// The vector member's value at p (rank 1: a row; rank 2: a non-empty array
// of rows of one length): the pointer past it, or nullptr.
const char* parse_vectors(const char* p, const char* end, int rank,
                          float* out, std::int64_t cap, std::int64_t* n,
                          std::int64_t* rows, std::int64_t* cols) {
  if (p >= end || *p != '[') return nullptr;
  if (rank == 1) {
    p = parse_row(p, end, out, cap, n);
    *rows = 1;
    *cols = *n;
    return p;
  }
  p = skip_ws(p + 1, end);
  std::int64_t r = 0;
  while (true) {
    if (p >= end || *p != '[') return nullptr;
    std::int64_t before = *n;
    p = parse_row(p, end, out, cap, n);
    if (p == nullptr) return nullptr;
    if (r == 0) {
      *cols = *n - before;
    } else if (*n - before != *cols) {
      return nullptr;
    }
    ++r;
    p = skip_ws(p, end);
    if (p >= end) return nullptr;
    if (*p == ']') {
      *rows = r;
      return p + 1;
    }
    if (*p != ',') return nullptr;
    p = skip_ws(p + 1, end);
  }
}

}  // namespace

extern "C" {

// See the file's head. info: value start, value end, rows, columns.
std::int64_t vdb_scan_vectors(const char* body, std::int64_t len,
                              const char* key, std::int64_t key_len,
                              int rank, float* out, std::int64_t cap,
                              std::int64_t* info) {
  if (rank != 1 && rank != 2) return -1;
  const char* p = body;
  const char* end = body + len;
  p = skip_ws(p, end);
  if (p >= end || *p != '{') return -1;
  p = skip_ws(p + 1, end);
  std::int64_t n = 0, rows = 0, cols = 0;
  const char* start = nullptr;
  const char* stop = nullptr;
  if (p < end && *p == '}') return -1;
  while (true) {
    if (p >= end || *p != '"') return -1;
    bool equal = false;
    p = scan_string(p, end, key, static_cast<std::size_t>(key_len), &equal);
    if (p == nullptr) return -1;
    p = skip_ws(p, end);
    if (p >= end || *p != ':') return -1;
    p = skip_ws(p + 1, end);
    if (equal) {
      if (start != nullptr) return -1;  // a key twice
      start = p;
      p = parse_vectors(p, end, rank, out, cap, &n, &rows, &cols);
      stop = p;
    } else {
      p = skip_value(p, end);
    }
    if (p == nullptr) return -1;
    p = skip_ws(p, end);
    if (p >= end) return -1;
    if (*p == '}') break;
    if (*p != ',') return -1;
    p = skip_ws(p + 1, end);
  }
  if (skip_ws(p + 1, end) != end || start == nullptr) return -1;
  info[0] = start - body;
  info[1] = stop - body;
  info[2] = rows;
  info[3] = cols;
  return n;
}

}  // extern "C"
