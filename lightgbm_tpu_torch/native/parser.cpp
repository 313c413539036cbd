// Native chunked text parser for lightgbm_tpu_torch (the same source as
// lightgbm_tpu/native/parser.cpp, so both packages parse bit for bit alike).
//
// Runtime counterpart of the reference's Parser/TextReader pipeline
// (src/io/parser.cpp, include/LightGBM/utils/text_reader.h): dense
// CSV/TSV and sparse LibSVM files are parsed into row-major double
// matrices with multithreaded chunking.
//
// Float parsing reproduces the reference's hand-rolled
// Common::Atof (include/LightGBM/utils/common.h:163-261) EXACTLY,
// including its non-correctly-rounded digit accumulation
// (value += digit/pow10): bin thresholds are midpoints of Atof-parsed
// values, so bit-identical parsing is a hard requirement for
// prediction parity at value==threshold knife edges — a correctly
// rounded strtod differs by 1 ulp on e.g. "1.413" and flips the
// <= decision against a reference-trained model.
//
// Exposed via ctypes (a plain C ABI); see native/__init__.py.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

inline char lower(char c) { return static_cast<char>(std::tolower(static_cast<unsigned char>(c))); }

// Reference-compatible float parse (common.h:163-261 semantics,
// independently written). Returns pointer past the parsed token.
const char* AtofRef(const char* p, const char* end, double* out) {
  *out = 0;
  while (p < end && *p == ' ') ++p;
  double sign = 1.0;
  if (p < end && *p == '-') { sign = -1.0; ++p; }
  else if (p < end && *p == '+') { ++p; }

  if (p < end && ((*p >= '0' && *p <= '9') || *p == '.' || *p == 'e' || *p == 'E')) {
    double value = 0.0;
    for (; p < end && *p >= '0' && *p <= '9'; ++p) {
      value = value * 10.0 + (*p - '0');
    }
    if (p < end && *p == '.') {
      double pow10 = 10.0;
      ++p;
      while (p < end && *p >= '0' && *p <= '9') {
        value += (*p - '0') / pow10;
        pow10 *= 10.0;
        ++p;
      }
    }
    int frac = 0;
    double scale = 1.0;
    if (p < end && (*p == 'e' || *p == 'E')) {
      ++p;
      if (p < end && *p == '-') { frac = 1; ++p; }
      else if (p < end && *p == '+') { ++p; }
      uint32_t expon = 0;
      for (; p < end && *p >= '0' && *p <= '9'; ++p) {
        expon = expon * 10 + (*p - '0');
      }
      if (expon > 308) expon = 308;
      while (expon >= 50) { scale *= 1E50; expon -= 50; }
      while (expon >= 8)  { scale *= 1E8;  expon -= 8; }
      while (expon > 0)   { scale *= 10.0; expon -= 1; }
    }
    *out = sign * (frac ? (value / scale) : (value * scale));
  } else {
    // word tokens: na/nan -> 0, inf/infinity -> sign*1e308; an EMPTY
    // token (e.g. "1,,3") is 0.0 — the reference's cnt>0 branch is
    // skipped and *out keeps its 0 init (common.h:225-243).  Unknown
    // non-empty tokens are Log::Fatal there; nullptr here.
    size_t cnt = 0;
    while (p + cnt < end && p[cnt] != '\0' && p[cnt] != ' ' && p[cnt] != '\t' &&
           p[cnt] != ',' && p[cnt] != '\n' && p[cnt] != '\r' && p[cnt] != ':') {
      ++cnt;
    }
    if (cnt > 0) {
      std::string tmp(p, cnt);
      std::transform(tmp.begin(), tmp.end(), tmp.begin(), lower);
      if (tmp == "na" || tmp == "nan") {
        *out = 0;
      } else if (tmp == "inf" || tmp == "infinity") {
        *out = sign * 1e308;
      } else {
        return nullptr;  // unparseable token (reference: Log::Fatal)
      }
      p += cnt;
    }
  }
  return p;
}

// Collect [start, end) offsets of non-empty lines (memchr-driven).
void SplitLines(const char* buf, int64_t len, std::vector<std::pair<int64_t, int64_t>>* lines) {
  int64_t i = 0;
  while (i < len) {
    int64_t start = i;
    const char* nl = static_cast<const char*>(std::memchr(buf + i, '\n', len - i));
    int64_t stop = nl ? (nl - buf) : len;
    i = stop + 1;
    if (stop > start && buf[stop - 1] == '\r') --stop;
    bool blank = true;
    for (int64_t k = start; k < stop; ++k) {
      if (buf[k] != ' ' && buf[k] != '\t') { blank = false; break; }
    }
    if (!blank) lines->emplace_back(start, stop);
  }
}

// Opaque scan handle so dims + parse share ONE pass over the buffer.
struct ScanHandle {
  std::vector<std::pair<int64_t, int64_t>> lines;
};

inline bool IsSep(char c, char sep) {
  if (sep == ' ') return c == ' ' || c == '\t';  // whitespace mode
  return c == sep;
}

}  // namespace

extern "C" {

// Scan line structure once; reuse across dims + parse. Free with
// ltpu_scan_free.
void* ltpu_scan(const char* buf, int64_t len) {
  auto* h = new ScanHandle();
  SplitLines(buf, len, &h->lines);
  return h;
}

void ltpu_scan_free(void* handle) {
  delete static_cast<ScanHandle*>(handle);
}

// Count rows and columns of a dense file. sep==' ' means "any run of
// whitespace". Returns 0 ok, -1 ragged/invalid.
int ltpu_dims_csv(void* handle, const char* buf, char sep, int skip_lines,
                  int64_t* nrows, int* ncols) {
  auto& lines = static_cast<ScanHandle*>(handle)->lines;
  if (static_cast<size_t>(skip_lines) >= lines.size()) { *nrows = 0; *ncols = 0; return 0; }
  int cols = -1;
  for (size_t li = skip_lines; li < lines.size(); ++li) {
    const char* p = buf + lines[li].first;
    const char* end = buf + lines[li].second;
    int c = 0;
    bool in_tok = false;
    for (; p < end; ++p) {
      if (IsSep(*p, sep)) {
        if (sep != ' ' ) ++c;           // empty fields count for hard seps
        else if (in_tok) { in_tok = false; }
      } else {
        if (sep == ' ' && !in_tok) { ++c; in_tok = true; }
      }
    }
    if (sep != ' ') ++c;
    if (cols < 0) cols = c;
    else if (c != cols) return -1;
  }
  *nrows = static_cast<int64_t>(lines.size()) - skip_lines;
  *ncols = cols < 0 ? 0 : cols;
  return 0;
}

// Parse dense rows into out[nrows*ncols] (row major). Returns 0 ok,
// -1 on parse error or shape mismatch.
int ltpu_parse_csv(void* handle, const char* buf, char sep, int skip_lines,
                   double* out, int64_t nrows, int ncols, int nthreads) {
  auto& lines = static_cast<ScanHandle*>(handle)->lines;
  if (static_cast<int64_t>(lines.size()) - skip_lines != nrows) return -1;

  std::vector<int> errs(std::max(nthreads, 1), 0);
  auto work = [&](int tid, int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const char* p = buf + lines[r + skip_lines].first;
      const char* end = buf + lines[r + skip_lines].second;
      double* row = out + r * ncols;
      for (int c = 0; c < ncols; ++c) {
        if (sep == ' ') {
          while (p < end && (*p == ' ' || *p == '\t')) ++p;
        }
        if (p >= end && !(sep != ' ' && c == ncols - 1)) {
          // allow trailing empty field only for hard separators
          if (c != ncols - 1) { errs[tid] = 1; return; }
        }
        const char* q = AtofRef(p, end, &row[c]);
        if (q == nullptr) { errs[tid] = 1; return; }
        p = q;
        if (sep != ' ') {
          while (p < end && *p != sep) ++p;  // skip junk to separator
          if (p < end) ++p;                  // skip separator
        }
      }
    }
  };

  int nt = std::max(1, nthreads);
  if (nt == 1 || nrows < 4096) {
    work(0, 0, nrows);
  } else {
    std::vector<std::thread> threads;
    int64_t chunk = (nrows + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      int64_t lo = t * chunk, hi = std::min(nrows, lo + chunk);
      if (lo >= hi) break;
      threads.emplace_back(work, t, lo, hi);
    }
    for (auto& th : threads) th.join();
  }
  for (int e : errs) if (e) return -1;
  return 0;
}

// LibSVM pass 1: rows and max feature index (1 + max seen 0-based col).
int ltpu_dims_libsvm(void* handle, const char* buf, int64_t* nrows, int* ncols) {
  auto& lines = static_cast<ScanHandle*>(handle)->lines;
  int maxc = -1;
  for (auto& ln : lines) {
    const char* p = buf + ln.first;
    const char* end = buf + ln.second;
    // label token first — skip it
    while (p < end && *p != ' ' && *p != '\t') ++p;
    while (p < end) {
      while (p < end && (*p == ' ' || *p == '\t')) ++p;
      if (p >= end) break;
      int idx = 0;
      bool any = false;
      while (p < end && *p >= '0' && *p <= '9') { idx = idx * 10 + (*p - '0'); ++p; any = true; }
      if (!any || p >= end || *p != ':') return -1;
      ++p;
      while (p < end && *p != ' ' && *p != '\t') ++p;  // skip value
      maxc = std::max(maxc, idx);
    }
  }
  *nrows = static_cast<int64_t>(lines.size());
  *ncols = maxc + 1;
  return 0;
}

// LibSVM pass 2: fill dense out[nrows*ncols] (pre-zeroed by caller) and
// labels[nrows].
int ltpu_parse_libsvm(void* handle, const char* buf, double* out, double* labels,
                      int64_t nrows, int ncols, int nthreads) {
  auto& lines = static_cast<ScanHandle*>(handle)->lines;
  if (static_cast<int64_t>(lines.size()) != nrows) return -1;

  std::vector<int> errs(std::max(nthreads, 1), 0);
  auto work = [&](int tid, int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const char* p = buf + lines[r].first;
      const char* end = buf + lines[r].second;
      const char* q = AtofRef(p, end, &labels[r]);
      if (q == nullptr) { errs[tid] = 1; return; }
      p = q;
      double* row = out + r * ncols;
      while (p < end) {
        while (p < end && (*p == ' ' || *p == '\t')) ++p;
        if (p >= end) break;
        int idx = 0;
        while (p < end && *p >= '0' && *p <= '9') { idx = idx * 10 + (*p - '0'); ++p; }
        if (p >= end || *p != ':' || idx >= ncols) { errs[tid] = 1; return; }
        ++p;
        q = AtofRef(p, end, &row[idx]);
        if (q == nullptr) { errs[tid] = 1; return; }
        p = q;
      }
    }
  };

  int nt = std::max(1, nthreads);
  if (nt == 1 || nrows < 4096) {
    work(0, 0, nrows);
  } else {
    std::vector<std::thread> threads;
    int64_t chunk = (nrows + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      int64_t lo = t * chunk, hi = std::min(nrows, lo + chunk);
      if (lo >= hi) break;
      threads.emplace_back(work, t, lo, hi);
    }
    for (auto& th : threads) th.join();
  }
  for (int e : errs) if (e) return -1;
  return 0;
}

// Single-value Atof for host-side parity needs (e.g. tests).
double ltpu_atof(const char* s) {
  double v = 0;
  AtofRef(s, s + std::strlen(s), &v);
  return v;
}

}  // extern "C"
