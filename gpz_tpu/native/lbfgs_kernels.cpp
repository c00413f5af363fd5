// Native host-side kernels — C++ equivalents of the reference's MEX layer
// (ref minFunc/mex/lbfgsProdC.c, lbfgsAddC.c, lbfgsC.c, mcholC.c).
//
// The device training path runs the two-loop recursion on device
// (gpz_tpu/optim/lbfgs.py); these kernels back the host-resident optimizer
// used for small problems and for driving external objectives without
// device round-trips, plus the Gill–Murray modified Cholesky used by the
// Newton solver family. Exposed to Python via ctypes (gpz_tpu/native/ffi.py).
//
// All matrices are row-major contiguous doubles.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// Two-loop recursion over a circular curvature-pair buffer.
//   S, Y:   (history, p) row-major; slot j holds pair j
//   count:  number of valid pairs; pos: next insertion slot
//   g:      (p,) gradient; d_out: (p,) output direction = -H g
// Mirrors ref lbfgsProdC.c:46-88 (which uses start/end indices into column
// storage; the circular arithmetic here is equivalent).
void gpz_lbfgs_direction(const double* S, const double* Y, int64_t history,
                         int64_t p, int64_t count, int64_t pos,
                         double hdiag, const double* g, double* d_out) {
  std::vector<double> q(g, g + p);
  std::vector<double> al(static_cast<size_t>(count), 0.0);
  std::vector<double> rho(static_cast<size_t>(count), 0.0);

  // newest to oldest
  for (int64_t i = 0; i < count; ++i) {
    int64_t j = ((pos - 1 - i) % history + history) % history;
    const double* Sj = S + j * p;
    const double* Yj = Y + j * p;
    double sy = 0.0, sq = 0.0;
    for (int64_t t = 0; t < p; ++t) sy += Sj[t] * Yj[t];
    rho[i] = (sy > 1e-30) ? 1.0 / sy : 0.0;
    for (int64_t t = 0; t < p; ++t) sq += Sj[t] * q[t];
    double a = rho[i] * sq;
    al[i] = a;
    for (int64_t t = 0; t < p; ++t) q[t] -= a * Yj[t];
  }
  for (int64_t t = 0; t < p; ++t) q[t] *= hdiag;
  // oldest to newest
  for (int64_t i = count - 1; i >= 0; --i) {
    int64_t j = ((pos - 1 - i) % history + history) % history;
    const double* Sj = S + j * p;
    const double* Yj = Y + j * p;
    double yr = 0.0;
    for (int64_t t = 0; t < p; ++t) yr += Yj[t] * q[t];
    double b = rho[i] * yr;
    double corr = al[i] - b;
    for (int64_t t = 0; t < p; ++t) q[t] += corr * Sj[t];
  }
  for (int64_t t = 0; t < p; ++t) d_out[t] = -q[t];
}

// In-place curvature-pair insertion with the y's > 1e-10 skip rule
// (ref lbfgsAddC.c + lbfgsAdd.m:5-29). Returns 1 if accepted, 0 if skipped.
// On accept, writes s,y into slot *pos, advances *pos/*count, updates *hdiag.
int gpz_lbfgs_add(double* S, double* Y, int64_t history, int64_t p,
                  int64_t* count, int64_t* pos, double* hdiag,
                  const double* s, const double* y) {
  double ys = 0.0, yy = 0.0;
  for (int64_t t = 0; t < p; ++t) {
    ys += y[t] * s[t];
    yy += y[t] * y[t];
  }
  if (!(ys > 1e-10)) return 0;
  std::memcpy(S + *pos * p, s, sizeof(double) * p);
  std::memcpy(Y + *pos * p, y, sizeof(double) * p);
  *pos = (*pos + 1) % history;
  *count = std::min(*count + 1, history);
  *hdiag = ys / yy;
  return 1;
}

// Gill–Murray modified LDL^T with diagonal pivoting for (possibly
// indefinite) symmetric A — the role of ref mcholC.c:60-193: returns
// factors of A + E (E diagonal, minimal) that are safely positive definite.
//   A: (n, n) row-major, overwritten with L (unit lower) in the strict lower
//      triangle; d_out: (n,) positive diagonal of D; perm_out: (n,) pivot
//      order. Returns 0 on success.
int gpz_mchol(double* A, int64_t n, double* d_out, int64_t* perm_out) {
  // gamma = max |diagonal|, xi = max |off-diagonal|
  double gamma = 0.0, xi = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    gamma = std::max(gamma, std::fabs(A[i * n + i]));
    for (int64_t j = 0; j < i; ++j) xi = std::max(xi, std::fabs(A[i * n + j]));
  }
  double nd = std::max<double>(n * n - n, 1);
  double delta = 1e-12 * std::max(gamma + xi, 1.0);
  double beta2 = std::max({gamma, xi / std::sqrt(nd), 1e-12});

  std::vector<double> c(n * n, 0.0);
  std::vector<double> L(n * n, 0.0);
  std::vector<double> d(n, 0.0);
  std::vector<int64_t> perm(n);
  for (int64_t i = 0; i < n; ++i) {
    perm[i] = i;
    c[i * n + i] = A[i * n + i];
  }

  for (int64_t j = 0; j < n; ++j) {
    // pivot: largest |c_ii| among remaining
    int64_t q = j;
    for (int64_t i = j; i < n; ++i)
      if (std::fabs(c[perm[i] * n + perm[i]]) >
          std::fabs(c[perm[q] * n + perm[q]]))
        q = i;
    std::swap(perm[j], perm[q]);
    int64_t pj = perm[j];

    for (int64_t s = 0; s < j; ++s)
      L[j * n + s] = c[pj * n + perm[s]] / d[s];

    double theta = 0.0;
    for (int64_t i = j + 1; i < n; ++i) {
      int64_t pi = perm[i];
      double cij = A[pi * n + pj];
      for (int64_t s = 0; s < j; ++s)
        cij -= L[j * n + s] * c[pi * n + perm[s]];
      c[pi * n + pj] = cij;
      c[pj * n + pi] = cij;
      theta = std::max(theta, std::fabs(cij));
    }
    double dj = std::max({std::fabs(c[pj * n + pj]), theta * theta / beta2,
                          delta});
    d[j] = dj;
    for (int64_t i = j + 1; i < n; ++i) {
      int64_t pi = perm[i];
      c[pi * n + pi] -= c[pi * n + pj] * c[pi * n + pj] / dj;
    }
  }

  for (int64_t i = 0; i < n; ++i) {
    d_out[i] = d[i];
    perm_out[i] = perm[i];
    for (int64_t j = 0; j < n; ++j)
      A[i * n + j] = (i == j) ? 1.0 : (j < i ? L[i * n + j] : 0.0);
  }
  return 0;
}

}  // extern "C"
