"""Numerics substrate: robust PSD solves, masked moments, distances.

Static-shape replacements for the reference's numeric utilities:
  * `inv_logdet_psd` / `solve_psd` — Cholesky with escalating jitter replaces
    the SVD pseudo-inverse of ref GPz/inv_logdet.m:3-15
  * `dxy` — squared-distance matrix, ref GPz/Dxy.m:3-7
  * `nanaware_moments` / `pca_whiten` — NaN-aware mean/cov + eig-PCA whitening,
    ref GPz/pca.m:5-46
  * `fill_linear` — Gaussian-conditional imputation as one batched masked dense
    solve instead of per-missingness-pattern row grouping, ref GPz/fillLinear.m
  * `masked_psd` — embeds the observed-block restriction A[o,o] of a PSD matrix
    as a full-size masked matrix whose inverse/logdet agree with the
    restriction; this is what turns every "group rows by NaN pattern" loop in
    the reference (getPHI.m:43-54, predict.m:45-56) into static-shape batched
    linear algebra.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

# Escalating relative jitter levels tried when a Cholesky factorization fails.
_JITTERS = (0.0, 1e-12, 1e-10, 1e-8, 1e-6, 1e-4, 1e-2)


def safe_cholesky(A: jax.Array) -> jax.Array:
    """Cholesky of PSD `A` (batched, [..., n, n]) with escalating jitter.

    Fast path: ONE factorization at zero jitter (the Gram is PD by
    construction, so this is the overwhelmingly common case; factoring at
    every jitter level unconditionally would cost 7 extra factorizations
    per eval). On failure a
    `lax.while_loop` escalates the jitter on a gradient-stopped copy until the
    factorization is finite, and one clean differentiable factorization is
    taken at that level. If every level fails, NaNs propagate and the
    optimizer's line search rejects the step (the reference's
    isLegal/Armijo-fallback role, minFunc.m:963, WolfeLineSearch.m:53-69).
    """
    n = A.shape[-1]
    eye = jnp.eye(n, dtype=A.dtype)
    As = lax.stop_gradient(A)
    scale = jnp.mean(jnp.abs(jnp.diagonal(As, axis1=-2, axis2=-1)), axis=-1)
    scale = jnp.maximum(scale, jnp.asarray(1.0, A.dtype))[..., None, None]
    jitters = jnp.asarray(_JITTERS, dtype=A.dtype)

    L0 = jnp.linalg.cholesky(A)
    ok0 = jnp.all(jnp.isfinite(L0))

    def cond_fn(state):
        i, ok = state
        return (~ok) & (i < len(_JITTERS) - 1)

    def body_fn(state):
        i, _ = state
        i = i + 1
        L = jnp.linalg.cholesky(As + jitters[i] * scale * eye)
        return i, jnp.all(jnp.isfinite(L))

    # zero iterations when the first factorization succeeded; the loop runs
    # on stop_gradient inputs so reverse-mode AD never sees it.
    idx, _ = lax.while_loop(cond_fn, body_fn, (jnp.asarray(0), ok0))
    return lax.cond(
        idx == 0,
        lambda: L0,
        lambda: jnp.linalg.cholesky(A + jitters[idx] * scale * eye),
    )


def chol_logdet(L: jax.Array) -> jax.Array:
    """log|A| from its Cholesky factor (batched)."""
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)


def chol_solve(L: jax.Array, B: jax.Array) -> jax.Array:
    """Solve A X = B given L = chol(A) (batched)."""
    Y = jax.scipy.linalg.solve_triangular(L, B, lower=True)
    return jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), Y, lower=False
    )


def solve_psd(A: jax.Array, B: jax.Array):
    """Solve A X = B for PSD A; returns (X, logdet A)."""
    L = safe_cholesky(A)
    return chol_solve(L, B), chol_logdet(L)


@jax.custom_vjp
def solve_w_logdet(SIGMA: jax.Array, rhs: jax.Array):
    """(w, logdet) for the batched PSD system SIGMA_k w_k = rhs_k.

    SIGMA (k, m, m); rhs (m, k). Returns w (m, k), logdet (k,).

    Exists for its VJP: reverse-mode AD through cholesky / triangular-solve
    lowers to plain f64 matmuls inside the decomposition VJP rules; on a
    machine whose f64 dot is not f64-accurate, that gradient jag,
    kappa-amplified late in training, stalls the f64 refine phase. The
    closed-form cotangents below use ONLY triangular solves and
    elementwise outer products:

        dw/d(rhs)   ^T c = SIGMA^-1 c
        dw/d(SIGMA) ^T c = -sym_outer(SIGMA^-1 c, w)
        dlogdet/dSIGMA   = SIGMA^-1
    """
    w, logdet, _ = _solve_w_logdet_fwd_impl(SIGMA, rhs)
    return w, logdet


def _solve_w_logdet_fwd_impl(SIGMA, rhs):
    L = safe_cholesky(SIGMA)
    w = chol_solve(L, jnp.swapaxes(rhs, 0, 1)[..., None])[..., 0]  # (k, m)
    return jnp.swapaxes(w, 0, 1), chol_logdet(L), L


def _solve_w_logdet_fwd(SIGMA, rhs):
    w, logdet, L = _solve_w_logdet_fwd_impl(SIGMA, rhs)
    return (w, logdet), (L, w)


def _solve_w_logdet_bwd(res, cts):
    L, w = res
    w_ct, logdet_ct = cts                     # (m, k), (k,)
    m = L.shape[-1]
    # SIGMA^-1 w_ct via triangular solves (no matmul)
    siw = chol_solve(L, jnp.swapaxes(w_ct, 0, 1)[..., None])[..., 0]  # (k, m)
    rhs_ct = jnp.swapaxes(siw, 0, 1)                                  # (m, k)
    wk = jnp.swapaxes(w, 0, 1)                                        # (k, m)
    # -(SIGMA^-1 c) w' — SIGMA is symmetric, so the cotangent is the
    # symmetrized outer product (elementwise broadcast, exact in f64)
    outer = siw[..., :, None] * wk[..., None, :]                      # (k,m,m)
    SIGMA_ct = -0.5 * (outer + jnp.swapaxes(outer, -1, -2))
    eye = jnp.broadcast_to(jnp.eye(m, dtype=L.dtype), L.shape)
    SIGMA_inv = chol_solve(L, eye)
    SIGMA_ct = SIGMA_ct + logdet_ct[..., None, None] * SIGMA_inv
    return SIGMA_ct, rhs_ct


solve_w_logdet.defvjp(_solve_w_logdet_fwd, _solve_w_logdet_bwd)


# ---------------------------------------------------------------------------
# fast mixed-mode solve: f32 factor + exact-residual iterative refinement
# ---------------------------------------------------------------------------
#
# For a machine without fast float64 (reached with solve_mode="mixed" and
# the Ozaki Gram, objective._ozaki_active), where an f64 Cholesky costs far
# more than an f32 one. The mixed phase then solves through an f32 factor
# of the Jacobi-equilibrated Gram C = D^-1 SIGMA D^-1 (unit diagonal —
# GPz's wildly varying alpha/beta diagonal is most of cond(SIGMA), measured
# 8.5e8 at iteration 60 of the north-star run), refined back to ~f64
# accuracy by iterative refinement whose residuals are computed with Ozaki
# slice products (ops/ozaki.py — on such a machine an f64 dot would be
# f32-grade and IR would stagnate at kappa * eps_f32). Each IR step
# contracts the error by ~kappa(C) * eps_f32; three steps reach ~1e-9 for
# kappa(C) up to ~1e5.
# If the final residual says otherwise (kappa(C) too large, or a non-finite
# trial point), a lax.cond falls back to the strict f64 factorization at
# runtime, so the fast path never silently degrades the objective.
# logdet comes from the f32 factor of C plus the exact f64 equilibration
# term sum(log diag): absolute error ~1e-4, i.e. ~1e-9 in the per-sample
# nlml at n=70k — at the mixed phase's progress tolerance, below its f32
# design-matrix error floor.


def _exact_mm_sym(C, Y):
    """C (k, m, m) symmetric f64 @ Y (k, m, r) f64, per-k Ozaki products."""
    from gpz_tpu.ops.ozaki import ozaki_tn

    return jnp.stack([ozaki_tn(C[i], Y[i]) for i in range(C.shape[0])])


def _ir_solve(L32, C, B, steps=3, final_residual=False):
    """Solve C y = B through the f32 factor L32 with f64 refinement.

    Returns (y, max|B - C y|) — the residual is 0.0 when not requested.
    """
    y = chol_solve(L32, B.astype(jnp.float32)).astype(jnp.float64)
    for _ in range(steps):
        r = B - _exact_mm_sym(C, y)
        y = y + chol_solve(L32, r.astype(jnp.float32)).astype(jnp.float64)
    if not final_residual:
        return y, jnp.zeros((), jnp.float64)
    r = B - _exact_mm_sym(C, y)
    return y, jnp.max(jnp.abs(r))


def _equilibrate(SIGMA):
    dg = jnp.diagonal(SIGMA, axis1=-2, axis2=-1)              # (k, m)
    di = 1.0 / jnp.sqrt(dg)
    C = SIGMA * di[:, :, None] * di[:, None, :]
    return C, di, dg


def _fast_fwd_impl(SIGMA, rhs):
    C, di, dg = _equilibrate(SIGMA)
    L32 = safe_cholesky(C.astype(jnp.float32))
    logdet = (
        2.0 * jnp.sum(
            jnp.log(jnp.diagonal(L32, axis1=-2, axis2=-1).astype(
                jnp.float64)), axis=-1)
        + jnp.sum(jnp.log(dg), axis=-1)
    )
    b = (jnp.swapaxes(rhs, 0, 1) * di)[..., None]             # (k, m, 1)
    y, resid = _ir_solve(L32, C, b, final_residual=True)
    ok = (
        (resid <= 1e-9 * (jnp.max(jnp.abs(b)) + 1e-300))
        & jnp.all(jnp.isfinite(y))
        & jnp.all(jnp.isfinite(logdet))
    )
    w = jnp.swapaxes(y[..., 0] * di, 0, 1)                    # (m, k)
    return w, logdet, ok, L32, C, di


@jax.custom_vjp
def fast_solve_w_logdet(SIGMA, rhs):
    """solve_w_logdet through an equilibrated f32 factor + exact-residual
    refinement, with a runtime fallback to the strict f64 path (see the
    section comment above). Drop-in: SIGMA (k, m, m), rhs (m, k) — returns
    (w (m, k), logdet (k,)) at ~f64 accuracy for ~7x less solve time."""
    w, logdet, ok, _, _, _ = _fast_fwd_impl(SIGMA, rhs)
    return jax.lax.cond(
        ok,
        lambda: (w, logdet),
        lambda: _solve_w_logdet_fwd_impl(SIGMA, rhs)[:2],
    )


def fast_solve_ok(SIGMA, rhs):
    """Would fast_solve_w_logdet take its fast path here? (True) or fall
    back to the strict f64 factor (False). Exposed so benchmarks can record
    the fallback rate in the hard (late-training, ill-conditioned) regime —
    the fallback costs the full strict solve on top of the failed fast one
    (VERDICT r3 item 7)."""
    return _fast_fwd_impl(SIGMA, rhs)[2]


def _fast_solve_fwd(SIGMA, rhs):
    w, logdet, ok, L32, C, di = _fast_fwd_impl(SIGMA, rhs)
    w, logdet = jax.lax.cond(
        ok,
        lambda: (w, logdet),
        lambda: _solve_w_logdet_fwd_impl(SIGMA, rhs)[:2],
    )
    return (w, logdet), (SIGMA, L32, C, di, w, ok)


def _fast_solve_bwd(res, cts):
    SIGMA, L32, C, di, w, ok = res
    w_ct, logdet_ct = cts                                     # (m, k), (k,)
    m = SIGMA.shape[-1]

    def fast():
        bc = (jnp.swapaxes(w_ct, 0, 1) * di)[..., None]       # (k, m, 1)
        u, _ = _ir_solve(L32, C, bc)
        siw = u[..., 0] * di                                  # (k, m)
        eye = jnp.broadcast_to(
            jnp.eye(m, dtype=jnp.float64), C.shape)
        Cinv, _ = _ir_solve(L32, C, eye)
        Sinv = Cinv * di[:, :, None] * di[:, None, :]
        return siw, Sinv

    def strict():
        L = safe_cholesky(SIGMA)
        siw = chol_solve(L, jnp.swapaxes(w_ct, 0, 1)[..., None])[..., 0]
        eye = jnp.broadcast_to(jnp.eye(m, dtype=L.dtype), L.shape)
        return siw, chol_solve(L, eye)

    siw, Sinv = jax.lax.cond(ok, fast, strict)
    rhs_ct = jnp.swapaxes(siw, 0, 1)
    wk = jnp.swapaxes(w, 0, 1)
    outer = siw[..., :, None] * wk[..., None, :]              # (k, m, m)
    SIGMA_ct = -0.5 * (outer + jnp.swapaxes(outer, -1, -2))
    SIGMA_ct = SIGMA_ct + logdet_ct[..., None, None] * Sinv
    return SIGMA_ct, rhs_ct


fast_solve_w_logdet.defvjp(_fast_solve_fwd, _fast_solve_bwd)


def inv_logdet_psd(A: jax.Array):
    """(A^-1, log|A|) for PSD A — the role of ref GPz/inv_logdet.m."""
    L = safe_cholesky(A)
    eye = jnp.broadcast_to(jnp.eye(A.shape[-1], dtype=A.dtype), A.shape)
    return chol_solve(L, eye), chol_logdet(L)


def unrolled_cholesky(A: jax.Array) -> jax.Array:
    """Cholesky for huge batches of TINY (d x d) matrices, d static.

    Batched lax.linalg.cholesky/triangular_solve on millions of d ~ 5
    matrices lower to per-matrix library calls or scalar loops. Unrolling
    over the small static d turns the factorization into ~d^3/6 fused
    elementwise ops over the batch — this is the hot op of the
    full-covariance (GC/VC) family (SURVEY §3.2: the per-sample loop of
    getPHI.m:80-88 becomes this).
    Non-PD inputs produce NaNs exactly like lax.linalg.cholesky.
    """
    d = A.shape[-1]
    L = [[None] * d for _ in range(d)]
    for j in range(d):
        s = A[..., j, j]
        for t in range(j):
            s = s - L[j][t] * L[j][t]
        L[j][j] = jnp.sqrt(s)
        for i in range(j + 1, d):
            s2 = A[..., i, j]
            for t in range(j):
                s2 = s2 - L[i][t] * L[j][t]
            L[i][j] = s2 / L[j][j]
    zero = jnp.zeros_like(A[..., 0, 0])
    rows = [
        jnp.stack([L[i][j] if j <= i else zero for j in range(d)], axis=-1)
        for i in range(d)
    ]
    return jnp.stack(rows, axis=-2)


def unrolled_solve_lower(L: jax.Array, b: jax.Array) -> jax.Array:
    """Forward substitution L z = b for tiny static d; b is [..., d]."""
    d = L.shape[-1]
    z = []
    for i in range(d):
        s = b[..., i]
        for t in range(i):
            s = s - L[..., i, t] * z[t]
        z.append(s / L[..., i, i])
    return jnp.stack(z, axis=-1)


def unrolled_inv_psd(A: jax.Array, unroll_max: int = 8):
    """(A^-1, log|A|) for huge batches of tiny PSD matrices.

    Unrolled Cholesky + triangular inverse + Linv^T Linv, all elementwise
    over the batch (see unrolled_cholesky for why lax.linalg is avoided).
    Falls back to the lax path for d > unroll_max.
    """
    d = A.shape[-1]
    if d > unroll_max:
        L = jnp.linalg.cholesky(A)
        eye = jnp.broadcast_to(jnp.eye(d, dtype=A.dtype), A.shape)
        Linv = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
        inv = jnp.einsum("...ki,...kj->...ij", Linv, Linv)
        return inv, chol_logdet(L)

    L = unrolled_cholesky(A)
    Li = [[None] * d for _ in range(d)]
    for j in range(d):
        Li[j][j] = 1.0 / L[..., j, j]
        for i in range(j + 1, d):
            s = L[..., i, j] * Li[j][j]
            for t in range(j + 1, i):
                s = s + L[..., i, t] * Li[t][j]
            Li[i][j] = -s / L[..., i, i]
    zero = jnp.zeros_like(A[..., 0, 0])
    rows = []
    for a in range(d):
        cols = []
        for b in range(d):
            lo = max(a, b)
            acc = zero
            for t in range(lo, d):
                acc = acc + Li[t][a] * Li[t][b]
            cols.append(acc)
        rows.append(jnp.stack(cols, axis=-1))
    inv = jnp.stack(rows, axis=-2)
    logdet = 2.0 * sum(jnp.log(L[..., i, i]) for i in range(d))
    return inv, logdet


def quad_logdet_psd(A: jax.Array, delta: jax.Array, unroll_max: int = 8):
    """(delta^T A^-1 delta, log|A|) for batched PSD A [..., d, d].

    Uses the unrolled elementwise path for small d, lax.linalg otherwise.
    """
    d = A.shape[-1]
    if d <= unroll_max:
        L = unrolled_cholesky(A)
        z = unrolled_solve_lower(L, delta)
    else:
        L = jnp.linalg.cholesky(A)
        z = jax.scipy.linalg.solve_triangular(
            L, delta[..., None], lower=True
        )[..., 0]
    quad = jnp.sum(z * z, axis=-1)
    logdet = 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1
    )
    return quad, logdet


def dxy(X: jax.Array, Y: jax.Array) -> jax.Array:
    """Pairwise squared Euclidean distances, (n, p). Ref GPz/Dxy.m:3-7."""
    xx = jnp.sum(X * X, axis=1)[:, None]
    yy = jnp.sum(Y * Y, axis=1)[None, :]
    return jnp.abs(xx + yy - 2.0 * (X @ Y.T))


def masked_psd(A: jax.Array, mask: jax.Array) -> jax.Array:
    """Embed the observed-block restriction of PSD `A` in full size.

    Given A [..., d, d] and boolean mask [..., d] (True = observed), returns
    B = M A M + (I - M) with M = diag(mask). Then:
      * logdet(B) == logdet(A[o, o])
      * (B^-1 r)[o] == A[o, o]^-1 r[o] for any r zeroed on unobserved dims
      * B^-1 restricted to [o, o] == A[o, o]^-1
    which is exactly what the reference computes per missingness group
    (getPHI.m:76-87, predictCov.m:159-175) — here with static shapes.
    """
    m = mask.astype(A.dtype)
    d = A.shape[-1]
    outer = m[..., :, None] * m[..., None, :]
    eye = jnp.eye(d, dtype=A.dtype)
    return A * outer + eye * (1.0 - m)[..., :, None]


def nanaware_moments(X: jax.Array):
    """NaN-aware mean and covariance, ref GPz/pca.m:5-17.

    Returns (mu (d,), cov (d, d)) where cov uses the reference's
    pairwise-count normalization: cov = (Xc^T Xc) / (n - Mc^T Mc) with Xc the
    zero-filled centered data and Mc the missingness indicator.
    """
    n = X.shape[0]
    missing = jnp.isnan(X)
    Xz = jnp.where(missing, 0.0, X)
    counts = jnp.sum(~missing, axis=0)
    mu = jnp.sum(Xz, axis=0) / counts
    Xc = jnp.where(missing, 0.0, X - mu[None, :])
    Mc = missing.astype(X.dtype)
    denom = n - Mc.T @ Mc
    cov = (Xc.T @ Xc) / denom
    return mu, cov


def pca_whiten(X: jax.Array):
    """Eig-based PCA whitening for center initialization, ref GPz/pca.m:19-46.

    Returns (mu, cov, T, Ti) where T = U S^-1 whitens and Ti = S U^T
    un-whitens, with S = sqrt(eigvals * n / (n-1) ... ) following the
    reference's scaling: it eig-decomposes n*cov_pairwise and scales by
    sqrt(lambda / (n-1)).
    """
    n = X.shape[0]
    mu, cov = nanaware_moments(X)
    # reference decomposes sigmas = n * cov (pca.m:17-19)
    evals, U = jnp.linalg.eigh(n * cov)
    evals = jnp.abs(evals)
    order = jnp.argsort(-evals)
    U = U[:, order]
    evals = evals[order]
    S = jnp.sqrt(evals / (n - 1))
    T = U / S[None, :]
    Ti = S[:, None] * U.T
    return mu, cov, T, Ti


def fill_linear(X: jax.Array, mu: jax.Array, cov: jax.Array) -> jax.Array:
    """Gaussian-conditional imputation of NaNs, ref GPz/fillLinear.m:25-28.

    x_hat = mu + cov @ y where (M cov M + (I-M)) y = M (x - mu). On observed
    dims this returns x unchanged; on missing dims it returns
    mu_u + cov_uo cov_oo^-1 (x_o - mu_o). One batched d x d solve per row
    replaces the reference's per-missingness-pattern loop.
    """
    mask = ~jnp.isnan(X)
    Xz = jnp.where(mask, X, 0.0)
    r = jnp.where(mask, Xz - mu[None, :], 0.0)
    A = masked_psd(jnp.broadcast_to(cov, (X.shape[0],) + cov.shape), mask)
    y = jnp.linalg.solve(A, r[..., None])[..., 0]
    return mu[None, :] + y @ cov
