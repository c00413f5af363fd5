"""Negative log marginal likelihood, posterior solve, and metrics.

The heart of the model — equivalent of ref GPz/GPz.m (263 lines of hand-derived
gradient chain rule), expressed as a pure function whose exact gradient comes
from `jax.grad`. The math (ref GPz/GPz.m:43-110):

  beta      = exp(-lnBeta_i)                       noise precisions (n, k)
  SIGMA_k   = PHI^T diag(omega * beta_k) PHI + diag(alpha_k)
  w_k       = SIGMA_k^-1 PHI^T (omega * beta_k * y_k)
  logML     = sum_k [ -1/2 sum_i omega_i beta_ik delta_ik^2
                      -1/2 sum_j alpha_jk w_jk^2 + 1/2 sum_j lnalpha_jk
                      -1/2 logdet SIGMA_k - 1/2 sum_i lnBeta_ik omega_i ]
              (+ heteroscedastic prior terms on v with lnTau, GPz.m:96-108)
              - k/2 log(2 pi) sum_i omega_i
  nlogML    = -logML / (n_eff * k)

NB: the reference's 2pi constant (GPz.m:110) omits the factor k for k > 1;
here the mathematically correct k factor is used (identical for k == 1, and a
constant offset otherwise, so optimization is unaffected).

The train/valid metrics that the reference smuggles through MATLAB globals
(GPz.m:236-259 -> callBack.m) are explicit aux outputs here.

Every sample-indexed reduction is a weighted sum against `omega`, so zero-
padded rows (omega == 0) contribute exactly nothing — this is the invariant
the sharded path (gpz_tpu.parallel) relies on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp

from gpz_tpu.config import ModelConfig
from gpz_tpu.dataset import Dataset
from gpz_tpu.params import GPzParams
from gpz_tpu.phi import design_matrix
from gpz_tpu.linalg import (
    safe_cholesky, chol_logdet, chol_solve, solve_w_logdet,
    fast_solve_w_logdet,
)
from gpz_tpu.ops.ozaki import ozaki_gram, ozaki_tn

_LN2PI = math.log(2.0 * math.pi)
#: f32 contractions that feed the objective run at full f32 (a GPU may
#: otherwise run them in TF32, which keeps ~3 decimal digits)
_HIGHEST = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Aux:
    """Per-evaluation aux outputs (the reference's global side channel)."""

    w: jax.Array            # (m, k) posterior mean weights
    train_rmse: jax.Array   # scalar
    train_ll: jax.Array     # scalar (mean log likelihood)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Posterior:
    """Posterior state stored per parameter set (ref train.m:53-58)."""

    w: jax.Array            # (m, k)
    iSigma_w: jax.Array     # (k, m, m) inverse of the Gram SIGMA
    logdet: jax.Array       # (k,)


def _reducer(axis_name: Optional[str]):
    """Cross-shard reduction at the objective's psum points (SURVEY §2.3:
    the Gram, rhs, and every scalar sum over samples are the exact reduction
    boundaries for n-sharding). Identity when running unsharded."""
    if axis_name is None:
        return lambda x: x
    return lambda x: jax.lax.psum(x, axis_name)


#: row-block size of the mixed-mode Gram accumulation (env GPZ_GRAM_BLOCK):
#: per-block partial sums run as f32 matmuls, blocks are summed in
#: solve_dtype, so the f32 accumulation error stays ~sqrt(block) * eps
#: regardless of n.
import os as _os

GRAM_BLOCK = int(_os.environ.get("GPZ_GRAM_BLOCK", "8192"))

#: rows per Ozaki-Gram accumulation chunk (env GPZ_OZAKI_CHUNK): above this,
#: the slice-product Gram runs as a rematerialized scan over row chunks so
#: the bf16 slice copies stay O(chunk * m) instead of O(n * m) — required at
#: the 1M x 1000 scale target (BASELINE configs[4])
OZAKI_CHUNK = int(_os.environ.get("GPZ_OZAKI_CHUNK", str(128 * 1024)))

#: Ozaki slice-product Gram (ops/ozaki.py) per platform: off on both, since
#: CPU and GPU contract natively in float64 (PRECISION.md "GPU numerics
#: path" has the on-card A/B)
OZAKI_DEFAULT = {"cpu": False, "gpu": False}


def _ozaki_active() -> bool:
    """Use the Ozaki slice-product Gram path (ops/ozaki.py)? Default per
    platform from OZAKI_DEFAULT (an unknown platform raises). Env
    GPZ_OZAKI=1/0 forces it either way (tests force 1 to exercise the
    path, which stays reachable with solve_mode="mixed")."""
    env = _os.environ.get("GPZ_OZAKI")
    if env is not None:
        return env == "1"
    from gpz_tpu.config import platform

    return OZAKI_DEFAULT[platform()]


def _gram_reductions(PHI, ob, Y, sdt, r, mode: str):
    """The three n-reductions of the objective — Gram A, rhs, sum ob*y^2 —
    in solve_dtype (ref GPz.m:63-75; psum boundary of the n-sharded path).

    strict: accumulate the whole contraction in solve_dtype (native float64
    on CPU and GPU).

    mixed: per-block f32 partials (precision=HIGHEST so inputs are not
    rounded to bf16/TF32), cross-block accumulation in solve_dtype.
    Entry-level error ~sqrt(B)*eps_f32, independent of n.
    """
    if _ozaki_active():
        # Ozaki-scheme contractions from bf16 slice products with f32
        # accumulation (ops/ozaki.py) — for a machine whose f64 dot is not
        # f64-accurate. strict: f64 factors, Gram exact to ~1e-14. mixed:
        # f32 factors, the Gram is exact *given the f32 design matrix* —
        # the error floor drops from ~5e-6 (blockwise f32 accumulation) to
        # PHI's own ~6e-8 rounding.
        ft = sdt if mode == "strict" else PHI.dtype
        P = PHI.astype(ft)
        obf = ob.astype(ft)
        k = ob.shape[1]
        # gradient-safe sqrt: padded rows carry omega == 0 (the sharded
        # path's exact-no-op invariant), and d sqrt(0) = inf would turn
        # their zero cotangent into 0 * inf = NaN — every sharded gradient
        # would be NaN (caught by
        # tests/test_sharding.py::test_sharded_ozaki_fastsolve...)
        pos = obf > 0
        sq = jnp.sqrt(jnp.where(pos, obf, 1.0)) * pos.astype(ft)

        def chunk_grams(Pc, sqc, obfc, Yc):
            A = jnp.stack(
                [ozaki_gram(Pc * sqc[:, kk:kk + 1]) for kk in range(k)]
            )
            rhs = ozaki_tn(Pc, obfc * Yc.astype(ft))
            return A, rhs

        n = PHI.shape[0]
        if n <= OZAKI_CHUNK:
            A, rhs = chunk_grams(P, sq, obf, Y)
        else:
            # chunked accumulation: the slice products would otherwise
            # materialize q bf16 copies of the full (n, m) factor (~10 GB
            # at the 1M x 1000 scale target, BASELINE configs[4]);
            # jax.checkpoint keeps the scan's backward from stacking a
            # second full-size residual of W = PHI * sqrt(ob)
            nc = -(-n // OZAKI_CHUNK)
            npad = nc * OZAKI_CHUNK
            padn = lambda x: jnp.pad(x, ((0, npad - n), (0, 0)))
            xs = tuple(
                x.reshape((nc, OZAKI_CHUNK) + x.shape[1:])
                for x in (padn(P), padn(sq), padn(obf), padn(Y))
            )

            def step(acc, chunk):
                out = jax.checkpoint(chunk_grams)(*chunk)
                return jax.tree.map(jnp.add, acc, out), None

            m = PHI.shape[1]
            init = (jnp.zeros((k, m, m), jnp.float64),
                    jnp.zeros((m, k), jnp.float64))
            (A, rhs), _ = jax.lax.scan(step, init, xs)
        obyy = jnp.sum((ob * Y * Y).astype(sdt), axis=0)
        return r(A.astype(sdt)), r(rhs.astype(sdt)), r(obyy)

    if mode == "strict":
        A = r(jnp.einsum("nm,nk,nj->kmj", PHI, ob, PHI,
                         preferred_element_type=sdt))
        # the rhs as an elementwise multiply+sum in solve_dtype (k is 1 or
        # a few, so the (n, m, k) product is the size of PHI itself)
        oy = (ob * Y).astype(sdt)
        rhs = r(jnp.sum(PHI.astype(sdt)[:, :, None] * oy[:, None, :], axis=0))
        obyy = r(jnp.sum(ob * Y * Y, axis=0, dtype=sdt))
        return A, rhs, obyy

    n, m = PHI.shape
    k = ob.shape[1]
    oy = ob * Y
    B = min(GRAM_BLOCK, n)
    nb = -(-n // B)
    npad = nb * B
    if npad != n:
        pad = ((0, npad - n), (0, 0))
        PHI, ob, oy, Y = (jnp.pad(x, pad) for x in (PHI, ob, oy, Y))
    hp = jax.lax.Precision.HIGHEST
    Pb = PHI.reshape(nb, B, m)
    obb = ob.reshape(nb, B, k)
    oyb = oy.reshape(nb, B, k)
    Yb = Y.reshape(nb, B, k)
    W = Pb[:, :, None, :] * obb[:, :, :, None]           # (nb, B, k, m)
    A = jnp.einsum("bnkm,bnj->bkmj", W, Pb, precision=hp)
    rhs = jnp.einsum("bnm,bnk->bmk", Pb, oyb, precision=hp)
    obyy = jnp.einsum("bnk,bnk->bk", oyb, Yb, precision=hp)
    return (r(jnp.sum(A.astype(sdt), axis=0)),
            r(jnp.sum(rhs.astype(sdt), axis=0)),
            r(jnp.sum(obyy.astype(sdt), axis=0)))


def _gram_terms(
    params: GPzParams,
    cfg: ModelConfig,
    data: Dataset,
    complete: bool,
    axis_name: Optional[str] = None,
):
    """Shared forward computation: PHI, noise, Gram factor, posterior weights.

    Under shard_map (rows sharded on `axis_name`), the per-shard partial Gram
    and rhs are psum-reduced; the m x m solve is replicated on every device.
    """
    r = _reducer(axis_name)
    sdt = jnp.dtype(cfg.resolved_solve_dtype())
    mode = cfg.resolved_solve_mode()
    PHI, _, ln_beta = design_matrix(params, cfg, data.X, data.mask, data.psi, complete)
    beta = jnp.exp(-ln_beta)                             # (n, k)
    ob = data.omega[:, None] * beta                      # (n, k)
    alpha = jnp.exp(params.ln_alpha.astype(sdt))         # (m, k)

    # SIGMA_k = PHI^T diag(ob_k) PHI + diag(alpha_k)   (ref GPz.m:63-65)
    A, rhs, obyy = _gram_reductions(PHI, ob, data.Y, sdt, r, mode)
    SIGMA = A + jax.vmap(jnp.diag)(alpha.T)              # (k, m, m)

    # The factorization and solves always run in solve_dtype — in mixed mode
    # the Gram is already f64 (blockwise f32 partials, f64 cross-block
    # sums), and the (k, m, m) factor is tiny next to the O(n m d^2)
    # forward. Factoring in f32 with one f64 iterative-refinement step
    # breaks down mid-training:
    # once cond(SIGMA) approaches 1/eps_f32 (~1e7 — alpha/beta grow as the
    # fit sharpens), the refined w is garbage, and the objective VALUE picks
    # up deterministic O(1e-1) discontinuities (measured on the VC m=100
    # n=70k north-star run at iteration 6: mixed-vs-strict gradient
    # differed by 90%, and f *increased* by 1e-2 along the true descent
    # direction at steps of 1e-6). The line search then correctly concludes
    # no improving step exists and training stalls at a premature nlml.
    # solve_w_logdet carries a custom VJP built from triangular solves and
    # outer products only (no f64 matmuls in the cotangent; see its
    # docstring).
    if mode == "mixed" and _ozaki_active():
        # mixed phase with the Ozaki Gram: equilibrated f32 factor +
        # slice-product iterative refinement reaches ~f64 solve accuracy,
        # with a runtime fallback to the strict factor when cond(C) defeats
        # refinement (linalg.fast_solve_w_logdet).
        w, logdet = fast_solve_w_logdet(SIGMA, rhs)
    else:
        w, logdet = solve_w_logdet(SIGMA, rhs)       # (m, k), (k,)
    return PHI, ln_beta, beta, ob, alpha, SIGMA, logdet, w, rhs, obyy


def nlog_ml(
    params: GPzParams,
    data: Dataset,
    cfg: ModelConfig,
    n_eff: Optional[jax.Array] = None,
    complete: bool = False,
    axis_name: Optional[str] = None,
):
    """Negative mean log marginal likelihood and aux metrics.

    `n_eff` — number of real (unpadded) samples; defaults to data.n.
    `axis_name` — mesh axis holding the sample shards when called inside
    shard_map; every sample reduction becomes a psum and the result is
    replicated across the axis.
    Differentiate with `jax.value_and_grad(nlog_ml, has_aux=True)`: the full
    analytic gradient of ref GPz.m:89-234 falls out of AD (including through
    the psums, whose transpose XLA handles).
    """
    sdt = jnp.dtype(cfg.resolved_solve_dtype())
    if n_eff is None:
        n_eff = jnp.asarray(data.n, sdt)
    else:
        n_eff = n_eff.astype(sdt)
    r = _reducer(axis_name)
    k = cfg.k
    PHI, ln_beta, beta, ob, alpha, _, logdet, w, rhs, obyy = _gram_terms(
        params, cfg, data, complete, axis_name
    )
    # Every scalar evidence term accumulates in solve_dtype (f32 sums over n
    # can't resolve the per-iteration objective decreases the optimizer's
    # progress tests compare against). The data-fit quadratic uses the exact
    # normal-equations identity: with A = SIGMA - diag(alpha) and
    # SIGMA w = rhs (w is the solve, iteratively refined in mixed mode),
    #   sum_i ob (phi_i'w - y_i)^2 = w'Aw - 2 w'rhs + sum_i ob y^2
    #                              = sum_i ob y^2 - w'rhs - sum alpha w^2,
    # so the whole term is built from the already-solve_dtype (m-sized)
    # reductions plus the blockwise-accumulated n-scalar obyy — no (n, k)
    # f64 tensor ever exists. The identity holds for every theta (w is
    # theta's solve; the solve error enters the value only at second order
    # since w* is the quadratic's stationary point), so AD through this form
    # gives the gradient of the computed function exactly.
    wrhs = jnp.sum(w * rhs, axis=0)                              # (k,)
    aw2 = jnp.sum(alpha * w**2, axis=0)                          # (k,)
    quad = obyy - wrhs - aw2

    # per-k evidence terms (ref GPz.m:81-82)
    log_ml = (
        -0.5 * quad
        - 0.5 * aw2
        + 0.5 * jnp.sum(params.ln_alpha.astype(sdt), axis=0)
        - 0.5 * logdet
        - 0.5 * r(jnp.sum(ln_beta * data.omega[:, None], axis=0, dtype=sdt))
    )

    if params.heteroscedastic:
        tau = jnp.exp(params.ln_tau.astype(sdt))
        # prior on v (ref GPz.m:103)
        log_ml = log_ml + (
            -0.5 * jnp.sum(params.v.astype(sdt)**2 * tau, axis=0)
            + 0.5 * jnp.sum(params.ln_tau.astype(sdt), axis=0)
            - 0.5 * cfg.m * _LN2PI
        )

    total = jnp.sum(log_ml) - 0.5 * _LN2PI * k * r(
        jnp.sum(data.omega, dtype=sdt)
    )
    nlml = -total / (n_eff * k)

    # train metrics (ref GPz.m:236-237), explicit instead of globals.
    # delta is metrics-only, so the (n, k) residual stays in the compute
    # dtype; only the scalar accumulations happen in solve_dtype.
    delta = jnp.matmul(PHI, w.astype(PHI.dtype), precision=_HIGHEST) - data.Y
    train_rmse = jnp.sqrt(
        r(jnp.sum(data.omega[:, None] * delta**2, dtype=sdt)) / (n_eff * k)
    )
    train_ll = (
        r(jnp.sum(
            data.omega[:, None] * (-0.5 * beta * delta**2 - 0.5 * ln_beta),
            dtype=sdt,
        ))
        / (n_eff * k)
        - 0.5 * _LN2PI
    )
    return nlml, Aux(w=w, train_rmse=train_rmse, train_ll=train_ll)


def ozaki_active() -> bool:
    """Public alias of the Ozaki Gram gate (see _ozaki_active)."""
    return _ozaki_active()


def probe_phase(
    params: GPzParams,
    data: Dataset,
    cfg: ModelConfig,
    complete: bool = False,
):
    """(pipeline_finite, fast_solve_ok) of the mixed phase at `params`.

    A continuation/trained iterate can sit beyond the f32 pipeline's
    representable regime: at the trained photo-z point (cond(iSig) ~ 3e9),
    a few of the f32 design-matrix factorizations can go NaN (depending on
    the backend's rounding), which NaNs ln_beta, the Gram, and the whole
    objective — and every safe_cholesky then walks its full
    jitter-escalation ladder (~8 factorizations/eval). Separately, a finite but
    ill-conditioned Gram makes the equilibrated-f32 fast solve fall back
    to the strict factor on EVERY eval, paying both (VERDICT r4 #2).

    train() evaluates this probe once at x0 (jitted, memoized) and either
    starts directly in the f64 strict phase (not finite) or pins the mixed
    phase's solve to the strict factor ("mixed_strict", no fast attempt).
    """
    from gpz_tpu.linalg import fast_solve_ok

    PHI, ln_beta, _, _, _, SIGMA, logdet, w, rhs, _ = _gram_terms(
        params, cfg, data, complete
    )
    finite = (
        jnp.all(jnp.isfinite(PHI))
        & jnp.all(jnp.isfinite(ln_beta))
        & jnp.all(jnp.isfinite(w))
        & jnp.all(jnp.isfinite(logdet))
    )
    return finite, fast_solve_ok(SIGMA, rhs)


def posterior(
    params: GPzParams,
    data: Dataset,
    cfg: ModelConfig,
    complete: bool = False,
    axis_name: Optional[str] = None,
) -> Posterior:
    """Posterior weights + full Gram inverse (the reference's "weights-only"
    nargout trick, GPz.m:84-87, made an explicit function per SURVEY §3.4)."""
    _, _, _, _, _, SIGMA, logdet, w, _, _ = _gram_terms(
        params, cfg, data, complete, axis_name
    )
    m = cfg.m
    eye = jnp.broadcast_to(jnp.eye(m, dtype=SIGMA.dtype), (cfg.k, m, m))
    iSigma_w = chol_solve(safe_cholesky(SIGMA), eye)
    # stored posterior state feeds the (f32) prediction stack —
    # cast back to the compute dtype
    dt = jnp.dtype(cfg.dtype)
    return Posterior(w=w.astype(dt), iSigma_w=iSigma_w.astype(dt),
                     logdet=logdet.astype(dt))


def holdout_metrics(
    params: GPzParams,
    w: jax.Array,
    data: Dataset,
    cfg: ModelConfig,
    n_eff: Optional[jax.Array] = None,
    complete: bool = False,
    axis_name: Optional[str] = None,
):
    """Validation RMSE / mean-log-likelihood given training weights w.

    Equivalent of the validation block of ref GPz.m:239-259 (which reuses the
    training posterior's w; nu is computed there but unused by the metrics).
    Returns (rmse, ll).
    """
    sdt = jnp.dtype(cfg.resolved_solve_dtype())
    if n_eff is None:
        n_eff = jnp.asarray(data.n, sdt)
    else:
        n_eff = n_eff.astype(sdt)
    r = _reducer(axis_name)
    PHI, _, ln_beta = design_matrix(params, cfg, data.X, data.mask, data.psi, complete)
    beta = jnp.exp(-ln_beta)
    # the residual stays in the compute dtype (full f32, never TF32); only
    # the scalar accumulations happen in solve_dtype.
    delta = jnp.matmul(PHI, w.astype(PHI.dtype), precision=_HIGHEST) - data.Y
    k = cfg.k
    rmse = jnp.sqrt(
        r(jnp.sum(data.omega[:, None] * delta**2, dtype=sdt)) / (n_eff * k)
    )
    ll = (
        r(jnp.sum(
            data.omega[:, None] * (-0.5 * beta * delta**2 - 0.5 * ln_beta),
            dtype=sdt,
        ))
        / (n_eff * k)
        - 0.5 * _LN2PI
    )
    return rmse, ll
