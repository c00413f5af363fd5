"""Model lifecycle: init -> train -> predict (ref GPz/init.m, train.m,
predict.m).

Host-side orchestration around the jit-compiled core. The model object is a
plain container holding normalization stats plus two parameter sets, `last`
(current theta) and `best` (validation-selected theta), each with derived
posterior state — the explicit version of ref init.m:106-120 / train.m:53-80.
`train` may be called repeatedly: it restarts from `last` and preserves `best`
across calls (ref train.m:8-11).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from gpz_tpu.config import ModelConfig, TrainConfig
from gpz_tpu.dataset import Dataset
from gpz_tpu.params import GPzParams
from gpz_tpu import datautils
from gpz_tpu.objective import (
    nlog_ml, posterior, holdout_metrics, probe_phase, ozaki_active,
    Posterior,
)
from gpz_tpu.prior import get_prior
from gpz_tpu.optim import minimize
from gpz_tpu import predict as predict_mod


@dataclasses.dataclass
class ParamSet:
    """One resolved parameter set with derived posterior state
    (ref model.last / model.best, init.m:104-120)."""

    params: GPzParams
    post: Posterior
    priors: jax.Array        # (m,) mixture prior over bases (ref getPrior.m)
    score: float = -math.inf  # validation LL (ref model.best.LL)


@dataclasses.dataclass
class GPzModel:
    cfg: ModelConfig
    muX: np.ndarray
    sdX: np.ndarray
    muY: np.ndarray
    last: ParamSet
    best: ParamSet
    fit_info: Optional[dict] = None


def _to_dtype(cfg: ModelConfig):
    return jnp.dtype(cfg.dtype)


def _np_dev(x, dtype):
    """Host-side dtype cast, then one clean transfer. jnp.asarray(f64, f32)
    would ship the double-width bytes and compile a device convert program
    for every array."""
    return jnp.asarray(np.asarray(x, dtype))


# jitted-once lifecycle helpers: a fresh jax.jit(posterior) wrapper per call
# would re-trace and re-read the persistent cache every time
_posterior_jit = jax.jit(posterior, static_argnames=("cfg", "complete"))
_prior_jit = jax.jit(get_prior, static_argnames=("cfg", "complete"))
_probe_jit = jax.jit(probe_phase, static_argnames=("cfg", "complete"))

#: memoized per-(config, param structure, data completeness) phase closures.
#: minimize() keys its jit cache on the IDENTITY of `fun`/`score_fn`
#: (static args): fresh closures per train() call would re-trace the whole
#: training loop and re-read its executable from the persistent cache on
#: EVERY call. With the closures cached, repeat train() calls in one
#: process dispatch the already-loaded executable directly.
_PHASE_FUN_CACHE: dict = {}
_PHASE_FUN_CACHE_MAX = 32


def _param_signature(params):
    """(treedef, shapes, dtypes) of an actual params pytree — stored with
    each cache entry so a hit whose caller's pytree structure diverged from
    the first caller's (e.g. params cast inconsistently with cfg.dtype)
    fails loudly instead of silently unraveling the flat vector wrongly
    (ADVICE r4 #2)."""
    leaves, treedef = jax.tree.flatten(params)
    return treedef, tuple(
        (tuple(a.shape), jnp.asarray(a).dtype) for a in leaves
    )


def _phase_functions(cfg_phase, unravel_phase, param_sig,
                     complete_tr, complete_va, has_valid):
    # cfg_phase (frozen, hashable) fully determines the parameter pytree
    # structure (shapes from m/d/k/method/heteroscedastic, dtype), so the
    # captured unravel_phase is interchangeable across calls with equal
    # keys — enforced by comparing the caller's actual params signature
    # against the one stored with the entry
    key = (cfg_phase, complete_tr, complete_va, has_valid)
    hit = _PHASE_FUN_CACHE.get(key)
    if hit is not None:
        cached_sig, fns = hit
        if cached_sig != param_sig:
            raise RuntimeError(
                "phase-function cache hit with mismatched parameter pytree "
                f"structure for {cfg_phase!r}: cached {cached_sig}, "
                f"requested {param_sig} — params were constructed "
                "inconsistently with cfg.dtype/shape"
            )
        return fns

    vg = jax.value_and_grad(
        lambda p, d: nlog_ml(p, d, cfg_phase, complete=complete_tr),
        has_aux=True,
    )

    def fun(flat, d_tr, *_):
        (f, aux), g = vg(unravel_phase(flat), d_tr)
        return f, ravel_pytree(g)[0], aux

    score_fn = None
    if has_valid:
        def score_fn(flat, aux, _d_tr, d_va):
            rmse, ll = holdout_metrics(
                unravel_phase(flat), aux.w, d_va, cfg_phase,
                complete=complete_va,
            )
            return ll, {
                "valid_rmse": rmse,
                "valid_ll": ll,
                "train_rmse": aux.train_rmse,
                "train_ll": aux.train_ll,
            }

    if len(_PHASE_FUN_CACHE) >= _PHASE_FUN_CACHE_MAX:
        _PHASE_FUN_CACHE.pop(next(iter(_PHASE_FUN_CACHE)))
    _PHASE_FUN_CACHE[key] = (param_sig, (fun, score_fn))
    return fun, score_fn




class _LiveRowPrinter:
    """Streamed per-iteration table row (ref GPz/callBack.m:16-46).

    Called from inside the jitted training loop via `jax.debug.callback`
    (optim.lbfgs `iter_callback`), so a multi-minute run shows progress —
    and early stopping approaching — live, not only in the post-hoc table.
    Instances are memoized (_live_printer): the callback's identity is a
    static jit argument, so a fresh instance per train() call would
    re-trace the loop and defeat the in-process executable reuse. A row's
    wall time restarts at iteration 0 (each phase of the
    two-phase schedule re-enters at 0, so the refine phase prints a fresh
    header and its own clock, like the reference's tic/toc per train run).
    The `[...]` brackets mark a new validation best (callBack.m:26-34).
    """

    def __init__(self, has_valid: bool):
        self.has_valid = has_valid
        self.t0 = time.perf_counter()

    def __call__(self, it, f, opt_cond, step, score, improved, extras):
        it = int(it)
        if it == 0:
            self.t0 = time.perf_counter()
            if self.has_valid:
                print("\tIter\tlogML/n\t\tTrain RMSE\tTrain MLL"
                      "\tValid RMSE\tValid MLL\tTime", flush=True)
            else:
                print("\tIter\tlogML/n\t\tTime", flush=True)
        dt = time.perf_counter() - self.t0
        if self.has_valid:
            vr = f"{float(extras['valid_rmse']):.5e}"
            vl = f"{float(extras['valid_ll']):.5e}"
            if bool(improved):
                vr, vl = f"[{vr}]", f"[{vl}]"
            print(
                f"\t{it}\t{-float(f):.5e}\t"
                f"{float(extras['train_rmse']):.5e}\t"
                f"{float(extras['train_ll']):.5e}\t{vr}\t{vl}\t{dt:.2f}",
                flush=True,
            )
        else:
            print(f"\t{it}\t{-float(f):.5e}\t{dt:.2f}", flush=True)


_LIVE_PRINTERS: dict = {}


def _live_printer(has_valid: bool) -> _LiveRowPrinter:
    if has_valid not in _LIVE_PRINTERS:
        _LIVE_PRINTERS[has_valid] = _LiveRowPrinter(has_valid)
    return _LIVE_PRINTERS[has_valid]


def _make_dataset(Xn, Yc, psi, omega, rows, dtype) -> Dataset:
    Xr = Xn[rows]
    mask = ~np.isnan(Xr)
    return Dataset(
        X=_np_dev(np.where(mask, Xr, 0.0), dtype),
        mask=jnp.asarray(mask),
        omega=_np_dev(omega[rows], dtype),
        Y=None if Yc is None else _np_dev(Yc[rows], dtype),
        psi=None if psi is None else _np_dev(psi[rows], dtype),
    )


def init(
    X,
    Y,
    method: str = "VL",
    m: int = 100,
    *,
    heteroscedastic: bool = True,
    normalize: bool = True,
    omega=None,
    training=None,
    psi=None,
    seed: int = 0,
    dtype: str = "float32",
    solve_dtype: str = "auto",
    solve_mode: str = "auto",
) -> GPzModel:
    """Build and initialize a GPz model (ref GPz/init.m).

    Initialization heuristics match the reference:
      * centers drawn uniform in the PCA-whitened unit cube (init.m:57-59)
      * length scales from the mean-distance heuristic over linearly imputed
        data: gamma = sqrt(0.5 m^(1/d) / mean Dxy(Xl, P)) (init.m:61-62)
      * b = log var(Y), lnAlpha = -log var(Y) (init.m:54-55)
    """
    # a fresh process calling init() is about to train or predict: start
    # loading this machine's recent AOT executables NOW, in the background,
    # so the phase-1 training executable (whose load otherwise gates the
    # first optimizer step — it cannot be hidden under anything inside
    # train()) deserializes under the caller's data prep instead
    from gpz_tpu import aot as _aot

    _aot.prefetch_all()

    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    if Y.ndim == 1:
        Y = Y[:, None]
    n, d = X.shape
    k = Y.shape[1]
    if d == 1:
        method = method[0] + "L"  # ref init.m:12-14

    cfg = ModelConfig(
        m=m, d=d, k=k, method=method,
        heteroscedastic=heteroscedastic, normalize=normalize, dtype=dtype,
        solve_dtype=solve_dtype, solve_mode=solve_mode,
    )
    if training is None:
        training = np.ones(n, dtype=bool)
    if omega is None:
        omega = np.ones(n)

    muX, sdX, muY = datautils.normalization_stats(X, Y, training, normalize)
    Xn = (X - muX[None, :]) / sdX[None, :]
    Yc = Y - muY[None, :]
    psi_c = datautils.fix_psi(psi, n, sdX, cfg.full_cov)

    rng = np.random.default_rng(seed)
    Xtr = Xn[training]
    Ytr = Yc[training]

    b = np.log(np.var(Ytr, axis=0, ddof=1))                 # (k,)
    ln_alpha = np.broadcast_to(-b[None, :], (m, k)).copy()  # (m, k)

    # PCA-whitened uniform centers (init.m:57-59) — host-side NumPy so model
    # construction never waits on device compiles
    mu_p, cov_p, Ti = datautils.pca_whiten_np(Xtr)
    P = (rng.random((m, d)) - 0.5) * math.sqrt(12.0)
    P = P @ Ti + mu_p[None, :]

    # length-scale heuristic on imputed data (init.m:61-62)
    Xl = datautils.fill_linear_np(Xtr, mu_p, cov_p)
    D = np.abs(
        (Xl**2).sum(1)[:, None] + (P**2).sum(1)[None, :] - 2.0 * Xl @ P.T
    )
    gamma = np.sqrt(0.5 * m ** (1.0 / d) / D.mean(axis=0))  # (m,)

    gshape = cfg.gamma_shape
    if method == "GL":
        g0 = np.full(gshape, gamma.mean())
    elif method == "VL":
        g0 = gamma[:, None]
    elif method == "GD":
        g0 = np.full(gshape, gamma.mean())
    elif method == "VD":
        g0 = np.broadcast_to(gamma[:, None], gshape).copy()
    elif method == "GC":
        g0 = np.eye(d)[None, :, :] * gamma.mean()
    else:  # VC
        g0 = np.eye(d)[None, :, :] * gamma[:, None, None]
    g0 = np.ascontiguousarray(np.broadcast_to(g0, gshape))

    dt = _to_dtype(cfg)
    params = GPzParams(
        P=_np_dev(P, dt),
        gamma=_np_dev(g0, dt),
        ln_alpha=_np_dev(ln_alpha, dt),
        b=_np_dev(b, dt),
        v=jnp.zeros((m, k), dt) if heteroscedastic else None,
        ln_tau=jnp.zeros((m, k), dt) if heteroscedastic else None,
    )

    data = _make_dataset(Xn, Yc, psi_c, omega, training, dt)
    complete = bool(np.all(data.mask))
    post = _posterior_jit(params, data, cfg, complete=complete)
    priors = jnp.full((m,), 1.0 / m, dtype=dt)

    last = ParamSet(params=params, post=post, priors=priors)
    best = ParamSet(params=params, post=post, priors=priors, score=-math.inf)
    return GPzModel(cfg=cfg, muX=muX, sdX=sdX, muY=muY, last=last, best=best)


def train(
    model: GPzModel,
    X,
    Y,
    *,
    omega=None,
    training=None,
    validation=None,
    psi=None,
    max_iter: int = 200,
    max_attempts: Optional[int] = None,
    tc: Optional[TrainConfig] = None,
    verbose: bool = True,
) -> GPzModel:
    """Fit hyperparameters by maximizing the log marginal likelihood
    (ref GPz/train.m): jit-compiled L-BFGS with validation early stopping.

    Set env GPZ_PROFILE=/path to capture a jax.profiler trace of the run
    (the reference's only tracing was tic/toc prints, callBack.m:22-46)."""
    t_start = time.perf_counter()
    tc = tc or TrainConfig(max_iter=max_iter, max_attempts=max_attempts,
                           verbose=verbose)
    cfg = model.cfg
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    if Y.ndim == 1:
        Y = Y[:, None]
    n = X.shape[0]
    if training is None:
        training = np.ones(n, dtype=bool)
    if omega is None:
        omega = np.ones(n)

    Xn = (X - model.muX[None, :]) / model.sdX[None, :]
    Yc = Y - model.muY[None, :]
    psi_c = datautils.fix_psi(psi, n, model.sdX, cfg.full_cov)

    dt = _to_dtype(cfg)
    data_tr = _make_dataset(Xn, Yc, psi_c, omega, training, dt)
    complete_tr = bool(np.all(data_tr.mask))

    has_valid = validation is not None and np.any(validation)
    if has_valid:
        data_va = _make_dataset(Xn, Yc, psi_c, omega, validation, dt)
        complete_va = bool(np.all(data_va.mask))

    flat0, unravel = ravel_pytree(model.last.params)

    def make_phase(cfg_phase, unravel_phase, params_phase):
        """(fun, score_fn) for one precision phase, memoized process-wide
        (see _phase_functions). Datasets ride through minimize's `args`,
        NOT the closures: closed-over arrays become compiled-in constants,
        which bloats the program and keys the persistent compilation cache
        on the data bytes (any new catalog of the same shape would
        recompile the whole training loop)."""
        return _phase_functions(
            cfg_phase,
            unravel_phase,
            _param_signature(params_phase),
            complete_tr,
            complete_va if has_valid else None,
            has_valid,
        )

    # every phase shares one record_len — the full budget's 64-bucket — so
    # the refine phase's data-dependent remaining budget maps to the SAME
    # cached executable regardless of where phase 1 stopped (otherwise a
    # phase-1 outcome that crosses a 64-iteration bucket boundary triggers
    # a fresh compile; PRECISION.md §6)
    record_len = -(-(int(tc.max_iter) + 1) // 64) * 64

    # every phase of this training task records its executable-cache key
    # under one group; the NEXT process prefetches the whole group before
    # phase 1, hiding the later phases' executable loads under the earlier
    # phases' execution
    aot_group = (
        f"train:{cfg!r}|{complete_tr}|"
        f"{complete_va if has_valid else None}|{has_valid}|"
        f"{data_tr.n}x{data_tr.d}|{record_len}"
    )
    from gpz_tpu import aot as _aot

    _aot.prefetch_group(aot_group)

    def run_phase(cfg_phase, unravel_phase, params_phase, args_phase, x0,
                  budget, best_score0, x_best0, patience=0):
        fun, score_fn = make_phase(cfg_phase, unravel_phase, params_phase)
        return minimize(
            fun,
            x0,
            args=args_phase,
            history=tc.history,
            max_iter=budget,
            opt_tol=tc.opt_tol,
            prog_tol=tc.prog_tol,
            c1=tc.c1,
            c2=tc.c2,
            max_ls=tc.max_ls,
            score_fn=score_fn,
            max_attempts=tc.max_attempts,
            init_best_score=best_score0,
            x_best0=x_best0,
            record_len=record_len,
            # live row streaming (ref callBack.m): memoized so the callback
            # identity — a static jit arg — stays stable across train() calls
            patience=patience,
            patience_tol=tc.phase_patience_tol,
            iter_callback=_live_printer(has_valid) if tc.verbose else None,
            # cross-process AOT executable reuse (gpz_tpu.aot): the phase
            # config + completeness flags determine exactly what the
            # memoized fun/score_fn closures compute
            aot_key=(
                f"{cfg_phase!r}|{complete_tr}|"
                f"{complete_va if has_valid else None}|{has_valid}"
            ),
            aot_group=aot_group,
        )

    min_args = (data_tr, data_va) if has_valid else (data_tr,)

    def f64_ingredients(flat_src, unravel_src, x_best_src):
        """Phase ingredients recast float64 end-to-end (cfg, data, args,
        params, flat, unravel, x_best) — used by both the post-stall refine
        phase and a probe-forced f64 start."""
        cfg64 = dataclasses.replace(
            cfg, dtype="float64", solve_mode="strict", solve_dtype="float64",
        )
        data64 = _make_dataset(Xn, Yc, psi_c, omega, training, jnp.float64)
        args64 = (data64,)
        if has_valid:
            args64 = (data64, _make_dataset(
                Xn, Yc, psi_c, omega, validation, jnp.float64
            ))
        params64 = jax.tree.map(
            lambda a: a.astype(jnp.float64), unravel_src(flat_src)
        )
        flat64, unravel64 = ravel_pytree(params64)
        x_best64 = ravel_pytree(jax.tree.map(
            lambda a: a.astype(jnp.float64), unravel_src(x_best_src)
        ))[0]
        return cfg64, data64, args64, params64, flat64, unravel64, x_best64

    # ---- solve-path probe at x0 (objective.probe_phase) ----
    # Only previously-trained models are probed (fresh inits are always in
    # the easy regime; math.isfinite(best.score) is the trained marker that
    # survives checkpoints): a trained iterate can sit beyond the f32
    # pipeline's representable regime (non-finite mixed objective at the
    # trained photo-z point, cond(iSig) ~ 3e9), or carry a
    # Gram whose equilibrated-f32 fast solve falls back on every eval,
    # paying the failed attempt PLUS the strict solve (VERDICT r4 #2).
    # One memoized jitted probe picks the cheapest sound phase up front.
    cfg1, data1, args1 = cfg, data_tr, min_args
    params1, flat1, unravel1 = model.last.params, flat0, unravel
    x_best1 = ravel_pytree(model.best.params)[0]
    probe_info = None
    if (
        math.isfinite(model.best.score)
        and jnp.dtype(cfg.dtype) != jnp.float64
        and cfg.resolved_solve_mode() == "mixed"
        and ozaki_active()
    ):
        finite, fast_ok = _probe_jit(
            model.last.params, data_tr, cfg, complete=complete_tr
        )
        probe_info = {
            "pipeline_finite": bool(finite),
            "fast_solve_ok": bool(fast_ok),
        }
        if not probe_info["pipeline_finite"]:
            (cfg1, data1, args1, params1, flat1, unravel1,
             x_best1) = f64_ingredients(flat0, unravel, x_best1)
        elif not probe_info["fast_solve_ok"]:
            cfg1 = dataclasses.replace(cfg, solve_mode="mixed_strict")

    profile_dir = os.environ.get("GPZ_PROFILE")
    prof_cm = (
        jax.profiler.trace(profile_dir)
        if profile_dir
        else contextlib.nullcontext()
    )
    prep_seconds = round(time.perf_counter() - t_start, 2)
    with prof_cm:
        # continuation (ref train.m:8-11): thread BOTH the previous best
        # score and the previous best parameters, so a run that never
        # improves keeps the old best instead of replacing it with x0
        t_phase = time.perf_counter()
        # the noise-floor patience applies only when this phase is NOT the
        # final-precision one (the refine schedule will escalate a plateau
        # to float64); a final phase always runs to its own termination
        phase1_patience = (
            tc.phase_patience
            if (tc.refine in ("auto", "on")
                and jnp.dtype(cfg1.dtype) != jnp.float64)
            else 0
        )
        res = run_phase(
            cfg1, unravel1, params1, args1, flat1, tc.max_iter,
            (model.best.score if math.isfinite(model.best.score)
             else -jnp.inf),
            x_best1,
            patience=phase1_patience,
        )
        # block before reading the timer: with every executable cached the
        # dispatch is fully asynchronous, and an unblocked timer records
        # ~0 s while the execution leaks into the next phase's wall
        jax.block_until_ready(res.x)
        t_between = time.perf_counter()
        between_seconds = 0.0  # wall between phase timers (diagnostic)
        phase_seconds = [round(time.perf_counter() - t_phase, 2)]
        phase_modes = [f"{cfg1.dtype}/{cfg1.resolved_solve_mode()}"]
        phase1_iterations = int(res.iterations)
        # per-phase iteration counts, parallel to phase_seconds — the
        # boundary indices let wall-clock be attributed to the exact phase
        # that spent it (bench_convergence.time_to_target)
        phase_iterations = [phase1_iterations]
        # completed (trace, iterations) segments awaiting stitching: the
        # mixed phase plus any fresh-memory f64 restarts before the final one
        pending_segments = []
        unravel_final = unravel1
        cfg_final = cfg1
        data_final = data1

        # precision refinement (TrainConfig.refine): a fast-phase run that
        # stalled on progress with the gradient still large has hit the f32
        # pipeline's noise floor, NOT an optimum — the blockwise-f32 Gram's
        # ~5e-6 entry error AND the f32 design matrix's own rounding get
        # amplified by the ill-conditioned SIGMA into objective jaggedness
        # the line search cannot descend (and AD of the jagged computed
        # function produces spurious cliff gradients). The endgame therefore
        # reruns FLOAT64 END TO END (params, design matrix, reductions,
        # solve) from the same iterate — only the final ~100-200 evals pay
        # for it; the f32 phase has already done the bulk of the descent.
        # Same L-BFGS driver, continuation semantics.
        # Measurements: PRECISION.md; ref anchor: the reference pipeline is
        # MATLAB float64 end to end.
        from gpz_tpu.optim.lbfgs import (
            STATUS_LS_FAILED, STATUS_NO_DESCENT, STATUS_PLATEAU,
            STATUS_STEP_TOO_SMALL,
        )

        stalled = int(res.status) in (
            STATUS_STEP_TOO_SMALL, STATUS_LS_FAILED, STATUS_NO_DESCENT,
            STATUS_PLATEAU,
        )
        opt_cond_end = float(
            np.asarray(res.trace["opt_cond"])[phase1_iterations]
        )
        f_end = float(res.f)
        budget_left = tc.max_iter - phase1_iterations
        # non-finite phase-1 outcomes MUST escalate too: NaN compares false
        # against every tolerance, and a NaN-at-x0 run (un-probed trained
        # iterate beyond the f32 regime) exits LS_FAILED at iteration 0
        # with a NaN opt_cond — without the isfinite arms it would be
        # returned as the final model
        if (
            tc.refine in ("auto", "on")
            and jnp.dtype(cfg1.dtype) != jnp.float64
            and stalled
            and (
                opt_cond_end > tc.opt_tol
                or not math.isfinite(opt_cond_end)
                or not math.isfinite(f_end)
            )
            and budget_left > 0
        ):
            (cfg64, _, args64, params64, flat64, unravel64,
             x_best64) = f64_ingredients(res.x, unravel1, res.x_best)
            pending_segments.append(
                (jax.tree.map(np.asarray, res.trace), phase1_iterations)
            )
            best_score64 = res.best_score
            remaining = budget_left
            restarts = 0
            # Requantized fresh-memory restarts: an f64 segment that
            # terminates step_too_small while budget remains has often
            # stopped on a knife-edge plateau rather than an optimum —
            # seen on the VC photo-z north star: a run that
            # stalled at nlml -2.6586 stayed stalled when restarted from
            # the EXACT f64 iterate, but descended to -2.6692 (the
            # reference band) when restarted from the float32-cast of the
            # same point. The cast is not a random perturbation: it is
            # exactly the precision at which the model is STORED (resolve()
            # casts last/best to the model dtype), i.e. the point a user's
            # continuation train() would resume from anyway. Restart with
            # empty L-BFGS memory from the requantized iterate while
            # budget remains; stop when a restart makes no progress (a
            # genuine optimum survives requantization) or the cap hits.
            while True:
                t_phase = time.perf_counter()
                between_seconds += t_phase - t_between
                res = run_phase(
                    cfg64, unravel64, params64, args64, flat64, remaining,
                    best_score64, x_best64,
                )
                jax.block_until_ready(res.x)
                t_between = time.perf_counter()
                phase_seconds.append(round(t_between - t_phase, 2))
                phase_modes.append(
                    f"{cfg64.dtype}/{cfg64.resolved_solve_mode()}"
                )
                seg_iters = int(res.iterations)
                phase_iterations.append(seg_iters)
                remaining -= seg_iters
                f_seg = np.asarray(res.trace["f"])
                f_start, f_end2 = float(f_seg[0]), float(res.f)
                stalled2 = int(res.status) in (
                    STATUS_STEP_TOO_SMALL, STATUS_LS_FAILED,
                    STATUS_NO_DESCENT,
                )
                progressed = f_start - f_end2 > tc.prog_tol
                if not (
                    stalled2
                    and remaining > 0
                    and restarts < 8
                    and math.isfinite(f_end2)
                    # the first restart is always worth one try; further
                    # ones only while the previous restart kept descending
                    and (restarts == 0 or progressed)
                ):
                    break
                restarts += 1
                pending_segments.append(
                    (jax.tree.map(np.asarray, res.trace), seg_iters)
                )
                flat64 = ravel_pytree(jax.tree.map(
                    lambda a: a.astype(dt).astype(jnp.float64),
                    unravel64(res.x),
                ))[0]
                x_best64 = res.x_best
                best_score64 = res.best_score
            unravel_final = unravel64
            cfg_final = cfg64
            data_final = args64[0]

    def resolve(flat, score) -> ParamSet:
        # derived state is computed in the dtype of the phase that produced
        # the parameters (an f64 refine phase gets an f64-accurate posterior)
        # and stored in the model dtype so prediction keeps its fast path
        params = unravel_final(flat)
        post = _posterior_jit(params, data_final, cfg_final,
                              complete=complete_tr)
        priors = _prior_jit(params, data_final, cfg_final,
                            complete=complete_tr)
        cast = lambda a: jnp.asarray(a, dt)  # noqa: E731
        return ParamSet(
            params=jax.tree.map(cast, params),
            post=jax.tree.map(cast, post),
            priors=cast(priors),
            score=score,
        )

    t_finalize = time.perf_counter()
    last = resolve(res.x, float(res.best_score) if not has_valid else -math.inf)
    best = resolve(res.x_best, float(res.best_score))

    trace = jax.tree.map(np.asarray, res.trace)
    iterations = int(res.iterations)
    fun_evals = int(res.fun_evals)
    # stitch completed segments (mixed phase + any f64 restarts) onto the
    # final one, right to left so the eval counters accumulate correctly
    for seg_trace, seg_iters in reversed(pending_segments):
        trace, iterations, fun_evals = stitch_phase_traces(
            seg_trace, seg_iters, trace, iterations, fun_evals
        )

    fit_info = {
        "iterations": iterations,
        "fun_evals": fun_evals,
        "status": int(res.status),
        "final_nlml": float(res.f),
        "phase1_iterations": (
            None if not pending_segments else phase1_iterations
        ),
        "phase_seconds": phase_seconds,
        "phase_iterations": phase_iterations,
        "phase_modes": phase_modes,
        # wall outside the optimizer phases: host data prep + device
        # transfers before phase 1, posterior/prior resolution + trace
        # stitching after the last phase — diagnostic for the fresh-process
        # budget (the phases are where seconds_to_target is spent)
        "prep_seconds": prep_seconds,
        "between_seconds": round(between_seconds, 2),
        "finalize_seconds": round(time.perf_counter() - t_finalize, 2),
        "solve_probe": probe_info,
        "seconds": time.perf_counter() - t_start,
        "trace": trace,
    }
    if tc.verbose:
        _print_trace(fit_info, has_valid)

    return GPzModel(
        cfg=cfg, muX=model.muX, sdX=model.sdX, muY=model.muY,
        last=last, best=best, fit_info=fit_info,
    )


def stitch_phase_traces(phase1_trace, it1, trace2, it2, fun_evals2):
    """Concatenate the two precision-phase optimizer traces into one.

    Phase-2 row 0 is the re-evaluation of the phase-1 final iterate under
    the strict objective — KEPT in the stitched trace (it shows the
    mixed-value bias at the switch point), so the combined iteration count
    is it1 + it2 + 1. Phase-2 `fevals` counters (int32, -1 = unrecorded
    sentinel) continue from the phase-1 running count; -1 rows stay -1.
    `bench_convergence.time_to_target` attributes wall clock on exactly
    this structure, so it is unit-tested (tests/test_model_sinc.py).

    Returns (trace, iterations, fun_evals).
    """
    fe1 = int(np.asarray(phase1_trace["fevals"])[it1])

    def stitch(a1, a2):
        a2 = np.asarray(a2)[: it2 + 1]
        if a2.dtype == np.int32 and a2.ndim == 1:  # fevals counters
            a2 = np.where(a2 >= 0, a2 + fe1, a2)
        return np.concatenate([np.asarray(a1)[: it1 + 1], a2], axis=0)

    trace = jax.tree.map(stitch, phase1_trace, trace2)
    return trace, it1 + it2 + 1, fun_evals2 + fe1


def _print_trace(fit_info, has_valid):
    """Post-hoc iteration table (ref GPz/callBack.m:16-46)."""
    tr = fit_info["trace"]
    n_it = fit_info["iterations"]
    if has_valid:
        print("\tIter\tlogML/n\t\tTrain RMSE\tTrain MLL\tValid RMSE\tValid MLL")
        ex = tr["extras"]
        for i in range(n_it + 1):
            print(
                f"\t{i}\t{-tr['f'][i]:.5e}\t{ex['train_rmse'][i]:.5e}"
                f"\t{ex['train_ll'][i]:.5e}\t{ex['valid_rmse'][i]:.5e}"
                f"\t{ex['valid_ll'][i]:.5e}"
            )
    else:
        print("\tIter\tlogML/n")
        for i in range(n_it + 1):
            print(f"\t{i}\t{-tr['f'][i]:.5e}")
    print(f"\t[{fit_info['iterations']} iters, "
          f"{fit_info['fun_evals']} evals, status={fit_info['status']}]")


def sample_weights(
    model: GPzModel,
    n_samples: int = 20,
    *,
    which_set: str = "best",
    seed: int = 0,
) -> np.ndarray:
    """Draw basis-weight samples from the Gaussian posterior N(w, SIGMA^-1).

    The reference's posterior-sample plot (ref demo_sinc.m:77-87) draws
    ws = w + U sqrt(S) z with [U, S] = svd(iSigma_w), z ~ N(0, I), then
    plots the sampled curves PHI @ ws + muY. This is that draw as an API:
    returns (m, k, n_samples); curves for inputs X are
    `predict(X, model).phi @ draws[:, j, :] + model.muY[j]` per output j.

    Host-side NumPy — one m x m SVD per output, no device round trip.
    """
    pset = model.best if which_set == "best" else model.last
    w = np.asarray(pset.post.w, dtype=np.float64)            # (m, k)
    C = np.asarray(pset.post.iSigma_w, dtype=np.float64)     # (k, m, m)
    rng = np.random.default_rng(seed)
    m = w.shape[0]
    draws = []
    for kk in range(C.shape[0]):
        # svd of the (symmetrized) posterior covariance, like the reference;
        # eigenvalue clipping guards the f32-stored matrix's tiny negatives
        U, S, _ = np.linalg.svd((C[kk] + C[kk].T) / 2.0)
        R = U * np.sqrt(np.maximum(S, 0.0))[None, :]
        draws.append(
            w[:, kk, None] + R @ rng.standard_normal((m, n_samples))
        )
    return np.stack(draws, axis=1)                           # (m, k, S)


@dataclasses.dataclass
class Prediction:
    mu: np.ndarray
    sigma: np.ndarray
    nu: np.ndarray
    beta_i: np.ndarray
    gamma: np.ndarray
    phi: np.ndarray


#: memoized jitted predict closures per frozen config (ADVICE r4 #3: the
#: fresh jax.jit wrappers predict() used to build per call re-traced the
#: moment kernels and re-read their persistent-cache executables on EVERY
#: repeat predict() call)
_PREDICT_FN_CACHE: dict = {}
_PREDICT_FN_CACHE_MAX = 32


def _predict_functions(cfg: ModelConfig):
    hit = _PREDICT_FN_CACHE.get(cfg)
    if hit is not None:
        return hit

    clean_fn = jax.jit(
        lambda params, post, Xg: predict_mod.predict_clean(
            params, post, cfg, Xg, jnp.ones(Xg.shape, bool), None,
            complete=True,
        )
    )
    if cfg.full_cov:
        def moments(params, post, priors, Xg, patv, psig, complete,
                    mix_topl, return_coverage):
            return predict_mod.predict_moments_full(
                params, post, priors, cfg, Xg, patv, psig, complete,
                mix_topl, return_coverage,
            )
    else:
        def moments(params, post, priors, Xg, patv, psig, complete,
                    mix_topl, return_coverage):
            # the diagonal family computes its mixture exactly — coverage
            # is definitionally 1
            out = predict_mod.predict_moments_diag(
                params, post, priors, cfg, Xg, patv, psig, complete,
            )
            if return_coverage:
                return (*out, jnp.ones((), Xg.dtype))
            return out

    moments_fn = jax.jit(
        moments,
        static_argnames=("complete", "mix_topl", "return_coverage"),
    )
    if len(_PREDICT_FN_CACHE) >= _PREDICT_FN_CACHE_MAX:
        _PREDICT_FN_CACHE.pop(next(iter(_PREDICT_FN_CACHE)))
    _PREDICT_FN_CACHE[cfg] = (clean_fn, moments_fn)
    return clean_fn, moments_fn


def predict(
    X,
    model: GPzModel,
    *,
    psi=None,
    which_set: str = "best",
    selection=None,
    batch_size: int = 2048,
) -> Prediction:
    """Predict mean + decomposed uncertainty (ref GPz/predict.m).

    sigma = nu + beta_i + gamma (predict.m:72); mu is un-centered by muY.
    Rows are grouped by missingness pattern host-side (predict.m:45-56) and
    each group dispatches to the unified moment-matching kernel; clean rows
    take the O(n m) fast path.
    """
    cfg = model.cfg
    X = np.asarray(X, dtype=np.float64)
    if X.ndim == 1:
        X = X[:, None]
    if selection is not None:
        X = X[selection]
        if psi is not None:
            psi = np.asarray(psi)[selection]
    n, d = X.shape
    pset = model.best if which_set == "best" else model.last
    dt = _to_dtype(cfg)

    Xn = (X - model.muX[None, :]) / model.sdX[None, :]
    psi_c = datautils.fix_psi(psi, n, model.sdX, cfg.full_cov)

    mask = ~np.isnan(Xn)
    Xz = np.where(mask, Xn, 0.0)
    k = cfg.k
    out = {
        "mu": np.zeros((n, k)),
        "nu": np.zeros((n, k)),
        "beta_i": np.zeros((n, k)),
        "gamma": np.zeros((n, k)),
        "phi": np.zeros((n, cfg.m)),
    }

    clean_fn, moments_fn = _predict_functions(cfg)
    # the full-cov missing path truncates its conditioning mixture to the
    # top-MIX_TOPL responsibilities per row; the coverage guard below
    # escalates any batch whose dropped mass is non-negligible to the exact
    # full sum (ADVICE r4 #1 — flat responsibilities make blind truncation
    # unbounded), at the price of one re-dispatch for that batch
    guard_mix = cfg.full_cov and cfg.m > predict_mod.MIX_TOPL

    def run_batch(idx, pat, complete, bs):
        # bucket-pad every batch to a power of two (<= bs): a catalog with
        # P ragged missingness patterns compiles O(log bs) moment-kernel
        # shapes instead of O(P) — each fresh trace+compile costs seconds
        # (the reference pays a per-group LOOP, not a
        # per-group compile, predict.m:45-56)
        bucket = 16
        while bucket < len(idx):
            bucket *= 2
        bucket = min(bucket, bs)
        pad = bucket - len(idx)
        sel = np.concatenate([idx, np.repeat(idx[-1:], pad)])
        Xg = _np_dev(Xz[sel], dt)
        psig = None if psi_c is None else _np_dev(psi_c[sel], dt)
        if complete and psig is None:
            out = clean_fn(pset.params, pset.post, Xg)
        else:
            if psig is None:
                shape = (len(sel), d, d) if cfg.full_cov else (len(sel), d)
                psig = jnp.zeros(shape, dt)
            margs = (pset.params, pset.post, pset.priors, Xg,
                     _np_dev(pat, dt), psig)
            if guard_mix and not complete:
                *out, coverage = moments_fn(
                    *margs, complete=complete, mix_topl=None,
                    return_coverage=True,
                )
                if float(coverage) < predict_mod.MIX_COVERAGE_MIN:
                    out = moments_fn(
                        *margs, complete=complete, mix_topl=cfg.m,
                        return_coverage=False,
                    )
            else:
                out = moments_fn(
                    *margs, complete=complete, mix_topl=None,
                    return_coverage=False,
                )
        if pad:
            out = tuple(o[: len(idx)] for o in out)
        return out

    # the moment-matching pass tiles itself over basis-index blocks against
    # predict.PAIR_BUDGET, so peak memory is bounded for any row batch; the
    # host batch only needs to leave room for a useful block size (B >= ~8)
    # and for the O(n m d_cost) mixture tensors (X_hat/Psi_hat) of the
    # missing-data path
    d_cost = d * d if cfg.full_cov else d
    # budgets are calibrated in f32 elements; the moment pass runs its
    # density chain in predict.variance_dtype() (f64 by default), so scale
    # the row batch down to keep peak bytes constant
    vbytes = predict_mod.variance_dtype().itemsize
    moments_batch = max(
        16, min(batch_size,
                predict_mod.PAIR_BUDGET * 4 // vbytes // (8 * cfg.m * d_cost))
    )

    # group rows by missingness pattern (ref predict.m:45-56)
    patterns, inverse = np.unique(mask, axis=0, return_inverse=True)
    for pi in range(patterns.shape[0]):
        rows = np.where(inverse == pi)[0]
        pat = patterns[pi]
        complete = bool(pat.all())
        bs = batch_size if (complete and psi_c is None) else moments_batch
        for start in range(0, len(rows), bs):
            idx = rows[start : start + bs]
            mu, nu, bi, ga, phi = run_batch(idx, pat, complete, bs)
            out["mu"][idx] = np.asarray(mu)
            out["nu"][idx] = np.asarray(nu)
            out["beta_i"][idx] = np.asarray(bi)
            out["gamma"][idx] = np.asarray(ga)
            out["phi"][idx] = np.asarray(phi)

    # gamma = E[(phi'w)^2] - (E[phi'w])^2 >= 0 mathematically, but the f32
    # moment-matched difference can come out epsilon-negative; nu likewise
    # via the iSigma_w quadratic form. Clamp at zero so sigma stays a valid
    # variance (the reference's f64 pipeline makes these negatives
    # vanishingly small instead; sigma = nu+beta_i+gamma, predict.m:72)
    out["gamma"] = np.maximum(out["gamma"], 0.0)
    out["nu"] = np.maximum(out["nu"], 0.0)
    sigma = out["nu"] + out["beta_i"] + out["gamma"]
    mu = out["mu"] + model.muY[None, :]
    return Prediction(
        mu=mu, sigma=sigma, nu=out["nu"], beta_i=out["beta_i"],
        gamma=out["gamma"], phi=out["phi"],
    )
