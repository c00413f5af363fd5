"""Jit-compiled L-BFGS with strong-Wolfe line search and early stopping.

Device-resident replacement for the reference optimizer stack — the whole
training loop is a single `lax.while_loop` on device, so theta, the gradient,
and the curvature history never leave device memory:

  * two-loop recursion over a fixed-size circular history buffer
    (ref minFunc/lbfgsProd.m, lbfgsAdd.m and their C twins
    minFunc/mex/lbfgsProdC.c:46-88, lbfgsAddC.c — the in-place column writes
    become XLA donated-buffer dynamic updates)
  * curvature-pair skip rule y's > 1e-10 and Hdiag = ys/yy scaling
    (ref lbfgsAdd.m:5-29)
  * strong-Wolfe bracketing + zoom with cubic interpolation
    (ref minFunc/WolfeLineSearch.m:50-241, polyinterp.m), with non-finite
    trial values treated as +inf so the search backtracks — the role of the
    reference's Armijo fallback (WolfeLineSearch.m:53-69)
  * termination on max|g| <= optTol, step/function progress <= progTol,
    maxIter (ref minFunc.m:96-97,1118-1147)
  * validation-score early stopping with best-iterate tracking — the explicit
    carried-state version of the reference's globals-based callback
    (ref GPz/callBack.m:26-34, train.m:5-9)

The objective `fun` maps a flat parameter vector to (f, grad, aux); `score_fn`
maps (x, aux) to (score, extras) where higher score is better (the reference's
validation log-likelihood). Per-iteration scalars are recorded into fixed-size
trace arrays (the reference's printed iteration table, callBack.m:16-46).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

# status codes
STATUS_RUNNING = 0
STATUS_OPTIMAL = 1          # max|g| <= opt_tol
STATUS_STEP_TOO_SMALL = 2   # progress below prog_tol
STATUS_MAX_ITER = 3
STATUS_EARLY_STOP = 4       # validation attempts exhausted
STATUS_LS_FAILED = 5        # line search could not find a step
STATUS_NO_DESCENT = 6       # directional derivative above -prog_tol
STATUS_PLATEAU = 7          # patience window bought < patience_tol decrease


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MinimizeResult:
    x: jax.Array               # final iterate
    f: jax.Array
    x_best: jax.Array          # best-scoring iterate (== x if no score_fn)
    best_score: jax.Array
    iterations: jax.Array
    fun_evals: jax.Array
    status: jax.Array
    trace: dict                # per-iteration scalars, fixed length max_iter+1


def _cubic_min(x1, f1, g1, x2, f2, g2, lo, hi):
    """Minimizer of the cubic interpolating (x, f, f') at two points,
    clamped to [lo, hi]; bisects when the interpolation is ill-posed
    (ref minFunc/polyinterp.m closed form for the 2-point case)."""
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    rad = d1 * d1 - g1 * g2
    sq = jnp.sqrt(jnp.maximum(rad, 0.0))
    sq = jnp.where(x2 < x1, -sq, sq)
    denom = g2 - g1 + 2 * sq
    t = x2 - (x2 - x1) * (g2 + sq - d1) / denom
    bad = (rad < 0) | ~jnp.isfinite(t) | (jnp.abs(denom) < 1e-30)
    t = jnp.where(bad, 0.5 * (lo + hi), t)
    return jnp.clip(t, lo, hi)


class _LSState(NamedTuple):
    t: jax.Array
    f_new: jax.Array
    g_new: jax.Array
    aux_new: object
    t_prev: jax.Array
    f_prev: jax.Array
    gtd_prev: jax.Array
    g_prev: jax.Array
    aux_prev: object
    ls_iter: jax.Array
    done: jax.Array
    bracketed: jax.Array
    failed: jax.Array
    saw_finite: jax.Array  # any trial evaluated to a finite f
    pending: jax.Array     # the initial trial t0 has not been evaluated yet
    unprocessed: jax.Array  # the last eval has not been classified yet
    # bracket endpoints (set when bracketed)
    t_lo: jax.Array
    f_lo: jax.Array
    gtd_lo: jax.Array
    g_lo: jax.Array
    aux_lo: object
    t_hi: jax.Array
    f_hi: jax.Array
    gtd_hi: jax.Array


def wolfe_line_search(fun, x, f0, g0, d, t0, c1, c2, max_ls, prog_tol, aux0):
    """Strong-Wolfe line search (ref minFunc/WolfeLineSearch.m).

    Returns (t, f, g, aux, n_evals, failed). On failure t == 0 and the initial
    point is returned.

    ONE fused while_loop with a SINGLE objective call site. The reference
    (and rounds 1-4 here) structure the search as two loops — bracketing
    then zoom — each containing its own objective evaluation; inlined into
    the jit-compiled training loop that tripled the objective's footprint
    in the compiled program (a larger executable and a longer XLA compile
    at the north-star shape). The fused loop carries a phase flag instead: each
    iteration CLASSIFIES the previously evaluated trial under the rules of
    the current phase (bracketing: WolfeLineSearch.m:50-119; zoom:
    WolfeLineSearch.m:135-241), proposes the next trial (cubic
    extrapolation / safeguarded cubic interpolation), and evaluates it at
    the one shared call site. Semantics match the two-loop version
    trial-for-trial, INCLUDING the budget-exhaustion corner: a bracketing
    trial evaluated on the last budgeted iteration is left unclassified
    (minFunc's bracket loop exits on LSiter before processing it), while
    zoom trials are always classified (minFunc's zoom evaluates and
    processes in the same iteration). An earlier fused version classified
    that final bracketing trial "helpfully" — which let the mixed phase
    grind ~60 extra iterations through its f32 noise floor on the
    north-star run and handed the f64 endgame a different (worse) basin.
    """
    gtd0 = jnp.vdot(g0, d)
    dtype = x.dtype  # step-scalar dtype: the objective VALUE may be wider
    # (solve_dtype=f64) than the parameters; trial points x + t d must stay
    # in the parameter dtype or every gradient flips to f64

    def eval_at(t):
        f, g, aux = fun(x + t.astype(x.dtype) * d)
        # non-finite trial f OR g reads as +inf with a zeroed gradient: the
        # search then backtracks, playing the role of minFunc's isLegal +
        # Armijo fallback (WolfeLineSearch.m:53 checks BOTH f and g). Letting
        # a non-finite g escape with a finite f poisons gtd, the curvature
        # pairs, and ultimately the iterate itself (0 * inf = NaN in x + t d).
        bad = ~jnp.isfinite(f) | ~jnp.all(jnp.isfinite(g))
        f = jnp.where(bad, jnp.inf, f)
        g = jnp.where(bad, jnp.zeros_like(g), g)
        return f, g, aux

    tw = lambda c, a, b: jax.tree.map(        # noqa: E731
        lambda u, v: jnp.where(c, u, v), a, b
    )

    init = _LSState(
        t=t0,
        f_new=f0,     # placeholders until the pending initial eval
        g_new=g0,
        aux_new=aux0,
        t_prev=jnp.zeros((), dtype),
        f_prev=f0,
        gtd_prev=gtd0,
        g_prev=g0,
        aux_prev=aux0,
        ls_iter=jnp.zeros((), jnp.int32),
        done=jnp.zeros((), bool),
        bracketed=jnp.zeros((), bool),
        failed=jnp.zeros((), bool),
        saw_finite=jnp.zeros((), bool),
        pending=jnp.ones((), bool),
        unprocessed=jnp.zeros((), bool),
        t_lo=jnp.zeros((), dtype),
        f_lo=f0,
        gtd_lo=gtd0,
        g_lo=g0,
        aux_lo=aux0,
        t_hi=t0,
        f_hi=f0,
        gtd_hi=gtd0,
    )

    def cond(s: _LSState):
        # work remains while the initial eval is pending or the last eval
        # still needs classification; done/failed exit immediately. A
        # BRACKETING eval that consumed the last budget slot is left
        # unclassified (s.bracketed at entry reflects the mode the pending
        # eval was proposed under) — the reference's bracket loop gates on
        # LSiter before processing; its zoom processes in the same
        # iteration, so zoom evals always classify.
        return (~s.done) & (~s.failed) & (
            s.pending
            | (s.unprocessed & (s.bracketed | (s.ls_iter < max_ls)))
        )

    def body(s: _LSState):
        gtd_new = jnp.vdot(s.g_new, d)
        proc = ~s.pending            # there is an eval to classify
        in_brk = ~s.bracketed

        # ---- classify the last trial under the current phase's rules ----
        armijo0 = s.f_new > f0 + c1 * s.t * gtd0
        wolfe_ok = jnp.abs(gtd_new) <= -c2 * gtd0

        # bracketing rules (WolfeLineSearch.m:50-119)
        af_b = armijo0 | ((s.ls_iter > 1) & (s.f_new >= s.f_prev))
        newly = proc & in_brk & (af_b | (~wolfe_ok & (gtd_new >= 0)))
        done_b = proc & in_brk & ~af_b & wolfe_ok

        # zoom rules (WolfeLineSearch.m:135-241)
        af_z = armijo0 | (s.f_new >= s.f_lo)
        zoom_proc = proc & ~in_brk
        done_z = zoom_proc & ~af_z & wolfe_ok
        flip = gtd_new * (s.t_hi - s.t_lo) >= 0

        done = done_b | done_z

        # bracket set on the bracketing->zoom transition: [prev, new]
        # (lo/hi roles resolved by the zoom updates' f ordering)
        t_lo = jnp.where(newly, s.t_prev, s.t_lo)
        f_lo = jnp.where(newly, s.f_prev, s.f_lo)
        gtd_lo = jnp.where(newly, s.gtd_prev, s.gtd_lo)
        g_lo = tw(newly, s.g_prev, s.g_lo)
        aux_lo = tw(newly, s.aux_prev, s.aux_lo)
        t_hi = jnp.where(newly, s.t, s.t_hi)
        f_hi = jnp.where(newly, s.f_new, s.f_hi)
        gtd_hi = jnp.where(newly, gtd_new, s.gtd_hi)

        # zoom bracket updates: hi <- t on Armijo failure, else old lo when
        # the derivative sign flips; lo <- t unless Armijo failed
        z_hi = zoom_proc & af_z
        z_hi_flip = zoom_proc & ~af_z & flip
        t_hi = jnp.where(z_hi, s.t, jnp.where(z_hi_flip, s.t_lo, t_hi))
        f_hi = jnp.where(z_hi, s.f_new, jnp.where(z_hi_flip, s.f_lo, f_hi))
        gtd_hi = jnp.where(
            z_hi, gtd_new, jnp.where(z_hi_flip, s.gtd_lo, gtd_hi)
        )
        upd_lo = zoom_proc & ~af_z
        t_lo = jnp.where(upd_lo, s.t, t_lo)
        f_lo = jnp.where(upd_lo, s.f_new, f_lo)
        gtd_lo = jnp.where(upd_lo, gtd_new, gtd_lo)
        g_lo = tw(upd_lo, s.g_new, g_lo)
        aux_lo = tw(upd_lo, s.aux_new, aux_lo)

        # zoom give-up when the bracket can no longer make progress — ONLY
        # on a finite trial: a non-finite trial carries a sentinel zeroed
        # gradient (eval_at), and |0|*width < prog_tol would abort
        # instantly. The reference instead keeps shrinking the step until
        # evals are finite (WolfeLineSearch.m:53-69 -> ArmijoBacktrack.m);
        # here the shrinking is the f_hi=inf midpoint bisection below,
        # budgeted by max_ls.
        stall = jnp.isfinite(s.f_new) & (
            jnp.abs(gtd_new) * jnp.abs(t_hi - t_lo) < prog_tol
        )
        failed = zoom_proc & ~done_z & stall

        bracketed = s.bracketed | newly

        # ---- propose the next trial ----
        # bracketing: cubic extrapolation in [t + 0.01 (t - t_prev), 10 t]
        min_step = s.t + 0.01 * (s.t - s.t_prev)
        max_step = s.t * 10.0
        t_ext = _cubic_min(
            s.t_prev, s.f_prev, s.gtd_prev, s.t, s.f_new, gtd_new,
            min_step, max_step,
        ).astype(s.t.dtype)
        t_ext = jnp.where(jnp.isfinite(s.f_new), t_ext, s.t * 0.5)

        # zoom: safeguarded cubic interpolation on the UPDATED bracket,
        # kept strictly interior (minFunc insufficient-progress rule);
        # midpoint when the hi endpoint is non-finite
        lo_b = jnp.minimum(t_lo, t_hi)
        hi_b = jnp.maximum(t_lo, t_hi)
        width = hi_b - lo_b
        t_z = _cubic_min(
            t_lo, f_lo, gtd_lo, t_hi, f_hi, gtd_hi, lo_b, hi_b,
        ).astype(s.t.dtype)
        t_z = jnp.clip(t_z, lo_b + 0.1 * width, hi_b - 0.1 * width)
        t_z = jnp.where(jnp.isfinite(f_hi), t_z, 0.5 * (lo_b + hi_b))

        t_next = jnp.where(
            s.pending, s.t, jnp.where(bracketed, t_z, t_ext)
        )

        # bracketing shift prev <- current when continuing the extrapolation
        shift = proc & in_brk & ~newly & ~done
        t_prev = jnp.where(shift, s.t, s.t_prev)
        f_prev = jnp.where(shift, s.f_new, s.f_prev)
        gtd_prev = jnp.where(shift, gtd_new, s.gtd_prev)
        g_prev = tw(shift, s.g_new, s.g_prev)
        aux_prev = tw(shift, s.aux_new, s.aux_prev)

        # ---- the single objective call site ----
        do_eval = (~done) & (~failed) & (s.ls_iter < max_ls)
        t_eval = jnp.where(do_eval, t_next, s.t)
        f_new, g_new, aux_new = lax.cond(
            do_eval,
            lambda: eval_at(t_eval),
            lambda: (s.f_new, s.g_new, s.aux_new),
        )

        return s._replace(
            t=t_eval,
            f_new=f_new,
            g_new=g_new,
            aux_new=aux_new,
            t_prev=t_prev,
            f_prev=f_prev,
            gtd_prev=gtd_prev,
            g_prev=g_prev,
            aux_prev=aux_prev,
            ls_iter=s.ls_iter + jnp.where(do_eval, 1, 0),
            done=done,
            bracketed=bracketed,
            failed=failed,
            saw_finite=s.saw_finite | (do_eval & jnp.isfinite(f_new)),
            pending=jnp.zeros((), bool),
            unprocessed=do_eval,
            t_lo=t_lo,
            f_lo=f_lo,
            gtd_lo=gtd_lo,
            g_lo=g_lo,
            aux_lo=aux_lo,
            t_hi=t_hi,
            f_hi=f_hi,
            gtd_hi=gtd_hi,
        )

    s = lax.while_loop(cond, body, init)

    # resolve the result: Wolfe point if done; else bracket-lo if it improves
    # on f0; else fail
    use_lo = (~s.done) & (s.f_lo < f0) & (s.t_lo > 0)
    t_out = jnp.where(s.done, s.t, jnp.where(use_lo, s.t_lo, 0.0))
    f_out = jnp.where(s.done, s.f_new, jnp.where(use_lo, s.f_lo, f0))
    g_out = jax.tree.map(
        lambda gn, gl, g00: jnp.where(s.done, gn, jnp.where(use_lo, gl, g00)),
        s.g_new, s.g_lo, g0,
    )
    aux_out = jax.tree.map(
        lambda an, al, a00: jnp.where(s.done, an, jnp.where(use_lo, al, a00)),
        s.aux_new, s.aux_lo, aux0,
    )
    failed = ~s.done & ~use_lo
    return t_out, f_out, g_out, aux_out, s.ls_iter, failed, s.saw_finite


def _lbfgs_direction(g, S, Yb, count, pos, hdiag, history):
    """Two-loop recursion on the circular (history, p) buffers
    (ref minFunc/lbfgsProd.m:19-32, mex/lbfgsProdC.c:46-88)."""

    def sy(j):
        return jnp.vdot(S[j], Yb[j])

    def backward(i, carry):
        q, al = carry
        j = (pos - 1 - i) % history
        valid = i < count
        denom = sy(j)
        rho = jnp.where(valid & (denom > 1e-30), 1.0 / denom, 0.0)
        a = rho * jnp.vdot(S[j], q)
        q = q - a * Yb[j]
        al = al.at[j].set(a)
        return q, al

    q, al = lax.fori_loop(
        0, history, backward, (g, jnp.zeros((history,), g.dtype))
    )
    r = hdiag * q

    def forward(i, r):
        j = (pos - count + i) % history
        valid = i < count
        denom = sy(j)
        rho = jnp.where(valid & (denom > 1e-30), 1.0 / denom, 0.0)
        b = rho * jnp.vdot(Yb[j], r)
        return r + jnp.where(valid, al[j] - b, 0.0) * S[j]

    r = lax.fori_loop(0, history, forward, r)
    return -r


class _OptState(NamedTuple):
    x: jax.Array
    f: jax.Array
    g: jax.Array
    aux: object
    S: jax.Array
    Yb: jax.Array
    count: jax.Array
    pos: jax.Array
    hdiag: jax.Array
    it: jax.Array
    fevals: jax.Array
    status: jax.Array
    best_x: jax.Array
    best_score: jax.Array
    attempts: jax.Array
    restarted: jax.Array   # memory was just reset -> rescale next trial step
    trace: dict


def minimize(
    fun: Callable,
    x0: jax.Array,
    *,
    args: tuple = (),
    history: int = 100,
    max_iter: int = 200,
    opt_tol: float = 1e-5,
    prog_tol: float = 1e-9,
    c1: float = 1e-4,
    c2: float = 0.9,
    max_ls: int = 25,
    score_fn: Optional[Callable] = None,
    max_attempts: Optional[int] = None,
    init_best_score: Optional[jax.Array] = None,
    x_best0: Optional[jax.Array] = None,
    record_len: Optional[int] = None,
    iter_callback: Optional[Callable] = None,
    patience: int = 0,
    patience_tol: float = 0.0,
    aot_key: Optional[str] = None,
    aot_group: Optional[str] = None,
) -> MinimizeResult:
    """Minimize fun(x) -> (f, g, aux) by L-BFGS with strong-Wolfe search.

    score_fn(x, aux) -> (score, extras): higher-is-better model-selection score
    (the reference's validation LL). `best_x` tracks the argmax-score iterate;
    `max_attempts` successive non-improving iterations trigger early stopping
    (ref GPz/callBack.m:26-34; improvement uses >=, matching the reference).

    `args` is a pytree of extra runtime inputs appended to every `fun` /
    `score_fn` call (`fun(x, *args)`). Pass the training data here rather
    than closing over it: closed-over arrays are baked into the compiled
    program as constants, which bloats it and makes the persistent
    compilation cache key depend on the data bytes — with `args`, any
    same-shaped dataset reuses the compiled optimizer.

    `max_iter` / `max_attempts` are DYNAMIC operands of the compiled
    program, not compile-time constants: the trace buffers are sized by
    `record_len`, which defaults to `max_iter + 1` rounded up to a
    multiple of 64 — i.e. ONE EXECUTABLE PER 64-ITERATION BUCKET, not
    literally one. Budgets within the same bucket (and in particular the
    refine phase's data-dependent remaining budget, model.py train) reuse
    the same compiled executable from the persistent compilation
    cache; a budget that crosses a bucket boundary still compiles fresh.
    `max_iter` must be a concrete Python int here (it sizes host-side
    buffers); pass `record_len` explicitly to pin the bucket.

    `iter_callback(it, f, opt_cond, step, score, improved, extras)` — an
    optional host callback streamed one row per iteration from INSIDE the
    jitted loop via `jax.debug.callback` (the live version of the
    reference's per-iteration table, ref GPz/callBack.m:16-46 — without it
    a multi-minute run gives zero feedback until the while_loop returns).
    Its identity is a static jit argument: pass a memoized function, not a
    fresh closure per call, or every call re-traces the loop.

    `patience` / `patience_tol` — noise-floor plateau exit: terminate with
    STATUS_PLATEAU when the last `patience` iterations together decreased
    f by less than `patience_tol * max(1, |f|)`. For a phase whose
    working precision cannot resolve further descent (the mixed phase of
    model.train's refine schedule), grinding to a hard line-search stall
    wastes wall clock and drifts the iterate along the rounding floor;
    the reference has no analogue because its single phase IS the final
    one. patience == 0 (default) statically removes the test from the
    traced program (the common single-phase/final-phase programs carry
    zero extra ops); both values are static jit arguments, so changing
    them compiles a fresh loop.

    `aot_key` — opt-in AOT executable caching (gpz_tpu.aot): a semantic
    string capturing what `fun`/`score_fn` compute (their identities
    cannot key a cross-process cache). A repeat process with the same key,
    argument shapes, and code fingerprint calls the deserialized compiled
    executable directly — no trace, no lowering (~5-9 s per phase per
    process on the north-star shapes). Ignored when an iter_callback is
    present (host callbacks do not survive executable serialization).
    """
    max_iter = int(max_iter)
    if record_len is None:
        record_len = -(-(max_iter + 1) // 64) * 64
    elif max_iter + 1 > record_len:
        raise ValueError(
            f"record_len={record_len} cannot hold max_iter={max_iter} + 1 "
            "trace rows"
        )
    max_attempts = 2**31 - 1 if max_attempts is None else int(max_attempts)
    build = (
        fun, x0, args, history, max_iter, opt_tol, prog_tol, c1, c2,
        max_ls, score_fn, max_attempts, init_best_score, x_best0,
        record_len, iter_callback, patience, patience_tol,
    )
    if aot_key is not None and iter_callback is None:
        from gpz_tpu import aot

        if aot.enabled():
            dyn = (x0, args, max_iter, opt_tol, prog_tol, c1, c2,
                   max_attempts, init_best_score, x_best0)
            key = aot.cache_key(
                f"minimize:{aot_key}",
                dyn,
                (history, max_ls, record_len, score_fn is not None,
                 patience, patience_tol),
            )
            if aot_group is not None:
                # record the key under the caller's task group so the next
                # process can prefetch it (aot.prefetch_group)
                aot.note_group(aot_group, key)
            return aot.call_or_build(key, _minimize, build, dyn)
    return _minimize(*build)


@partial(
    jax.jit,
    static_argnames=(
        "fun", "score_fn", "history", "max_ls", "record_len",
        "iter_callback", "patience", "patience_tol",
    ),
)
def _minimize(
    fun, x0, args, history, max_iter, opt_tol, prog_tol, c1, c2, max_ls,
    score_fn, max_attempts, init_best_score, x_best0, record_len,
    iter_callback, patience=0, patience_tol=0.0,
) -> MinimizeResult:
    p = x0.shape[0]
    dtype = x0.dtype
    max_iter = jnp.asarray(max_iter, jnp.int32)

    user_fun, user_score = fun, score_fn
    fun = lambda x: user_fun(x, *args)          # noqa: E731
    if user_score is not None:
        score_fn = lambda x, aux: user_score(x, aux, *args)  # noqa: E731

    f0, g0, aux0 = fun(x0)
    if score_fn is None:
        score0, extras0 = -f0, ()
    else:
        score0, extras0 = score_fn(x0, aux0)
    if init_best_score is None:
        init_best_score = jnp.asarray(-jnp.inf, score0.dtype)
    init_best_score = jnp.asarray(init_best_score, score0.dtype)
    # continuation semantics (ref train.m:8-11 + callBack.m:26-34): when the
    # caller provides the previous best score, it provides the matching
    # previous best PARAMETERS too — otherwise a run that never beats the old
    # score would return x0 as "best" while keeping the old (better) score.
    if x_best0 is None:
        x_best0 = x0

    attempts_cap = jnp.asarray(max_attempts, jnp.int32)

    # trace arrays live in the dtype of the quantity they record (f/score are
    # solve_dtype scalars; a parameter-dtype (f32) buffer would silently
    # downcast-scatter — a FutureWarning today, an error in future JAX)
    fdt = f0.dtype

    trace0 = {
        "f": jnp.full((record_len,), jnp.nan, fdt),
        "opt_cond": jnp.full((record_len,), jnp.nan, dtype),
        "step": jnp.full((record_len,), jnp.nan, dtype),
        "score": jnp.full((record_len,), jnp.nan, score0.dtype),
        "fevals": jnp.full((record_len,), -1, jnp.int32),
        "extras": jax.tree.map(
            lambda e: jnp.full((record_len,), jnp.nan, jnp.asarray(e).dtype),
            extras0,
        ),
    }

    def record(trace, i, f, opt_cond, step, score, fevals, extras):
        def put(arr, v):
            return arr.at[i].set(jnp.asarray(v, arr.dtype))

        out = dict(trace)
        out["f"] = put(trace["f"], f)
        out["opt_cond"] = put(trace["opt_cond"], opt_cond)
        out["step"] = put(trace["step"], step)
        out["score"] = put(trace["score"], score)
        out["fevals"] = put(trace["fevals"], fevals)
        out["extras"] = jax.tree.map(put, trace["extras"], extras)
        return out

    trace0 = record(
        trace0, 0, f0, jnp.max(jnp.abs(g0)), 0.0, score0, 1, extras0
    )

    def emit_row(it, f, opt_cond, step, score, improved, extras):
        # streamed host print (ref callBack.m:16-46); unordered is fine —
        # rows carry their own iteration index
        if iter_callback is not None:
            jax.debug.callback(
                iter_callback, it, f, opt_cond, step, score, improved,
                extras,
            )

    emit_row(
        jnp.zeros((), jnp.int32), f0, jnp.max(jnp.abs(g0)),
        jnp.zeros((), dtype), score0,
        jnp.asarray(score0 >= init_best_score), extras0,
    )

    # best tracking starts from the provided floor (model.best.LL, train.m:8-9)
    improved0 = score0 >= init_best_score
    state = _OptState(
        x=x0,
        f=f0,
        g=g0,
        aux=aux0,
        S=jnp.zeros((history, p), dtype),
        Yb=jnp.zeros((history, p), dtype),
        count=jnp.zeros((), jnp.int32),
        pos=jnp.zeros((), jnp.int32),
        hdiag=jnp.ones((), dtype),
        it=jnp.zeros((), jnp.int32),
        fevals=jnp.ones((), jnp.int32),
        status=jnp.asarray(STATUS_RUNNING, jnp.int32),
        best_x=jnp.where(improved0, x0, x_best0),
        best_score=jnp.where(improved0, score0, init_best_score),
        attempts=jnp.zeros((), jnp.int32),
        restarted=jnp.zeros((), bool),
        trace=trace0,
    )

    opt0_done = jnp.max(jnp.abs(g0)) <= opt_tol
    state = state._replace(
        status=jnp.where(opt0_done, STATUS_OPTIMAL, state.status)
    )
    # a non-finite objective AT THE STARTING POINT poisons every Armijo /
    # curvature comparison (NaN compares false), so the search would burn
    # its whole max_ls eval budget learning nothing — exit immediately
    # instead; the caller's precision escalation (model.train refine)
    # reacts to the failed status. Trial-point non-finiteness stays handled
    # inside the line search (backtracking), this is only about x0.
    bad0 = ~jnp.isfinite(f0) | ~jnp.all(jnp.isfinite(g0))
    state = state._replace(
        status=jnp.where(bad0, STATUS_LS_FAILED, state.status)
    )

    def cond(s: _OptState):
        return (s.status == STATUS_RUNNING) & (s.it < max_iter)

    def body(s: _OptState):
        d_raw = _lbfgs_direction(
            s.g, s.S, s.Yb, s.count, s.pos, s.hdiag, history
        )
        # fall back to steepest descent when the quasi-Newton direction is
        # non-finite (minFunc isLegal, minFunc.m:963) OR fails the descent
        # test (minFunc.m:972-980) — and reset the curvature memory, since a
        # bad direction means the history no longer models the local
        # curvature. minFunc aborts on non-descent; resetting first and only
        # aborting when steepest descent itself fails is the "quit only when
        # the fallback is exhausted" semantics.
        # ">= 0" and not "> -prog_tol": a direction with tiny-but-negative
        # gtd is the normal near-convergence regime (handled by the progress
        # tests below), not a breakdown — swapping it for steepest descent
        # would derail the final quasi-Newton steps.
        d_bad = ~jnp.all(jnp.isfinite(d_raw)) | (jnp.vdot(s.g, d_raw) >= 0)
        fallback = d_bad & (s.count > 0)
        d = jnp.where(d_bad, -s.g, d_raw)
        count0 = jnp.where(fallback, 0, s.count)
        pos0 = jnp.where(fallback, 0, s.pos)
        hdiag0 = jnp.where(fallback, jnp.ones((), dtype), s.hdiag)

        gtd = jnp.vdot(s.g, d)
        # terminal only when even steepest descent is non-descent (g zero or
        # non-finite). A direction with tiny-but-negative gtd is NOT terminal:
        # it is either near-convergence (the progress tests below handle it)
        # or a badly *scaled* quasi-Newton direction after extreme curvature
        # pairs — the line search's 10x extrapolation recovers the scale
        # (minFunc maxStep rule, WolfeLineSearch.m bracketing).
        no_descent = gtd >= 0

        # step init (minFunc.m:983-1023): first iter t = min(1, 1/sum|g|);
        # same rescale after a memory reset (the next step is steepest
        # descent again, so the raw |g| scale applies)
        t0 = jnp.where(
            (s.it == 0) | s.restarted | fallback,
            jnp.minimum(1.0, 1.0 / jnp.sum(jnp.abs(s.g))),
            1.0,
        ).astype(dtype)

        t, f_new, g_new, aux_new, ls_evals, ls_failed, saw_finite = (
            wolfe_line_search(
                fun, s.x, s.f, s.g, d, t0, c1, c2, max_ls, prog_tol, s.aux
            )
        )
        x_new = s.x + t * d

        # a failed search with curvature memory in play: discard the memory
        # and retry from steepest descent next iteration instead of aborting
        # (the reference only gives up after its Armijo fallback is
        # exhausted, WolfeLineSearch.m:53-69). Terminal only when steepest
        # descent itself cannot find a step — and then the terminal code
        # depends on WHY: finite trials that never improved mean the function
        # is flat along -g at working precision ("function value changing by
        # less than progTol", minFunc.m's progress break — the f32 noise
        # floor lands here), while all-non-finite trials are a genuine
        # line-search pathology.
        soft_fail = ls_failed & (count0 > 0)
        hard_fail = ls_failed & (count0 == 0)
        hard_fail_flat = hard_fail & saw_finite
        hard_fail_path = hard_fail & ~saw_finite

        # curvature update with skip rule (lbfgsAdd.m:5)
        sk = t * d
        yk = g_new - s.g
        ys = jnp.vdot(yk, sk)
        accept = (ys > 1e-10) & ~ls_failed
        S = jnp.where(accept, s.S.at[pos0].set(sk), s.S)
        Yb = jnp.where(accept, s.Yb.at[pos0].set(yk), s.Yb)
        pos = jnp.where(accept, (pos0 + 1) % history, pos0)
        count = jnp.where(accept, jnp.minimum(count0 + 1, history), count0)
        hdiag = jnp.where(accept, ys / jnp.vdot(yk, yk), hdiag0)
        count = jnp.where(soft_fail, 0, count)
        pos = jnp.where(soft_fail, 0, pos)
        hdiag = jnp.where(soft_fail, jnp.ones((), dtype), hdiag)

        # scoring / early stopping — skipped on a soft-failed iteration
        # (x unchanged: re-scoring the same point must not reset `attempts`)
        if score_fn is None:
            score, extras = -f_new, ()
        else:
            score, extras = score_fn(x_new, aux_new)
        improved = (score >= s.best_score) & ~soft_fail
        best_x = jnp.where(improved, x_new, s.best_x)
        best_score = jnp.where(improved, score, s.best_score)
        attempts = jnp.where(
            soft_fail, s.attempts, jnp.where(improved, 0, s.attempts + 1)
        )

        opt_cond = jnp.max(jnp.abs(g_new))
        it = s.it + 1

        status = jnp.asarray(STATUS_RUNNING, jnp.int32)
        status = jnp.where(attempts >= attempts_cap, STATUS_EARLY_STOP, status)
        # progress-based termination only applies to a real accepted step —
        # a soft-failed iteration leaves x/f unchanged by construction
        prog_stop = (~soft_fail) & (
            (jnp.abs(s.f - f_new) < prog_tol)
            | (jnp.max(jnp.abs(t * d)) <= prog_tol)
        )
        status = jnp.where(prog_stop, STATUS_STEP_TOO_SMALL, status)
        status = jnp.where(opt_cond <= opt_tol, STATUS_OPTIMAL, status)
        status = jnp.where(hard_fail_flat, STATUS_STEP_TOO_SMALL, status)
        status = jnp.where(hard_fail_path, STATUS_LS_FAILED, status)
        status = jnp.where(no_descent, STATUS_NO_DESCENT, status)
        if patience:
            # noise-floor plateau exit (static `patience` knobs, see the
            # minimize docstring): when the trailing `patience` iterations
            # together bought less than patience_tol*max(1,|f|) of
            # decrease, this phase's working precision is exhausted —
            # terminate so the caller's refine schedule escalates instead
            # of grinding. Applied only while RUNNING: a genuine
            # termination this iteration wins. patience == 0 removes the
            # block from the traced program entirely.
            f_window_ago = jnp.asarray(
                lax.dynamic_index_in_dim(
                    s.trace["f"], jnp.maximum(it - patience, 0),
                    keepdims=False,
                ),
                f_new.dtype,
            )
            plateau = (
                (it >= patience)
                & jnp.isfinite(f_new)
                & (f_window_ago - f_new
                   < patience_tol * jnp.maximum(1.0, jnp.abs(f_new)))
            )
            status = jnp.where(
                plateau & (status == STATUS_RUNNING), STATUS_PLATEAU,
                status,
            )
        status = jnp.where(it >= max_iter, jnp.where(
            status == STATUS_RUNNING, STATUS_MAX_ITER, status), status)

        trace = record(
            s.trace, it, f_new, opt_cond, t, score, s.fevals + ls_evals, extras
        )
        emit_row(it, f_new, opt_cond, t, score, improved, extras)

        return _OptState(
            x=x_new,
            f=f_new,
            g=g_new,
            aux=aux_new,
            S=S,
            Yb=Yb,
            count=count,
            pos=pos,
            hdiag=hdiag,
            it=it,
            fevals=s.fevals + ls_evals,
            status=status,
            best_x=best_x,
            best_score=best_score,
            attempts=attempts,
            restarted=soft_fail,
            trace=trace,
        )

    s = lax.while_loop(cond, body, state)
    status = jnp.where(
        s.status == STATUS_RUNNING, STATUS_MAX_ITER, s.status
    )
    # with no score_fn, "best" mirrors the reference's trainingOnly callback
    # path: best == last (callBack.m:20-22)
    if score_fn is None:
        best_x, best_score = s.x, -s.f
    else:
        best_x, best_score = s.best_x, s.best_score
    return MinimizeResult(
        x=s.x,
        f=s.f,
        x_best=best_x,
        best_score=best_score,
        iterations=s.it,
        fun_evals=s.fevals,
        status=status,
        trace=s.trace,
    )
