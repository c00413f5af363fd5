#!/usr/bin/env python3
"""Smoke test of GPz training and prediction on one NVIDIA GPU.

Drives the VC photo-z main path through the public API (gpz_tpu.init ->
train -> predict) at the north-star width — SDSS-like 5 bands with their
errors as input noise (psi = err^2), m=100 basis functions, 70k training +
10k validation rows (the bench_convergence.py problem) — and checks it
against float64 references:

  device     the default JAX device must be a GPU; there is no CPU fallback
  objective  nlog_ml value + gradient on the GPU under the default numerics
             path, the mixed/Ozaki candidate and float64 strict, each against
             the same function in float64 on the host CPU at full n, and
             against tests/reference_impl.py on a 2k-row slice
  train      gpz_tpu.train(max_iter=10) with validation: finite,
             non-increasing nlml, healthy status; compile reported apart
  predict    gpz_tpu.predict on 20k rows with psi and one missing band,
             against CPU float64 predict on 2k of them; then VC m=1000
             noisy + missing rows (finite, sigma > 0)
  ozaki      exactness of the bf16 slice products (ops/ozaki.py) on the card

Every failure exits non-zero; only a full pass prints the last line,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

    python chip_smoke.py          # one GPU, every phase
    python chip_smoke.py --four   # only the n-sharded path, on 4 GPUs

Keep to one JAX process per card: this script is that process.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

import gpz_tpu  # noqa: E402
from bench import card_lines  # noqa: E402

_ROOT = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes; the defaults are the full-width smoke."""

    n_train: int = 70_000
    n_valid: int = 10_000
    m: int = 100
    ref_rows: int = 2_000       # rows compared with tests/reference_impl.py
    reps: int = 20              # timed objective evaluations per path
    train_iters: int = 10
    n_pred: int = 20_000
    pred_ref_rows: int = 2_000  # predict rows compared with CPU float64
    m_big: int = 1_000
    big_n: int = 2_000
    big_nq: int = 256


#: L-BFGS statuses that mean the run ended in good order
#: (gpz_tpu.optim.lbfgs: OPTIMAL, STEP_TOO_SMALL, MAX_ITER, EARLY_STOP)
HEALTHY_STATUSES = (1, 2, 3, 4)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(phase: str, name: str, err: float, tol: float, reason: str):
    """Print one comparison and fail unless err <= tol (NaN fails)."""
    ok = bool(err <= tol)
    log(phase, f"{name}: rel err {err:.3e} <= tol {tol:.0e} "
               f"({reason}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{phase}: {name} rel err {err:.3e} > {tol:.0e}")


def rel(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def require_gpu(devices, count: int):
    """Exit non-zero unless the first `count` devices are GPUs."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke: needs a GPU, the default JAX device "
                         f"is {plat!r}")
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found "
                         f"{len(devices)}")


@contextlib.contextmanager
def ozaki_env(value):
    """Set GPZ_OZAKI (None = unset, i.e. the platform default) while a
    path is traced; objective._ozaki_active reads it at trace time."""
    old = os.environ.get("GPZ_OZAKI")
    if value is None:
        os.environ.pop("GPZ_OZAKI", None)
    else:
        os.environ["GPZ_OZAKI"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("GPZ_OZAKI", None)
        else:
            os.environ["GPZ_OZAKI"] = old


# ---------------------------------------------------------------------------
# problem
# ---------------------------------------------------------------------------

def make_problem(sizes: Sizes, seed: int = 1):
    """Synthetic SDSS catalog: (mags, z, psi, train mask, valid mask)."""
    from gpz_tpu.data.photoz import synthetic_sdss

    n = sizes.n_train + sizes.n_valid
    mags, errs, z = synthetic_sdss(n, filters=5, seed=seed)
    tr = np.zeros(n, bool)
    tr[:sizes.n_train] = True
    return mags, z, errs**2, tr, ~tr


def dataset(model, X, Y, psi, rows, dtype):
    """The training Dataset of `rows`, normalized as model.train does."""
    from gpz_tpu import datautils
    from gpz_tpu.dataset import Dataset

    Xn = (X[rows] - model.muX[None, :]) / model.sdX[None, :]
    mask = ~np.isnan(Xn)
    n = Xn.shape[0]
    psi_c = datautils.fix_psi(psi[rows], n, model.sdX, model.cfg.full_cov)
    return Dataset(
        X=np.where(mask, Xn, 0.0).astype(dtype),
        mask=mask,
        omega=np.ones(n, dtype),
        Y=(Y[rows][:, None] - model.muY[None, :]).astype(dtype),
        psi=psi_c.astype(dtype),
    )


def cast(tree, dtype):
    """Host copy of a pytree with its floating arrays cast to `dtype`."""
    def one(a):
        a = np.asarray(a)
        return a.astype(dtype) if np.issubdtype(a.dtype, np.floating) else a

    return jax.tree.map(one, tree)


def objective_fn(cfg, complete=True):
    """A fresh jitted (params, data) -> (f, flat gradient)."""
    from gpz_tpu.objective import nlog_ml

    vg = jax.value_and_grad(
        lambda p, d: nlog_ml(p, d, cfg, complete=complete), has_aux=True)

    def fg(p, d):
        (f, _), g = vg(p, d)
        return f, ravel_pytree(g)[0]

    return jax.jit(fg)


def timed_evals(fn, args, reps: int):
    """(first-call seconds, steady seconds per call, outputs)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return first, (time.perf_counter() - t0) / max(reps, 1), out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(devices, count: int):
    require_gpu(devices, count)
    log("device", f"platform={devices[0].platform} "
                  f"kind={devices[0].device_kind} count={len(devices)} "
                  f"jax={jax.__version__} "
                  f"compile_cache={jax.config.jax_compilation_cache_dir}")
    print(card_lines(), flush=True)


def phase_objective(model, prob, sizes: Sizes, cpu):
    """GPU nlog_ml value+gradient per numerics path vs CPU float64."""
    sys.path.insert(0, os.path.join(_ROOT, "tests"))
    from reference_impl import ref_nlog_ml

    X, Y, psi, tr, _ = prob
    cfg = model.cfg
    cfg64 = dataclasses.replace(cfg, dtype="float64", solve_mode="strict",
                                solve_dtype="float64")
    p32 = cast(model.last.params, np.float32)
    p64 = cast(model.last.params, np.float64)
    d32 = dataset(model, X, Y, psi, tr, np.float32)
    d64 = dataset(model, X, Y, psi, tr, np.float64)

    # CPU float64 strict reference at full n
    with jax.default_device(cpu), ozaki_env("0"):
        t0 = time.perf_counter()
        f_ref, g_ref = jax.block_until_ready(objective_fn(cfg64)(
            jax.device_put(p64, cpu), jax.device_put(d64, cpu)))
    log("objective", f"cpu float64 strict reference n={d64.n}: "
                     f"f={float(f_ref):.12f} |g|={np.linalg.norm(g_ref):.6e} "
                     f"({time.perf_counter() - t0:.1f} s incl. compile)")

    auto = cfg.resolved_solve_mode()
    paths = [
        # (label, cfg, GPZ_OZAKI, params, data, f tol, g tol, reason)
        (f"default (auto -> {auto}, Ozaki off, f32 design matrix)",
         cfg, None, p32, d32, 1e-5, 1e-3,
         "float32 design matrix: eps_f32 rounding of PHI, ln beta and the "
         "Delta quadratic forms, float64 reductions"),
        ("candidate mixed+Ozaki (GPZ_OZAKI=1, f32 design matrix)",
         dataclasses.replace(cfg, solve_mode="mixed"), "1", p32, d32,
         1e-5, 1e-3,
         "same float32 design matrix; Gram exact given it, f32-factor "
         "refined solve"),
        ("float64 strict (dtype float64)", cfg64, "0", p64, d64, 1e-10, 1e-7,
         "same float64 math; only summation order differs"),
    ]
    dev = jax.devices()[0]
    results = {}
    for label, c, oz, p, d, ftol, gtol, reason in paths:
        with ozaki_env(oz):
            fn = objective_fn(c)
            first, per, (f, g) = timed_evals(
                fn, (jax.device_put(p, dev), jax.device_put(d, dev)),
                sizes.reps)
        log("objective", f"time {label}: {per * 1e3:.3f} ms per "
                         f"value+grad eval (first call {first:.2f} s)")
        results[label] = (f, g, ftol, gtol, reason)
    for label, (f, g, ftol, gtol, reason) in results.items():
        assert np.isfinite(float(f)) and np.all(np.isfinite(g)), label
        log("objective", f"{label}: |g| rel err "
                         f"{abs(np.linalg.norm(g) / np.linalg.norm(g_ref) - 1):.3e}")
        check("objective", f"{label} f vs cpu f64", rel(f, f_ref), ftol,
              reason)
        check("objective", f"{label} g vs cpu f64", rel(g, g_ref), gtol,
              reason)

    # port-of-record comparison on a slice (tests/reference_impl.py)
    rows = np.flatnonzero(tr)[:sizes.ref_rows]
    sl = np.zeros_like(tr)
    sl[rows] = True
    s64 = dataset(model, X, Y, psi, sl, np.float64)
    t0 = time.perf_counter()
    q = p64
    f_port, _ = ref_nlog_ml(
        s64.X, s64.Y, s64.psi, s64.omega, q.P, q.gamma, q.ln_alpha, q.b,
        q.v, q.ln_tau, cfg.method)
    log("objective", f"reference_impl n={len(rows)}: f={f_port:.12f} "
                     f"({time.perf_counter() - t0:.1f} s)")
    for label, c, oz, p, tol, reason in [
        ("float64 strict", cfg64, "0", p64, 1e-9,
         "float64 on both sides; the port uses slogdet/solve per row"),
        ("default", cfg, None, p32, 1e-5, "float32 design matrix"),
    ]:
        dd = s64 if c is cfg64 else cast(s64, np.float32)
        with ozaki_env(oz):
            f, _ = objective_fn(c)(jax.device_put(p, dev),
                                   jax.device_put(dd, dev))
        check("objective", f"{label} f vs reference_impl ({len(rows)} rows)",
              rel(f, f_port), tol, reason)


def _monotone_segments(model) -> bool:
    """nlml trace non-increasing inside every precision phase (a phase
    switch re-evaluates the iterate in float64, which may read higher)."""
    info = model.fit_info
    f = np.asarray(info["trace"]["f"], np.float64)
    start = 0
    for it in info["phase_iterations"]:
        seg = f[start:start + it + 1]
        if not np.all(np.diff(seg) <= 1e-9 * np.maximum(1.0, np.abs(seg[:-1]))):
            return False
        start += it + 1
    return True


def phase_train(model, prob, sizes: Sizes):
    """10 L-BFGS iterations with validation; compile apart from the run."""
    X, Y, psi, tr, va = prob
    walls = []
    for _ in range(2):   # the second call reuses the compiled programs
        t0 = time.perf_counter()
        out = gpz_tpu.train(model, X, Y, training=tr, validation=va, psi=psi,
                            max_iter=sizes.train_iters, verbose=False)
        walls.append(time.perf_counter() - t0)
    info = out.fit_info
    it = info["iterations"]
    f = np.asarray(info["trace"]["f"][: it + 1], np.float64)
    log("train", f"n={int(tr.sum())} m={model.cfg.m} iterations={it} "
                 f"fun_evals={info['fun_evals']} status={info['status']} "
                 f"phases={info['phase_modes']} nlml {f[0]:.6f} -> {f[-1]:.6f}")
    log("train", f"first call {walls[0]:.2f} s (compile + run), second call "
                 f"{walls[1]:.2f} s (run): compile ~{walls[0] - walls[1]:.2f} s, "
                 f"{walls[1] / max(it, 1) * 1e3:.1f} ms per iteration")
    assert np.all(np.isfinite(f)), f
    assert _monotone_segments(out), f
    assert info["status"] in HEALTHY_STATUSES, info["status"]
    assert f[-1] < f[0], "training made no progress"
    return out


def _model_on(model, device, dtype):
    """The model with every array cast to `dtype` on `device`."""
    put = lambda t: jax.tree.map(  # noqa: E731
        lambda a: jax.device_put(np.asarray(a, dtype), device), t)
    ps = lambda s: dataclasses.replace(  # noqa: E731
        s, params=put(s.params), post=put(s.post), priors=put(s.priors))
    return dataclasses.replace(
        model, cfg=dataclasses.replace(model.cfg, dtype=np.dtype(dtype).name),
        last=ps(model.last), best=ps(model.best))


def phase_predict(model, prob, sizes: Sizes, cpu):
    """Predict with psi + one missing band vs CPU float64; m=1000 case."""
    X, Y, psi, _, _ = prob
    nq = sizes.n_pred
    Xq = X[:nq].copy()
    Xq[-nq // 4:, 2] = np.nan          # one missing-band pattern (r band)
    psiq = psi[:nq]
    t0 = time.perf_counter()
    pred = gpz_tpu.predict(Xq, model, psi=psiq)
    log("predict", f"{nq} rows ({nq // 4} missing band 2): "
                   f"{time.perf_counter() - t0:.2f} s incl. compile")
    for name in ("mu", "sigma", "nu", "beta_i", "gamma"):
        assert np.all(np.isfinite(getattr(pred, name))), name
    assert np.all(pred.sigma > 0)

    # the same rows on the host CPU, in float64 (the reference) and in
    # float32 (the model's own precision: its distance from float64 is the
    # float32 pipeline's floor, which the GPU should not exceed by much)
    half = sizes.pred_ref_rows // 2
    sel = np.r_[0:half, nq - half:nq]   # complete rows and missing rows
    with jax.default_device(cpu):
        ref = gpz_tpu.predict(Xq[sel], _model_on(model, cpu, np.float64),
                              psi=psiq[sel])
        ref32 = gpz_tpu.predict(Xq[sel], _model_on(model, cpu, np.float32),
                                psi=psiq[sel])
    mu_err = lambda p, r: float(np.max(  # noqa: E731
        np.abs(p.mu[r] - ref.mu[r]) / np.sqrt(ref.sigma[r])))
    sg_err = lambda p, r: float(np.max(  # noqa: E731
        np.abs(p.sigma[r] - ref.sigma[r]) / ref.sigma[r]))
    gpu_sel = dataclasses.replace(
        pred, **{f: getattr(pred, f)[sel] for f in ("mu", "sigma")})
    for part, rows in (("complete", slice(0, half)),
                       ("missing", slice(half, 2 * half))):
        mu_floor, sg_floor = mu_err(ref32, rows), sg_err(ref32, rows)
        log("predict", f"{part} rows, cpu float32 vs cpu float64 (the "
                       f"float32 floor): mu {mu_floor:.3e} sd, "
                       f"sigma {sg_floor:.3e} rel")
        # the model is stored and predicted in float32, so its distance
        # from float64 is set by float32 itself (the nu/gamma contractions
        # cancel: ~eps_f32 * sum|terms| absolute on a small sigma); the GPU
        # may not add to it — TF32 contractions would, by orders of magnitude
        reason = "at most twice the float32 floor of this run"
        check("predict", f"mu {part} rows vs cpu f64, in predictive sd",
              mu_err(gpu_sel, rows), max(2 * mu_floor, 1e-4), reason)
        check("predict", f"sigma {part} rows vs cpu f64",
              sg_err(gpu_sel, rows), max(2 * sg_floor, 1e-3), reason)

    # VC m=1000, noisy + missing rows (BASELINE.json configs[4] widths)
    rng = np.random.default_rng(4)
    n, d, m = sizes.big_n, 5, sizes.m_big
    Xb = rng.standard_normal((n, d))
    yb = np.sin(Xb[:, 0]) + 0.1 * rng.standard_normal(n)
    big = gpz_tpu.init(Xb, yb, "VC", m, psi=0.01 + 0.05 * rng.random((n, d)),
                       seed=0)
    Xbq = rng.standard_normal((sizes.big_nq, d))
    Xbq[-sizes.big_nq // 4:, 2] = np.nan
    t0 = time.perf_counter()
    pb = gpz_tpu.predict(Xbq, big, psi=0.02 * np.ones((sizes.big_nq, d)))
    log("predict", f"VC m={m}: {sizes.big_nq} rows noisy+missing in "
                   f"{time.perf_counter() - t0:.2f} s incl. compile; "
                   f"sigma in [{pb.sigma.min():.3e}, {pb.sigma.max():.3e}]")
    assert np.all(np.isfinite(pb.mu)) and np.all(np.isfinite(pb.sigma))
    assert np.all(pb.sigma > 0)


def phase_ozaki(m: int = 100):
    """ops/ozaki.py on the card: are bf16 slice products with f32
    accumulation exact here, and do the tests/test_ozaki.py exactness
    checks hold?"""
    from gpz_tpu.ops.ozaki import (
        _BLOCK, _block, _nslices, _slice_blocks, ozaki_gram, ozaki_tn,
    )

    rng = np.random.default_rng(0)
    # slice-level: every per-block f32-accumulated product of two slices
    # against the same product in float64 on the host
    Wp = rng.standard_normal((4 * _BLOCK, m)) * np.exp(
        2.0 * rng.standard_normal((4 * _BLOCK, m)))
    s = _slice_blocks(_block(jnp.asarray(Wp), _BLOCK), _nslices(jnp.float64))
    worst = 0.0
    for i in range(len(s)):
        for j in range(i, len(s) - i):
            got = np.asarray(jnp.einsum("cna,cnb->cab", s[i], s[j],
                                        preferred_element_type=jnp.float32))
            a = np.asarray(s[i].astype(jnp.float64))
            b = np.asarray(s[j].astype(jnp.float64))
            want = np.einsum("cna,cnb->cab", a, b)
            worst = max(worst, float(np.max(np.abs(got - want))))
    log("ozaki", f"bf16 slice products ({4 * _BLOCK}x{m}, {_BLOCK}-row "
                 f"blocks) exact with f32 accumulation on this card: "
                 f"{'yes' if worst == 0.0 else 'NO'} (max abs diff {worst:.3e})")

    # the exactness checks of tests/test_ozaki.py, on the card
    W = rng.standard_normal((3000, 23)) * np.exp(
        2.0 * rng.standard_normal((3000, 23)))
    A = np.asarray(jax.jit(ozaki_gram)(jnp.asarray(W)))
    ref = W.T @ W
    check("ozaki", "gram f64", np.abs(A - ref).max() / np.abs(ref).max(),
          1e-13, "exact slices, dropped tail 2^-56")
    Wf = W.astype(np.float32)
    A = np.asarray(jax.jit(ozaki_gram)(jnp.asarray(Wf)))
    sig = np.abs(Wf).max(axis=0).astype(np.float64)
    err = (np.abs(A - Wf.astype(np.float64).T @ Wf.astype(np.float64))
           / (Wf.shape[0] * np.outer(sig, sig))).max()
    check("ozaki", "gram f32 input (column-scale abs)", err, 2.0**-30,
          "q=5 slices")
    Yt = rng.standard_normal((3000, 4))
    O = np.asarray(jax.jit(ozaki_tn)(jnp.asarray(W), jnp.asarray(Yt)))
    check("ozaki", "tn f64", np.abs(O - W.T @ Yt).max()
          / np.abs(W.T @ Yt).max(), 1e-13, "exact slices")
    Wn = W.copy()
    Wn[17, 3] = np.nan
    assert np.isnan(np.asarray(ozaki_gram(jnp.asarray(Wn)))).any()
    Xs = rng.standard_normal((24, 5000))
    Ms = rng.standard_normal((24, 24))
    O = np.asarray(ozaki_tn(jnp.asarray(Xs), jnp.asarray(Ms)))
    check("ozaki", "short factor", np.abs(O - Xs.T @ Ms).max()
          / np.abs(Xs.T @ Ms).max(), 1e-13, "contraction shorter than a block")


def phase_four(model, prob, sizes: Sizes, devices):
    """The n-sharded objective on a 1 x 4 data mesh vs one device, float64;
    then 2 L-BFGS steps of train_sharded."""
    from gpz_tpu.config import TrainConfig
    from gpz_tpu.objective import nlog_ml
    from gpz_tpu.parallel import make_mesh, shard_dataset, train_sharded
    from gpz_tpu.parallel.sharded import sharded_nlog_ml

    X, Y, psi, tr, va = prob
    cfg64 = dataclasses.replace(model.cfg, dtype="float64",
                                solve_mode="strict", solve_dtype="float64")
    # host arrays: jit places them (a copy committed to one device could
    # not meet the 4-device shards in one computation)
    p64 = cast(model.last.params, np.float64)
    d64 = dataset(model, X, Y, psi, tr, np.float64)
    mesh = make_mesh(n_data=4, n_restart=1, devices=devices[:4])

    with ozaki_env("0"):
        f1, g1 = objective_fn(cfg64)(p64, d64)
        sdata, n_eff = shard_dataset(d64, mesh)
        vg = jax.jit(jax.value_and_grad(
            lambda p, d, ne: sharded_nlog_ml(p, d, cfg64, mesh, ne, True)[0]))
        first, per, (f4, g4) = timed_evals(vg, (p64, sdata, n_eff), 5)
        g4 = ravel_pytree(g4)[0]
        log("four", f"sharded value+grad on {mesh.shape}: {per * 1e3:.3f} ms "
                    f"per eval (first call {first:.2f} s)")
        check("four", "sharded f vs one device", rel(f4, f1), 1e-9,
              "float64; psum reorders the n-sums")
        check("four", "sharded g vs one device", rel(g4, g1), 1e-9,
              "float64; psum reorders the n-sums")

        v64 = dataset(model, X, Y, psi, va, np.float64)
        t0 = time.perf_counter()
        res, _ = train_sharded(
            p64, d64, cfg64, mesh, valid_data=v64,
            tc=TrainConfig(max_iter=2, verbose=False), complete=True)
        it = int(res.iterations)
        f = np.asarray(res.trace["f"][: it + 1], np.float64)
    log("four", f"train_sharded 2 L-BFGS steps: iterations={it} "
                f"status={int(res.status)} nlml {f[0]:.9f} -> {f[-1]:.9f} "
                f"({time.perf_counter() - t0:.2f} s incl. compile)")
    assert np.all(np.isfinite(f)) and np.all(np.diff(f) <= 0), f
    assert int(res.status) in HEALTHY_STATUSES, int(res.status)


# ---------------------------------------------------------------------------

def main(argv=None, devices=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the n-sharded path on 4 GPUs")
    args = ap.parse_args(argv)
    count = 4 if args.four else 1
    devices = list(jax.devices() if devices is None else devices)
    phase_device(devices, count)
    sizes = Sizes()
    cpu = jax.devices("cpu")[0]
    prob = make_problem(sizes)
    X, Y, psi, tr, _ = prob
    t0 = time.perf_counter()
    model = gpz_tpu.init(X, Y, "VC", sizes.m, heteroscedastic=True,
                         training=tr, psi=psi, seed=1)
    log("init", f"VC m={sizes.m} n_train={int(tr.sum())}: "
                f"{time.perf_counter() - t0:.2f} s incl. compile")
    if args.four:
        phase_four(model, prob, sizes, devices)
    else:
        phase_objective(model, prob, sizes, cpu)
        trained = phase_train(model, prob, sizes)
        phase_predict(trained, prob, sizes, cpu)
        phase_ozaki()
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
