"""Hard-regime benchmark (VERDICT r3 item 7, r4 next #2): per-eval cost
where the wall clock is actually spent, at a committed TRAINED parameter
set (benchmarks/photoz_trained_m100.npz — the shipped photo-z VC m=100
model, see parity_numbers.py).

At this point the raw f32 mixed pipeline can be NOT FINITE — cond(iSig)
~ 3e9 can NaN a few of the f32 design-matrix factorizations, which NaNs
ln_beta/Gram/objective, and every safe_cholesky then walks its full
jitter-escalation ladder. train() probes x0 (objective.probe_phase) and
starts in the phase this bench measures:

  * the probe verdict at the trained point (pipeline_finite, fast_solve_ok)
  * evals/s of the SHIPPED continuation path at the trained point (what
    train() actually runs after the probe — f64 strict here)
  * the solve-level fast-vs-strict comparison on the trained (finite, f64)
    Gram, including the fast solve's ok gate

Usage:  python benchmarks/hard_regime_bench.py
Writes chiprun_out/hard_bench.json; one JSON line per case.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                   "chiprun_out", "hard_bench.json")
CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "photoz_trained_m100.npz")


def main():
    import jax
    import jax.numpy as jnp

    import gpz_tpu
    from gpz_tpu import checkpoint, datautils
    from gpz_tpu.model import _make_dataset
    from gpz_tpu.objective import nlog_ml, _gram_terms, probe_phase
    from gpz_tpu import linalg
    from parity_numbers import photoz_data

    model = checkpoint.load_model(CKPT)
    X, Y, psi, omega, tr, va, te = photoz_data()
    Xn = (X - model.muX[None]) / model.sdX[None]
    Yc = (Y - model.muY[None]).reshape(len(Y), -1)
    psi_c = datautils.fix_psi(psi, len(Y), model.sdX, True)

    def timed_evals(cfg, params, data, iters=20):
        @jax.jit
        def run(p0, d):
            def body(i, acc):
                p = jax.tree.map(lambda x: x + acc * 1e-30, p0)
                (f, aux), g = jax.value_and_grad(
                    lambda q: nlog_ml(q, d, cfg, complete=True),
                    has_aux=True,
                )(p)
                return acc + f + g.P[0, 0] * 1e-30
            return jax.lax.fori_loop(0, iters, body, 0.0)

        float(run(params, data))             # compile + warm
        t0 = time.perf_counter()
        float(run(params, data))
        return iters / (time.perf_counter() - t0)

    results = {"backend": jax.default_backend()}

    # --- the x0 probe at the trained point (what train() consults) ---
    cfg32 = dataclasses.replace(model.cfg, solve_mode="auto",
                                solve_dtype="auto")
    params32 = model.best.params
    data32 = _make_dataset(Xn, Yc, psi_c, omega, tr, jnp.float32)
    finite, fast_ok = jax.jit(
        probe_phase, static_argnames=("cfg", "complete")
    )(params32, data32, cfg32, complete=True)
    results["probe_pipeline_finite"] = bool(finite)
    results["fast_solve_ok_at_trained_point"] = bool(fast_ok)
    print(json.dumps({"case": "probe", "pipeline_finite": bool(finite),
                      "fast_solve_ok": bool(fast_ok)}))

    # --- the shipped continuation path at the trained point: the phase
    # train() starts in after the probe ---
    if not bool(finite):
        shipped_cfg = dataclasses.replace(
            model.cfg, dtype="float64", solve_mode="strict",
            solve_dtype="float64",
        )
        shipped_params = jax.tree.map(
            lambda a: a.astype(jnp.float64), params32
        )
        shipped_data = _make_dataset(Xn, Yc, psi_c, omega, tr, jnp.float64)
        shipped_label = "float64/strict"
        iters = 10
    elif not bool(fast_ok):
        shipped_cfg = dataclasses.replace(cfg32, solve_mode="mixed_strict")
        shipped_params, shipped_data = params32, data32
        shipped_label = "float32/mixed_strict"
        iters = 20
    else:
        shipped_cfg, shipped_params, shipped_data = cfg32, params32, data32
        shipped_label = "float32/mixed"
        iters = 20
    r = timed_evals(shipped_cfg, shipped_params, shipped_data, iters=iters)
    results["shipped_phase_at_trained_point"] = shipped_label
    # the headline key the round-4 verdict tracks: evals/s of what train()
    # actually executes at this point (no failed-fast-attempt double pay)
    results["mixed_evals_per_sec_trained_point"] = round(r, 2)
    print(json.dumps({"case": "shipped_trained", "phase": shipped_label,
                      "evals_per_sec": round(r, 2)}))

    # --- solve-level fast-vs-strict on the trained (finite, f64) Gram ---
    cfg64 = dataclasses.replace(model.cfg, dtype="float64",
                                solve_mode="strict", solve_dtype="float64")
    params64 = jax.tree.map(lambda a: a.astype(jnp.float64), params32)
    data64 = _make_dataset(Xn, Yc, psi_c, omega, tr, jnp.float64)
    gt = jax.jit(lambda p, d: _gram_terms(p, cfg64, d, True)[5:9])
    SIGMA, logdet, w, rhs = jax.block_until_ready(gt(params64, data64))
    dg = np.diagonal(np.asarray(SIGMA), axis1=-2, axis2=-1)
    results["trained_gram_finite"] = bool(np.isfinite(np.asarray(SIGMA)).all())
    results["fast_solve_ok_trained_f64_gram"] = bool(
        jax.jit(linalg.fast_solve_ok)(SIGMA, rhs)
    )

    def timed_solve(fn, iters=50):
        @jax.jit
        def run(S, r):
            def body(i, acc):
                w, ld = fn(S + acc * 1e-300, r)
                return acc + w[0, 0] * 1e-300 + ld[0] * 1e-300
            return jax.lax.fori_loop(0, iters, body, 0.0)
        float(run(SIGMA, rhs))
        t0 = time.perf_counter()
        float(run(SIGMA, rhs))
        return (time.perf_counter() - t0) / iters * 1e3

    results["solve_ms_fast"] = round(timed_solve(linalg.fast_solve_w_logdet), 3)
    results["solve_ms_strict"] = round(timed_solve(linalg.solve_w_logdet), 3)
    print(json.dumps({"case": "solve_level",
                      "ok": results["fast_solve_ok_trained_f64_gram"],
                      "fast_ms": results["solve_ms_fast"],
                      "strict_ms": results["solve_ms_strict"]}))

    # --- f64 refine phase at the trained point (reference number) ---
    r64 = timed_evals(cfg64, params64, data64, iters=10)
    results["f64_refine_evals_per_sec_trained_point"] = round(r64, 2)
    print(json.dumps({"case": "f64_refine_trained",
                      "evals_per_sec": round(r64, 2)}))

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as fh:
        json.dump(results, fh, indent=1)
    print(json.dumps({"written": os.path.basename(OUT)}))


if __name__ == "__main__":
    main()
