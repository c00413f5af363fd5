"""Prediction-scale benchmark (VERDICT r2 item 4): wall clock of the
public predict API at m in {100, 1000} x {clean, noisy, noisy+missing},
so regressions at the north-star scale (BASELINE.json configs[4]) are
visible (an m=1000 noisy+missing path once crashed the device and no
bench existed to catch it).

Usage:  python benchmarks/predict_bench.py [--n 2000] [--nq 256]
Writes chiprun_out/predict_bench.json and prints one JSON line per
case (seconds are second-call, compile excluded).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                   "chiprun_out", "predict_bench.json")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--nq", type=int, default=256)
    args = ap.parse_args()

    import dataclasses

    import jax
    import jax.numpy as jnp
    import gpz_tpu

    rng = np.random.default_rng(4)
    d = 5
    results = []
    for m in (100, 1000):
        X = rng.standard_normal((args.n, d))
        y = np.sin(X[:, 0]) + 0.1 * rng.standard_normal(args.n)
        psi = 0.01 + 0.05 * rng.random((args.n, d))
        model = gpz_tpu.init(X, y, "VC", m, psi=psi, seed=0)

        # trained models carry EM-collapsed mixture priors (most bases at
        # exactly 0 mass; ref getPrior.m fixed point — see predict._log_
        # priors) and therefore peaked responsibilities that keep the
        # top-L truncation within its coverage guard. The fresh init here
        # has FLAT priors, whose guard correctly escalates every missing
        # batch to the exact full mixture. Bench both: "_collapsed" is the
        # production (trained-model) path, plain "noisy_missing" the
        # flat-responsibility worst case.
        n_live = min(m, 48)
        priors_c = np.zeros(m)
        priors_c[rng.choice(m, n_live, replace=False)] = 1.0 / n_live
        model_c = dataclasses.replace(
            model,
            best=dataclasses.replace(
                model.best, priors=jnp.asarray(priors_c, jnp.float32)
            ),
        )

        Xq_clean = rng.standard_normal((args.nq, d))
        Xq_miss = Xq_clean.copy()
        Xq_miss[-args.nq // 4:, 2] = np.nan
        psiq = 0.02 * np.ones((args.nq, d))
        cases = [
            ("clean", Xq_clean, None, model),
            ("noisy", Xq_clean, psiq, model),
            ("noisy_missing", Xq_miss, psiq, model),
            ("noisy_missing_collapsed", Xq_miss, psiq, model_c),
        ]
        for label, Xq, pq, mdl in cases:
            gpz_tpu.predict(Xq, mdl, psi=pq)       # compile + warm
            t0 = time.perf_counter()
            pred = gpz_tpu.predict(Xq, mdl, psi=pq)
            dt = time.perf_counter() - t0
            row = {
                "m": m, "case": label, "nq": args.nq,
                "seconds": round(dt, 3),
                "rows_per_sec": round(args.nq / dt, 1),
                "finite": bool(np.isfinite(pred.sigma).all()
                               and np.isfinite(pred.mu).all()),
                "backend": jax.default_backend(),
            }
            results.append(row)
            print(json.dumps(row), flush=True)

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as fh:
        json.dump({"results": results}, fh, indent=1)


if __name__ == "__main__":
    main()
