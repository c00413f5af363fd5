"""Scaling-efficiency harness (the north-star ">0.8 efficiency" metric,
BASELINE.json): weak-scaling of the SPMD objective over the data mesh axis.

For each device count D, runs the n-sharded objective+gradient with n = D *
ROWS_PER_DEVICE rows and reports throughput (rows/s) and parallel efficiency
relative to D=1 (rows/s/device ratio). On a multi-GPU host run as-is;
on a single-GPU/dev box use --cpu to measure over the virtual CPU mesh
(validates the collective layout, not silicon speed).

Usage:
  python benchmarks/scaling.py [--cpu] [--rows 25000] [--m 100] [--method VC]

Prints one JSON line per device count plus a summary line.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="force an 8-device virtual CPU mesh")
    ap.add_argument("--rows", type=int, default=25_000,
                    help="rows per device (weak scaling)")
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--d", type=int, default=5)
    ap.add_argument("--method", default="VC")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed repetitions; min and median are reported "
                    "(single-shot timings on a shared host produced "
                    "super-linear 'efficiencies' — VERDICT r3 weak #6)")
    args = ap.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        )

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from bench import make_problem
    from gpz_tpu.parallel import make_mesh, shard_dataset, sharded_nlog_ml
    from gpz_tpu.dataset import Dataset

    n_dev_total = len(jax.devices())
    counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= n_dev_total]

    results = []
    for D in counts:
        n = args.rows * D
        cfg, params, data = make_problem(
            n=n, d=args.d, m=args.m, method=args.method,
        )
        mesh = make_mesh(n_data=D, n_restart=1,
                         devices=jax.devices()[:D])
        sdata, n_eff = shard_dataset(data, mesh)

        def loss(p):
            return sharded_nlog_ml(p, sdata, cfg, mesh, n_eff, complete=True)[0]

        @jax.jit
        def run(p):
            def body(i, acc):
                g = jax.grad(loss)(jax.tree.map(lambda x: x + acc * 1e-30, p))
                return acc + g.P[0, 0]
            return jax.lax.fori_loop(0, args.iters, body, 0.0)

        float(run(params))  # compile
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            float(run(params))
            times.append((time.perf_counter() - t0) / args.iters)
        dt_min = min(times)
        dt_med = float(np.median(times))
        rows_per_s = n / dt_min          # min = least-contended shot
        results.append((D, rows_per_s))
        print(json.dumps({
            "devices": D, "rows": n,
            "rows_per_sec": round(rows_per_s, 1),
            "ms_per_grad_eval_min": round(dt_min * 1e3, 2),
            "ms_per_grad_eval_median": round(dt_med * 1e3, 2),
            "repeats": args.repeats,
        }))

    base = results[0][1] / results[0][0]
    # the raw ratio is preserved next to the capped one: >1 is measurement
    # noise by construction of weak scaling, but clamping alone would make
    # a saturated measurement indistinguishable from a clean one
    # (ADVICE r4 #5)
    raw = {D: (r / D) / base for D, r in results}
    effs = {D: min(1.0, e) for D, e in raw.items()}
    from gpz_tpu.objective import ozaki_active

    # on a virtual CPU mesh the D devices share the same physical cores,
    # so per-device efficiency is bounded by cores/D regardless of the
    # collective layout; the meaningful number there is TOTAL-throughput
    # retention as the mesh grows (how much the psum boundaries cost).
    # On real multi-chip hardware per-device efficiency is the metric.
    best_total = max(r for _, r in results)
    retention = results[-1][1] / best_total
    summary = {
        "metric": "weak_scaling_efficiency",
        "raw_rows_per_sec": {str(D): round(r, 1) for D, r in results},
        "per_device": {str(D): round(e, 3) for D, e in effs.items()},
        "per_device_raw": {str(D): round(e, 3) for D, e in raw.items()},
        "max_devices_efficiency": round(effs[results[-1][0]], 3),
        "total_throughput_retention_at_max_dev": round(retention, 3),
        # provenance: the numerics path the objective took (GPZ_OZAKI=1
        # forces the Ozaki Gram)
        "provenance": {
            "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
            "ozaki_gram_active": bool(ozaki_active()),
            "rows_per_device": args.rows,
            "m": args.m, "d": args.d, "method": args.method,
            "repeats": args.repeats,
        },
        "interpretation": (
            "virtual CPU mesh: devices share physical cores, so "
            "per-device efficiency is core-bounded; total-throughput "
            "retention isolates the collective-layout cost"
            if jax.default_backend() == "cpu" else
            "real multi-device mesh: per_device is the headline"
        ),
    }
    print(json.dumps(summary))
    out_file = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        os.environ.get("GPZ_SCALING_OUT", "chiprun_out/scaling.json"),
    )
    os.makedirs(os.path.dirname(out_file), exist_ok=True)
    with open(out_file, "w") as fh:
        json.dump(summary, fh, indent=1)


if __name__ == "__main__":
    main()
