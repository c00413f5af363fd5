"""Device time of the VC design matrix (forward, forward + backward) and of
one objective value+gradient eval, from a jax.profiler trace, on a GPU.

North-star shape (bench.make_problem): n=100k rows, d=5 bands with full
(d, d) input-noise covariances, m=100 VC basis functions, float32 design
matrix. For each program it reports:

  * host-clock seconds per call (block_until_ready, profiler off),
  * device busy seconds per call: the union of the GPU kernel intervals in a
    traced window, divided by the calls in it,
  * the longest kernels by summed device time,
  * XLA's cost analysis (flops, bytes accessed) and, from the peak table
    below, the roofline share: max(flops / peak flops, bytes / peak
    bandwidth) / device time.

Writes the full result to chiprun_out/trace_design_matrix.json and prints
one JSON line per program. Needs a GPU; exits non-zero without one.

    python benchmarks/trace_design_matrix.py [--rows 100000] [--m 100]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

#: published dense peaks (NVIDIA H100 SXM data sheet; full 700 W limit):
#: float32 outside the tensor cores and float64 on them are both 67 TFLOP/s;
#: HBM bandwidth 3.35 TB/s
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": 67e12, "bytes_per_s": 3.35e12},
}


def device_intervals(xplane_path):
    """{kernel name: [(start_ns, end_ns), ...]} over the GPU planes'
    stream lines (XLA's own "XLA Modules"/"XLA Ops" summary lines and the
    host planes are skipped)."""
    pd = jax.profiler.ProfileData.from_file(xplane_path)
    out = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith("XLA"):
                continue
            for ev in line.events:
                out.setdefault(ev.name, []).append(
                    (ev.start_ns, ev.start_ns + ev.duration_ns))
    return out


def busy_ns(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def plane_summary(xplane_path):
    pd = jax.profiler.ProfileData.from_file(xplane_path)
    return {p.name: [ln.name for ln in p.lines] for p in pd.planes}


def measure(name, fn, args, reps, window):
    fn = fn.lower(*args).compile()
    cost = fn.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    jax.block_until_ready(fn(*args))                     # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    host_s = (time.perf_counter() - t0) / reps

    tdir = tempfile.mkdtemp(prefix=f"trace_{name}_")
    with jax.profiler.trace(tdir):
        for _ in range(window):
            out = fn(*args)
        jax.block_until_ready(out)
    path = sorted(glob.glob(f"{tdir}/plugins/profile/*/*.xplane.pb"))[-1]
    ivs = device_intervals(path)
    all_ivs = [iv for v in ivs.values() for iv in v]
    per_kernel = sorted(
        ((k, sum(e - s for s, e in v) / window / 1e9, len(v) // window)
         for k, v in ivs.items()),
        key=lambda t: -t[1],
    )
    return {
        "program": name,
        "host_seconds_per_call": host_s,
        "device_busy_seconds_per_call": busy_ns(all_ivs) / window / 1e9,
        "kernels_per_call": len(all_ivs) / window,
        "top_kernels": [
            {"name": k[:120], "seconds_per_call": t, "launches_per_call": c}
            for k, t, c in per_kernel[:10]
        ],
        "xla_flops": float(cost.get("flops", float("nan"))),
        "xla_bytes_accessed": float(cost.get("bytes accessed", float("nan"))),
        "trace_planes": plane_summary(path),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--window", type=int, default=5)
    args = ap.parse_args()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, the default device is {dev.platform!r}")
    from bench import card_lines, make_problem

    card = card_lines().splitlines()[0]
    from gpz_tpu.objective import nlog_ml
    from gpz_tpu.phi import design_matrix

    cfg, params, data = make_problem(n=args.rows, m=args.m)
    n, d, m = args.rows, data.d, args.m
    C = jnp.asarray(np.random.default_rng(0).standard_normal((n, m)),
                    jnp.float32)

    def phi_only(p):
        PHI, _, ln_beta = design_matrix(p, cfg, data.X, data.mask, data.psi,
                                        complete=True)
        return PHI, ln_beta

    def phi_fwd_bwd(p):
        return jax.grad(lambda q: jnp.sum(phi_only(q)[0] * C))(p)

    def objective(p):
        return jax.value_and_grad(
            lambda q: nlog_ml(q, data, cfg, complete=True)[0])(p)

    # bytes a fused kernel must move at least: inputs X, psi and the (n, m)
    # f32 activations out (forward); the backward reads the cotangent too
    min_fwd = 4 * (n * d + n * d * d + n * m + n)
    results = []
    for name, fn, min_bytes in (
        ("design_matrix_fwd", jax.jit(phi_only), min_fwd),
        ("design_matrix_fwd_bwd", jax.jit(phi_fwd_bwd), min_fwd + 4 * n * m),
        ("objective_value_grad", jax.jit(objective), None),
    ):
        r = measure(name, fn, (params,), args.reps, args.window)
        r.update({"shape": {"n": n, "d": d, "m": m, "method": cfg.method},
                  "min_bytes": min_bytes, "platform": dev.platform,
                  "device_kind": dev.device_kind, "card": card,
                  "solve_mode": cfg.resolved_solve_mode()})
        results.append(r)
        print(json.dumps({k: v for k, v in r.items()
                          if k not in ("trace_planes", "top_kernels")}),
              flush=True)

    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/trace_design_matrix.json", "w") as fh:
        json.dump(results, fh, indent=1)

    if dev.device_kind not in PEAKS:
        raise SystemExit(f"no peak rates for device_kind "
                         f"{dev.device_kind!r}; add it to PEAKS")
    pk = PEAKS[dev.device_kind]
    for r in results:
        t = r["device_busy_seconds_per_call"]
        bound_f = r["xla_flops"] / pk["flops"]
        bound_b = r["xla_bytes_accessed"] / pk["bytes_per_s"]
        print(json.dumps({
            "program": r["program"],
            "roofline_share": max(bound_f, bound_b) / t,
            "bound": "bytes" if bound_b >= bound_f else "flops",
            "achieved_bytes_per_s": r["xla_bytes_accessed"] / t,
            "achieved_flops_per_s": r["xla_flops"] / t,
            "device_kind": dev.device_kind, "card": card,
        }), flush=True)


if __name__ == "__main__":
    main()
