"""Recorded demo-parity table (BASELINE.md protocol step 2; VERDICT r1
item 6 / r2 missing #2).

For each reference demo scenario (ref demo_sinc.m, demo_2D.m,
demo_photoz.m), runs the SAME seeded data through two pipelines:

  * reference: dtype float64 + strict f64 reductions on CPU — the
    port-of-record configuration (the reference pipeline is MATLAB f64
    end to end; the objective itself is FD-validated against
    tests/reference_impl.py),
  * shipped: the default float32 config (float32 design matrix with the
    platform's default reductions + automatic f64 refine,
    TrainConfig.refine="auto") on whatever backend is active — recorded
    with its platform, device kind and, on a GPU, the card's name and
    power limit.

and records final log-ML, test RMSE / MLL (+ FR15/FR05/bias for photo-z)
into PARITY_NUMBERS.json with tolerances. tests/test_parity_numbers.py
asserts a shipped-config run lands inside the recorded bands.

Usage:  python benchmarks/parity_numbers.py [--quick]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                   "PARITY_NUMBERS.json")


# ---------------------------------------------------------------------------
# seeded data generators — mirror demos/demo_sinc.py, demo_2d.py,
# demo_photoz.py exactly (same seeds, same draw order)
# ---------------------------------------------------------------------------

def sinc_data(n=10_000, seed=1):
    import gpz_tpu

    rng = np.random.default_rng(seed)
    fx = lambda x: np.sinc(x / math.pi)                       # noqa: E731
    sx = lambda x: 0.05 + (1 / (1 + np.exp(-0.2 * x))) * (   # noqa: E731
        1 + np.sin(2 * x)) * 0.2
    X = np.linspace(-10, 10, n)
    X = X[(X < -7) | (X > -2)]
    n = len(X)
    Y = fx(X) + rng.standard_normal(n) * sx(X)
    E, V = 0.5, 0.25
    psi = rng.gamma(E**2 / V, V / E, size=n)
    X = X + rng.standard_normal(n) * np.sqrt(psi)
    tr, va, te = gpz_tpu.datautils.split(n, 0.7, 0.15, 0.15, rng)
    return X[:, None], Y, psi, None, tr, va, te


def twod_data(seed=1, n_per=1000):
    import gpz_tpu

    rng = np.random.default_rng(seed)
    means = [np.array([10, 0]), np.array([10, 10]), np.array([5, 5])]
    covs = [np.array([[10.0, 0], [0, 1]]),
            np.array([[5.0, -3], [-3, 3]]),
            np.array([[2.0, 0], [0, 2]])]
    X = np.vstack([rng.multivariate_normal(mu, C, n_per)
                   for mu, C in zip(means, covs)])
    n = X.shape[0]

    def mvnpdf(x, mu, C):
        diff = x - mu
        Ci = np.linalg.inv(C)
        q = np.einsum("nd,de,ne->n", diff, Ci, diff)
        return np.exp(-0.5 * q) / (2 * np.pi * np.sqrt(np.linalg.det(C)))

    PHI = np.stack([mvnpdf(X, mu, C) for mu, C in zip(means, covs)], axis=1)
    w = np.array([-9.0, 6.0, 3.0])
    Y = PHI @ w + rng.standard_normal(n) * 0.01
    E, V = 0.5, 0.25
    psi = rng.gamma(E**2 / V, V / E, size=(n, 2))
    Xn = X + rng.standard_normal((n, 2)) * np.sqrt(psi)
    r = rng.permutation(n)
    psize = int(np.ceil(0.5 * n / 2))
    Xn[r[:psize], 0] = np.nan
    Xn[r[psize: 2 * psize], 1] = np.nan
    tr, va, te = gpz_tpu.datautils.split(n, 0.7, 0.15, 0.15, rng)
    return Xn, Y, psi, None, tr, va, te


def photoz_data(n=20_000, seed=1):
    import gpz_tpu
    from gpz_tpu.data import synthetic_sdss

    mags, errs, z = synthetic_sdss(n=n, seed=seed)
    psi = errs**2
    rng = np.random.default_rng(seed)
    tr, va, te = gpz_tpu.datautils.split(len(z), 0.2, 0.2, 0.6, rng)
    omega = gpz_tpu.datautils.get_omega(z, "normal", 0.1)
    return mags, z, psi, omega, tr, va, te


CONFIGS = {
    # name: (data_fn, data_kwargs, method, m)
    "sinc_VL_m100": (sinc_data, {}, "VL", 100),
    "sinc_VL_m50_small": (sinc_data, {"n": 4000}, "VL", 50),  # CI-test size
    "twod_VD_m50": (twod_data, {}, "VD", 50),
    "photoz_VC_m100": (photoz_data, {}, "VC", 100),
}


def _cache_state():
    """(n_entries, bytes) of the persistent XLA compile cache — recorded next
    to every wall-clock figure so 'seconds' are interpretable (VERDICT r3
    weak #3: numbers recorded with unknown cache state aren't evidence)."""
    import jax

    cache_dir = jax.config.jax_compilation_cache_dir
    if not cache_dir or not os.path.isdir(cache_dir):
        return 0, 0
    sizes = [
        os.path.getsize(os.path.join(cache_dir, f))
        for f in os.listdir(cache_dir)
        if os.path.isfile(os.path.join(cache_dir, f))
    ]
    return len(sizes), sum(sizes)


def _device_info():
    """Platform and device kind of the run; on a GPU also the card's name
    and power limit (nvidia-smi), which every card timing carries."""
    import jax

    from bench import card_lines

    dev = jax.devices()[0]
    info = {"platform": dev.platform, "device_kind": dev.device_kind}
    if dev.platform == "gpu":
        info["card"] = card_lines().splitlines()[0]
    return info


def run_config(name, pipeline, max_iter=200, max_attempts=50):
    """pipeline: 'reference' (f64 end-to-end) or 'shipped' (f32 defaults)."""
    import gpz_tpu
    from gpz_tpu import metrics as M

    data_fn, kw, method, m = CONFIGS[name]
    X, Y, psi, omega, tr, va, te = data_fn(**kw)
    if pipeline == "reference":
        init_kw = dict(dtype="float64", solve_mode="strict",
                       solve_dtype="float64")
    else:
        init_kw = dict(dtype="float32")
    cache_n0, cache_b0 = _cache_state()
    t0 = time.time()
    model = gpz_tpu.init(X, Y, method, m, heteroscedastic=True, training=tr,
                         psi=psi, omega=omega, seed=1, **init_kw)
    model = gpz_tpu.train(model, X, Y, training=tr, validation=va, psi=psi,
                          omega=omega, max_iter=max_iter,
                          max_attempts=max_attempts, verbose=False)
    pred = gpz_tpu.predict(X, model, psi=psi, selection=te)
    y = (Y if Y.ndim == 1 else Y[:, 0])[te]
    mu, sigma = pred.mu[:, 0], pred.sigma[:, 0]
    err = y - mu
    out = {
        "pipeline": pipeline,
        "log_ml": -float(model.fit_info["final_nlml"]),
        "best_valid_ll": float(model.best.score),
        "rmse": float(np.sqrt(np.mean(err**2))),
        "mll": float(np.mean(-0.5 * err**2 / sigma - 0.5 * np.log(sigma))
                     - 0.5 * math.log(2 * math.pi)),
        "iterations": int(model.fit_info["iterations"]),
        "status": int(model.fit_info["status"]),
        "seconds": round(time.time() - t0, 1),
        # cold/warm context for the wall clock: entries already in the
        # persistent compile cache before this run, and added by it
        "cache_entries_before": cache_n0,
        "cache_entries_added": _cache_state()[0] - cache_n0,
        **_device_info(),
    }
    if name.startswith("photoz"):
        out["fr15"] = float(M.cumulative_by_confidence(y, mu, sigma, M.fr15)[-1])
        out["fr05"] = float(M.cumulative_by_confidence(y, mu, sigma, M.fr05)[-1])
        out["bias"] = float(M.cumulative_by_confidence(y, mu, sigma, M.bias)[-1])
    return out


#: acceptance bands: the optimizer is seeded but trajectories differ across
#: precision pipelines, so parity = landing in the same quality regime
#: (SURVEY §7 hard part (b): parity is >= reference log-ML-quality, not
#: identical theta)
TOLERANCES = {
    "rmse": 0.10,          # relative
    "mll": 0.15,           # absolute (it is a mean log density)
    "best_valid_ll": 0.15, # absolute
    # photo-z quality-curve metrics (ref demo_photoz.m:89-105): fr15/fr05
    # are percentages of test points within |dz|/(1+z) thresholds (higher
    # is better), bias is a signed mean (band on |bias|)
    "fr15": 1.0,           # absolute percentage points
    "fr05": 2.0,           # absolute percentage points
    "bias": 0.002,         # absolute
}


def check_parity(table, tolerances=TOLERANCES):
    """Violations of the shipped-vs-reference bands. NaN anywhere in a
    compared metric reads as a violation (NaN comparisons are silently
    False, so every band is written as `not (ok)`)."""
    bad = []
    for name, entry in table.items():
        ref, sh = entry.get("reference"), entry.get("shipped")
        if not ref or not sh:
            continue
        if not (sh["rmse"] <= ref["rmse"] * (1 + tolerances["rmse"])):
            bad.append((name, "rmse", sh["rmse"], ref["rmse"]))
        if not (sh["mll"] >= ref["mll"] - tolerances["mll"]):
            bad.append((name, "mll", sh["mll"], ref["mll"]))
        for key in ("fr15", "fr05"):
            if key in ref and not (sh.get(key, math.nan)
                                   >= ref[key] - tolerances[key]):
                bad.append((name, key, sh.get(key), ref[key]))
        if "bias" in ref and not (
            abs(sh.get("bias", math.nan))
            <= abs(ref["bias"]) + tolerances["bias"]
        ):
            bad.append((name, "bias", sh.get("bias"), ref["bias"]))
    return bad


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="only the small CI config")
    ap.add_argument("--skip-reference", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (leave the GPU alone)")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    names = (["sinc_VL_m50_small"] if args.quick else list(CONFIGS))
    table = {}
    if os.path.exists(OUT):
        with open(OUT) as fh:
            table = json.load(fh).get("configs", {})
    for name in names:
        entry = table.get(name, {})
        if not args.skip_reference:
            ref = run_config(name, "reference")
            entry["reference"] = ref
            print(json.dumps({"config": name, **ref}), flush=True)
        shipped = run_config(name, "shipped")
        entry["shipped"] = shipped
        print(json.dumps({"config": name, **shipped}), flush=True)
        table[name] = entry

    # the harness REFUSES to persist a table that fails its own bands or
    # contains a non-finite compared metric (VERDICT r3 weak #1: a NaN mll
    # was committed and masked a live violation for a whole round)
    bad = check_parity(table)
    for b in bad:
        print("PARITY VIOLATION:", b)
    if bad:
        print(json.dumps({"parity_ok": False, "n_configs": len(table),
                          "persisted": False}))
        raise SystemExit(
            f"REFUSING to write {os.path.basename(OUT)}: "
            f"{len(bad)} band violation(s) — fix the regression first "
            "(the old table is left untouched)"
        )

    payload = {"tolerances": TOLERANCES, "configs": table}
    with open(OUT, "w") as fh:
        json.dump(payload, fh, indent=1)
    print(json.dumps({"parity_ok": True, "n_configs": len(table),
                      "persisted": True}))


if __name__ == "__main__":
    main()
