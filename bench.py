"""Benchmark: log-ML gradient evals/s on the SDSS-like VC config, on a GPU.

The north-star shape (BASELINE.json): SDSS photo-z (d=5 magnitudes, input
noise), VC covariance, m=100 bases, heteroscedastic, n=100k rows — the cost
of one training objective+gradient evaluation, which dominates wall clock
(each L-BFGS iteration is 1-3 of these; SURVEY §3.2).

Needs a GPU: exits non-zero, printing no result, when the default JAX device
is anything else. Prints the device (platform, device_kind, count) and the
card's name and power limit, then ONE JSON line:
{"metric": ..., "value": N, "unit": ..., "vs_baseline", "device": {...}}.
vs_baseline is measured against the reference-derived budget of 60 s to
converged log-ML on one host (BASELINE.json): assuming ~250 grad evals to
convergence (200 iters x 1.25 evals), the baseline rate is ~4.2 evals/s.
"""

import json
import subprocess
import time

import numpy as np
import jax
import jax.numpy as jnp

from gpz_tpu.config import ModelConfig
from gpz_tpu.dataset import Dataset
from gpz_tpu.params import GPzParams
from gpz_tpu.objective import nlog_ml


def card_lines() -> str:
    """Each GPU's name and power limit, one line per card, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them; every card timing is recorded beside them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def make_problem(n=100_000, d=5, m=100, k=1, method="VC", dtype=jnp.float32,
                 seed=0):
    rng = np.random.default_rng(seed)
    cfg = ModelConfig(m=m, d=d, k=k, method=method, dtype="float32")
    X = rng.standard_normal((n, d)).astype(dtype)
    Y = (X @ rng.standard_normal((d, k)) * 0.3
         + 0.1 * rng.standard_normal((n, k))).astype(dtype)
    psi = np.zeros((n, d, d), dtype=dtype)
    psi[:, np.arange(d), np.arange(d)] = 0.05 + 0.1 * rng.random((n, d))
    data = Dataset(
        X=jnp.asarray(X),
        mask=jnp.ones((n, d), bool),
        omega=jnp.ones((n,), dtype),
        Y=jnp.asarray(Y),
        psi=jnp.asarray(psi),
    )
    gam = np.zeros((m, d, d), dtype=dtype)
    gam[:, np.arange(d), np.arange(d)] = 1.0 + 0.1 * rng.random((m, d))
    params = GPzParams(
        P=jnp.asarray(rng.standard_normal((m, d)).astype(dtype)),
        gamma=jnp.asarray(gam),
        ln_alpha=jnp.zeros((m, k), dtype),
        b=jnp.zeros((k,), dtype),
        v=jnp.zeros((m, k), dtype),
        ln_tau=jnp.zeros((m, k), dtype),
    )
    return cfg, params, data


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU, the default JAX device is "
                         f"{dev.platform!r}")
    card = card_lines().splitlines()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": card}
    print(f"device: {device}", flush=True)
    cfg, params, data = make_problem()

    # amortize over an on-device loop so the host clock measures device
    # work, not per-call dispatch. The tiny data-dependent perturbation
    # defeats loop-invariant hoisting.
    iters = 20

    @jax.jit
    def run(params, data):
        def body(i, acc):
            p = jax.tree.map(lambda x: x + acc * 1e-30, params)
            (f, aux), g = jax.value_and_grad(
                lambda q: nlog_ml(q, data, cfg, complete=True), has_aux=True
            )(p)
            return acc + f + g.P[0, 0] * 1e-30
        return jax.lax.fori_loop(0, iters, body, 0.0)

    float(run(params, data))  # compile + warm up
    t0 = time.perf_counter()
    float(run(params, data))
    dt = time.perf_counter() - t0

    evals_per_sec = iters / dt
    baseline_rate = 250.0 / 60.0  # ~converged run inside the 60 s budget
    print(json.dumps({
        "metric": "logML_grad_evals_per_sec_VC_m100_n100k",
        "value": evals_per_sec,
        "unit": "evals/s/device",
        "vs_baseline": evals_per_sec / baseline_rate,
        "solve_mode": cfg.resolved_solve_mode(),
        "device": device,
    }))


if __name__ == "__main__":
    main()
