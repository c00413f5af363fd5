"""On-GPU tests — the compiled device path on a real card.

The rest of the suite validates numerics on the virtual CPU mesh (conftest
pins the CPU); these exercise what only the card compiles: the objective on
the resolved default numerics path inside the jitted L-BFGS while-loop, and
the prediction stack up to the m=1000 scale (BASELINE.json configs[4]).

Run on a machine with a GPU:

    GPZ_GPU_TESTS=1 python -m pytest tests/test_gpu.py -m gpu -q

Each test takes the `gpu` fixture, which skips it when the default device is
not a GPU (always the case under the default conftest). `chip_smoke.py`
covers the same path at full size, compared with the CPU float64 reference.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


def _vc_problem(n, m, d=5, k=1, seed=0):
    from gpz_tpu.config import ModelConfig
    from gpz_tpu.dataset import Dataset
    from gpz_tpu.params import GPzParams

    rng = np.random.default_rng(seed)
    cfg = ModelConfig(m=m, d=d, k=k, method="VC", dtype="float32")
    X = rng.standard_normal((n, d)).astype(np.float32)
    Y = (X @ rng.standard_normal((d, k)) * 0.3
         + 0.1 * rng.standard_normal((n, k))).astype(np.float32)
    psi = np.zeros((n, d, d), np.float32)
    psi[:, np.arange(d), np.arange(d)] = 0.05 + 0.1 * rng.random((n, d))
    data = Dataset(
        X=jnp.asarray(X), mask=jnp.ones((n, d), bool),
        omega=jnp.ones((n,), jnp.float32),
        Y=jnp.asarray(Y), psi=jnp.asarray(psi),
    )
    gam = np.zeros((m, d, d), np.float32)
    gam[:, np.arange(d), np.arange(d)] = 1.0 + 0.1 * rng.random((m, d))
    params = GPzParams(
        P=jnp.asarray(rng.standard_normal((m, d)).astype(np.float32)),
        gamma=jnp.asarray(gam),
        ln_alpha=jnp.zeros((m, k), jnp.float32),
        b=jnp.zeros((k,), jnp.float32),
        v=jnp.zeros((m, k), jnp.float32),
        ln_tau=jnp.zeros((m, k), jnp.float32),
    )
    return cfg, params, data


def test_lbfgs_default_path_5_iters(gpu):
    """Five L-BFGS iterations of the VC objective on the resolved default
    numerics path: finite, monotone non-increasing trace, healthy status."""
    from gpz_tpu.objective import nlog_ml
    from gpz_tpu.optim import minimize
    from gpz_tpu.optim.lbfgs import (
        STATUS_MAX_ITER, STATUS_OPTIMAL, STATUS_STEP_TOO_SMALL,
    )
    from jax.flatten_util import ravel_pytree

    cfg, params, data = _vc_problem(n=4096, m=32)
    assert cfg.resolved_solve_mode() == "strict"
    flat0, unravel = ravel_pytree(params)
    vg = jax.value_and_grad(
        lambda p, d: nlog_ml(p, d, cfg, complete=True), has_aux=True
    )

    def fun(x, d):
        (f, aux), g = vg(unravel(x), d)
        return f, ravel_pytree(g)[0], aux

    res = minimize(fun, flat0, args=(data,), max_iter=5)
    n_it = int(res.iterations)
    f = np.asarray(res.trace["f"][: n_it + 1])
    assert np.all(np.isfinite(f))
    assert np.all(np.diff(f) <= 1e-7), f
    assert int(res.status) in (
        STATUS_MAX_ITER, STATUS_OPTIMAL, STATUS_STEP_TOO_SMALL,
    )


def test_predict_small_with_missing_pattern(gpu):
    """Train-free predict on the card: clean + noisy + one missing pattern
    through the public model API."""
    import gpz_tpu

    rng = np.random.default_rng(3)
    n, d = 400, 4
    X = rng.standard_normal((n, d))
    y = np.sin(X[:, 0]) + 0.1 * rng.standard_normal(n)
    psi = (0.01 + 0.05 * rng.random((n, d)))
    model = gpz_tpu.init(X, y, "VC", 24, psi=psi, seed=0)

    Xq = rng.standard_normal((64, d))
    Xq[-16:, 1] = np.nan                       # one missing pattern
    psiq = 0.02 * np.ones((64, d))
    pred = gpz_tpu.predict(Xq, model, psi=psiq)
    for name in ("mu", "sigma", "nu", "beta_i", "gamma"):
        v = getattr(pred, name)
        assert np.all(np.isfinite(v)), name
    assert np.all(pred.sigma > 0)


def test_predict_m1000_noisy_missing(gpu):
    """The m=1000 scale config (BASELINE.json configs[4]): VC m=1000,
    noisy + missing rows, through the public predict API. Pass = finite
    outputs and sigma > 0."""
    import gpz_tpu

    rng = np.random.default_rng(4)
    n, d, m = 2000, 5, 1000
    X = rng.standard_normal((n, d))
    y = np.sin(X[:, 0]) + 0.1 * rng.standard_normal(n)
    psi = 0.01 + 0.05 * rng.random((n, d))
    model = gpz_tpu.init(X, y, "VC", m, psi=psi, seed=0)

    nq = 256
    Xq = rng.standard_normal((nq, d))
    Xq[-64:, 2] = np.nan
    psiq = 0.02 * np.ones((nq, d))
    pred = gpz_tpu.predict(Xq, model, psi=psiq)
    assert np.all(np.isfinite(pred.mu))
    assert np.all(np.isfinite(pred.sigma))
    assert np.all(pred.sigma > 0)
