"""Objective parity + gradient checks (the reference's own methodology:
finite differences vs the analytic gradient, ref minFunc/autoDif/derivativeCheck.m
— here finite differences vs jax.grad, across methods x {het} x {psi} x
{missing})."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gpz_tpu.config import ModelConfig
from gpz_tpu.dataset import Dataset
from gpz_tpu.objective import nlog_ml, posterior, holdout_metrics

from reference_impl import ref_nlog_ml
from test_phi import make_params, make_data


def build(rng, method, with_psi, with_missing, het, n=25, d=3, m=4, k=1):
    cfg = ModelConfig(m=m, d=d, k=k, method=method, heteroscedastic=het,
                      dtype="float64")
    params = make_params(rng, cfg)
    if not het:
        params = params.__class__(
            P=params.P, gamma=params.gamma, ln_alpha=params.ln_alpha,
            b=params.b, v=None, ln_tau=None,
        )
    X, psi = make_data(rng, n, d, with_psi, with_missing, cfg.full_cov)
    Y = rng.standard_normal((n, k))
    omega = 0.5 + rng.random(n)
    mask = ~np.isnan(X)
    data = Dataset(
        X=jnp.asarray(np.where(mask, X, 0.0)),
        mask=jnp.asarray(mask),
        omega=jnp.asarray(omega),
        Y=jnp.asarray(Y),
        psi=None if psi is None else jnp.asarray(psi),
    )
    return cfg, params, data, X, Y, psi, omega


CASES = [
    ("GL", False, False, True),
    ("VL", True, False, True),
    ("GD", False, True, True),
    ("VD", True, True, True),
    ("VD", True, False, False),
    ("GC", True, False, True),
    ("VC", False, True, True),
    ("VC", True, True, True),
]


@pytest.mark.parametrize("method", ["VL", "VC"])
def test_nlog_ml_parity_multi_output(rng, method):
    """k = 2 outputs: per-k Gram solves and the heteroscedastic prior terms
    (the reference's k-loop, GPz.m:61-75)."""
    cfg, params, data, X, Y, psi, omega = build(
        rng, method, True, False, True, k=2
    )
    got, aux = nlog_ml(params, data, cfg, complete=True)
    expect, w_expect = ref_nlog_ml(
        X, Y, psi, omega,
        np.asarray(params.P), np.asarray(params.gamma),
        np.asarray(params.ln_alpha), np.asarray(params.b),
        np.asarray(params.v), np.asarray(params.ln_tau), method,
    )
    np.testing.assert_allclose(float(got), expect, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(aux.w), w_expect, rtol=1e-7, atol=1e-9)


def test_check_gradient_utility(rng):
    from gpz_tpu.optim import check_gradient

    cfg, params, data, *_ = build(rng, "VD", True, False, True, n=12, m=3)
    flat0, unravel = params.flatten()
    ok, err = check_gradient(
        lambda x: nlog_ml(unravel(x), data, cfg, complete=True)[0], flat0
    )
    assert ok, err


@pytest.mark.parametrize("method,with_psi,with_missing,het", CASES)
def test_nlog_ml_parity(rng, method, with_psi, with_missing, het):
    cfg, params, data, X, Y, psi, omega = build(
        rng, method, with_psi, with_missing, het
    )
    got, aux = nlog_ml(params, data, cfg, complete=not with_missing)
    expect, w_expect = ref_nlog_ml(
        X, Y, psi, omega,
        np.asarray(params.P), np.asarray(params.gamma),
        np.asarray(params.ln_alpha), np.asarray(params.b),
        None if params.v is None else np.asarray(params.v),
        None if params.ln_tau is None else np.asarray(params.ln_tau),
        method,
    )
    np.testing.assert_allclose(float(got), expect, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(aux.w), w_expect, rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("method,with_psi,with_missing,het", CASES)
def test_gradient_vs_finite_differences(rng, method, with_psi, with_missing, het):
    cfg, params, data, *_ = build(
        rng, method, with_psi, with_missing, het, n=15, m=3
    )
    complete = not with_missing

    flat0, unravel = params.flatten()

    def f(flat):
        return nlog_ml(unravel(flat), data, cfg, complete=complete)[0]

    g = jax.grad(f)(flat0)
    eps = 1e-6
    fd = np.zeros_like(np.asarray(flat0))
    f0 = None
    for i in range(flat0.shape[0]):
        e = jnp.zeros_like(flat0).at[i].set(eps)
        fd[i] = (float(f(flat0 + e)) - float(f(flat0 - e))) / (2 * eps)
    np.testing.assert_allclose(np.asarray(g), fd, rtol=2e-4, atol=1e-7)


def test_padding_invariance(rng):
    """omega=0 padded rows must leave loss, grad and metrics unchanged."""
    from gpz_tpu.dataset import pad_dataset

    cfg, params, data, *_ = build(rng, "VD", True, False, True, n=20)
    f1, aux1 = nlog_ml(params, data, cfg, complete=True)
    padded = pad_dataset(data, 32)
    f2, aux2 = nlog_ml(
        params, padded, cfg, n_eff=jnp.asarray(20.0), complete=True
    )
    np.testing.assert_allclose(float(f1), float(f2), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(aux1.w), np.asarray(aux2.w), rtol=1e-10
    )
    np.testing.assert_allclose(
        float(aux1.train_rmse), float(aux2.train_rmse), rtol=1e-12
    )

    flat0, unravel = params.flatten()
    g1 = jax.grad(lambda t: nlog_ml(unravel(t), data, cfg, complete=True)[0])(flat0)
    g2 = jax.grad(
        lambda t: nlog_ml(
            unravel(t), padded, cfg, n_eff=jnp.asarray(20.0), complete=True
        )[0]
    )(flat0)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-9)


def test_posterior_matches_objective_aux(rng):
    cfg, params, data, *_ = build(rng, "VL", False, False, True)
    _, aux = nlog_ml(params, data, cfg, complete=True)
    post = posterior(params, data, cfg, complete=True)
    np.testing.assert_allclose(
        np.asarray(post.w), np.asarray(aux.w), rtol=1e-10
    )
    # iSigma_w is a true inverse of the Gram
    k, m = post.iSigma_w.shape[0], cfg.m
    assert post.iSigma_w.shape == (k, m, m)


def test_holdout_metrics_finite(rng):
    cfg, params, data, *_ = build(rng, "VL", False, False, True)
    _, aux = nlog_ml(params, data, cfg, complete=True)
    rmse, ll = holdout_metrics(params, aux.w, data, cfg, complete=True)
    assert np.isfinite(float(rmse)) and np.isfinite(float(ll))
    np.testing.assert_allclose(float(rmse), float(aux.train_rmse), rtol=1e-10)
    np.testing.assert_allclose(float(ll), float(aux.train_ll), rtol=1e-10)


@pytest.mark.parametrize("method,with_psi,with_missing,het", CASES)
def test_mixed_mode_matches_strict(rng, method, with_psi, with_missing, het):
    """The mixed solve mode (blockwise f32 Gram accumulation +
    f32 Cholesky with one f64 refinement of the posterior solve) must agree
    with the strict f64 path to f32-accumulation accuracy (~1e-6 value,
    looser on gradients). Exercised on CPU by forcing solve_mode."""
    import dataclasses as _dc

    cfg, params, data, *_ = build(
        rng, method, with_psi, with_missing, het, n=120, m=6
    )
    # mixed mode accumulates f32 partials: feed it the f32 compute dtype
    cfg32 = _dc.replace(cfg, dtype="float32")
    params32 = jax.tree.map(lambda x: x.astype(jnp.float32), params)
    data32 = jax.tree.map(
        lambda x: x.astype(jnp.float32) if x.dtype == jnp.float64 else x, data
    )
    complete = not with_missing

    cfg_strict = _dc.replace(cfg32, solve_mode="strict")
    cfg_mixed = _dc.replace(cfg32, solve_mode="mixed")

    f_s, _ = nlog_ml(params32, data32, cfg_strict, complete=complete)
    f_m, aux_m = nlog_ml(params32, data32, cfg_mixed, complete=complete)
    assert float(f_s) == pytest.approx(float(f_m), rel=2e-6)
    assert aux_m.w.dtype == jnp.float64

    g_s = jax.grad(lambda p: nlog_ml(p, data32, cfg_strict, complete=complete)[0])(params32)
    g_m = jax.grad(lambda p: nlog_ml(p, data32, cfg_mixed, complete=complete)[0])(params32)
    for name in ("P", "gamma", "ln_alpha", "b"):
        a = np.ravel(getattr(g_s, name))
        b = np.ravel(getattr(g_m, name))
        denom = max(np.linalg.norm(a), 1e-8)
        assert np.linalg.norm(a - b) / denom < 5e-4, name
