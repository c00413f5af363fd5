"""Distributed-correctness tests on the 8-virtual-device CPU mesh
(SURVEY §4.4: sharded Gram/grad psum must equal the single-device result
bit-tolerantly; the reference has no multi-node testing at all)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.flatten_util import ravel_pytree

from gpz_tpu.config import ModelConfig, TrainConfig
from gpz_tpu.objective import nlog_ml
from gpz_tpu.parallel import (
    make_mesh,
    shard_dataset,
    sharded_nlog_ml,
    train_sharded,
    ensemble_grad_step,
)

from test_objective import build


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return make_mesh(n_data=8, n_restart=1)


@pytest.fixture(scope="module")
def mesh2x4():
    return make_mesh(n_data=4, n_restart=2)


@pytest.mark.parametrize("method,with_psi", [("VL", False), ("VD", True), ("VC", True)])
def test_sharded_loss_matches_single_device(mesh8, method, with_psi):
    rng = np.random.default_rng(3)
    cfg, params, data, *_ = build(rng, method, with_psi, False, True, n=37)
    f1, aux1 = nlog_ml(params, data, cfg, complete=True)

    sdata, n_eff = shard_dataset(data, mesh8)
    f2, aux2 = sharded_nlog_ml(params, sdata, cfg, mesh8, n_eff, complete=True)

    np.testing.assert_allclose(float(f1), float(f2), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(aux1.w), np.asarray(aux2.w), rtol=1e-10)
    np.testing.assert_allclose(
        float(aux1.train_rmse), float(aux2.train_rmse), rtol=1e-12
    )


def test_sharded_grad_matches_single_device(mesh8):
    rng = np.random.default_rng(4)
    cfg, params, data, *_ = build(rng, "VD", True, False, True, n=29)
    flat0, unravel = ravel_pytree(params)

    g1 = jax.grad(lambda t: nlog_ml(unravel(t), data, cfg, complete=True)[0])(flat0)

    sdata, n_eff = shard_dataset(data, mesh8)
    g2 = jax.grad(
        lambda t: sharded_nlog_ml(
            unravel(t), sdata, cfg, mesh8, n_eff, complete=True
        )[0]
    )(flat0)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-9, atol=1e-12)


def test_train_sharded_runs_and_converges(mesh8):
    rng = np.random.default_rng(5)
    cfg, params, data, *_ = build(rng, "VL", False, False, True, n=64)
    res, unravel = train_sharded(
        params, data, cfg, mesh8,
        tc=TrainConfig(max_iter=25, verbose=False), complete=True,
    )
    tr = np.asarray(res.trace["f"])
    n_it = int(res.iterations)
    assert n_it >= 1
    assert tr[n_it] < tr[0]
    assert np.isfinite(float(res.f))


def test_train_sharded_matches_unsharded_trajectory(mesh8):
    """Same data, same init: the sharded and single-device optimizations must
    produce near-identical losses (float64 => tight)."""
    from gpz_tpu.optim import minimize

    rng = np.random.default_rng(6)
    cfg, params, data, *_ = build(rng, "VL", False, False, True, n=64)
    flat0, unravel = ravel_pytree(params)

    vg = jax.value_and_grad(
        lambda p: nlog_ml(p, data, cfg, complete=True), has_aux=True
    )

    def fun(flat):
        (f, aux), g = vg(unravel(flat))
        return f, ravel_pytree(g)[0], aux

    res1 = minimize(fun, flat0, max_iter=15)
    res2, _ = train_sharded(
        params, data, cfg, mesh8,
        tc=TrainConfig(max_iter=15, verbose=False), complete=True,
    )
    np.testing.assert_allclose(float(res1.f), float(res2.f), rtol=1e-8)


def test_ensemble_grad_step_2d_mesh(mesh2x4):
    """Restart-sharded x data-sharded 2-D mesh executes and matches the
    per-restart single-device gradient step."""
    rng = np.random.default_rng(7)
    cfg, params, data, *_ = build(rng, "VD", False, False, True, n=32)
    R = 4

    # stack R jittered copies of params
    stacked = jax.tree.map(
        lambda x: jnp.stack(
            [x + 0.01 * jnp.asarray(rng.standard_normal(x.shape)) for _ in range(R)]
        ),
        params,
    )
    sdata, n_eff = shard_dataset(data, mesh2x4)
    out = ensemble_grad_step(
        stacked, sdata, cfg, mesh2x4, n_eff, lr=1e-3, complete=True
    )

    # reference: same step computed serially per restart
    for ri in range(R):
        p_i = jax.tree.map(lambda x: x[ri], stacked)
        g_i = jax.grad(lambda p: nlog_ml(p, data, cfg, complete=True)[0])(p_i)
        want = jax.tree.map(lambda p, g: p - 1e-3 * g, p_i, g_i)
        got = jax.tree.map(lambda x: x[ri], out)
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-9)


@pytest.mark.parametrize("mode", ["mixed", "strict"])
def test_sharded_ozaki_fastsolve_matches_single_device(mesh8, monkeypatch,
                                                       mode):
    """The Ozaki numerics — slice-product Gram/rhs (GPZ_OZAKI=1) and, in
    mixed mode, the equilibrated-f32 + exact-IR fast solve — must be
    psum-exact under row sharding too, not only the einsum Gram path the
    CPU and GPU take by default.

    Per-shard Ozaki slice grids depend on per-block column maxima, so the
    sharded result is not bit-identical to single-device — but both are
    exact to ~2^-35 of the column scale, so the tolerance is tight."""
    import dataclasses

    monkeypatch.setenv("GPZ_OZAKI", "1")
    rng = np.random.default_rng(11)
    cfg, params, data, *_ = build(rng, "VC", True, False, True, n=37)
    # f32 params/data, f64 solve quantities
    cfg = dataclasses.replace(cfg, dtype="float32", solve_mode=mode,
                              solve_dtype="float64")
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    data = jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a,
        data,
    )
    flat0, unravel = ravel_pytree(params)

    (f1, aux1), g1 = jax.value_and_grad(
        lambda p: nlog_ml(p, data, cfg, complete=True), has_aux=True
    )(params)
    g1 = ravel_pytree(g1)[0]

    sdata, n_eff = shard_dataset(data, mesh8)
    (f2, aux2), g2 = jax.value_and_grad(
        lambda p: sharded_nlog_ml(p, sdata, cfg, mesh8, n_eff,
                                  complete=True),
        has_aux=True,
    )(params)
    g2 = ravel_pytree(g2)[0]

    np.testing.assert_allclose(float(f1), float(f2), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(aux1.w), np.asarray(aux2.w),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                               rtol=2e-4, atol=1e-7)
