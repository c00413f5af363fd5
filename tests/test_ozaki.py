"""Ozaki-scheme exact contractions from bf16 slice products (ops/ozaki.py).

The scheme can replace the backend f64 dot in the objective's Gram/rhs
reductions (GPZ_OZAKI=1). These CPU tests pin the numerics: the bf16 slice
products must reconstruct the true-f64 contraction to ~1e-13 regardless of
backend, and the custom VJPs must match plain AD. chip_smoke.py runs the
exactness checks on a GPU.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gpz_tpu.ops.ozaki import ozaki_gram, ozaki_tn


@pytest.fixture
def W(rng):
    # wide dynamic range within columns — the hard case for aligned slicing
    return rng.standard_normal((3000, 23)) * np.exp(
        2.0 * rng.standard_normal((3000, 23))
    )


def test_gram_f64_exact(W):
    A = np.asarray(jax.jit(ozaki_gram)(jnp.asarray(W)))
    A_ref = W.T @ W
    assert np.abs(A - A_ref).max() / np.abs(A_ref).max() < 1e-13


def test_gram_f32_input(W):
    Wf = W.astype(np.float32)
    A = np.asarray(jax.jit(ozaki_gram)(jnp.asarray(Wf)))
    A_ref = Wf.astype(np.float64).T @ Wf.astype(np.float64)
    # q=5 slices: the contract is ABSOLUTE error ~2^-35 of the column-scale
    # product n * sigma_a * sigma_b (entries far below the column max are
    # only captured to the shared grid, so a relative-to-entry bound cannot
    # hold under cancellation)
    sigma = np.abs(Wf).max(axis=0).astype(np.float64)
    scale = Wf.shape[0] * np.outer(sigma, sigma)
    assert (np.abs(A - A_ref) / scale).max() < 2.0**-30


def test_tn_f64_exact(W, rng):
    Y = rng.standard_normal((3000, 4))
    O = np.asarray(jax.jit(ozaki_tn)(jnp.asarray(W), jnp.asarray(Y)))
    O_ref = W.T @ Y
    assert np.abs(O - O_ref).max() / np.abs(O_ref).max() < 1e-13


def test_gram_nan_propagates(W):
    Wn = W.copy()
    Wn[17, 3] = np.nan
    A = np.asarray(ozaki_gram(jnp.asarray(Wn)))
    assert np.isnan(A).any()


def test_short_factor_not_padded_to_block():
    # contraction length far below the block size (the backward's m-sized
    # contraction) must not blow up memory or accuracy
    rng = np.random.default_rng(1)
    X = rng.standard_normal((24, 5000))
    M = rng.standard_normal((24, 24))
    O = np.asarray(ozaki_tn(jnp.asarray(X), jnp.asarray(M)))
    O_ref = X.T @ M
    assert np.abs(O - O_ref).max() / np.abs(O_ref).max() < 1e-13


def test_gram_vjp_matches_plain_ad(W):
    Ws = jnp.asarray(W[:400])

    # scale A into sin's well-conditioned range: at |A|~1e4 the phase
    # sensitivity of sin turns the forward paths' own 1e-14 difference into
    # a cotangent difference far above the VJP's error
    def loss_oz(w):
        return jnp.sum(jnp.sin(ozaki_gram(w) * 1e-4))

    def loss_pl(w):
        return jnp.sum(jnp.sin((w.T @ w) * 1e-4))

    g1 = np.asarray(jax.grad(loss_oz)(Ws))
    g2 = np.asarray(jax.grad(loss_pl)(Ws))
    assert np.abs(g1 - g2).max() / np.abs(g2).max() < 1e-11


def test_tn_vjp_matches_plain_ad(W, rng):
    Xs = jnp.asarray(W[:400])
    Ys = jnp.asarray(rng.standard_normal((400, 6)))

    def loss_oz(x, y):
        return jnp.sum(jnp.cos(ozaki_tn(x, y)))

    def loss_pl(x, y):
        return jnp.sum(jnp.cos(x.T @ y))

    g1 = jax.grad(loss_oz, argnums=(0, 1))(Xs, Ys)
    g2 = jax.grad(loss_pl, argnums=(0, 1))(Xs, Ys)
    for a, b in zip(g1, g2):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-300) < 1e-11


def test_objective_ozaki_matches_plain_strict(rng, monkeypatch):
    """The Ozaki Gram path == the plain strict path on CPU (f64)."""
    from bench import make_problem
    from gpz_tpu.objective import nlog_ml
    import dataclasses

    cfg, params, data = make_problem(n=800, m=16, dtype=jnp.float64, seed=3)
    cfg = dataclasses.replace(cfg, dtype="float64", solve_mode="strict",
                              solve_dtype="float64")
    params = jax.tree.map(lambda a: a.astype(jnp.float64), params)
    data = jax.tree.map(
        lambda a: a.astype(jnp.float64) if a.dtype == jnp.float32 else a,
        data,
    )

    def fg(oz):
        monkeypatch.setenv("GPZ_OZAKI", oz)
        (f, _), g = jax.value_and_grad(
            lambda q: nlog_ml(q, data, cfg, complete=True), has_aux=True
        )(params)
        gf = jax.flatten_util.ravel_pytree(g)[0]
        return float(f), np.asarray(gf)

    f1, g1 = fg("1")
    f0, g0 = fg("0")
    assert abs(f1 - f0) < 1e-11
    assert np.abs(g1 - g0).max() < 1e-8


class TestFastSolve:
    """linalg.fast_solve_w_logdet: equilibrated f32 factor + exact IR."""

    def _problem(self, cond_target, m=60, k=1, seed=0):
        rng = np.random.default_rng(seed)
        # SPD with controlled conditioning, wildly scaled diagonal (the GPz
        # late-training shape: alpha spans orders of magnitude)
        Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
        ev = np.logspace(0, np.log10(cond_target), m)
        d = np.exp(rng.uniform(-6, 6, m))
        S = (Q * ev) @ Q.T
        S = S * np.outer(d, d)
        S = 0.5 * (S + S.T)
        rhs = rng.standard_normal((m, k))
        return jnp.asarray(S[None]), jnp.asarray(rhs)

    def test_matches_strict(self):
        from gpz_tpu.linalg import fast_solve_w_logdet, solve_w_logdet

        S, rhs = self._problem(1e5)
        w_f, ld_f = fast_solve_w_logdet(S, rhs)
        w_s, ld_s = solve_w_logdet(S, rhs)
        assert np.abs(np.asarray(w_f - w_s)).max() / np.abs(
            np.asarray(w_s)).max() < 1e-8
        # logdet comes from the f32 factor: absolute error ~m*eps32*growth
        # (measured 1.4e-4 here) — ~1e-9 per-sample nlml at n=70k, below
        # the mixed phase's f32 design-matrix error floor
        assert np.abs(np.asarray(ld_f - ld_s)).max() < 1e-3

    def test_fallback_on_extreme_cond(self):
        from gpz_tpu.linalg import fast_solve_w_logdet, solve_w_logdet

        # kappa(C) >> 1/eps_f32 even after equilibration: refinement cannot
        # converge, the runtime fallback must produce the strict answer
        S, rhs = self._problem(1e12)
        w_f, ld_f = fast_solve_w_logdet(S, rhs)
        w_s, ld_s = solve_w_logdet(S, rhs)
        assert np.abs(np.asarray(w_f - w_s)).max() / np.abs(
            np.asarray(w_s)).max() < 1e-9
        assert np.abs(np.asarray(ld_f - ld_s)).max() < 1e-9

    def test_nonfinite_propagates(self):
        from gpz_tpu.linalg import fast_solve_w_logdet

        S, rhs = self._problem(1e4)
        S = S.at[0, 3, 4].set(jnp.nan)
        w, ld = fast_solve_w_logdet(S, rhs)
        assert not bool(jnp.all(jnp.isfinite(w))) or not bool(
            jnp.all(jnp.isfinite(ld)))

    def test_grad_matches_strict(self):
        from gpz_tpu.linalg import fast_solve_w_logdet, solve_w_logdet

        S, rhs = self._problem(1e5, m=24)

        def loss(fn, S, rhs):
            w, ld = fn(S, rhs)
            return jnp.sum(w * rhs) + 0.1 * jnp.sum(ld)

        gf = jax.grad(lambda s, r: loss(fast_solve_w_logdet, s, r),
                      argnums=(0, 1))(S, rhs)
        gs = jax.grad(lambda s, r: loss(solve_w_logdet, s, r),
                      argnums=(0, 1))(S, rhs)
        for a, b in zip(gf, gs):
            a, b = np.asarray(a), np.asarray(b)
            assert np.abs(a - b).max() / (np.abs(b).max() + 1e-300) < 1e-7


def test_chunked_gram_accumulation_matches(monkeypatch):
    """Above OZAKI_CHUNK rows the exact Gram runs as a rematerialized scan
    over row chunks (slice copies stay O(chunk * m) — the 1M x 1000 scale
    path, BASELINE configs[4]). Value and gradient must match the
    single-chunk path exactly."""
    import gpz_tpu.objective as O
    from gpz_tpu.objective import nlog_ml
    from jax.flatten_util import ravel_pytree
    from test_objective import build

    monkeypatch.setenv("GPZ_OZAKI", "1")
    rng = np.random.default_rng(2)
    cfg, params, data, *_ = build(rng, "VC", True, False, True, n=37)

    def vg():
        (f, _), g = jax.value_and_grad(
            lambda p: nlog_ml(p, data, cfg, complete=True), has_aux=True
        )(params)
        return float(f), ravel_pytree(g)[0]

    monkeypatch.setattr(O, "OZAKI_CHUNK", 16)   # 37 rows -> 3 chunks + pad
    f_c, g_c = vg()
    monkeypatch.setattr(O, "OZAKI_CHUNK", 1 << 20)
    f_1, g_1 = vg()
    assert abs(f_c - f_1) < 1e-12
    np.testing.assert_allclose(np.asarray(g_c), np.asarray(g_1), atol=1e-12)
