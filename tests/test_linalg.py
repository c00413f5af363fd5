"""Unit tests for the numerics substrate (SURVEY §7 stage 1)."""

import numpy as np
import jax.numpy as jnp

from gpz_tpu import linalg


def _rand_psd(rng, n, batch=()):
    A = rng.standard_normal(batch + (n, n))
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


def test_safe_cholesky_matches_numpy(rng):
    A = _rand_psd(rng, 6)
    L = np.asarray(linalg.safe_cholesky(jnp.asarray(A)))
    np.testing.assert_allclose(L, np.linalg.cholesky(A), rtol=1e-10)


def test_safe_cholesky_batched(rng):
    A = _rand_psd(rng, 5, batch=(3, 2))
    L = np.asarray(linalg.safe_cholesky(jnp.asarray(A)))
    np.testing.assert_allclose(L, np.linalg.cholesky(A), rtol=1e-10)


def test_safe_cholesky_jitters_singular(rng):
    # rank-deficient PSD: plain Cholesky fails, jitter path must recover
    v = rng.standard_normal((6, 2))
    A = v @ v.T
    L = np.asarray(linalg.safe_cholesky(jnp.asarray(A)))
    assert np.all(np.isfinite(L))
    np.testing.assert_allclose(L @ L.T, A, atol=1e-4)


def test_inv_logdet_psd(rng):
    A = _rand_psd(rng, 8)
    Ai, ld = linalg.inv_logdet_psd(jnp.asarray(A))
    np.testing.assert_allclose(np.asarray(Ai), np.linalg.inv(A), rtol=1e-8)
    np.testing.assert_allclose(float(ld), np.linalg.slogdet(A)[1], rtol=1e-10)


def test_solve_psd(rng):
    A = _rand_psd(rng, 7)
    B = rng.standard_normal((7, 3))
    X, ld = linalg.solve_psd(jnp.asarray(A), jnp.asarray(B))
    np.testing.assert_allclose(np.asarray(X), np.linalg.solve(A, B), rtol=1e-8)


def test_dxy(rng):
    X = rng.standard_normal((10, 3))
    Y = rng.standard_normal((7, 3))
    D = np.asarray(linalg.dxy(jnp.asarray(X), jnp.asarray(Y)))
    expect = ((X[:, None, :] - Y[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(D, expect, atol=1e-10)


def test_masked_psd_restriction(rng):
    A = _rand_psd(rng, 5)
    mask = np.array([True, False, True, True, False])
    B = np.asarray(linalg.masked_psd(jnp.asarray(A), jnp.asarray(mask)))
    o = np.where(mask)[0]
    # logdet equals the observed-block logdet
    np.testing.assert_allclose(
        np.linalg.slogdet(B)[1], np.linalg.slogdet(A[np.ix_(o, o)])[1], rtol=1e-10
    )
    # inverse restricted to observed block equals restricted inverse
    Binv = np.linalg.inv(B)
    np.testing.assert_allclose(
        Binv[np.ix_(o, o)], np.linalg.inv(A[np.ix_(o, o)]), rtol=1e-8
    )


def test_nanaware_moments(rng):
    X = rng.standard_normal((200, 4))
    mu, cov = linalg.nanaware_moments(jnp.asarray(X))
    np.testing.assert_allclose(np.asarray(mu), X.mean(0), atol=1e-10)
    # no missing data: pairwise-count normalization reduces to /n... the
    # reference divides by (n - overlap-missing) == n here
    np.testing.assert_allclose(
        np.asarray(cov), (X - X.mean(0)).T @ (X - X.mean(0)) / 200, atol=1e-10
    )


def test_nanaware_moments_with_nans(rng):
    X = rng.standard_normal((500, 3))
    X[rng.random((500, 3)) < 0.2] = np.nan
    mu, cov = linalg.nanaware_moments(jnp.asarray(X))
    expect_mu = np.nanmean(X, axis=0)
    np.testing.assert_allclose(np.asarray(mu), expect_mu, atol=1e-10)
    assert np.all(np.isfinite(np.asarray(cov)))


def test_fill_linear_exact_on_observed(rng):
    X = rng.standard_normal((50, 4))
    Xm = X.copy()
    Xm[rng.random((50, 4)) < 0.3] = np.nan
    mu = X.mean(0)
    cov = np.cov(X.T)
    filled = np.asarray(linalg.fill_linear(jnp.asarray(Xm), jnp.asarray(mu), jnp.asarray(cov)))
    obs = ~np.isnan(Xm)
    np.testing.assert_allclose(filled[obs], Xm[obs], atol=1e-8)
    assert np.all(np.isfinite(filled))


def test_fill_linear_matches_conditional(rng):
    # one fixed pattern: last dim missing
    X = rng.standard_normal((20, 3))
    mu = rng.standard_normal(3)
    cov = _rand_psd(rng, 3)
    Xm = X.copy()
    Xm[:, 2] = np.nan
    filled = np.asarray(linalg.fill_linear(jnp.asarray(Xm), jnp.asarray(mu), jnp.asarray(cov)))
    o = [0, 1]
    expect = mu[2] + (X[:, o] - mu[o]) @ np.linalg.solve(cov[np.ix_(o, o)], cov[o, 2])
    np.testing.assert_allclose(filled[:, 2], expect, rtol=1e-8)


def test_pca_whiten_roundtrip(rng):
    X = rng.standard_normal((300, 4)) @ _rand_psd(rng, 4)
    mu, cov, T, Ti = linalg.pca_whiten(jnp.asarray(X))
    T, Ti = np.asarray(T), np.asarray(Ti)
    # T whitens: cov of whitened data ~ identity (up to the n/(n-1) scaling)
    Xw = (X - np.asarray(mu)) @ T
    C = np.cov(Xw.T, ddof=1)
    np.testing.assert_allclose(C, np.eye(4) * C[0, 0], atol=0.15)
    # Ti inverts T
    np.testing.assert_allclose(T @ Ti, np.eye(4), atol=1e-8)


def test_solve_w_logdet_custom_vjp_matches_ad():
    """solve_w_logdet's closed-form cotangents (triangular solves + outer
    products) must equal AD through the stock
    cholesky/solve path — exact on CPU, where the stock VJP is accurate."""
    import jax
    import jax.numpy as jnp

    from gpz_tpu.linalg import solve_w_logdet, safe_cholesky, chol_solve, \
        chol_logdet

    rng = np.random.default_rng(7)
    k, m = 2, 12
    A = rng.standard_normal((k, m, 3 * m))
    SIGMA = jnp.asarray(A @ np.swapaxes(A, 1, 2) / m + 1e-3 * np.eye(m))
    rhs = jnp.asarray(rng.standard_normal((m, k)))

    def loss_custom(S, r):
        w, ld = solve_w_logdet(S, r)
        return jnp.sum(jnp.sin(w)) + jnp.sum(ld * jnp.asarray([0.7, -1.3]))

    def loss_stock(S, r):
        L = safe_cholesky(S)
        w = chol_solve(L, jnp.swapaxes(r, 0, 1)[..., None])[..., 0].T
        ld = chol_logdet(L)
        return jnp.sum(jnp.sin(w)) + jnp.sum(ld * jnp.asarray([0.7, -1.3]))

    v1 = float(loss_custom(SIGMA, rhs))
    v2 = float(loss_stock(SIGMA, rhs))
    np.testing.assert_allclose(v1, v2, rtol=1e-12)
    g1 = jax.grad(loss_custom, argnums=(0, 1))(SIGMA, rhs)
    g2 = jax.grad(loss_stock, argnums=(0, 1))(SIGMA, rhs)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-9, atol=1e-12)
