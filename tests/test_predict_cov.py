"""Full-covariance prediction with missing data: loopy port-of-record parity
(ref predictCov.m:134-232 predictMissing and 233-337 predictNoisyMissing)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gpz_tpu.config import ModelConfig
from gpz_tpu.predict import predict_moments_full

from test_phi import make_params
from test_predict import make_post


def _ref_predict_missing_cov(X, psi, P, Sigma, iSig, w, v, b, iSw, priors):
    """Loopy reference for the full-covariance missing(+noisy) prediction,
    written from the math of ref predictCov.m (conditional imputation via
    R = Sigma_oo^-1 Sigma_ou, X_hat, Psi_hat; full-dim pair expectations).
    Covers predictMissing when psi == 0."""
    n, d = X.shape
    m, k = w.shape
    o = ~np.isnan(X[0])
    u = ~o
    do = int(o.sum())

    lnz = np.array([0.5 * np.linalg.slogdet(Sigma[i])[1] for i in range(m)])

    # responsibilities + conditional imputation per basis
    Ex = np.zeros((n, m))
    X_hat = np.zeros((n, m, d))
    Psi_hat = np.zeros((n, m, d, d))
    for i in range(m):
        Soo = Sigma[i][np.ix_(o, o)]
        for s in range(n):
            SPoo = Soo + psi[s][np.ix_(o, o)]
            delta = X[s, o] - P[i, o]
            q = delta @ np.linalg.solve(SPoo, delta)
            Ex[s, i] = np.exp(
                -0.5 * q - 0.5 * np.linalg.slogdet(SPoo)[1]
            ) * priors[i]
            R = np.linalg.solve(Soo, Sigma[i][np.ix_(o, u)])  # (do, du)
            X_hat[s, i, o] = X[s, o]
            X_hat[s, i, u] = P[i, u] + (X[s, o] - P[i, o]) @ R
            T = np.zeros((d, do))
            T[o, :] = np.eye(do)
            T[u, :] = R.T
            Psi_hat[s, i] = T @ psi[s][np.ix_(o, o)] @ T.T
            Psi_hat[s, i][np.ix_(u, u)] += (
                Sigma[i][np.ix_(u, u)] - Sigma[i][np.ix_(u, o)] @ R
            )
    Pio = Ex / Ex.sum(axis=1, keepdims=True)

    # PHI_i = exp(lnz_i) sum_j Pio_j N(X_hat_j; P_i, Sigma_i + Psi_hat_j)
    PHI = np.zeros((n, m))
    for s in range(n):
        for i in range(m):
            acc = 0.0
            for j in range(m):
                C = Sigma[i] + Psi_hat[s, j]
                delta = X_hat[s, j] - P[i]
                q = delta @ np.linalg.solve(C, delta)
                acc += Pio[s, j] * np.exp(
                    -0.5 * q - 0.5 * np.linalg.slogdet(C)[1]
                )
            PHI[s, i] = np.exp(lnz[i]) * acc

    mu = PHI @ w
    ElnS = PHI @ v

    gamma = np.zeros((n, k))
    VlnS = np.zeros((n, k))
    nu = np.zeros((n, k))
    for i in range(m):
        for j in range(m):
            iC = iSig[i] + iSig[j]
            C = np.linalg.inv(iC)
            c = (P[i] @ iSig[i] + P[j] @ iSig[j]) @ C
            SS = Sigma[i] + Sigma[j]
            dP = P[i] - P[j]
            lnZ = (
                lnz[i] + lnz[j]
                - 0.5 * dP @ np.linalg.solve(SS, dP)
                - 0.5 * np.linalg.slogdet(SS)[1]
            )
            for s in range(n):
                acc = 0.0
                for l in range(m):
                    CP = C + Psi_hat[s, l]
                    delta = X_hat[s, l] - c
                    q = delta @ np.linalg.solve(CP, delta)
                    acc += Pio[s, l] * np.exp(
                        -0.5 * q - 0.5 * np.linalg.slogdet(CP)[1]
                    )
                Z = np.exp(lnZ) * acc
                gamma[s] += Z * (w[i] * w[j])
                VlnS[s] += Z * (v[i] * v[j])
                nu[s] += Z * iSw[:, i, j]
    VlnS -= ElnS**2
    beta_i = np.exp(ElnS + b[None, :]) * (1 + 0.5 * VlnS)
    gamma -= mu**2
    return mu, nu, beta_i, gamma, PHI


@pytest.mark.parametrize("with_psi", [False, True])
def test_missing_cov_vs_loopy_reference(rng, with_psi, monkeypatch):
    # pin the mixture scans to f64 for the structural oracle comparison;
    # the default f32 chain's rounding is bounded separately by
    # test_missing_cov_mix_dtype_error_bound
    monkeypatch.setenv("GPZ_MIX_DTYPE", "float64")
    n, d, m, k = 5, 3, 3, 1
    cfg = ModelConfig(m=m, d=d, k=k, method="VC", dtype="float64")
    params = make_params(rng, cfg)
    post = make_post(rng, m, k)
    priors = np.asarray(rng.random(m)) + 0.1
    priors /= priors.sum()

    X = rng.standard_normal((n, d))
    X[:, 2] = np.nan
    if with_psi:
        A = rng.standard_normal((n, d, d)) * 0.2
        psi = A @ np.swapaxes(A, 1, 2) + 0.1 * np.eye(d)
        # the reference only consumes the observed block; zero the rest for a
        # well-defined comparison
        psi[:, 2, :] = 0.0
        psi[:, :, 2] = 0.0
    else:
        psi = np.zeros((n, d, d))

    G = np.asarray(params.expand_gamma(cfg))
    iSig = np.einsum("mij,mik->mjk", G, G)
    Sigma = np.linalg.inv(iSig)

    exp = _ref_predict_missing_cov(
        X, psi, np.asarray(params.P), Sigma, iSig, np.asarray(post.w),
        np.asarray(params.v), np.asarray(params.b),
        np.asarray(post.iSigma_w), priors,
    )

    mask_vec = jnp.asarray([1.0, 1.0, 0.0])
    Xz = np.where(np.isnan(X), 0.0, X)
    got = predict_moments_full(
        params, post, jnp.asarray(priors), cfg, jnp.asarray(Xz), mask_vec,
        jnp.asarray(psi), False,
    )
    for g, e, name in zip(got, exp, ["mu", "nu", "beta_i", "gamma", "phi"]):
        np.testing.assert_allclose(
            np.asarray(g), e, rtol=1e-6, atol=1e-9, err_msg=name
        )


def test_missing_cov_finite_at_trained_scales(rng):
    """Regression: trained VC models reach Sigma eigenvalues ~1e9 in f32;
    the covariance-form conditional cov (Sigma - J Sigma) cancels
    catastrophically there (indefinite matrices -> NaN logdets -> all-NaN
    predictions). The precision-form path must stay finite. Collapsed EM
    priors (exact zeros) ride along — log(0) must not NaN the softmax."""
    n, d, m, k = 7, 4, 6, 1
    cfg = ModelConfig(m=m, d=d, k=k, method="VC", dtype="float32")
    params = make_params(rng, cfg)
    # scale gamma down so Sigma = inv(G'G) has huge eigenvalues (~1e8-1e10)
    params = dataclasses.replace(
        params, gamma=params.gamma * np.float32(1e-4)
    )
    params = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a, np.float32)), params
    )
    post = make_post(rng, m, k)
    post = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a, np.float32)), post
    )
    priors = np.zeros(m, np.float32)
    priors[1] = 0.99
    priors[4] = 0.01

    X = np.float32(rng.standard_normal((n, d)))
    psi = np.zeros((n, d, d), np.float32)
    psi[:, np.arange(d), np.arange(d)] = 0.05
    mask_vec = jnp.asarray([1.0, 1.0, 0.0, 1.0], jnp.float32)
    Xz = X * np.asarray([1, 1, 0, 1], np.float32)

    out = predict_moments_full(
        params, post, jnp.asarray(priors), cfg, jnp.asarray(Xz), mask_vec,
        jnp.asarray(psi), False,
    )
    for a, name in zip(out, ["mu", "nu", "beta_i", "gamma", "phi"]):
        assert np.isfinite(np.asarray(a)).all(), name


def test_missing_cov_mix_dtype_error_bound(rng, monkeypatch):
    """The default f32 mixture-conditional chain (predict.mix_dtype) must
    stay within ~1e-4 relative of the all-f64 chain: the mixture sums are
    nonnegative, so per-component f32 rounding passes through linearly
    instead of being amplified by the pair pass's cancellations, and the
    float32 scans are the cheap ones for missing-data prediction at
    m=1000."""
    n, d, m, k = 8, 4, 24, 1
    cfg = ModelConfig(m=m, d=d, k=k, method="VC", dtype="float64")
    params = make_params(rng, cfg)
    post = make_post(rng, m, k)
    priors = np.asarray(rng.random(m)) + 0.1
    priors /= priors.sum()
    X = rng.standard_normal((n, d))
    psi = np.zeros((n, d, d))
    psi[:, np.arange(d), np.arange(d)] = 0.05
    mask_vec = jnp.asarray([1.0, 1.0, 0.0, 1.0])
    Xz = X * np.asarray([1, 1, 0, 1.0])

    outs = {}
    for mdt in ("float64", "float32"):
        monkeypatch.setenv("GPZ_MIX_DTYPE", mdt)
        outs[mdt] = predict_moments_full(
            params, post, jnp.asarray(priors), cfg, jnp.asarray(Xz),
            mask_vec, jnp.asarray(psi), False,
        )
    for a, b, name in zip(outs["float32"], outs["float64"],
                          ["mu", "nu", "beta_i", "gamma", "phi"]):
        a, b = np.asarray(a), np.asarray(b)
        scale = np.maximum(np.abs(b), 1e-8 * np.abs(b).max() + 1e-300)
        assert np.max(np.abs(a - b) / scale) < 1e-4, name
