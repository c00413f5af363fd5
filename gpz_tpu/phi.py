"""Design-matrix construction — the getPHI equivalent as batched masked math.

One parameterized kernel family replaces the reference's six method branches x
{Psi, no-Psi} x {missing, complete} code paths (ref GPz/getPHI.m:26-110):

  * GL/VL/GD/VD: diagonal covariance, Sigma_jd = gamma_jd^-2 (getPHI.m:93)
  * GC/VC: full covariance, iSigma_j = Gamma_j^T Gamma_j (getPHI.m:73)
  * input noise Psi enters as Psi + Sigma in the quadratic form plus a log-det
    correction (Gaussian convolution, getPHI.m:84-87,102-105)
  * missing dims are handled by masked dense algebra — each unobserved dim
    contributes -0.5*log(2) to lnPHI (marginalization constant, getPHI.m:76)
    instead of the reference's per-missingness-pattern row loops

Everything is a jit-friendly static-shape computation: X is zero-filled, the
missingness pattern lives in a boolean mask. A static `complete` hint (decided
host-side from the data) lets the full-covariance family skip the per-sample
masked restriction entirely when nothing is missing.

Returns log-space quantities; exp happens at the caller:
  lnPHI (n, m)  log basis activations
  lnN   (n, m)  log *normalized* densities (consumed by the prior EM,
                ref GPz/getPrior.m)
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from gpz_tpu.config import ModelConfig
from gpz_tpu.params import GPzParams
from gpz_tpu.linalg import (
    safe_cholesky,
    chol_logdet,
    masked_psd,
    quad_logdet_psd,
)

_LN2 = math.log(2.0)
_LN2PI = math.log(2.0 * math.pi)


def log_phi(
    params: GPzParams,
    cfg: ModelConfig,
    X: jax.Array,
    mask: jax.Array,
    psi: Optional[jax.Array],
    complete: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Compute (lnPHI, lnN), each (n, m).

    X:        (n, d) zero-filled inputs
    mask:     (n, d) True where observed
    psi:      None | (n, d) | (n, d, d) input-noise variances
    complete: static hint that mask is all-True (skips masked restrictions in
              the full-covariance family; the diagonal family is mask-native)
    """
    if cfg.full_cov:
        return _log_phi_full(params, cfg, X, mask, psi, complete)
    return _log_phi_diag(params, cfg, X, mask, psi)


def _log_phi_diag(params, cfg, X, mask, psi):
    G = params.expand_gamma(cfg)             # (m, d)
    Sigma = G**-2                            # per-dim variances (getPHI.m:93)
    P = params.P
    fmask = mask.astype(X.dtype)
    n_obs = jnp.sum(fmask, axis=1)           # (n,)
    n_mis = X.shape[1] - n_obs

    Delta = X[:, None, :] - P[None, :, :]    # (n, m, d)
    fm3 = fmask[:, None, :]                  # (n, 1, d)
    # these reductions over the tiny d axis (1-10) are written as
    # multiply+sum, not einsum: they fuse into one elementwise kernel
    # instead of becoming batched dots with a contraction of length d
    log_sigma_obs = jnp.sum(jnp.log(Sigma)[None, :, :] * fm3, axis=-1)

    if psi is None:
        quad = jnp.sum(Delta**2 / Sigma[None, :, :] * fm3, axis=-1)
        ln_phi = -0.5 * quad - 0.5 * n_mis[:, None] * _LN2
    else:
        ps = psi[:, None, :] + Sigma[None, :, :]          # (n, m, d)
        quad = jnp.sum(Delta**2 / ps * fm3, axis=-1)
        # log(1 + psi/Sigma) correction (getPHI.m:104)
        logr = jnp.sum(
            jnp.log1p(psi[:, None, :] / Sigma[None, :, :]) * fm3, axis=-1
        )
        ln_phi = -0.5 * quad - 0.5 * logr - 0.5 * n_mis[:, None] * _LN2

    ln_n = (
        ln_phi
        - 0.5 * log_sigma_obs
        - 0.5 * n_obs[:, None] * _LN2PI
        + 0.5 * n_mis[:, None] * _LN2
    )
    return ln_phi, ln_n


#: row-block size for the full-covariance per-sample (B, m, d, d) Cholesky
#: pass; bounds the device-memory working set (B * m * d^2 elements)
#: regardless of n
PHI_BLOCK_ROWS = 4096


def _log_phi_full(params, cfg, X, mask, psi, complete):
    G = params.expand_gamma(cfg)             # (m, d, d)
    P = params.P
    n, d = X.shape
    m = cfg.m
    fmask = mask.astype(X.dtype)

    # Gamma^T Gamma (getPHI.m:73) as multiply+sum over the tiny d axis
    iSig = jnp.sum(G[:, :, :, None] * G[:, :, None, :], axis=1)  # (m, d, d)

    if complete and psi is None:
        # quad = |Gamma Delta|^2 — no inverse needed at all
        Delta = X[:, None, :] - P[None, :, :]
        V = jnp.sum(G[None, :, :, :] * Delta[:, :, None, :], axis=-1)
        quad = jnp.sum(V * V, axis=-1)       # (n, m)
        L_iSig = safe_cholesky(iSig)
        logdet_Soo = -chol_logdet(L_iSig)[None, :]  # logdet(Sigma_j), (1, m)
        ln_phi = -0.5 * quad
        ln_n = ln_phi - 0.5 * logdet_Soo - 0.5 * d * _LN2PI
        return ln_phi, jnp.broadcast_to(ln_n, (n, m))

    # Sigma_j = iSig^-1 and its logdet, via Cholesky (replaces svd logdets,
    # getPHI.m:77,86)
    L_iSig = safe_cholesky(iSig)
    logdet_Sigma = -chol_logdet(L_iSig)      # (m,)
    eye = jnp.broadcast_to(jnp.eye(d, dtype=X.dtype), (m, d, d))
    Linv = jax.scipy.linalg.solve_triangular(L_iSig, eye, lower=True)
    # Linv^T Linv, multiply+sum for the same reasons as iSig above
    Sigma = jnp.sum(Linv[:, :, :, None] * Linv[:, :, None, :], axis=1)

    def block_fn(args):
        """Per-row-block (B, m, d, d) work; rematerialized in the backward
        pass (jax.checkpoint) so only (B, m) activations persist."""
        Xb, maskb, psib = args
        fm = maskb.astype(X.dtype)
        n_obs = jnp.sum(fm, axis=1)
        n_mis = d - n_obs
        Delta = (Xb[:, None, :] - P[None, :, :]) * fm[:, None, :]

        if psib is None:
            # quad + logdet through Sigma_oo (tiny-d unrolled elementwise path)
            Soo = masked_psd(Sigma[None, :, :, :], maskb[:, None, :])
            quad, logdet_Soo = quad_logdet_psd(Soo, Delta)
            ln_phi = -0.5 * quad - 0.5 * n_mis[:, None] * _LN2
        else:
            if complete:
                logdet_Soo = jnp.broadcast_to(
                    logdet_Sigma[None, :], (Xb.shape[0], m)
                )
                ps = psib[:, None, :, :] + Sigma[None, :, :, :]
            else:
                Soo = masked_psd(Sigma[None, :, :, :], maskb[:, None, :])
                _, logdet_Soo = quad_logdet_psd(Soo, Delta)
                ps = masked_psd(
                    psib[:, None, :, :] + Sigma[None, :, :, :],
                    maskb[:, None, :],
                )
            quad, logdet_ps = quad_logdet_psd(ps, Delta)
            # +0.5 logdet(Sigma_oo) - 0.5 logdet(Psi_oo+Sigma_oo) (getPHI.m:86)
            ln_phi = (
                -0.5 * quad
                + 0.5 * logdet_Soo
                - 0.5 * logdet_ps
                - 0.5 * n_mis[:, None] * _LN2
            )

        ln_n = (
            ln_phi
            - 0.5 * logdet_Soo
            - 0.5 * n_obs[:, None] * _LN2PI
            + 0.5 * n_mis[:, None] * _LN2
        )
        return ln_phi, ln_n

    B = PHI_BLOCK_ROWS
    if n <= B:
        return block_fn((X, mask, psi))

    # pad rows to a block multiple, scan blocks, slice back
    n_pad = -(-n // B) * B
    pad = n_pad - n
    Xp = jnp.pad(X, ((0, pad), (0, 0)))
    maskp = jnp.pad(mask, ((0, pad), (0, 0)), constant_values=True)
    psip = None if psi is None else jnp.pad(
        psi, ((0, pad),) + ((0, 0),) * (psi.ndim - 1)
    )
    nb = n_pad // B
    blocks = (
        Xp.reshape(nb, B, d),
        maskp.reshape(nb, B, d),
        None if psip is None else psip.reshape((nb, B) + psip.shape[1:]),
    )
    ln_phi, ln_n = jax.lax.map(jax.checkpoint(block_fn), blocks)
    return ln_phi.reshape(n_pad, m)[:n], ln_n.reshape(n_pad, m)[:n]


def design_matrix(
    params: GPzParams,
    cfg: ModelConfig,
    X: jax.Array,
    mask: jax.Array,
    psi: Optional[jax.Array],
    complete: bool = False,
):
    """(PHI, lnN, ln_beta_i): activations, log densities, log noise variance.

    ln_beta_i = b + PHI @ v when heteroscedastic (ref getPHI.m:117-125).
    """
    ln_phi, ln_n = log_phi(params, cfg, X, mask, psi, complete)
    PHI = jnp.exp(ln_phi)
    ln_beta_i = jnp.broadcast_to(params.b[None, :], (X.shape[0], cfg.k))
    if params.heteroscedastic:
        # HIGHEST: ln beta feeds the objective and sigma, so the f32
        # contraction must not run in TF32 on a GPU
        ln_beta_i = ln_beta_i + jnp.matmul(
            PHI, params.v, precision=jax.lax.Precision.HIGHEST
        )
    return PHI, ln_n, ln_beta_i
