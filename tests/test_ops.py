"""Plain-XLA VC design matrix, platform resolution and cache placement.

* the full-covariance design matrix (phi._log_phi_full) with input noise
  against the loopy float64 port-of-record, across row counts that straddle
  the row-block size (padding + scan), and its blocked (rematerialized)
  gradient against the unblocked one;
* solve_mode="auto" and the Ozaki Gram gate resolve per named platform
  ("cpu", "gpu") and raise on any other;
* the persistent compile cache honours JAX_COMPILATION_CACHE_DIR and
  otherwise sits at <checkout>/.jax_cache.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.flatten_util import ravel_pytree

import gpz_tpu
from gpz_tpu import aot, objective, phi
from gpz_tpu.config import ModelConfig

from reference_impl import ref_log_phi
from test_phi import make_data, make_params

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _vc(rng, n, missing=False, m=5, d=3):
    cfg = ModelConfig(m=m, d=d, method="VC", dtype="float64")
    params = make_params(rng, cfg)
    X, psi = make_data(rng, n, d, True, missing, True)
    return cfg, params, X, psi


def _lnphi(params, cfg, X, psi, complete):
    mask = ~np.isnan(X)
    return phi.log_phi(params, cfg, jnp.asarray(np.where(mask, X, 0.0)),
                       jnp.asarray(mask), jnp.asarray(psi), complete)


@pytest.mark.parametrize("n", [7, 8, 9, 20])
def test_vc_complete_psi_matches_reference_across_blocks(rng, monkeypatch, n):
    """n below, at and above PHI_BLOCK_ROWS=8: single block, exact block,
    padded scan of 2 blocks, padded scan of 3 blocks."""
    monkeypatch.setattr(phi, "PHI_BLOCK_ROWS", 8)
    cfg, params, X, psi = _vc(rng, n)
    ln_phi, ln_n = _lnphi(params, cfg, X, psi, complete=True)
    ref_phi, ref_n = ref_log_phi(X, psi, np.asarray(params.P),
                                 np.asarray(params.gamma), "VC")
    assert ln_phi.shape == (n, cfg.m)
    np.testing.assert_allclose(np.asarray(ln_phi), ref_phi,
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.asarray(ln_n), ref_n,
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("complete", [True, False])
def test_vc_blocked_gradient_matches_unblocked(rng, monkeypatch, complete):
    """The row-blocked lax.map + checkpoint path differentiates to the same
    gradient as one unblocked pass (21 rows: 3 blocks of 8, padded)."""
    cfg, params, X, psi = _vc(rng, 21, missing=not complete)
    W = jnp.asarray(rng.standard_normal((21, cfg.m)))

    def grad(block_rows):
        monkeypatch.setattr(phi, "PHI_BLOCK_ROWS", block_rows)

        def loss(p):
            ln_phi, _ = _lnphi(p, cfg, X, psi, complete)
            return jnp.sum(jnp.exp(ln_phi) * W)

        return ravel_pytree(jax.grad(loss)(params))[0]

    g_blocked = grad(8)
    g_full = grad(1 << 20)
    assert np.all(np.isfinite(np.asarray(g_full)))
    np.testing.assert_allclose(np.asarray(g_blocked), np.asarray(g_full),
                               rtol=1e-11, atol=1e-13)


@pytest.mark.parametrize("platform, mode, ozaki", [
    ("cpu", "strict", False),
    ("gpu", "strict", False),
])
def test_platform_defaults(monkeypatch, platform, mode, ozaki):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.delenv("GPZ_OZAKI", raising=False)
    assert ModelConfig(m=4, d=2).resolved_solve_mode() == mode
    assert objective._ozaki_active() is ozaki


def test_unknown_platform_raises(monkeypatch):
    """No platform inherits another's numerics: an unnamed one raises."""
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    monkeypatch.delenv("GPZ_OZAKI", raising=False)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        ModelConfig(m=4, d=2).resolved_solve_mode()
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        objective._ozaki_active()
    # explicit choices need no platform
    assert ModelConfig(m=4, d=2, solve_mode="mixed").resolved_solve_mode() \
        == "mixed"


@pytest.mark.parametrize("env", ["1", "0"])
def test_ozaki_env_override(monkeypatch, env):
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    monkeypatch.setenv("GPZ_OZAKI", env)
    assert objective._ozaki_active() is (env == "1")


@pytest.mark.parametrize("env_set", [True, False])
def test_cache_dir_placement(tmp_path, monkeypatch, env_set):
    """cache_dir()/aot._dir() in process, and what a fresh interpreter's
    `import gpz_tpu` leaves in JAX's config."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_set:
        want = str(tmp_path / "jc")
        env["JAX_COMPILATION_CACHE_DIR"] = want
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    else:
        want = os.path.join(_ROOT, ".jax_cache")
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert gpz_tpu.cache_dir() == want
    assert aot._dir() == os.path.join(want, "aot")
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, gpz_tpu; print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, env=env, cwd=_ROOT, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == want
