"""AOT executable cache (gpz_tpu.aot): cross-process trace skipping.

A fresh process pays jax trace+lower per training phase even with a warm
persistent compilation cache. minimize(aot_key=...) serializes the compiled
executable; a repeat call (or process) with the same semantic key,
argument signature, and code fingerprint calls the deserialized
executable directly. These tests pin: result equality through the cache,
key sensitivity (shape/semantics/fingerprint), and the fallback path.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from gpz_tpu import aot
from gpz_tpu.optim.lbfgs import minimize


@pytest.fixture
def aot_dir(tmp_path, monkeypatch):
    # the AOT files live under the compile-cache root (aot._dir)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("GPZ_AOT", raising=False)
    aot._LOADED.clear()
    (tmp_path / "aot").mkdir()
    yield tmp_path / "aot"
    aot._LOADED.clear()


def quad_fun(x):
    f = 0.5 * jnp.sum(x.astype(jnp.float64) ** 2)
    return f, x, ()


def test_minimize_aot_roundtrip_matches_plain(aot_dir):
    x0 = jnp.asarray(np.full(6, 2.0), jnp.float32)
    plain = minimize(quad_fun, x0, max_iter=10)
    first = minimize(quad_fun, x0, max_iter=10, aot_key="quadtest")
    files = [f for f in os.listdir(aot_dir) if f.endswith(".jaxexe")]
    assert len(files) == 1, files
    # second call goes through the serialized executable (the in-process
    # handle cache is cleared to force a real deserialize)
    aot._LOADED.clear()
    second = minimize(quad_fun, x0, max_iter=10, aot_key="quadtest")
    for res in (first, second):
        np.testing.assert_array_equal(np.asarray(res.x),
                                      np.asarray(plain.x))
        assert float(res.f) == float(plain.f)
        assert int(res.iterations) == int(plain.iterations)
        assert int(res.status) == int(plain.status)
    # dynamic operands stay dynamic: a different budget reuses the SAME
    # executable (record_len bucket unchanged) with a different result
    res5 = minimize(quad_fun, x0, max_iter=3, aot_key="quadtest")
    assert len(os.listdir(aot_dir)) == 1
    assert int(res5.iterations) <= 3


def test_aot_key_sensitivity(aot_dir):
    x0 = jnp.asarray(np.full(6, 2.0), jnp.float32)
    minimize(quad_fun, x0, max_iter=10, aot_key="a")
    n0 = len(os.listdir(aot_dir))
    # different semantic key -> new entry
    minimize(quad_fun, x0, max_iter=10, aot_key="b")
    assert len(os.listdir(aot_dir)) == n0 + 1
    # different shape -> new entry under the same key
    minimize(quad_fun, jnp.asarray(np.full(7, 2.0), jnp.float32),
             max_iter=10, aot_key="a")
    assert len(os.listdir(aot_dir)) == n0 + 2


def test_aot_disabled_uses_plain_path(aot_dir, monkeypatch):
    monkeypatch.setenv("GPZ_AOT", "0")
    x0 = jnp.asarray(np.full(4, 1.0), jnp.float32)
    res = minimize(quad_fun, x0, max_iter=5, aot_key="nope")
    assert not os.listdir(aot_dir)
    assert float(res.f) < 1e-6


def test_corrupt_entry_falls_back_and_heals(aot_dir):
    x0 = jnp.asarray(np.full(4, 1.0), jnp.float32)
    minimize(quad_fun, x0, max_iter=5, aot_key="heal")
    (entry,) = [f for f in os.listdir(aot_dir) if f.endswith(".jaxexe")]
    with open(os.path.join(aot_dir, entry), "wb") as fh:
        fh.write(b"garbage")
    aot._LOADED.clear()
    res = minimize(quad_fun, x0, max_iter=5, aot_key="heal")
    assert float(res.f) < 1e-6  # rebuilt + rewrote the entry
    assert os.path.getsize(os.path.join(aot_dir, entry)) > 100


def test_train_aot_cross_call(aot_dir):
    """End-to-end: train() populates the AOT cache and a cache-served
    repeat train produces the same fit."""
    import gpz_tpu

    rng = np.random.default_rng(0)
    n = 160
    X = rng.standard_normal((n, 2))
    y = np.sin(X[:, 0])
    va = np.zeros(n, bool)
    va[120:] = True
    model0 = gpz_tpu.init(X, y, "VD", 6, seed=0)
    m1 = gpz_tpu.train(model0, X, y, training=~va, validation=va,
                       max_iter=4, verbose=False)
    assert any(f.endswith(".jaxexe") for f in os.listdir(aot_dir))
    aot._LOADED.clear()
    m2 = gpz_tpu.train(model0, X, y, training=~va, validation=va,
                       max_iter=4, verbose=False)
    assert m1.fit_info["final_nlml"] == m2.fit_info["final_nlml"]
    assert m1.fit_info["iterations"] == m2.fit_info["iterations"]
