"""Hard-regime solve-path selection (VERDICT r4 next #2).

At trained/continuation iterates the f32 pipeline can be unusable in two
distinct ways, seen at the trained photo-z point:
  * non-finite: cond(iSig) ~ 3e9 NaNs ~1% of the f32 design-matrix
    factorizations, NaN-ing the whole objective (every safe_cholesky then
    walks its full jitter ladder, ~8 factorizations per eval);
  * finite but hard: the equilibrated-f32 fast solve fails its residual
    gate on every eval and pays the failed attempt PLUS the strict
    fallback (the round-4 double-pay).
train() probes x0 once (objective.probe_phase) and reacts: f64 start for
the former, solve pinned to the strict factor ("mixed_strict") for the
latter. These tests cover the probe, the pinned mode's no-double-pay
property, the minimize f0 guard, and the train() wiring.
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import gpz_tpu
import gpz_tpu.model as model_mod
from gpz_tpu import linalg
from gpz_tpu import objective
from gpz_tpu.config import ModelConfig
from gpz_tpu.optim.lbfgs import minimize, STATUS_LS_FAILED


def _hard_gram(m=64, cond=1e13):
    """Finite PSD Gram whose equilibrated form still defeats f32+IR."""
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    evals = np.logspace(0, -math.log10(cond), m)
    S = (Q * evals) @ Q.T
    S = (S + S.T) / 2 + 1e-300
    rhs = rng.standard_normal((m, 1))
    return jnp.asarray(S[None]), jnp.asarray(rhs)


def test_fast_solve_ok_flags_hard_gram():
    S, rhs = _hard_gram()
    assert not bool(jax.jit(linalg.fast_solve_ok)(S, rhs))
    # an easy Gram passes
    m = 64
    rng = np.random.default_rng(1)
    A = rng.standard_normal((m, m)) * 0.1
    S_easy = jnp.asarray((A @ A.T + np.eye(m))[None])
    assert bool(jax.jit(linalg.fast_solve_ok)(S_easy, rhs))


def _toy_model(solve_mode="mixed", n=160, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 3))
    y = np.sin(X[:, 0]) + 0.1 * rng.standard_normal(n)
    va = np.zeros(n, bool)
    va[-40:] = True
    model = gpz_tpu.init(X, y, "VD", 6, seed=seed, dtype="float32",
                         solve_mode=solve_mode)
    return model, X, y, ~va, va


def test_mixed_strict_never_attempts_fast_solve(monkeypatch):
    """mixed_strict must not even TRACE the fast path — the no-double-pay
    property is structural, not a runtime branch."""
    monkeypatch.setenv("GPZ_OZAKI", "1")
    model, X, y, tr, va = _toy_model()
    from gpz_tpu.model import _make_dataset
    from gpz_tpu import datautils

    Xn = (X - model.muX[None]) / model.sdX[None]
    Yc = (y - model.muY[None, 0])[:, None]
    data = _make_dataset(Xn, Yc, None, np.ones(len(y)), tr, jnp.float32)

    def boom(*a, **kw):
        raise AssertionError("fast solve attempted under mixed_strict")

    monkeypatch.setattr(objective, "fast_solve_w_logdet", boom)
    cfg_pin = dataclasses.replace(model.cfg, solve_mode="mixed_strict")
    f, aux = jax.jit(
        lambda p, d: objective.nlog_ml(p, d, cfg_pin, complete=True)
    )(model.last.params, data)
    assert np.isfinite(float(f))

    cfg_mixed = dataclasses.replace(model.cfg, solve_mode="mixed")
    with pytest.raises(AssertionError, match="mixed_strict"):
        jax.jit(
            lambda p, d: objective.nlog_ml(p, d, cfg_mixed, complete=True)
        )(model.last.params, data)


def test_mixed_strict_matches_mixed_values(monkeypatch):
    monkeypatch.setenv("GPZ_OZAKI", "1")
    model, X, y, tr, va = _toy_model()
    from gpz_tpu.model import _make_dataset

    Xn = (X - model.muX[None]) / model.sdX[None]
    Yc = (y - model.muY[None, 0])[:, None]
    data = _make_dataset(Xn, Yc, None, np.ones(len(y)), tr, jnp.float32)
    outs = {}
    for mode in ("mixed", "mixed_strict"):
        cfgm = dataclasses.replace(model.cfg, solve_mode=mode)
        f, _ = jax.jit(
            lambda p, d, c=cfgm: objective.nlog_ml(p, d, c, complete=True)
        )(model.last.params, data)
        outs[mode] = float(f)
    # the fast solve refines to ~f64 accuracy when its gate passes, so the
    # two modes agree to solve precision
    assert abs(outs["mixed"] - outs["mixed_strict"]) < 1e-6


def test_minimize_bails_immediately_on_nonfinite_f0():
    def fun(x):
        f = jnp.where(jnp.sum(x) < 1e6, jnp.nan, 0.0)  # NaN at any sane x
        return f, jnp.ones_like(x), ()

    res = minimize(fun, jnp.zeros(4, jnp.float32), max_iter=10)
    assert int(res.status) == STATUS_LS_FAILED
    assert int(res.iterations) == 0
    assert int(res.fun_evals) <= 2


def test_train_reacts_to_probe(monkeypatch):
    """Wiring: a trained model whose probe reports (finite, no-fast) pins
    mixed_strict; (not finite, *) starts float64/strict. The probe itself
    is exercised against real hard Grams in test_fast_solve_ok_flags_hard_
    gram; here it is stubbed so the CPU test hits both branches."""
    monkeypatch.setenv("GPZ_OZAKI", "1")
    model, X, y, tr, va = _toy_model(solve_mode="mixed")
    model = gpz_tpu.train(model, X, y, training=tr, validation=va,
                          max_iter=3, verbose=False)
    assert math.isfinite(model.best.score)

    calls = {}

    def fake_probe(params, data, cfg, complete=False):
        calls["probed"] = True
        return (jnp.asarray(fake_probe.finite),
                jnp.asarray(fake_probe.fast_ok))

    monkeypatch.setattr(model_mod, "_probe_jit", fake_probe)

    fake_probe.finite, fake_probe.fast_ok = True, False
    m2 = gpz_tpu.train(model, X, y, training=tr, validation=va,
                       max_iter=3, verbose=False)
    assert calls.get("probed")
    assert m2.fit_info["solve_probe"] == {
        "pipeline_finite": True, "fast_solve_ok": False,
    }
    assert m2.fit_info["phase_modes"][0] == "float32/mixed_strict"

    fake_probe.finite, fake_probe.fast_ok = False, False
    m3 = gpz_tpu.train(model, X, y, training=tr, validation=va,
                       max_iter=3, verbose=False)
    assert m3.fit_info["phase_modes"][0] == "float64/strict"
    assert np.isfinite(m3.fit_info["final_nlml"])

    # easy probe -> unchanged fast path
    fake_probe.finite, fake_probe.fast_ok = True, True
    m4 = gpz_tpu.train(model, X, y, training=tr, validation=va,
                       max_iter=3, verbose=False)
    assert m4.fit_info["phase_modes"][0] == "float32/mixed"


def test_fresh_models_are_not_probed(monkeypatch):
    monkeypatch.setenv("GPZ_OZAKI", "1")

    def boom(*a, **kw):
        raise AssertionError("fresh model was probed")

    monkeypatch.setattr(model_mod, "_probe_jit", boom)
    model, X, y, tr, va = _toy_model(solve_mode="mixed")
    model = gpz_tpu.train(model, X, y, training=tr, validation=va,
                          max_iter=2, verbose=False)
    assert model.fit_info["solve_probe"] is None
