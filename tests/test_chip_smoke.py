"""chip_smoke.py's phases at a tiny size on the CPU, and its refusal to run
without a GPU. On the CPU every "device" computation and its "host"
reference run on the same backend, so these pin the control flow, the
comparisons and the checks, not the GPU numerics."""

import jax
import pytest

import chip_smoke as cs
import gpz_tpu

TINY = cs.Sizes(n_train=300, n_valid=60, m=8, ref_rows=40, reps=1,
                train_iters=3, n_pred=200, pred_ref_rows=40, m_big=24,
                big_n=120, big_nq=16)


@pytest.fixture(scope="module")
def problem():
    prob = cs.make_problem(TINY)
    X, Y, psi, tr, _ = prob
    model = gpz_tpu.init(X, Y, "VC", TINY.m, training=tr, psi=psi, seed=1)
    return model, prob


def test_phase_objective_tiny(problem, capsys):
    model, prob = problem
    cs.phase_objective(model, prob, TINY, jax.devices("cpu")[0])
    out = capsys.readouterr().out
    assert out.count(" ok\n") == 8 and "FAIL" not in out
    assert "ms per value+grad eval" in out


def test_phase_train_and_predict_tiny(problem, capsys):
    model, prob = problem
    trained = cs.phase_train(model, prob, TINY)
    assert trained.fit_info["iterations"] == TINY.train_iters
    cs.phase_predict(trained, prob, TINY, jax.devices("cpu")[0])
    out = capsys.readouterr().out
    assert out.count(" ok\n") == 4 and "FAIL" not in out


def test_phase_ozaki_small(capsys):
    cs.phase_ozaki(m=8)
    out = capsys.readouterr().out
    assert "exact with f32 accumulation on this card: yes" in out


def test_phase_four_on_virtual_cpu_devices(problem, capsys):
    """The --four path on 4 of the conftest's 8 virtual CPU devices."""
    model, prob = problem
    cs.phase_four(model, prob, TINY, jax.devices()[:4])
    out = capsys.readouterr().out
    assert out.count(" ok\n") == 2 and "train_sharded" in out


def test_check_fails_on_nan_and_excess():
    cs.check("t", "fine", 1e-9, 1e-8, "r")
    for err in (1e-7, float("nan")):
        with pytest.raises(AssertionError):
            cs.check("t", "bad", err, 1e-8, "r")


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_cpu(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main(argv, devices=jax.devices("cpu"))
    assert exc.value.code not in (0, None)
    assert "needs a GPU" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_sizes_default_is_full_width():
    """The script's own run is the north-star width, not a cut."""
    s = cs.Sizes()
    assert (s.n_train, s.n_valid, s.m) == (70_000, 10_000, 100)
