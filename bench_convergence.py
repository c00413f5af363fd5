"""North-star wall-clock benchmark (BASELINE.json): synthetic-SDSS VC m=100
heteroscedastic trained to the float64 port-of-record log-ML, in seconds.

Protocol (BASELINE.md steps 2-3): the "reference log-ML" is what the strict
float64 solve path converges to on the same seeded problem; the shipped
float32 default path must reach it and the wall clock to get there is
the headline number (BASELINE.json's budget: < 60 s on one device, warm
compilation cache).

Usage:
  python bench_convergence.py                # benchmark the shipped config
  python bench_convergence.py --target       # (re)compute the f64 target
                                             # (runs on CPU, dtype float64 —
                                             # the reference-pipeline analogue)
  python bench_convergence.py --study        # shipped + f32 ablation

Prints one JSON line per run. The committed f64 target lives in
benchmarks/convergence_target.json; a run refuses to define a target unless
its optimizer status is a genuine termination (OPTIMAL / STEP_TOO_SMALL /
MAX_ITER / EARLY_STOP).
"""

import argparse
import dataclasses
import json
import os
import time

import numpy as np

TARGET_FILE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "benchmarks", "convergence_target.json",
)

#: measurement records (not committed: see .gitignore)
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")

N_TRAIN = 70_000
N_VALID = 10_000
M = 100
SEED = 1
# iteration budget, NOT part of the metric (seconds_to_target attributes
# wall clock up to the band crossing; unused budget costs nothing). 320
# leaves room for the requantized-restart refine segments: the shipped
# trajectory spends ~84 mixed + ~77 + ~100 f64 iterations reaching the
# f64 target band (round-5; the committed target itself is unchanged)
MAX_ITER = 320
MAX_ATTEMPTS = 50


def build_problem():
    from gpz_tpu.data.photoz import synthetic_sdss

    mags, errs, z = synthetic_sdss(N_TRAIN + N_VALID, filters=5, seed=SEED)
    psi = errs**2                      # ref demo_photoz.m:54-62: Psi = e^2
    tr = np.zeros(len(z), bool)
    va = np.zeros(len(z), bool)
    tr[:N_TRAIN] = True
    va[N_TRAIN:] = True
    return mags, z, psi, tr, va


def run_training(solve_mode, solve_dtype="auto", dtype="float32",
                 _problem_cache={}):
    """Train once; returns (model, seconds). The seeded problem is cached so
    repeat calls in one process time only training."""
    import gpz_tpu

    if "p" not in _problem_cache:
        _problem_cache["p"] = build_problem()
    X, Y, psi, tr, va = _problem_cache["p"]
    model = gpz_tpu.init(X, Y, "VC", M, heteroscedastic=True,
                         training=tr, psi=psi, seed=SEED, dtype=dtype)
    model = dataclasses.replace(
        model,
        cfg=dataclasses.replace(
            model.cfg, solve_mode=solve_mode, solve_dtype=solve_dtype
        ),
    )
    t0 = time.perf_counter()
    model = gpz_tpu.train(
        model, X, Y, training=tr, validation=va, psi=psi,
        max_iter=MAX_ITER, max_attempts=MAX_ATTEMPTS, verbose=False,
    )
    seconds = time.perf_counter() - t0
    return model, seconds


#: terminal statuses that mean "the optimizer genuinely finished"
#: (gpz_tpu.optim.lbfgs codes: OPTIMAL, STEP_TOO_SMALL, MAX_ITER, EARLY_STOP).
#: LS_FAILED (5) / NO_DESCENT (6) runs must never define a target — that is
#: exactly how a 2-iteration premature stop got committed as "the f64 target"
#: in round 2 (VERDICT r2 weak #2/#8).
CONVERGED_STATUSES = {1: "optimal", 2: "step_too_small",
                      3: "max_iter", 4: "early_stop"}


def summarize(model, seconds, label):
    tr = model.fit_info["trace"]
    n_it = model.fit_info["iterations"]
    status = int(model.fit_info["status"])
    f = np.asarray(tr["f"][: n_it + 1], dtype=np.float64)
    fev = np.asarray(tr.get("fevals", np.full(n_it + 1, np.nan)))
    out = {
        "label": label,
        "final_nlml": float(f[n_it]),
        "best_nlml": float(np.nanmin(f)),
        "best_valid_ll": float(model.best.score),
        "iterations": int(n_it),
        "fun_evals": int(model.fit_info["fun_evals"]),
        "status": status,
        "status_name": CONVERGED_STATUSES.get(status, f"FAILED({status})"),
        "converged": status in CONVERGED_STATUSES,
        "seconds_total": round(seconds, 2),
        "train_seconds": round(model.fit_info["seconds"], 2),
        "phase_seconds": model.fit_info.get("phase_seconds"),
        "phase_iterations": model.fit_info.get("phase_iterations"),
        "phase1_iterations": model.fit_info.get("phase1_iterations"),
        # non-phase wall inside train(): host prep / inter-phase glue
        # (f64 recast + segment trace downloads) / posterior resolution
        "prep_seconds": model.fit_info.get("prep_seconds"),
        "between_seconds": model.fit_info.get("between_seconds"),
        "finalize_seconds": model.fit_info.get("finalize_seconds"),
    }
    it1 = model.fit_info.get("phase1_iterations")
    if it1 is not None:
        # where the mixed phase stalled, and what the f64 endgame then had
        # to close — the compute budget's two halves (PRECISION.md §2)
        out["phase1_final_nlml"] = float(f[it1])
        out["phase1_fun_evals"] = int(fev[it1])
    return out, f, fev


def time_to_target(f, fev, total_seconds, total_evals, target, tol,
                   phase_seconds=None, phase1_iterations=None,
                   phase_iterations=None):
    """Seconds until the trace first reaches target (+tol), attributing wall
    clock by cumulative objective evals. The phases' per-eval costs differ
    (a float32 eval is cheaper than a float64 one), so when phase
    timings are available each phase's wall is attributed uniformly over
    ITS OWN evals instead of pooling — `phase_iterations` (fit_info) gives
    the per-phase iteration counts; in the stitched trace phase p spans
    [sum(it_j)+p .. sum(it_j)+p+it_p] (each later phase contributes its
    row-0 re-eval of the previous phase's final iterate, model.py
    stitch_phase_traces)."""
    hit = np.nonzero(f <= target + tol)[0]
    if len(hit) == 0:
        return None
    i = int(hit[0])
    # fevals traces are int32 with a -1 "unrecorded" sentinel, which IS
    # finite — guard on >= 0 (and on the window fitting inside the trace)
    # so an unstitched/truncated trace falls back to index-proportional
    # attribution instead of producing garbage seconds (ADVICE r3 #1)
    fev_ok = i < len(fev) and bool(np.all(np.asarray(fev[: i + 1]) >= 0))
    if (
        phase_seconds is not None
        and phase_iterations is not None
        and len(phase_seconds) == len(phase_iterations)
        and fev_ok
    ):
        start = 0  # stitched index where the current phase's row 0 sits
        total = 0.0
        for p, (secs, its) in enumerate(zip(phase_seconds,
                                            phase_iterations)):
            end = start + int(its)
            if i <= end:
                fe_start = float(fev[start])
                fe_end = float(fev[end])
                frac = (float(fev[i]) - fe_start) / max(fe_end - fe_start,
                                                        1.0)
                return total + secs * frac
            total += secs
            start = end + 1  # skip the next phase's row-0 re-eval
        # hit beyond the recorded phases (inconsistent metadata): fall
        # through to the pooled attribution below
    if fev_ok:
        evals_at = float(fev[i])
    else:
        evals_at = total_evals * (i / max(len(f) - 1, 1))
    return total_seconds * evals_at / max(total_evals, 1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", action="store_true",
                    help="recompute the strict-f64 target nlml")
    ap.add_argument("--study", action="store_true",
                    help="run strict/mixed/f32 and compare")
    ap.add_argument("--fresh-only", action="store_true",
                    help="one training run in this (fresh) process, "
                    "appended to chiprun_out/convergence_fresh.json with "
                    "the fresh_process label — the BASELINE.md 'run the "
                    "tool, get the model' condition")
    args = ap.parse_args()

    if args.target:
        # The reference pipeline is MATLAB float64 end to end; the honest
        # target is therefore dtype=float64 + strict f64 reductions, run on
        # CPU where f64 is native. Forced BEFORE the first backend touch.
        import jax

        jax.config.update("jax_platforms", "cpu")
        model, secs = run_training("strict", "float64", dtype="float64")
        out, f, _ = summarize(model, secs, "f64_cpu")
        print(json.dumps(out))
        if not out["converged"]:
            raise SystemExit(
                f"REFUSING to write target: f64 run ended "
                f"{out['status_name']} after {out['iterations']} iterations "
                f"— a target must come from a genuinely finished run"
            )
        # the target is the best nlml the finished f64 run visited: the
        # early-stopped final iterate can sit slightly above the best one
        payload = {
            "target_nlml": out["best_nlml"],
            "best_valid_ll": out["best_valid_ll"],
            "config": {"n_train": N_TRAIN, "m": M, "seed": SEED,
                       "max_iter": MAX_ITER, "max_attempts": MAX_ATTEMPTS,
                       "dtype": "float64", "platform": "cpu"},
            "run": out,
        }
        os.makedirs(os.path.dirname(TARGET_FILE), exist_ok=True)
        with open(TARGET_FILE, "w") as fh:
            json.dump(payload, fh, indent=1)
        return

    if not os.path.exists(TARGET_FILE):
        raise SystemExit("no committed target; run --target first")
    with open(TARGET_FILE) as fh:
        target = json.load(fh)
    tgt = target["target_nlml"]
    # tolerance: reach within 0.1% of the f64 target's distance from the
    # init value — effectively "converged to the same log-ML"
    tol = 1e-3 * abs(tgt)

    if args.fresh_only:
        model, secs = run_training("mixed", "auto")
        out, f, fev = summarize(model, secs, "fresh_process")
        t_hit = time_to_target(
            f, fev, out["train_seconds"], out["fun_evals"], tgt, tol,
            phase_seconds=out.get("phase_seconds"),
            phase1_iterations=out.get("phase1_iterations"),
            phase_iterations=out.get("phase_iterations"),
        )
        out["target_nlml"] = tgt
        out["reached_target"] = t_hit is not None
        out["seconds_to_target"] = None if t_hit is None else round(t_hit, 2)
        print(json.dumps(out), flush=True)
        rec_file = os.path.join(OUT_DIR, "convergence_fresh.json")
        os.makedirs(OUT_DIR, exist_ok=True)
        recs = {"fresh_process_runs": []}
        if os.path.exists(rec_file):
            with open(rec_file) as fh:
                recs = json.load(fh)
        recs.setdefault("fresh_process_runs", []).append(out)
        recs["target"] = target["target_nlml"]
        with open(rec_file, "w") as fh:
            json.dump(recs, fh, indent=1)
        return

    # the shipped config: mixed fast phase + automatic strict refinement
    # (TrainConfig.refine="auto")
    runs = [("mixed", "auto", "mixed")]
    if args.study:
        runs.append(("mixed", "float32", "f32"))

    results = []
    mixed_fresh = mixed_warm = None  # the two headline runs, by name —
    # positional indexing into `results` silently misattributed the
    # north-star metric when runs were reordered (ADVICE r4 #4)
    for mode, sdt, label in runs:
        # two identical trainings in one process: run 1 pays the per-process
        # handling (jax trace + persistent-cache executable reads — no
        # recompiles when the cache is warm), run 2 measures the pure
        # compute + dispatch floor the handling sits on. Both are recorded;
        # the headline is run 1 (a fresh process with a warm cache — the
        # BASELINE.md condition), run 2 bounds what handling work remains.
        for attempt in (1, 2):
            model, secs = run_training(mode, sdt)
            out, f, fev = summarize(
                model, secs,
                label if attempt == 1 else f"{label}_process_warm",
            )
            t_hit = time_to_target(
                f, fev, out["train_seconds"], out["fun_evals"], tgt, tol,
                phase_seconds=out.get("phase_seconds"),
                phase1_iterations=out.get("phase1_iterations"),
                phase_iterations=out.get("phase_iterations"),
            )
            out["target_nlml"] = tgt
            out["reached_target"] = t_hit is not None
            out["seconds_to_target"] = (
                None if t_hit is None else round(t_hit, 2)
            )
            results.append(out)
            if label == "mixed":
                if attempt == 1:
                    mixed_fresh = out
                else:
                    mixed_warm = out
            print(json.dumps(out), flush=True)
            if label != "mixed":
                break
        if label == "mixed":
            print(json.dumps({
                "metric": "seconds_to_f64_logML_VC_m100_n70k",
                "value": mixed_fresh["seconds_to_target"],
                "unit": "s",
                "vs_baseline": (
                    None if mixed_fresh["seconds_to_target"] is None
                    else round(60.0 / mixed_fresh["seconds_to_target"], 3)
                ),
                "process_warm_value": mixed_warm["seconds_to_target"],
            }))

    # the run's result next to the target it chased
    result_file = os.path.join(OUT_DIR, "convergence_result.json")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(result_file, "w") as fh:
        json.dump({"target": target, "runs": results}, fh, indent=1)


if __name__ == "__main__":
    main()
