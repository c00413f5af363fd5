"""SDSS photo-z demo (ref demo_photoz.m): magnitudes + errors -> redshift with
input-noise propagation, cost-sensitive weighting, and cumulative-confidence
metric curves.

The reference's data/sdss_sample.csv is a stripped blob; by default this uses
a statistically similar synthetic sample. Pass --data path/to.csv for a real
file in the same m_1..m_f,e_1..e_f,z_spec format.

Run: python demos/demo_photoz.py [--m 100] [--method VC]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import math

import numpy as np

import gpz_tpu
from gpz_tpu.data import load_sdss_csv, synthetic_sdss
from gpz_tpu import metrics as M


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend even where a GPU is "
                    "present")
    ap.add_argument("--data", default=None)
    ap.add_argument("--n", type=int, default=60_000)
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--method", default="VC")
    ap.add_argument("--max-iter", type=int, default=500)
    ap.add_argument("--max-attempts", type=int, default=50)
    ap.add_argument("--csl", default="normal",
                    choices=["normal", "normalized", "balanced"])
    ap.add_argument("--bin-width", type=float, default=0.1)
    ap.add_argument("--no-input-noise", action="store_true")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None, help="csv path for predictions")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    if args.data:
        mags, errs, z = load_sdss_csv(args.data)
    else:
        mags, errs, z = synthetic_sdss(n=args.n, seed=args.seed)
    n = len(z)

    omega = gpz_tpu.datautils.get_omega(z, args.csl, args.bin_width)

    if args.no_input_noise:
        X = np.hstack([mags, np.log(errs)])  # errors as extra features
        psi = None
    else:
        X = mags
        psi = errs**2  # mag errors as input-noise variance (demo_photoz.m:57)

    rng = np.random.default_rng(args.seed)
    tr, va, te = gpz_tpu.datautils.split(n, 0.2, 0.2, 0.6, rng)

    model = gpz_tpu.init(
        X, z, args.method, args.m, omega=omega, training=tr,
        heteroscedastic=True, psi=psi, seed=args.seed, dtype=args.dtype,
    )
    model = gpz_tpu.train(
        model, X, z, omega=omega, training=tr, validation=va, psi=psi,
        max_iter=args.max_iter, max_attempts=args.max_attempts,
    )

    pred = gpz_tpu.predict(X, model, psi=psi, selection=te)
    y, mu, sigma = z[te], pred.mu[:, 0], pred.sigma[:, 0]

    rmse = M.rmse_curve(y, mu, sigma)
    mll = M.cumulative_by_confidence(y, mu, sigma, M.log_likelihood)
    f15 = M.cumulative_by_confidence(y, mu, sigma, M.fr15)
    f05 = M.cumulative_by_confidence(y, mu, sigma, M.fr05)
    bi = M.cumulative_by_confidence(y, mu, sigma, M.bias)

    print("RMSE\t\tMLL\t\tFR15\t\tFR05\t\tBIAS")
    print(f"{rmse[-1]:.6f}\t{mll[-1]:.6f}\t{f15[-1]:.6f}\t{f05[-1]:.6f}\t{bi[-1]:.6f}")

    if args.out:
        np.savetxt(
            args.out,
            np.column_stack([y, mu, sigma, pred.nu[:, 0], pred.beta_i[:, 0],
                             pred.gamma[:, 0]]),
            delimiter=",",
            header="z_spec,mu,sigma,nu,beta_i,gamma", comments="",
        )


if __name__ == "__main__":
    main()
