"""2-D demo (ref demo_2D.m): GMM-generated surface, input noise, 50%
missing-at-random feature deletion, and prediction with a fully-missing
column compared against a reference model retrained on the observed column.

Run: python demos/demo_2d.py [--m 50] [--method VD]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import numpy as np

import gpz_tpu


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend even where a GPU is "
                    "present")
    ap.add_argument("--m", type=int, default=50)
    ap.add_argument("--method", default="VD")
    ap.add_argument("--max-iter", type=int, default=500)
    ap.add_argument("--max-attempts", type=int, default=50)
    ap.add_argument("--percentage", type=float, default=0.5)
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    rng = np.random.default_rng(args.seed)

    means = [np.array([10, 0]), np.array([10, 10]), np.array([5, 5])]
    covs = [
        np.array([[10.0, 0], [0, 1]]),
        np.array([[5.0, -3], [-3, 3]]),
        np.array([[2.0, 0], [0, 2]]),
    ]
    X = np.vstack([rng.multivariate_normal(mu, C, 1000) for mu, C in zip(means, covs)])
    n, d = X.shape

    def mvnpdf(x, mu, C):
        diff = x - mu
        Ci = np.linalg.inv(C)
        q = np.einsum("nd,de,ne->n", diff, Ci, diff)
        return np.exp(-0.5 * q) / (2 * np.pi * np.sqrt(np.linalg.det(C)))

    PHI = np.stack([mvnpdf(X, mu, C) for mu, C in zip(means, covs)], axis=1)
    w = np.array([-9.0, 6.0, 3.0])
    Y = PHI @ w + rng.standard_normal(n) * 0.01

    # input noise (ref demo_2D.m:45-60)
    E, V = 0.5, 0.25
    psi = rng.gamma(E**2 / V, V / E, size=(n, 2))
    Xn = X + rng.standard_normal((n, 2)) * np.sqrt(psi)
    full_cov = args.method in ("GC", "VC")
    psi_in = psi
    if full_cov:
        cube = np.zeros((n, 2, 2))
        cube[:, 0, 0] = psi[:, 0]
        cube[:, 1, 1] = psi[:, 1]
        psi_in = cube

    # delete one variable from half the selected rows (demo_2D.m:72-78)
    if args.percentage > 0:
        r = rng.permutation(n)
        psize = int(np.ceil(args.percentage * n / 2))
        Xn[r[:psize], 0] = np.nan
        Xn[r[psize : 2 * psize], 1] = np.nan

    tr, va, te = gpz_tpu.datautils.split(n, 0.7, 0.15, 0.15, rng)

    model = gpz_tpu.init(
        Xn, Y, args.method, args.m, heteroscedastic=True, training=tr,
        psi=psi_in, seed=args.seed, dtype=args.dtype,
    )
    model = gpz_tpu.train(
        model, Xn, Y, training=tr, validation=va, psi=psi_in,
        max_iter=args.max_iter, max_attempts=args.max_attempts,
    )

    # predict with one variable fully missing vs retrained reference model
    rmses = np.zeros((2, 2))
    for o in range(2):
        Xs = np.full((te.sum(), 2), np.nan)
        Xs[:, o] = X[te, o]
        mu = gpz_tpu.predict(Xs, model).mu[:, 0]
        rmses[0, o] = np.sqrt(np.mean((Y[te] - mu) ** 2))

        removed = np.isnan(Xn[:, o])
        psi_o = psi[:, o]
        ref = gpz_tpu.init(
            Xn[:, o : o + 1], Y, args.method, args.m, heteroscedastic=True,
            training=tr & ~removed, psi=psi_o, seed=args.seed, dtype=args.dtype,
        )
        ref = gpz_tpu.train(
            ref, Xn[:, o : o + 1], Y, training=tr & ~removed,
            validation=va & ~removed, psi=psi_o,
            max_iter=args.max_iter, max_attempts=args.max_attempts,
            verbose=False,
        )
        mu_ref = gpz_tpu.predict(X[te, o : o + 1], ref).mu[:, 0]
        rmses[1, o] = np.sqrt(np.mean((Y[te] - mu_ref) ** 2))

    print("\t\t  RMSE on the test set")
    print("\t\tMissing y\tMissing x")
    print(f"Predicted\t{rmses[0, 0]:.6f}\t{rmses[0, 1]:.6f}")
    print(f"Reference\t{rmses[1, 0]:.6f}\t{rmses[1, 1]:.6f}")


if __name__ == "__main__":
    main()
