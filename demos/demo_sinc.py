"""1-D sinc demo (ref demo_sinc.m): heteroscedastic noise + gamma-distributed
input noise + a gap in the training support.

Run: python demos/demo_sinc.py [--m 100] [--method VL] [--max-iter 500]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import math

import numpy as np

import gpz_tpu


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend even where a GPU is "
                    "present")
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--method", default="VL")
    ap.add_argument("--max-iter", type=int, default=500)
    ap.add_argument("--max-attempts", type=int, default=50)
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--no-input-noise", action="store_true")
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    rng = np.random.default_rng(args.seed)
    fx = lambda x: np.sinc(x / math.pi)  # sin(x)/x
    sx = lambda x: 0.05 + (1 / (1 + np.exp(-0.2 * x))) * (1 + np.sin(2 * x)) * 0.2

    X = np.linspace(-10, 10, args.n)
    X = X[(X < -7) | (X > -2)]  # gap in support (ref demo_sinc.m:32)
    n = len(X)
    Y = fx(X) + rng.standard_normal(n) * sx(X)

    if args.no_input_noise:
        psi = None
    else:
        E, V = 0.5, 0.25
        psi = rng.gamma(E**2 / V, V / E, size=n)
        X = X + rng.standard_normal(n) * np.sqrt(psi)

    tr, va, te = gpz_tpu.datautils.split(n, 0.7, 0.15, 0.15, rng)

    model = gpz_tpu.init(
        X[:, None], Y, args.method, args.m,
        heteroscedastic=True, training=tr, psi=psi,
        seed=args.seed, dtype=args.dtype,
    )
    model = gpz_tpu.train(
        model, X[:, None], Y, training=tr, validation=va, psi=psi,
        max_iter=args.max_iter, max_attempts=args.max_attempts,
    )

    pred = gpz_tpu.predict(X[:, None], model, psi=psi, selection=te)
    err = Y[te] - pred.mu[:, 0]
    rmse = float(np.sqrt(np.mean(err**2)))
    mll = float(
        np.mean(-0.5 * err**2 / pred.sigma[:, 0] - 0.5 * np.log(pred.sigma[:, 0]))
        - 0.5 * math.log(2 * math.pi)
    )
    print("Scores on Test Set")
    print("RMSE\t\tMLL")
    print(f"{rmse:.6f}\t{mll:.6f}")

    # posterior-sample curves (ref demo_sinc.m:77-87): draw weight samples
    # from N(w, SIGMA^-1) and push them through the design matrix on a
    # dense grid. The sampled-curve spread should blow up inside the
    # training gap and stay tight on-support — the same story the
    # reference's plot tells, summarized numerically (and plotted when
    # matplotlib is importable).
    Xs = np.linspace(-10, 10, 500)
    grid = gpz_tpu.predict(Xs[:, None], model)
    ws = gpz_tpu.sample_weights(model, n_samples=20, seed=args.seed)
    mus = grid.phi @ ws[:, 0, :] + model.muY[0]          # (500, 20)
    spread = mus.std(axis=1)
    in_gap = (Xs > -7) & (Xs < -2)
    print("Posterior-sample curves (20 draws from N(w, iSigma_w)):")
    print(f"  mean curve spread in the training gap:  {spread[in_gap].mean():.4f}")
    print(f"  mean curve spread on-support:           {spread[~in_gap].mean():.4f}")
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        band = 2.0 * np.sqrt(grid.sigma[:, 0])
        plt.fill_between(Xs, grid.mu[:, 0] - band, grid.mu[:, 0] + band,
                         color="0.85", label=r"$\pm 2\sigma(x)$")
        plt.plot(X, Y, "b.", markersize=2)
        plt.plot(Xs, mus, linewidth=0.5)
        plt.plot(Xs, fx(Xs), "k-", linewidth=2, label="sinc(x)")
        plt.plot(Xs, grid.mu[:, 0], "r-", linewidth=2, label=r"$\mu(x)$")
        plt.legend(loc="upper left")
        out_png = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "sinc_posterior_samples.png")
        plt.savefig(out_png, dpi=120)
        print(f"  wrote {out_png}")
    except ImportError:
        pass


if __name__ == "__main__":
    main()
