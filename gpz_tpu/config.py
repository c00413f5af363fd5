"""Typed configuration objects.

The reference passes MATLAB name/value pairs parsed at each API entry
(ref GPz/init.m:6-10, GPz/train.m:25-28, GPz/predict.m:5-8); here they are
explicit frozen dataclasses with the same names and defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

METHODS = ("GL", "VL", "GD", "VD", "GC", "VC")

#: methods with full (d x d) covariance per basis — the 'C' family
FULL_COV_METHODS = ("GC", "VC")

#: solve_mode="auto" per platform. Both CPU and GPU have float64 in hardware,
#: so the n-reductions accumulate directly in float64; on the H100 this beat
#: the mixed Ozaki/fast-solve path per objective+gradient eval (PRECISION.md
#: "GPU numerics path").
AUTO_SOLVE_MODE = {"cpu": "strict", "gpu": "strict"}


def platform() -> str:
    """The default JAX backend's platform, which must be "cpu" or "gpu".

    Every platform-dependent default (AUTO_SOLVE_MODE, the Ozaki Gram gate in
    objective.py) is keyed by this name; an unknown platform raises instead
    of silently taking some other platform's numerics."""
    import jax

    name = jax.default_backend()
    if name not in AUTO_SOLVE_MODE:
        raise RuntimeError(
            f"unsupported JAX platform {name!r}: gpz_tpu runs on "
            f"{sorted(AUTO_SOLVE_MODE)}"
        )
    return name


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model structure. Hashable: usable as a jit static argument.

    Mirrors the `model` struct fields of ref GPz/init.m:16-20.
    """

    m: int                      # number of basis functions
    d: int                      # input dimensionality
    k: int = 1                  # output dimensionality
    method: str = "VL"          # one of GL/VL/GD/VD/GC/VC
    heteroscedastic: bool = True
    normalize: bool = True
    dtype: str = "float32"      # compute dtype ("float64" for parity tests)
    # dtype of the REDUCED quantities (Gram, rhs, every scalar evidence term):
    # "auto" resolves to float64 when jax x64 is enabled, float32 otherwise.
    # The objective VALUE benefits from resolving differences below float32
    # eps for the Wolfe line search / progress tests (ref minFunc
    # progTol=1e-9); see `solve_mode` for HOW the f64 quantities are obtained.
    solve_dtype: str = "auto"
    # How the n-reductions are computed (the m x m factorization and solves
    # ALWAYS run in solve_dtype — an f32-factor-plus-one-refinement scheme
    # broke down at cond(SIGMA) ~ 1/eps_f32 mid-training; see the note in
    # objective._gram_terms and PRECISION.md):
    #   "strict" — accumulate the n-contractions directly in solve_dtype
    #              (native float64 on CPU and GPU),
    #   "mixed"  — per-block f32 partial Gram (precision=HIGHEST) with
    #              cross-block accumulation in solve_dtype. Per-entry
    #              error ~sqrt(block) * eps_f32 independent of n; measured
    #              agreement with strict recorded in PRECISION.md.
    #   "mixed_strict" — mixed Gram reductions but the m x m solve PINNED to
    #              the strict f64 factorization (no equilibrated-f32 fast
    #              attempt). train() selects this when its x0 probe finds
    #              the fast solve would fall back at the starting iterate —
    #              late-training Grams (cond ~ 1e9) otherwise pay the failed
    #              fast attempt PLUS the strict fallback on every eval.
    #   "auto"   — per platform, from AUTO_SOLVE_MODE.
    solve_mode: str = "auto"

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, got {self.method!r}")
        if self.m <= 0 or self.d <= 0 or self.k <= 0:
            raise ValueError("m, d, k must be positive")
        if self.solve_dtype not in ("auto", "float32", "float64"):
            raise ValueError(f"bad solve_dtype {self.solve_dtype!r}")
        if self.solve_mode not in ("auto", "strict", "mixed", "mixed_strict"):
            raise ValueError(f"bad solve_mode {self.solve_mode!r}")

    def resolved_solve_dtype(self) -> str:
        """Concrete solve dtype ("auto" needs the process x64 state)."""
        if self.solve_dtype != "auto":
            return self.solve_dtype
        import jax

        return "float64" if jax.config.jax_enable_x64 else "float32"

    def resolved_solve_mode(self) -> str:
        """Concrete solve mode ("auto" picks by platform, AUTO_SOLVE_MODE)."""
        if self.solve_mode != "auto":
            return self.solve_mode
        return AUTO_SOLVE_MODE[platform()]

    @property
    def full_cov(self) -> bool:
        return self.method in FULL_COV_METHODS

    @property
    def gamma_shape(self) -> tuple:
        """Canonical storage shape of the length-scale parameter Gamma.

        Shapes are chosen so that `jnp.broadcast_to` expands them to the
        working shape ((m, d) for the diagonal family, (m, d, d) for the full
        family) — broadcasting makes jax.grad produce exactly the per-method
        gradient reductions of ref GPz/GPz.m:215-225 automatically.

        Degrees of freedom match ref GPz/init.m:65-86:
        GL=1, VL=m, GD=d, VD=m*d, GC=d*d, VC=m*d*d.
        """
        m, d = self.m, self.d
        return {
            "GL": (1, 1),
            "VL": (m, 1),
            "GD": (1, d),
            "VD": (m, d),
            "GC": (1, d, d),
            "VC": (m, d, d),
        }[self.method]

    @property
    def gamma_expanded_shape(self) -> tuple:
        m, d = self.m, self.d
        return (m, d, d) if self.full_cov else (m, d)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization options (ref GPz/train.m:25-28 + minFunc defaults)."""

    max_iter: int = 200
    max_attempts: Optional[int] = None   # None == inf (ref default maxAttempts=inf)
    # minFunc L-BFGS defaults (ref minFunc.m:96-101,178)
    history: int = 100                   # L-BFGS correction pairs (ref Corr=100)
    opt_tol: float = 1e-5
    prog_tol: float = 1e-9
    c1: float = 1e-4
    c2: float = 0.9
    max_ls: int = 25
    verbose: bool = True
    # Two-phase precision schedule ("auto" | "on" | "off"). A float32
    # design matrix (and, in mixed mode, the blockwise-f32 Gram's ~5e-6
    # relative entry error) puts a rounding floor under the objective;
    # late in training cond(SIGMA) amplifies it into O(1e-2) objective
    # jaggedness and the line search correctly stalls above the true
    # optimum (measured on the VC m=100 n=70k north star: mixed floors at
    # nlml -1.86 where strict continues to descend smoothly). "auto"/"on"
    # continue a stalled float32 run with the float64 objective from the
    # same iterate — most of the descent happens in the cheap float32
    # phase, and only the endgame pays for float64 end to end.
    refine: str = "auto"
    # Noise-floor patience for the NON-FINAL mixed phase (only applied when
    # `refine` will escalate to float64 afterwards — the final phase always
    # runs to its own termination). The f32 surface's useful descent is
    # front-loaded: once `phase_patience` consecutive iterations buy less
    # than `phase_patience_tol * max(1, |f|)` total decrease, the phase is
    # grinding rounding jaggedness the line search cannot resolve, and
    # every further iteration both wastes wall clock AND can walk the
    # iterate into basins the f64 endgame then escapes via expensive
    # requantized restarts. The defaults are a guard for genuinely glacial
    # phases, not an active part of a typical trajectory. patience=0
    # statically removes the check from the compiled loop.
    phase_patience: int = 10
    phase_patience_tol: float = 2e-4


@dataclasses.dataclass(frozen=True)
class PredictConfig:
    """Prediction options (ref GPz/predict.m:5-8)."""

    which_set: str = "best"      # "best" | "last"
    batch_size: int = 4096       # host-side chunking of the O(n m^2) moment pass
