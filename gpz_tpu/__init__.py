"""gpz_tpu — sparse heteroscedastic Gaussian processes in JAX.

A from-scratch JAX/XLA re-design of the GPz basis-function model
(reference: OxfordML/GPz, MATLAB). The model is a linear combination of m
anisotropic Gaussian radial basis functions where both the predictive mean and
the log noise variance are linear in the basis activations; hyperparameters are
MAP-fit by maximizing the exact log marginal likelihood with a fully
jit-compiled L-BFGS + strong-Wolfe optimizer. Runs on the CPU and on NVIDIA
GPUs.

Capabilities (parity surface with the reference):
  * six covariance parameterizations GL/VL/GD/VD/GC/VC (ref README.md:16-22)
  * heteroscedastic noise modelling (ref GPz/getPHI.m:121-125)
  * input-noise (Psi) propagation via Gaussian convolution (ref getPHI.m:84-105)
  * missing-data marginalization for NaN inputs (ref getPHI.m:43-54)
  * cost-sensitive sample weighting omega (ref GPz/getOmega.m)
  * train/valid model selection with early stopping (ref GPz/callBack.m)
  * full uncertainty decomposition sigma = nu + beta_i + gamma
    (ref GPz/predict.m:72)

Design (not a port):
  * parameters are a typed pytree, not a packed flat vector
  * the 6 methods are one broadcast-parameterized kernel family
  * missing data becomes masked dense linear algebra, not row-group loops
  * the full analytic gradient comes from jax.grad, not 200 lines of chain rule
  * the training loop (L-BFGS + Wolfe + early stopping) is one lax.while_loop
    running entirely on device
  * the sample axis n is sharded over a device mesh with psum reductions at the
    Gram/gradient accumulation points (gpz_tpu.parallel)
"""

import os as _os


def cache_dir() -> str:
    """Root of the persistent compile caches: JAX_COMPILATION_CACHE_DIR when
    set, else the fixed <checkout>/.jax_cache (a fixed path, since the path
    is part of the cache key). gpz_tpu.aot keeps its executables under it."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache",
    )


# persistent compilation cache: training/predict programs (jitted while_loop
# over the SPMD objective) are expensive to compile. JAX reads
# JAX_COMPILATION_CACHE_DIR itself; only when it is unset is the directory
# set here. Opt out with GPZ_NO_CACHE=1.
if (_os.environ.get("GPZ_NO_CACHE") != "1"
        and not _os.environ.get("JAX_COMPILATION_CACHE_DIR")):
    import jax as _jax

    _jax.config.update("jax_compilation_cache_dir", cache_dir())

# x64 must be available for the solve_dtype=float64 path (ModelConfig): the
# objective VALUE is accumulated in f64 from the Gram reduction onward so the
# Wolfe line search and progress tests can resolve late-stage decreases
# (f32-only objectives stall the optimizer within a handful of iterations).
# Tensor compute (design matrix, prediction contractions) stays f32.
#
# jax_enable_x64 is process-global, so flipping it here changes default
# literal dtypes (i64 ints, f64 floats) for ALL JAX code in the process —
# potentially surprising for embedding applications. There is no scoped
# alternative in current JAX (jax.experimental.enable_x64 was removed in
# 0.9), so the policy is: flip only when the flag is actually False, emit a
# one-time filterable warning when we do, and offer two opt-outs:
#   * set GPZ_NO_X64=1 before import (solve_dtype degrades to float32;
#     expect earlier optimizer stalls on large n), or
#   * pre-set jax.config.update("jax_enable_x64", ...) yourself before
#     importing gpz_tpu — a pre-set value (either way) is never overridden.


class GPzX64Warning(UserWarning):
    """Warns that importing gpz_tpu enabled jax_enable_x64 process-wide."""


if _os.environ.get("GPZ_NO_X64") != "1":  # pragma: no branch
    import jax as _jax2

    if (not _jax2.config.jax_enable_x64
            and _os.environ.get("JAX_ENABLE_X64") is None):
        import warnings as _warnings

        _warnings.warn(
            "gpz_tpu enabled jax_enable_x64 process-wide (needed for the "
            "float64 solve path; see ModelConfig.solve_dtype). This changes "
            "default JAX literal dtypes to 64-bit for the whole process. "
            "Opt out with GPZ_NO_X64=1, or silence this by setting "
            "jax.config.update('jax_enable_x64', True) before import.",
            GPzX64Warning,
            stacklevel=2,
        )
        _jax2.config.update("jax_enable_x64", True)

from gpz_tpu.config import ModelConfig, TrainConfig, PredictConfig
from gpz_tpu.params import GPzParams
from gpz_tpu.dataset import Dataset
try:  # model layer lands after the numerics substrate during bring-up
    from gpz_tpu.model import (  # noqa: E402
        GPzModel, init, train, predict, sample_weights,
    )
except ImportError:  # pragma: no cover
    GPzModel = init = train = predict = sample_weights = None
from gpz_tpu import linalg, metrics, datautils  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "ModelConfig",
    "TrainConfig",
    "PredictConfig",
    "GPzParams",
    "Dataset",
    "GPzModel",
    "init",
    "train",
    "predict",
    "sample_weights",
    "linalg",
    "metrics",
    "datautils",
]
