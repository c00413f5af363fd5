"""Test configuration: 8 virtual CPU devices + float64 for parity tests.

Must run before the first JAX backend initialization. The platform is pinned
to the CPU through jax.config unless GPZ_GPU_TESTS=1, which leaves the GPU
visible for the `gpu`-marked tests (tests/test_gpu.py):

    GPZ_GPU_TESTS=1 python -m pytest tests/test_gpu.py -m gpu -q
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

if os.environ.get("GPZ_GPU_TESTS") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# persistent compilation cache: the sharded/while-loop programs are expensive
# to compile on CPU; repeat test runs hit the cache. Same rule as the package
# (gpz_tpu.cache_dir): JAX_COMPILATION_CACHE_DIR when set — JAX reads it
# itself — else the fixed <checkout>/.jax_cache.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.abspath(
            os.path.join(os.path.dirname(__file__), "..", ".jax_cache")
        ),
    )
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere; run with "
        "GPZ_GPU_TESTS=1)"
    )
    config.addinivalue_line(
        "markers", "slow: long-running; tier-1 deselects with -m 'not slow'"
    )


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX's default backend has
    none. Decided here, at run time, never while a module is imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default device is {dev.platform}; run "
                    "with GPZ_GPU_TESTS=1 on a machine with a card)")
    return dev
