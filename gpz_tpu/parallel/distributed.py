"""Multi-host initialization and data loading helpers.

The reference is single-process (SURVEY §2.3: no distributed backend at all).
Here, multi-host runs use jax.distributed + the same (restart, data) mesh:
each host initializes the runtime, loads only its row range of the catalog,
and the SPMD objective's psums ride NVLink within a host and the network
across hosts.

Typical multi-host entry:

    from gpz_tpu.parallel import distributed as dist
    dist.initialize(addr, n_hosts, host_id)  # or env-driven where JAX detects a cluster
    mesh = make_mesh()                      # all global devices
    lo, hi = dist.host_row_range(n_total)
    X_local = load_rows(path, lo, hi)       # native CSV reader w/ skip_rows
    data = dist.global_dataset(local_data, mesh)
    res, unravel = train_sharded(params0, data, cfg, mesh, ...)

Single-host usage needs none of this — the mesh over local devices suffices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gpz_tpu.dataset import Dataset
from gpz_tpu.parallel.mesh import DATA_AXIS


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed. Where JAX detects a cluster environment
    the arguments are discovered from it; pass them explicitly elsewhere
    (e.g. coordinator_address="localhost:<port>" on one machine). Idempotent.

    Must run before the first backend touch — NOTE the idempotence probe
    deliberately uses jax.distributed.is_initialized(), not
    jax.process_count(): the latter initializes the local backend, after
    which jax.distributed.initialize() fails — the original version of this
    function poisoned itself that way and silently fell back to
    single-process (caught by tests/test_distributed.py)."""
    if jax.distributed.is_initialized():
        return
    if coordinator_address is not None:
        # explicit multi-process setup: failures here are real errors and
        # must propagate — swallowing them silently degrades a multi-host
        # run to npro=1
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return
    try:
        jax.distributed.initialize()
    except (RuntimeError, ValueError):
        # env-discovery found no coordinator: a single-process run
        pass


def host_row_range(n_total: int) -> Tuple[int, int]:
    """Contiguous row range this host should load (balanced split)."""
    p = jax.process_count()
    i = jax.process_index()
    base = n_total // p
    extra = n_total % p
    lo = i * base + min(i, extra)
    hi = lo + base + (1 if i < extra else 0)
    return lo, hi


def global_dataset(local: Dataset, mesh: Mesh) -> Tuple[Dataset, jax.Array]:
    """Assemble per-host row shards into one globally-sharded Dataset.

    Each host passes only its local rows; the result is a global array view
    sharded on the mesh's data axis (jax.make_array_from_process_local_data).
    Local row counts must already be equal across hosts (pad with omega=0
    rows via dataset.pad_dataset if needed). Returns (dataset, n_eff) where
    n_eff is the global count of nonzero-weight rows.
    """
    import jax.numpy as jnp

    sharding = NamedSharding(mesh, P(DATA_AXIS))

    def to_global(x):
        if x is None:
            return None
        return jax.make_array_from_process_local_data(sharding, np.asarray(x))

    out = Dataset(
        X=to_global(local.X),
        mask=to_global(local.mask),
        omega=to_global(local.omega),
        Y=to_global(local.Y),
        psi=to_global(local.psi),
    )
    local_count = float(np.sum(np.asarray(local.omega) > 0))
    # sum of real rows across hosts (host-side allreduce via process_allgather
    # would need jax.experimental.multihost_utils; a cheap psum does it)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        local_count = float(
            np.sum(multihost_utils.process_allgather(np.asarray(local_count)))
        )
    return out, jnp.asarray(local_count, out.X.dtype)
