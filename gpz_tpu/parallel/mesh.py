"""Device mesh construction.

The framework's mesh has two axes (SURVEY §2.3 / §5):
  * `data`    — the sample axis n is sharded here; the objective's Gram,
                rhs, and scalar reductions psum over it (NVLink within a
                host, the network across hosts)
  * `restart` — independent random restarts / posterior chains (the GPz
                analogue of ensemble/expert parallelism); parameters are
                sharded here, data is replicated

The reference has no parallelism of any kind (single MATLAB process); this
layer is the net-new device-parallel subsystem.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"
RESTART_AXIS = "restart"


def make_mesh(
    n_data: Optional[int] = None,
    n_restart: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Create a (restart, data) mesh over the available devices.

    With n_data=None, all devices not consumed by the restart axis go to the
    data axis. Works identically on the GPUs of a host and on a
    --xla_force_host_platform_device_count CPU mesh.
    """
    devices = list(devices if devices is not None else jax.devices())
    total = len(devices)
    if n_data is None:
        if total % n_restart != 0:
            raise ValueError(
                f"{total} devices not divisible by n_restart={n_restart}"
            )
        n_data = total // n_restart
    if n_restart * n_data > total:
        raise ValueError(
            f"mesh ({n_restart} x {n_data}) exceeds {total} devices"
        )
    grid = np.asarray(devices[: n_restart * n_data]).reshape(n_restart, n_data)
    return Mesh(grid, (RESTART_AXIS, DATA_AXIS))
