"""Device mesh helpers.

The reference scales over MPI ranks owning record "bins"
(/root/reference/src/dcx_cc/dcx.hh:884-935, mpi/mpi_utils.hh:148-295).  Here
one 1-D jax mesh axis plays the rank role.  The cards of one host are
joined all to all (NVLink on an H100 host), so the mesh follows the
algorithm alone; XLA hands the collectives to NCCL.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DEFAULT_AXIS = "bins"


def make_mesh(n_devices: Optional[int] = None, axis: str = DEFAULT_AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def row_sharding(mesh: Mesh, axis: str = DEFAULT_AXIS) -> NamedSharding:
    """Shard the leading (row/position) dimension across the mesh."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
