"""Multi-process (multi-host) entry points: jax.distributed + global mesh.

The reference scales construction across machines with MPI ranks
(/root/reference/src/mpi/mpi_utils.hh:148-218 MPI_handler init/finalize;
femto_index runs under mpirun).  The equivalent here is jax.distributed:
every process runs the SAME program over a global mesh, and the shard_map
collectives that carry the build go through NCCL, with no code changes to
the build itself.  On one host, one process drives all of its cards (four
H100s over NVLink) and needs none of this module: make_mesh(4) is enough.

Typical multi-host launch (one process per host; nothing tells JAX of the
cluster, so the coordinator is named explicitly):

    from femto_tpu.parallel import distributed as ftd
    ftd.initialize("host0:<port>", num_processes=2, process_id=0)
    mesh = ftd.global_mesh()
    index = build_index_sharded(prepared, mesh)

CPU testing uses two localhost processes with gloo collectives
(tests/test_multiprocess.py), mirroring the reference's mpirun-on-one-host
test strategy (SURVEY.md §4.3).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               cpu_collectives: Optional[str] = None) -> None:
    """Initialize jax.distributed.  Pass the coordinator address, the
    process count and this process's id; without them JAX can only
    auto-discover clusters whose environment describes them.

    cpu_collectives: set to "gloo" for multi-process CPU runs (tests)."""
    import jax

    if cpu_collectives:
        jax.config.update("jax_cpu_collectives_implementation",
                          cpu_collectives)
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes,
                      process_id=process_id)
    jax.distributed.initialize(**kwargs)


def global_mesh(axis: str = "bins"):
    """1-D mesh over every device of every process."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def put_global(arr, sharding):
    """Place a host array onto a (possibly multi-process) sharding.

    Single-process: plain device_put.  Multi-process: every process holds
    the full host array and materializes only its addressable shards (for
    production multi-host corpus loading, feed per-host slices through
    jax.make_array_from_process_local_data instead)."""
    import jax

    arr_np = np.asarray(arr)
    if jax.process_count() == 1:
        return jax.device_put(arr_np, sharding)
    return jax.make_array_from_callback(
        arr_np.shape, sharding, lambda idx: arr_np[idx]
    )
