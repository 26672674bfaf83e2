"""Multi-host runtime initialization.

The reference's scale-out entry is ``mpirun``/SLURM launching one MPI rank
per node (reference cori_MPI_example.sh, mpi.py:31-33); the JAX
equivalent is one Python process per host joined into a global JAX
runtime. One process drives all the cards of its host (four H100s joined
by NVLink), so a single-host run needs none of this.
"""

from __future__ import annotations

import os
from typing import Optional


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the multi-host JAX runtime if this looks like a multi-host
    environment; no-op (returns False) on a single host.

    The cluster is described by explicit coordinator parameters or the
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
    environment variables (``localhost:<port>`` for processes on one
    machine); with neither, this is a single-process run.
    """
    import jax

    # NB: must not touch the backend (jax.devices/process_count) before
    # jax.distributed.initialize — it would lock in a single-process
    # runtime and make initialize() raise
    if jax.distributed.is_initialized():
        return jax.process_count() > 1
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    env_np = os.environ.get("JAX_NUM_PROCESSES")
    env_pid = os.environ.get("JAX_PROCESS_ID")
    if num_processes is None and env_np:
        num_processes = int(env_np)
    if process_id is None and env_pid:
        process_id = int(env_pid)
    if coordinator_address is None and num_processes is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True
