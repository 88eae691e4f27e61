"""Multi-host initialization helpers.

Across hosts each host runs the same program; `jax.distributed` wires the
process group (give it coordinator_address, num_processes and process_id)
and `jax.devices()` spans every device, so the landmark mesh in
rso.ba.distributed covers all hosts — XLA routes the psum over the links
between them.  Nothing else in the framework changes per host.

Multi-host runs are validated with multi-process CPU (tests/test_multihost.py drives two OS processes
with a shared coordinator, the jax.distributed equivalent of the
reference's absent MPI layer).
"""
from __future__ import annotations

import os


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None):
    """Initialize jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    No-op when single-process."""
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return False
    num_processes = int(num_processes
                        or os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = int(process_id or os.environ.get("JAX_PROCESS_ID", "0"))
    if num_processes <= 1:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_landmark_mesh(axis: str = "lmk"):
    """Mesh over every global device (all hosts) for the distributed BA."""
    import numpy as np

    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), axis_names=(axis,))
