"""Multi-host (multi-host) initialisation and mesh construction.

The reference scales with MPI ranks (mpirun); here multi-host runs use
``jax.distributed`` — one process per host, devices glued into one global
mesh. The synthesis axes map as:

* frequency → the outermost mesh axis (collective-free in the streamed
  path — safe to place on DCN between hosts),
* ℓ/ring-band sharding (for Λ tables beyond one chip's HBM) → inner interconnect
  axis.
"""

from __future__ import annotations

import os

import numpy as np
import jax
from jax.sharding import Mesh


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Initialise jax.distributed from arguments or standard env vars.

    No-op when single-process (num_processes in {None, 1} and no
    coordinator configured) so code can call it unconditionally.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "CORA_TPU_COORDINATOR"
    )
    if num_processes is None:
        num_processes = int(os.environ.get("CORA_TPU_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("CORA_TPU_PROCESS_ID", "0"))

    if num_processes <= 1 and coordinator_address is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def make_pod_mesh(freq_hosts=None, axis_names=("freq", "band")):
    """Global 2-D mesh over all devices: (frequency-shard × ring-band).

    ``freq_hosts``: size of the frequency axis; defaults to the number of
    processes (one frequency shard per host — the streamed synthesis needs
    no communication along this axis, so it rides DCN for free). The
    remaining devices per frequency shard form the inner axis for
    ring-band/ℓ sharding over the interconnect.
    """
    devices = np.asarray(jax.devices())
    n = devices.size
    if freq_hosts is None:
        freq_hosts = max(1, jax.process_count())
    if n % freq_hosts:
        raise ValueError(f"{n} devices not divisible by freq axis {freq_hosts}")
    grid = devices.reshape(freq_hosts, n // freq_hosts)
    return Mesh(grid, axis_names)
