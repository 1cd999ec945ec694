"""Device mesh construction for data-parallel FAD.

The reference has no distributed layer at all (SURVEY.md §2, §5.8) — its only
concurrency is a decode thread pool. Here a 1-D ``Mesh`` spans the devices:
the per-file/per-patch batch is sharded over the 'data' axis with shard_map,
and the streaming (N, Σx, Σxxᵀ) accumulators are psum-reduced across devices.
Multi-host runs extend the same mesh via jax.distributed (initialize() before
calling data_mesh()).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"


def data_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D data-parallel mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def pad_to_shards(n: int, num_shards: int) -> int:
    """Smallest multiple of num_shards >= n (batch padding for even sharding)."""
    return ((n + num_shards - 1) // num_shards) * num_shards


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host initialization via jax.distributed.

    Call once per process before data_mesh(); afterwards jax.devices() spans
    every process and the same shard_map/psum programs scale across hosts.
    Pass all three arguments where no cluster environment announces them.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
