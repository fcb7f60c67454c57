"""Device-mesh construction for scenario-parallel Monte-Carlo scaling.

The reference has no distributed backend at all (SURVEY.md section 2: no
MPI/NCCL/Gloo; two shared-memory parfor loops).  Here (SURVEY.md section
5.8) a 1-D `jax.sharding.Mesh` shards the Monte-Carlo scenario axis across
devices and reduces statistics with collectives (`psum`, which XLA hands
to NCCL on GPUs).  Every card of a host reaches every other at the same
rate, so the mesh follows the algorithm alone.  Multi-host runs reuse the
same code: under `jax.distributed`, `jax.devices()` spans all hosts.
"""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SCENARIO_AXIS = "scenario"


def scenario_mesh(n_devices: int | None = None,
                  devices: Sequence | None = None) -> Mesh:
    """1-D mesh over the scenario (Monte-Carlo) axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (SCENARIO_AXIS,))


def scenario_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding for per-scenario arrays."""
    return NamedSharding(mesh, P(SCENARIO_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_devices(n: int, n_devices: int) -> int:
    """Smallest multiple of n_devices >= n (static shapes need even
    shards)."""
    return ((n + n_devices - 1) // n_devices) * n_devices
