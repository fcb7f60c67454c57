"""Multi-host execution helpers.

BASELINE config 5: 100k+ scenario rollouts across hosts with statistics
reduced via collectives.  The scenario-sharded `montecarlo.run_sharded`
path is already multi-host-clean -- under `jax.distributed`,
`jax.devices()` spans every host, the mesh covers all of them, and each
process feeds only its addressable shard.  This module adds the process
bootstrap and global-array assembly glue.

Launch ONE process per host: it drives every card of its host (JAX's
default for a process started without ``local_device_ids``), and
`jax.distributed` joins the hosts.  Two processes on one host would each
claim all of its cards.  Run on every host:
    python -m mpc_sensorlessao_tpu.parallel.multihost \
        --coordinator=HOST0:1234 --num-processes=N --process-id=i
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from .mesh import SCENARIO_AXIS, scenario_mesh


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed bootstrap (no-op for single-process runs)."""
    if coordinator is None:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def global_scenarios(scen, mesh) -> object:
    """Assemble a process-local ScenarioBatch into a global sharded batch.

    Each process passes its local shard (n_global / n_processes scenarios);
    the result is a global array spanning the mesh.
    """
    sharding = NamedSharding(mesh, P(SCENARIO_AXIS))

    def put(local):
        local = np.asarray(local)
        global_shape = (local.shape[0] * jax.process_count(),
                        *local.shape[1:])
        return jax.make_array_from_process_local_data(
            sharding, local, global_shape)

    return jax.tree.map(put, scen)


def main(argv=None):
    import argparse
    import dataclasses

    from ..models import pipeline
    from ..utils.config import reference_config
    from . import montecarlo

    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--scenarios-per-device", type=int, default=16)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--resolution", type=int, default=128)
    args = p.parse_args(argv)

    initialize(args.coordinator, args.num_processes, args.process_id)
    cfg = reference_config(resolution=args.resolution)
    cfg = cfg.replace(sim=dataclasses.replace(
        cfg.sim, n_train=300, n_valid=50, n_test=args.steps))
    system = pipeline.build(cfg, jax.random.PRNGKey(0))
    mesh = scenario_mesh()
    n = args.scenarios_per_device * mesh.devices.size
    scen = montecarlo.make_scenarios(cfg, jax.random.PRNGKey(1), n)
    stats = montecarlo.run_sharded(system.loop, system.layers, cfg, scen,
                                   n_steps=args.steps, mesh=mesh)
    if jax.process_index() == 0:
        print({k: float(v) for k, v in stats._asdict().items()})


if __name__ == "__main__":
    main()
