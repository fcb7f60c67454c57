"""Scenario-parallel scaling-efficiency report over a device mesh.

BASELINE asks for solves/s efficiency at 1 chip / 1 host / N hosts; this
reports scaling over however many devices the runtime exposes (run with
JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 for
the virtual mesh; on a 4-GPU host it uses the real cards unchanged).

Usage: python benchmarks/scaling.py [scenarios_per_device] [steps] [out.json]
"""

import dataclasses
import json
import os
import sys
import time

import jax

try:
    import mpc_sensorlessao_tpu  # noqa: F401  (installed package)
except ImportError:  # source checkout without `pip install -e .`
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
from mpc_sensorlessao_tpu.models import pipeline                 # noqa: E402
from mpc_sensorlessao_tpu.parallel import mesh as mesh_lib       # noqa: E402
from mpc_sensorlessao_tpu.parallel import montecarlo             # noqa: E402
from mpc_sensorlessao_tpu.utils.config import reference_config   # noqa: E402


def main():
    per_dev = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    out_path = sys.argv[3] if len(sys.argv) > 3 else None
    cfg = reference_config(resolution=64)
    cfg = cfg.replace(sim=dataclasses.replace(
        cfg.sim, n_train=300, n_valid=50, n_test=steps))
    system = pipeline.build(cfg, jax.random.PRNGKey(0))

    n_devices = len(jax.devices())
    results = {}
    for nd in sorted({1, max(n_devices // 2, 1), n_devices}):
        m = mesh_lib.scenario_mesh(n_devices=nd)
        scen = montecarlo.make_scenarios(cfg, jax.random.PRNGKey(1),
                                         per_dev * nd)
        run = lambda: montecarlo.run_sharded(
            system.loop, system.layers, cfg, scen, n_steps=steps, mesh=m,
            shared_window=True)
        jax.block_until_ready(run())
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(run())
            best = min(best, time.perf_counter() - t0)
        rate = per_dev * nd * steps / best
        results[nd] = rate
        eff = rate / (results[1] * nd) if 1 in results and nd > 1 else 1.0
        print(f"devices={nd:2d} scenarios={per_dev*nd:4d}: "
              f"{rate:,.0f} solves/s  efficiency={eff*100:.0f}%")
    if out_path:
        report = {
            "platform": jax.devices()[0].platform,
            "n_devices": n_devices,
            "scenarios_per_device": per_dev,
            "steps": steps,
            "solves_per_s": {str(k): round(v, 1) for k, v in results.items()},
            "efficiency": {str(k): round(v / (results[1] * k), 4)
                           for k, v in results.items()},
        }
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")


if __name__ == "__main__":
    main()
