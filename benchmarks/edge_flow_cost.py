"""Per-step cost of the conditional-Gaussian frozen flow on chip.

The periodic sampled flow (ops/phase_screens.py) is the fast path;
the conditional-Gaussian border extension (ops/edge_flow.py) is the
reference-parity stochastic flow (telescopeAbstract.m:823-901).  This
measures both inside the full closed-loop scan so the number is the
real marginal cost of choosing reference-parity turbulence.

Usage: python benchmarks/edge_flow_cost.py [resolution] [steps]
Env:   EFC_CPU=1
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
from mpc_sensorlessao_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
if os.environ.get("EFC_CPU"):
    jax.config.update("jax_platforms", "cpu")

from mpc_sensorlessao_tpu.models import pipeline                  # noqa
from mpc_sensorlessao_tpu.utils.config import reference_config    # noqa


def main():
    res = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 500
    report = {"resolution": res, "steps": steps,
              "device": str(jax.devices()[0])}
    for flow in ("periodic", "conditional"):
        cfg = reference_config(resolution=res)
        cfg = cfg.replace(
            atmosphere=dataclasses.replace(cfg.atmosphere, flow=flow),
            sim=dataclasses.replace(cfg.sim, n_train=300, n_valid=50,
                                    n_test=steps))
        system = pipeline.build(cfg, jax.random.PRNGKey(0))
        out = pipeline.run_closed_loop(system, cfg, jax.random.PRNGKey(1))
        jax.block_until_ready(out.rms_res)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = pipeline.run_closed_loop(system, cfg,
                                           jax.random.PRNGKey(1))
            jax.block_until_ready(out.rms_res)
            best = min(best, time.perf_counter() - t0)
        report[flow] = {
            "loop_s": round(best, 4),
            "us_per_step": round(best / steps * 1e6, 1),
            "mean_strehl": round(
                float(out.strehl_exact[steps // 2:].mean()), 4),
        }
        print(flow, report[flow], file=sys.stderr)
    report["conditional_overhead_us_per_step"] = round(
        report["conditional"]["us_per_step"]
        - report["periodic"]["us_per_step"], 1)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
