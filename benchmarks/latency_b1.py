"""Single-solve (B=1) closed-loop step latency vs the 5 ms budget.

BASELINE.md targets "<5 ms per-solve latency" (200 Hz, README.md:36).
All headline numbers are batch throughput; this records the honest B=1
per-step latency: the closed-loop scan body applied to ONE scenario,
measured with the differenced-scan method (per-dispatch latency can
dwarf the step itself -- a naive timing loop measures dispatch; the
program runs device-resident, so the in-scan per-step time IS the
control latency).

Usage: python benchmarks/latency_b1.py [out.json]
Env:   LAT_RES=128,512  LAT_STEPS=200  LAT_REPEATS=9  LAT_CPU=1
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np

try:
    import mpc_sensorlessao_tpu  # noqa: F401  (installed package)
except ImportError:  # source checkout without `pip install -e .`
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

from mpc_sensorlessao_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
if os.environ.get("LAT_CPU"):
    jax.config.update("jax_platforms", "cpu")

from mpc_sensorlessao_tpu.models import closed_loop, pipeline      # noqa
from mpc_sensorlessao_tpu.utils.config import reference_config     # noqa


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else "LATENCY.json"
    res_grid = [int(r) for r in
                os.environ.get("LAT_RES", "128,512").split(",")]
    steps = int(os.environ.get("LAT_STEPS", "200"))
    repeats = int(os.environ.get("LAT_REPEATS", "9"))
    gn = int(os.environ.get("BENCH_GN", "0"))

    report = {
        "what": ("B=1 closed-loop control-step latency measured inside "
                 "the production scan (differenced-scan median over "
                 "repeats); budget = 5 ms at 200 Hz (README.md:36)"),
        "steps": steps, "repeats": repeats, "gauss_newton_iters": gn,
        "device": str(jax.devices()[0]), "rows": {},
    }

    for res in res_grid:
        cfg = reference_config(resolution=res)
        cfg = cfg.replace(
            sim=dataclasses.replace(cfg.sim, n_train=300, n_valid=50),
            estimator=dataclasses.replace(cfg.estimator,
                                          gauss_newton_iters=gn))
        system = pipeline.build(cfg, jax.random.PRNGKey(0))
        start = float(cfg.sim.n_train + cfg.sim.n_valid)

        def run(n):
            def f(key):
                return closed_loop.simulate(
                    system.loop, system.layers, cfg, key, n_steps=n,
                    start_step=start).rms_res
            return jax.jit(f)

        from _timing import differenced_median

        key = jax.random.PRNGKey(1)
        short, long = run(steps), run(2 * steps)
        med, est = differenced_median(
            lambda: short(key).block_until_ready(),
            lambda: long(key).block_until_ready(), steps, repeats)
        ms = med * 1e3
        row = {
            "ms_per_step_b1": round(ms, 4),
            "iqr_ms": [round(float(np.percentile(est, 25)) * 1e3, 4),
                       round(float(np.percentile(est, 75)) * 1e3, 4)],
            "budget_ms": 5.0,
            "x_under_budget": round(5.0 / ms, 1),
            "meets_200hz": bool(ms < 5.0),
        }
        report["rows"][f"R={res}"] = row
        print(json.dumps({f"R={res}": row}), file=sys.stderr, flush=True)

    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
