"""Monte-Carlo closed-loop sweep at scale: D/r0 x SNR x noise seeds.

The capability the reference cannot express at all (single MATLAB
process, one scenario per run): per turbulence strength, a BATCH of
noise realizations across an SNR grid runs as ONE vmapped program --
here 4 x (4 SNR x 64 seeds) x 500 steps = 512k closed-loop control
steps -- and reports per-cell settled statistics with divergence
containment (parallel/montecarlo.py).

Usage: python benchmarks/montecarlo_sweep.py [resolution] [out.json]
Env:   MC_DR0=5,10,15,20  MC_SNR=5,10,20,40  MC_REPS=64  MC_STEPS=500
       MC_CPU=1
"""

import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

try:
    import mpc_sensorlessao_tpu  # noqa: F401  (installed package)
except ImportError:  # source checkout without `pip install -e .`
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
from mpc_sensorlessao_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
if os.environ.get("MC_CPU"):
    jax.config.update("jax_platforms", "cpu")

from mpc_sensorlessao_tpu.models import pipeline                   # noqa
from mpc_sensorlessao_tpu.parallel import montecarlo               # noqa
from mpc_sensorlessao_tpu.utils.config import reference_config     # noqa


def main():
    res = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    out_path = sys.argv[2] if len(sys.argv) > 2 else "MONTECARLO.json"
    d_grid = [float(x) for x in
              os.environ.get("MC_DR0", "5,10,15,20").split(",")]
    snr_grid = [float(x) for x in
                os.environ.get("MC_SNR", "5,10,20,40").split(",")]
    reps = int(os.environ.get("MC_REPS", "64"))
    n_steps = int(os.environ.get("MC_STEPS", "500"))

    report = {"resolution": res, "n_steps": n_steps, "reps": reps,
              "device": str(jax.devices()[0]), "cells": {}}
    total_steps = 0
    total_time = 0.0

    for d in d_grid:
        cfg = reference_config(resolution=res)
        cfg = cfg.replace(
            zernike=dataclasses.replace(cfg.zernike, radial_order=10),
            mpc=dataclasses.replace(cfg.mpc, warm_start=True,
                                    var_ridge=1e-2, r_weight=30.0),
            estimator=dataclasses.replace(
                cfg.estimator, method="mmse",
                prior_scale=min(0.15, 0.5 / d)),
            sim=dataclasses.replace(cfg.sim, d_over_r0=d,
                                    n_test=n_steps))
        system = pipeline.build(cfg, jax.random.PRNGKey(0))
        start = float(cfg.sim.n_train + cfg.sim.n_valid)
        n = len(snr_grid) * reps
        scales = np.repeat(
            [10.0 ** ((cfg.estimator.snr_db - s) / 20.0)
             for s in snr_grid], reps)
        scen = montecarlo.ScenarioBatch(
            start_step=jnp.full((n,), start, dtype=jnp.float32),
            mag=jnp.full((n,), cfg.sim.magnification, dtype=jnp.float32),
            noise_scale=jnp.asarray(scales, dtype=jnp.float32),
            key=jax.random.split(jax.random.PRNGKey(int(d)), n),
        )
        init_u = pipeline.warm_start_command(
            system, cfg, cfg.sim.n_train + cfg.sim.n_valid)

        def run(s):
            from mpc_sensorlessao_tpu.models import closed_loop
            return jax.vmap(lambda key, ns: closed_loop.simulate(
                system.loop, system.layers, cfg, key, n_steps=n_steps,
                start_step=start, noise_scale=ns,
                init_u=init_u))(s.key, s.noise_scale)

        runj = jax.jit(run)
        out = runj(scen)
        jax.block_until_ready(out.rms_res)
        t0 = time.time()
        out = runj(scen)
        jax.block_until_ready(out.rms_res)
        dt = time.time() - t0
        total_steps += n * n_steps
        total_time += dt

        res_m = np.asarray(out.rms_res)[:, n_steps // 2:]
        turb_m = np.asarray(out.rms_turb)[:, n_steps // 2:]
        sx = np.asarray(out.strehl_exact)[:, n_steps // 2:]
        for i, snr in enumerate(snr_grid):
            sl = slice(i * reps, (i + 1) * reps)
            rm = res_m[sl].mean(axis=1)
            ok = np.isfinite(rm) & (rm <= 10.0 * turb_m[sl].mean(axis=1))
            report["cells"][f"d={d:g},snr={snr:g}dB"] = {
                "mean_strehl": round(float(sx[sl][ok].mean()), 4),
                "p10_strehl": round(
                    float(np.percentile(sx[sl][ok].mean(axis=1), 10)), 4),
                "mean_rms_res": round(float(rm[ok].mean()), 4),
                "std_rms_res": round(float(rm[ok].std()), 4),
                "n_diverged": int((~ok).sum()),
            }
        print(f"d={d:g}: {n} scenarios x {n_steps} steps in {dt:.2f}s "
              f"({n*n_steps/dt:,.0f} steps/s)", file=sys.stderr)

    report["total_control_steps"] = total_steps
    report["total_loop_s"] = round(total_time, 2)
    report["steps_per_s"] = round(total_steps / total_time, 1)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
