"""Benchmark: end-to-end MPC control-step throughput on one GPU.

Each "solve" is one full sensorless-AO control step -- frozen-flow
turbulence evolution, 3-diversity PSF formation (partial-DFT measure),
LS estimate with one Gauss-Newton refinement (BENCH_GN), condensed-QP
assembly and the fixed-barrier Newton-KKT fastMPC solve, DM modal
correction -- batched over Monte-Carlo scenarios.

Baseline: the reference's implied real-time budget of 200 Hz (5 ms per
control step, README.md:36; BASELINE.md) -> vs_baseline = solves_per_s/200.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}; a second
JSON line on stderr carries the device, build/compile times and Strehl.
Exits with an error unless JAX's backend is a GPU: a CPU timing is never
reported under this metric.
Env knobs: BENCH_RES (128), BENCH_BATCH (4096), BENCH_STEPS (25),
BENCH_SOLVER (fastmpc), BENCH_REPEATS (3), BENCH_GN (0), BENCH_DFT_DTYPE
(float32 | bfloat16 measurement matmuls).
"""

import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp


def main():
    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX backend is "
                 f"{jax.default_backend()!r}")
    from mpc_sensorlessao_tpu.utils import compile_cache
    compile_cache.enable()

    res = int(os.environ.get("BENCH_RES", "128"))
    batch = int(os.environ.get("BENCH_BATCH", "4096"))
    steps = int(os.environ.get("BENCH_STEPS", "25"))
    solver = os.environ.get("BENCH_SOLVER", "fastmpc")
    repeats = int(os.environ.get("BENCH_REPEATS", "3"))
    dft_dtype = os.environ.get("BENCH_DFT_DTYPE", "float32")
    # 0 = the reference's linear-LS estimator exactly (README.md:478);
    # each extra iteration re-runs the PSF measure once more per step to
    # widen the capture range -- a robustness extension the reference
    # does not have.
    gn = int(os.environ.get("BENCH_GN", "0"))

    from mpc_sensorlessao_tpu.models import pipeline
    from mpc_sensorlessao_tpu.parallel import montecarlo
    from mpc_sensorlessao_tpu.utils.config import reference_config

    cfg = reference_config(resolution=res)
    # shorter ID pre-pass: the benchmark measures the closed loop
    cfg = cfg.replace(
        sim=dataclasses.replace(cfg.sim, n_train=300, n_valid=50,
                                n_test=steps),
        estimator=dataclasses.replace(cfg.estimator,
                                      dft_dtype=dft_dtype,
                                      gauss_newton_iters=gn))

    t0 = time.time()
    system = pipeline.build(cfg, jax.random.PRNGKey(0))
    jax.block_until_ready(system.loop.est.A_s)
    build_s = time.time() - t0

    scen = montecarlo.make_scenarios(
        cfg, jax.random.PRNGKey(1), batch,
        d_over_r0_grid=(5.0,), snr_db_grid=(10.0,))

    # every bench scenario uses the same turbulence window -> the frozen
    # flow is traced once per step, not per scenario (montecarlo.run_batch);
    # verified on the concrete batch here, since inside jit the starts
    # are tracers
    montecarlo.assert_shared_window(scen)
    run = jax.jit(lambda s: montecarlo.run_batch(
        system.loop, system.layers, cfg, s, n_steps=steps, solver=solver,
        shared_window="verified"))

    t0 = time.time()
    out = run(scen)
    jax.block_until_ready(out.rms_res)
    compile_s = time.time() - t0

    times = []
    for _ in range(repeats):
        t0 = time.time()
        out = run(scen)
        jax.block_until_ready(out.rms_res)
        times.append(time.time() - t0)
    best = min(times)
    solves_per_s = batch * steps / best

    meta = {
        "build_s": round(build_s, 2),
        "compile_s": round(compile_s, 2),
        "run_s": round(best, 4),
        "resolution": res,
        "batch": batch,
        "steps": steps,
        "solver": solver,
        "gauss_newton_iters": gn,
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        # exact OTF-volume Strehl (imager.m:115) is the headline metric;
        # the Marechal approximation is kept for comparison
        "mean_strehl": float(jnp.mean(out.strehl_exact[:, steps // 2:])),
        "mean_strehl_marechal": float(jnp.mean(out.strehl[:, steps // 2:])),
        "mean_rms_res": float(jnp.mean(out.rms_res[:, steps // 2:])),
    }
    print(json.dumps(meta), file=sys.stderr)
    print(json.dumps({
        "metric": "mpc_control_steps_per_s",
        "value": round(solves_per_s, 1),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_s / 200.0, 2),
    }))


if __name__ == "__main__":
    main()
