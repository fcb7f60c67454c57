"""100k+ scenario Monte-Carlo closed loop on one chip (BASELINE config 5 scale).

BASELINE config 5 asks for "100k+ scenario rollouts"; the multi-host
fabric is dryrun-validated (MULTIPROC/MULTICHIP artifacts), and the
single-chip shared-window path is fast enough to run the full 100k-
scenario population outright: D/r0 x SNR grid x thousands of noise seeds
per cell, chunked so per-chunk telemetry stays modest, with ONLY
per-scenario settled summaries leaving the device.

Per (D/r0): one tuned build (the MMSE prior scale depends on d); the
scenario axis is SNR x seeds on the shared turbulence window.

Checkpoint/resume (SURVEY section 5.4; VERDICT r4 #5): with
MC1_CKPT=<dir> the per-chunk settled summaries + a cursor persist via
utils/checkpoint (Orbax) after EVERY chunk; re-running with --resume
restores and skips completed chunks (the per-chunk PRNG keys derive
from the chunk index, so an interrupted + resumed sweep is
bit-identical to an uninterrupted one -- tests/test_montecarlo_resume.py).
MC1_STOP_AFTER=<k> aborts after k chunks (the kill half of the test).

Usage: python benchmarks/montecarlo_100k.py [resolution] [out.json]
       [--resume]
Env:   MC1_DR0=5,10,15,20  MC1_SNR=5,10,20,40  MC1_REPS=6400
       MC1_STEPS=100  MC1_CHUNK=1600  MC1_CPU=1 (smoke)
       MC1_CKPT=dir  MC1_STOP_AFTER=k
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

import jax  # noqa: E402

from mpc_sensorlessao_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
if os.environ.get("MC1_CPU"):
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from mpc_sensorlessao_tpu.models import pipeline                   # noqa
from mpc_sensorlessao_tpu.parallel import montecarlo               # noqa
from mpc_sensorlessao_tpu.utils.config import (                    # noqa
    mag_conv, reference_config)


def main():
    res = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    out_path = sys.argv[2] if len(sys.argv) > 2 else "MONTECARLO.json"
    d_grid = [float(x) for x in
              os.environ.get("MC1_DR0", "5,10,15,20").split(",")]
    snr_grid = [float(x) for x in
                os.environ.get("MC1_SNR", "5,10,20,40").split(",")]
    reps = int(os.environ.get("MC1_REPS", "6400"))
    n_steps = int(os.environ.get("MC1_STEPS", "100"))
    chunk_reps = int(os.environ.get("MC1_CHUNK", "1600"))
    assert reps % chunk_reps == 0

    # -- checkpoint/resume state (see module docstring) --
    ckpt_dir = os.environ.get("MC1_CKPT")
    resume = "--resume" in sys.argv
    stop_after = int(os.environ.get("MC1_STOP_AFTER", "0"))
    n_chunks = reps // chunk_reps
    B_chunk = len(snr_grid) * chunk_reps
    state = {
        # per-chunk settled summaries: [d, chunk, (strehl|rms|turb), scen]
        "summaries": np.full((len(d_grid), n_chunks, 3, B_chunk),
                             np.nan, np.float32),
        "cursor": np.zeros((), np.int64),
    }
    if resume:
        if not ckpt_dir:
            raise SystemExit("--resume requires MC1_CKPT")
        from mpc_sensorlessao_tpu.utils import checkpoint as ckpt_mod
        state = ckpt_mod.restore(ckpt_dir, state)
        # np.asarray over a jax array is a READ-ONLY view; the chunk
        # loop writes in place, so take writable copies
        state = {k: np.array(v) for k, v in state.items()}
        print(f"resumed at cursor={int(state['cursor'])}/"
              f"{len(d_grid) * n_chunks}", file=sys.stderr, flush=True)

    n_total = len(d_grid) * len(snr_grid) * reps
    report = {
        "what": (f"{n_total} closed-loop scenarios x {n_steps} steps on "
                 "one chip: per-cell mean/p10 settled Strehl, residual "
                 "RMS, divergence count; chunked shared-window batches, "
                 "only per-scenario settled summaries leave the device"),
        "resolution": res, "n_steps": n_steps, "reps_per_cell": reps,
        "n_scenarios": n_total, "device": str(jax.devices()[0]),
        "cells": {},
    }
    if ckpt_dir:
        from mpc_sensorlessao_tpu.utils import checkpoint as ckpt_mod
        report["checkpoint_dir"] = os.path.abspath(ckpt_dir)
        report["resumed_at_cursor"] = int(state["cursor"])
    t_all = time.time()
    total_loop_s = 0.0
    session_ran = 0

    for d_idx, d in enumerate(d_grid):
        if int(state["cursor"]) >= (d_idx + 1) * n_chunks:
            continue          # d fully restored from the checkpoint
        cfg = reference_config(resolution=res)
        cfg = cfg.replace(
            zernike=dataclasses.replace(cfg.zernike, radial_order=10),
            mpc=dataclasses.replace(cfg.mpc, warm_start=True,
                                    var_ridge=1e-2, r_weight=30.0),
            estimator=dataclasses.replace(
                cfg.estimator, method="mmse",
                prior_scale=min(0.15, 0.5 / d)),
            sim=dataclasses.replace(cfg.sim, d_over_r0=d, n_train=300,
                                    n_valid=50, n_test=n_steps),
        )
        t0 = time.time()
        system = pipeline.build(cfg, jax.random.PRNGKey(0))
        jax.block_until_ready(system.loop.est.A_s)
        build_s = time.time() - t0
        start = float(cfg.sim.n_train + cfg.sim.n_valid)
        init_u = pipeline.warm_start_command(system, cfg, int(start))
        mag = float(mag_conv(d))
        # noise_scale per SNR cell: 10^((SNR_cfg - snr)/20)
        scales = np.asarray(
            [10.0 ** ((cfg.estimator.snr_db - s) / 20.0)
             for s in snr_grid], np.float32)
        B = len(snr_grid) * chunk_reps
        scale_col = np.repeat(scales, chunk_reps)
        settle = n_steps // 2

        @jax.jit
        def run_chunk(keys):
            def one(key, ns):
                out = pipeline.closed_loop.simulate(
                    system.loop, system.layers, cfg, key,
                    n_steps=n_steps, start_step=start, mag=mag,
                    noise_scale=ns, init_u=init_u)
                return (jnp.mean(out.strehl_exact[settle:]),
                        jnp.mean(out.rms_res[settle:]),
                        jnp.mean(out.rms_turb[settle:]))
            return jax.vmap(one)(keys, jnp.asarray(scale_col))

        # run the remaining chunks of this d; per-chunk keys derive from
        # the chunk index ONLY, so resumed and uninterrupted sweeps are
        # bit-identical
        t0 = time.time()
        ran_this_d = 0
        for c in range(n_chunks):
            gidx = d_idx * n_chunks + c
            if gidx < int(state["cursor"]):
                continue
            keys = jax.random.split(
                jax.random.fold_in(jax.random.PRNGKey(1), c), B)
            sx, rr, rt = run_chunk(keys)
            state["summaries"][d_idx, c, 0] = np.asarray(sx)
            state["summaries"][d_idx, c, 1] = np.asarray(rr)
            state["summaries"][d_idx, c, 2] = np.asarray(rt)
            state["cursor"] = np.asarray(gidx + 1, np.int64)
            ran_this_d += 1
            session_ran += 1
            if ckpt_dir:
                ckpt_mod.save(ckpt_dir, state, overwrite=True)
            if stop_after and session_ran >= stop_after:
                print(f"MC1_STOP_AFTER={stop_after}: stopping at cursor "
                      f"{int(state['cursor'])} (checkpoint saved)",
                      file=sys.stderr, flush=True)
                raise SystemExit(3)
        loop_s = time.time() - t0
        total_loop_s += loop_s
        print(json.dumps({f"d={d:g}": {
            "build_s": round(build_s, 1), "loop_s": round(loop_s, 2),
            "chunks_run": ran_this_d,
            "steps_per_s": round(
                ran_this_d * B * n_steps / max(loop_s, 1e-9), 1)}}),
            file=sys.stderr, flush=True)

    # cells from the (possibly partly restored) summary tensor
    for d_idx, d in enumerate(d_grid):
        for s_idx, s in enumerate(snr_grid):
            sl = slice(s_idx * chunk_reps, (s_idx + 1) * chunk_reps)
            sx = state["summaries"][d_idx, :, 0, sl].ravel()
            rr = state["summaries"][d_idx, :, 1, sl].ravel()
            rt = state["summaries"][d_idx, :, 2, sl].ravel()
            finite = np.isfinite(rr) & np.isfinite(sx)
            diverged = (~finite) | (rr > 3.0 * rt)
            okv = sx[~diverged]
            cell = {"n": int(sx.size), "n_diverged": int(diverged.sum())}
            if okv.size:  # an all-diverged cell must not crash the
                # report after the full multi-minute chip run
                cell.update(
                    mean_strehl=round(float(okv.mean()), 4),
                    p10_strehl=round(float(np.percentile(okv, 10)), 4),
                    min_strehl=round(float(okv.min()), 4),
                    mean_rms_res=round(float(rr[~diverged].mean()), 4),
                    mean_rms_turb=round(float(rt[~diverged].mean()), 4),
                )
            report["cells"][f"d={d:g}_snr={s:g}"] = cell

    report["total_loop_s"] = round(total_loop_s, 2)
    report["total_wall_s"] = round(time.time() - t_all, 1)
    report["aggregate_steps_per_s"] = round(
        n_total * n_steps / total_loop_s, 1)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
