"""BASELINE config 3: mode sweep 28 -> 66 -> 120 (radial order 6/10/14)
with longer MPC horizons, closed loop on chip.

The reference fixes 28 modes and N=2 and never scales either
(README.md:38,338; Fast_MPC/VAR_2/Fast_MPC2.m:28-55 takes N as a
constructor arg it never varies).  This sweep closes the loop at every
(radial order, horizon) cell of {6,10,14} x {2,8,32}, recording settled
Strehl, rejection, and solves/s.  The N=32 cells also run with
newton_steps=2, which routes the in-loop solve through the general
Newton-KKT path whose Schur solve uses O(log T) block cyclic reduction
at this horizon (ops/newton_kkt.py CR_MIN_HORIZON=16) -- the CR path
engaged in anger inside the production scan, not just as a solver
unit benchmark.

One build per order (the expensive layers are horizon-independent);
horizons swap in via pipeline.with_horizon.  Tuned recipe per
benchmarks/protocol_sweep.py (ridge VAR + MMSE estimator + warm start;
R=128: order-14 estimator columns alias below ~128 px).

Usage: python benchmarks/modes_horizon.py [out.json]
Env:   MODES_RES=128  MODES_BATCH=64  MODES_STEPS=200
       MODES_ORDERS=6,10,14  MODES_HORIZONS=2,8,32
       MODES_TRAIN=1000 (n_valid=500 at the default; else n_valid=50)
       MODES_CPU=1 force host CPU (smoke test)
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
if os.environ.get("MODES_CPU"):
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from mpc_sensorlessao_tpu.models import pipeline                     # noqa
from mpc_sensorlessao_tpu.parallel import montecarlo                 # noqa
from mpc_sensorlessao_tpu.utils.config import reference_config       # noqa


def _row(out, t_loop, batch, n_steps):
    res = np.asarray(out.rms_res, dtype=np.float64)
    turb = np.asarray(out.rms_turb, dtype=np.float64)
    sx = np.asarray(out.strehl_exact, dtype=np.float64)
    s = res.shape[-1] // 2
    res_t, turb_t, sx_t = res[..., s:], turb[..., s:], sx[..., s:]
    return {
        "mean_rms_res_rad": round(float(res_t.mean()), 4),
        "mean_rms_turb_rad": round(float(turb_t.mean()), 4),
        "rejection": round(float(turb_t.mean() / res_t.mean()), 3),
        "mean_strehl": round(float(sx_t.mean()), 4),
        "min_strehl": round(float(sx_t.min()), 4),
        "finite": bool(np.isfinite(res).all()),
        "loop_s": round(t_loop, 2),
        "solves_per_s": round(batch * n_steps / t_loop, 1),
        "x_real_time": round(batch * n_steps / t_loop / 200.0, 1),
    }


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else "MODES.json"
    res = int(os.environ.get("MODES_RES", "128"))
    batch = int(os.environ.get("MODES_BATCH", "64"))
    n_steps = int(os.environ.get("MODES_STEPS", "200"))
    orders = [int(o) for o in
              os.environ.get("MODES_ORDERS", "6,10,14").split(",")]
    horizons = [int(h) for h in
                os.environ.get("MODES_HORIZONS", "2,8,32").split(",")]
    n_train = int(os.environ.get("MODES_TRAIN", "1000"))

    base = reference_config(resolution=res)
    if n_train != base.sim.n_train:
        base = base.replace(sim=dataclasses.replace(
            base.sim, n_train=n_train, n_valid=50))
    base = base.replace(sim=dataclasses.replace(base.sim, n_test=n_steps))

    report = {
        "what": ("BASELINE config 3 sweep: radial order x MPC horizon, "
                 "closed loop on chip; N=32 cells additionally run via "
                 "the general Newton-KKT path (newton_steps=2) with "
                 "cyclic reduction engaged (CR_MIN_HORIZON=16)"),
        "resolution": res, "batch": batch, "n_steps": n_steps,
        "n_train": base.sim.n_train, "n_valid": base.sim.n_valid,
        "d_over_r0": 5, "device": str(jax.devices()[0]),
        "cells": {},
    }

    for order in orders:
        n_modes = (order + 1) * (order + 2) // 2
        # tuned recipe + VAR companion-radius clamp: the order-14 LS/ridge
        # fit lands at spectral radius ~0.996 and the N>=8 free-response
        # powers amplify the noisy high-order rows into a collapse
        # (measured: Strehl 0.058 at N=8 without the clamp; 0.95 is not
        # enough at the full 1000/500 split -- 0.85 locks at 0.991)
        cfg_o = base.replace(
            zernike=dataclasses.replace(base.zernike, radial_order=order),
            mpc=dataclasses.replace(base.mpc, var_ridge=1e-2,
                                    warm_start=True, r_weight=30.0,
                                    var_max_radius=0.85),
            estimator=dataclasses.replace(base.estimator, method="mmse",
                                          prior_scale=0.1),
        )
        t0 = time.time()
        system = pipeline.build(cfg_o, jax.random.PRNGKey(0))
        jax.block_until_ready(system.loop.est.A_s)
        build_s = time.time() - t0
        print(f"order {order} ({n_modes} modes) built in {build_s:.1f}s",
              file=sys.stderr, flush=True)

        for N in horizons:
            from mpc_sensorlessao_tpu.ops import newton_kkt
            variants = [("fixed", 1)] + (
                [("general_cr", 2)]
                if N >= newton_kkt.CR_MIN_HORIZON else [])
            for tag, nsteps_newton in variants:
                cfg = cfg_o.replace(mpc=dataclasses.replace(
                    cfg_o.mpc, horizon=N, newton_steps=nsteps_newton))
                sys_n = pipeline.with_horizon(system, cfg)
                start = float(cfg.sim.n_train + cfg.sim.n_valid)
                init_u = pipeline.warm_start_command(sys_n, cfg,
                                                     int(start))
                keys = jax.random.split(jax.random.PRNGKey(1), batch)

                # models/layers as jit ARGUMENTS, not closure captures:
                # captured arrays would be baked into the program as
                # constants (the N=32 operators are large)
                def one(key, loop, layers, u0):
                    return pipeline.closed_loop.simulate(
                        loop, layers, cfg, key,
                        n_steps=n_steps, start_step=start,
                        init_u=u0)

                run = jax.jit(jax.vmap(one,
                                       in_axes=(0, None, None, None)))
                args = (keys, sys_n.loop, sys_n.layers, init_u)
                out = run(*args)             # compile + run
                jax.block_until_ready(out.rms_res)
                t0 = time.time()
                out = run(*args)
                jax.block_until_ready(out.rms_res)
                t_loop = time.time() - t0
                row = _row(out, t_loop, batch, n_steps)
                row["build_s"] = round(build_s, 1)
                key = f"order={order}_N={N}_{tag}"
                report["cells"][key] = row
                print(json.dumps({key: row}), file=sys.stderr, flush=True)

    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
