"""Flagship-scale reference protocol sweep: D/r0 in {5, 10, 15, 20}.

Reproduces the reference's full experimental protocol at its real scale
(README.md:36-37,112-115,277-284): 512-px pupil grid, 2000 frames at
200 Hz (1000 train / 500 valid / 500 test), VAR(2) identification with
held-out validation, then the 500-step closed-loop MPC run at every
published turbulence strength -- the reference ships mag_conv multipliers
for D/r0 = 5, 10, 15, 20 (README.md:277-281) and re-runs the loop with
the same frozen-flow tensor scaled by each.

Two row families per D/r0:
  reference: the reference's exact operating point -- 28 Zernike modes,
             plain LS estimator/ID, cold start (one build; the LS VAR fit
             is scale-invariant so the magnification sweeps at runtime as
             a vmapped scenario axis -- the reference must re-run
             sequentially).
  tuned:     the framework recipe that extends the closed-loop envelope
             (radial order 10, ridge VAR, MMSE estimator, calibration
             warm start -- see MPCConfig/EstimatorConfig docstrings).

Writes a JSON artifact (default RESULTS.json) with per-row settled
Strehl (exact OTF-volume + Marechal), residual RMS, rejection, VAR
validation RMSE/RRMSE, and wall-clock timings.

Usage: python benchmarks/protocol_sweep.py [resolution] [out.json]
Env:   PROTO_CPU=1       force host CPU backend (smoke test)
       PROTO_DR0=5,10    override the D/r0 grid
       PROTO_STEPS=50    override closed-loop steps (default n_test=500)
       PROTO_TRAIN=300   override ID train/valid split (default 1000/500)
       PROTO_SKIP_TUNED=1  reference rows only
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
if os.environ.get("PROTO_CPU"):
    jax.config.update("jax_platforms", "cpu")

from mpc_sensorlessao_tpu.models import pipeline, var                 # noqa
from mpc_sensorlessao_tpu.parallel import montecarlo                  # noqa
from mpc_sensorlessao_tpu.utils import guards                         # noqa
from mpc_sensorlessao_tpu.utils.config import (                       # noqa
    mag_conv, reference_config)


def _settled_row(out, i=None):
    """Per-scenario settled-tail summary (last half of the time axis)."""
    def arr(x):
        a = np.asarray(x, dtype=np.float64)
        return a[i] if i is not None else a
    res = arr(out.rms_res)
    s = res.shape[-1] // 2
    turb = arr(out.rms_turb)[s:]
    strehl_x = arr(out.strehl_exact)[s:]
    strehl_m = arr(out.strehl)[s:]
    res = res[s:]
    row = {
        "mean_rms_res_rad": round(float(res.mean()), 4),
        "p95_rms_res_rad": round(float(np.percentile(res, 95)), 4),
        "mean_rms_turb_rad": round(float(turb.mean()), 4),
        "rejection": round(float(turb.mean() / res.mean()), 3),
        "mean_strehl": round(float(strehl_x.mean()), 4),
        "min_strehl": round(float(strehl_x.min()), 4),
        "mean_strehl_marechal": round(float(strehl_m.mean()), 4),
        "finite": bool(np.isfinite(res).all()),
    }
    # crop-validity flag (models/closed_loop.py StepOutputs): the exact
    # OTF-volume Strehl is only meaningful while the residual PSF peak
    # stays inside the (2c+1)^2 diversity crop; an unlocked row
    # (rejection ~< 1) pushes the peak outside and strehl_exact
    # UNDERSTATES -- flag it per row instead of a footnote
    if row["rejection"] < 1.2 or row["mean_strehl"] < 0.1:
        row["strehl_exact_crop_valid"] = False
    return row


def _var_validation(cfg, system):
    """Held-out VAR RMSE/RRMSE (README.md:134-155)."""
    states = system.coeff_series[:, 1:]
    _, rmse, rrmse = var.validate(
        system.var_model, states[cfg.sim.n_train - cfg.mpc.var_order:])
    return {"var_rmse_mean": round(float(jnp.mean(rmse)), 5),
            "var_rrmse_mean": round(float(jnp.mean(rrmse)), 5)}


def main():
    res = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    out_path = sys.argv[2] if len(sys.argv) > 2 else "RESULTS.json"
    d_grid = [float(d) for d in
              os.environ.get("PROTO_DR0", "5,10,15,20").split(",")]

    cfg = reference_config(resolution=res)
    if os.environ.get("PROTO_TRAIN"):
        n_tr = int(os.environ["PROTO_TRAIN"])
        cfg = cfg.replace(sim=dataclasses.replace(
            cfg.sim, n_train=n_tr, n_valid=50))
    n_steps = int(os.environ.get("PROTO_STEPS", cfg.sim.n_test))
    cfg = cfg.replace(sim=dataclasses.replace(cfg.sim, n_test=n_steps))

    stages = set(os.environ.get("PROTO_STAGES", "ref,tuned").split(","))
    tuned_grid = [float(d) for d in os.environ.get(
        "PROTO_TUNED_DR0", os.environ.get("PROTO_DR0",
                                          "5,10,15,20")).split(",")]

    report = {
        "protocol": "README.md:36-37,112-115,277-284 at flagship scale",
        "resolution": res,
        "n_train": cfg.sim.n_train, "n_valid": cfg.sim.n_valid,
        "n_steps": n_steps,
        "device": str(jax.devices()[0]),
        "reference_rows": {}, "tuned_rows": {},
    }
    if os.path.exists(out_path):  # staged run: merge into the prior file
        with open(out_path) as f:
            prior = json.load(f)
        if (prior.get("resolution") == res
                and prior.get("n_steps") == n_steps):
            report.update(prior)

    def _save():
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")

    # ---- reference rows: one build, runtime D/r0 sweep (vmap) ----
    if "ref" in stages:
        t0 = time.time()
        system = pipeline.build(cfg, jax.random.PRNGKey(0))
        jax.block_until_ready(system.loop.est.A_s)
        report["reference_build_s"] = round(time.time() - t0, 1)
        report["reference_var"] = _var_validation(cfg, system)

        start = float(cfg.sim.n_train + cfg.sim.n_valid)
        scen = montecarlo.ScenarioBatch(
            start_step=jnp.full((len(d_grid),), start, dtype=jnp.float32),
            mag=jnp.asarray([mag_conv(d) for d in d_grid],
                            dtype=jnp.float32),
            noise_scale=jnp.ones((len(d_grid),), dtype=jnp.float32),
            key=jax.random.split(jax.random.PRNGKey(1), len(d_grid)),
        )
        t0 = time.time()
        out = montecarlo.run_batch(system.loop, system.layers, cfg, scen,
                                   n_steps=n_steps)
        jax.block_until_ready(out.rms_res)
        t_loop = time.time() - t0
        report["reference_loop_s"] = round(t_loop, 2)
        report["reference_solves_per_s"] = round(
            len(d_grid) * n_steps / t_loop, 1)
        for i, d in enumerate(d_grid):
            report["reference_rows"][f"d_over_r0={d:g}"] = (
                _settled_row(out, i))
        print(json.dumps({k: v for k, v in report.items()
                          if k != "tuned_rows"}, indent=2),
              file=sys.stderr)
        _save()

    # ---- tuned rows: per-D/r0 builds (prior/warm start depend on mag) ----
    if "tuned" in stages and not os.environ.get("PROTO_SKIP_TUNED"):
        for d in tuned_grid:
            # Residual-scale MMSE shrinkage (prior_scale ~ 0.5/d: the
            # closed-loop residual is ~1/rejection of the open-loop
            # prior) plus r_weight=30: the reference's R=I leaves the
            # 79-dim actuator null space essentially free, and solver
            # noise churning it makes strong-turbulence locks a
            # numerical knife edge (vmapped-vs-single lowering decided
            # lock at d>=15); R=30 damps it with ~0 tracking cost --
            # measured robust over 8 noise seeds at every D/r0.
            cfg_t = cfg.replace(
                zernike=dataclasses.replace(cfg.zernike, radial_order=10),
                mpc=dataclasses.replace(cfg.mpc, warm_start=True,
                                        var_ridge=1e-2, r_weight=30.0),
                estimator=dataclasses.replace(
                    cfg.estimator, method="mmse",
                    prior_scale=min(0.15, 0.5 / d)),
                sim=dataclasses.replace(cfg.sim, d_over_r0=d),
            )
            t0 = time.time()
            sys_t = pipeline.build(cfg_t, jax.random.PRNGKey(0))
            jax.block_until_ready(sys_t.loop.est.A_s)
            t_build = time.time() - t0
            t0 = time.time()
            out_t = pipeline.run_closed_loop(sys_t, cfg_t,
                                             jax.random.PRNGKey(1))
            jax.block_until_ready(out_t.rms_res)
            row = _settled_row(out_t)
            row.update(_var_validation(cfg_t, sys_t))
            row["build_s"] = round(t_build, 1)
            row["loop_s"] = round(time.time() - t0, 2)
            report["tuned_rows"][f"d_over_r0={d:g}"] = row
            print(json.dumps({f"tuned d={d:g}": row}), file=sys.stderr)
            _save()

    _save()
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
