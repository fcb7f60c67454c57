"""Classical SH + integrator loop vs the sensorless MPC loop.

The paper's core motivation (citation:1-30): replace the classical
wavefront-sensor + integrator AO loop with PSF-based sensorless MPC.
This benchmark runs BOTH controllers on the SAME frozen-flow turbulence
window and records Strehl / residual RMS / rejection per D/r0.

Controllers:
  integrator: Shack-Hartmann geometric slopes (models/wfs.py) ->
      TSVD-calibrated modal command (models/integrator.py
      calibration_vault, controller.m:305-308 update law), gain swept
      and the best recorded.  Two rows: an IDEAL one (noiseless slopes,
      zero extra delay, perfect modal corrector) and a noise-matched one
      whose per-slope SNR equals the MPC estimator's configured SNR
      (sigma = rms(signal slopes) * 10^(-SNR/20)).
  mpc: the full sensorless pipeline (PSF diversity estimator with its
      configured measurement noise, VAR prediction, fastMPC solver) --
      the reference recipe at D/r0=5 and the strong-turbulence recipe
      (order 10, residual-scale MMSE, warm start) at D/r0 >= 10.

Usage: python benchmarks/classical_vs_mpc.py [resolution] [out.json]
Env:   CVM_DR0=5,10  CVM_STEPS=500  CVM_CPU=1
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
if os.environ.get("CVM_CPU"):
    jax.config.update("jax_platforms", "cpu")

from mpc_sensorlessao_tpu.models import (                          # noqa
    closed_loop, integrator, pipeline, wfs)
from mpc_sensorlessao_tpu.utils.config import reference_config     # noqa


def _marechal(rms):
    return float(np.mean(np.exp(-np.asarray(rms)[len(rms) // 2:] ** 2)))


def main():
    res = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    out_path = sys.argv[2] if len(sys.argv) > 2 else "CLASSICAL.json"
    d_grid = [float(d) for d in os.environ.get("CVM_DR0", "5,10").split(",")]
    n_steps = int(os.environ.get("CVM_STEPS", "500"))

    report = {"resolution": res, "n_steps": n_steps,
              "device": str(jax.devices()[0]), "rows": {}}

    for d in d_grid:
        cfg = reference_config(resolution=res)
        cfg = cfg.replace(sim=dataclasses.replace(
            cfg.sim, d_over_r0=d, n_test=n_steps))
        if d >= 10:
            cfg = cfg.replace(
                zernike=dataclasses.replace(cfg.zernike, radial_order=10),
                mpc=dataclasses.replace(cfg.mpc, warm_start=True,
                                        var_ridge=1e-2, r_weight=30.0),
                estimator=dataclasses.replace(
                    cfg.estimator, method="mmse",
                    prior_scale=min(0.15, 0.5 / d)))
        t0 = time.time()
        system = pipeline.build(cfg, jax.random.PRNGKey(0))
        jax.block_until_ready(system.loop.est.A_s)
        build_s = time.time() - t0

        # --- MPC loop ---
        t0 = time.time()
        out = pipeline.run_closed_loop(system, cfg, jax.random.PRNGKey(1))
        jax.block_until_ready(out.rms_res)
        mpc_s = time.time() - t0
        res_m = np.asarray(out.rms_res)
        turb = np.asarray(out.rms_turb)
        s = n_steps // 2
        row = {
            "mpc": {
                "mean_rms_res": round(float(res_m[s:].mean()), 4),
                "rejection": round(float(turb[s:].mean()
                                         / res_m[s:].mean()), 3),
                "strehl_exact": round(
                    float(np.asarray(out.strehl_exact)[s:].mean()), 4),
                "strehl_marechal": round(_marechal(res_m), 4),
                "loop_s": round(mpc_s, 2),
            },
            "mean_rms_turb": round(float(turb[s:].mean()), 4),
            "build_s": round(build_s, 1),
        }

        # --- classical integrator on the SAME turbulence window ---
        n_lenslet = 10 if res % 10 == 0 else 8
        sh = wfs.build(res, n_lenslet=n_lenslet)
        stack = system.loop.state_stack            # (K, R, R)
        D = wfs.interaction_matrix(sh, stack)
        vault = integrator.calibration_vault(D, cond=100.0)
        start = cfg.sim.n_train + cfg.sim.n_valid

        # open-loop turbulence phases for the window (host -> device)
        from mpc_sensorlessao_tpu.ops import phase_screens, zernike
        mask = system.loop.mask
        npx = system.loop.mask_npix

        def turb_phase(idx):
            raw = phase_screens.phase_at(system.layers, start + idx, res)
            return zernike.piston_removed_phase_masked(
                raw, mask, npx) * cfg.sim.magnification

        phis = jax.lax.map(turb_phase,
                           jnp.arange(n_steps, dtype=jnp.float32),
                           batch_size=16)
        flat = phis.reshape(n_steps, -1)
        # noise-matched row: per-slope SNR = the estimator's cfg SNR
        sig_slopes = jnp.sqrt(jnp.mean((flat @ sh.slope_op.T) ** 2))
        sigma = float(sig_slopes) * 10.0 ** (-cfg.estimator.snr_db / 20.0)
        noise = sigma * jax.random.normal(
            jax.random.PRNGKey(2), (n_steps, sh.n_slopes))
        for label, sl_noise in (("integrator", None),
                                ("integrator_snr_matched", noise)):
            best = None
            for gain in (0.3, 0.5, 0.7):
                t0 = time.time()
                _, rms = integrator.closed_loop(
                    sh.slope_op, vault, stack.reshape(stack.shape[0], -1),
                    flat, integrator.IntegratorConfig(gain=gain),
                    mask_flat=mask.reshape(-1), slope_noise=sl_noise)
                rms = np.asarray(rms)
                cand = {
                    "gain": gain,
                    "mean_rms_res": round(float(rms[s:].mean()), 4),
                    "rejection": round(float(turb[s:].mean()
                                             / rms[s:].mean()), 3),
                    "strehl_marechal": round(_marechal(rms), 4),
                    "loop_s": round(time.time() - t0, 2),
                }
                if (best is None
                        or cand["mean_rms_res"] < best["mean_rms_res"]):
                    best = cand
            row[label] = best
        row["mpc_advantage_rms"] = round(
            row["integrator"]["mean_rms_res"]
            / row["mpc"]["mean_rms_res"], 3)
        row["mpc_advantage_rms_snr_matched"] = round(
            row["integrator_snr_matched"]["mean_rms_res"]
            / row["mpc"]["mean_rms_res"], 3)
        report["rows"][f"d_over_r0={d:g}"] = row
        print(json.dumps({f"d={d:g}": row}), file=sys.stderr)

    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
