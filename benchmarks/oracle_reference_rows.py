"""Settle the strong-turbulence reference-row parity question.

The protocol sweep's (benchmarks/protocol_sweep.py) `reference_rows`
collapse at D/r0 >= 10 (the settled residual far exceeds the turbulence:
the loop INJECTS aberration) while the tuned rows hold lock.  Is that a bug in the JAX engine, or the
physics of the reference's plain-LS estimator operated outside its linear
capture range?  This script runs the *independent float64 NumPy oracle*
(tests/oracle_numpy.py -- a deliberately naive re-transcription of the
reference loop, README.md:444-626, sharing no code with the engine) in the
exact reference configuration (28 modes, plain LS, cold start, SNR-10 dB
noise at the reference's injection point, mag_conv scaling per
README.md:277-284) and records whether the collapse reproduces.

Usage: python benchmarks/oracle_reference_rows.py [out.json]
Env:   ORACLE_RES=512     pupil grid (default 512 = flagship protocol)
       ORACLE_STEPS=120   closed-loop steps (>=100 per the verdict ask)
       ORACLE_TRAIN=1000  train split (with n_valid=500 at default)
       ORACLE_DR0=5,10    D/r0 grid
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
sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")  # float64 oracle: host run

from mpc_sensorlessao_tpu.models import pipeline                     # noqa
from mpc_sensorlessao_tpu.utils.config import (                      # noqa
    mag_conv, reference_config)
from oracle_numpy import closed_loop as oracle_loop, pupil_phase     # noqa
from test_golden_trajectory import _oracle_params                    # noqa


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else "ORACLE_REFROWS.json"
    res = int(os.environ.get("ORACLE_RES", "512"))
    n_steps = int(os.environ.get("ORACLE_STEPS", "120"))
    n_train = int(os.environ.get("ORACLE_TRAIN", "1000"))
    d_grid = [float(d) for d in
              os.environ.get("ORACLE_DR0", "5,10").split(",")]

    cfg = reference_config(resolution=res)
    if n_train != cfg.sim.n_train:
        cfg = cfg.replace(sim=dataclasses.replace(
            cfg.sim, n_train=n_train, n_valid=50))

    t0 = time.time()
    system = pipeline.build(cfg, jax.random.PRNGKey(0))
    build_s = time.time() - t0
    params = _oracle_params(cfg, system, "fastmpc")

    est = system.loop.est
    std = float(est.noise_std)
    report = {
        "what": ("Independent float64 NumPy oracle (tests/oracle_numpy.py) "
                 "run in the exact reference configuration -- 28 modes, "
                 "plain LS estimator, cold start, SNR-10dB noise -- to "
                 "check whether the RESULTS reference_rows collapse at "
                 "D/r0>=10 is reference physics or an engine bug"),
        "resolution": res, "n_steps": n_steps,
        "n_train": cfg.sim.n_train, "n_valid": cfg.sim.n_valid,
        "noise_std": std, "build_s": round(build_s, 1),
        "rows": {},
    }

    # per-step turbulence RMS (needed for the rejection ratio; the oracle
    # returns residual RMS only)
    def turb_rms(mag):
        vals = []
        for k in range(n_steps):
            ph = pupil_phase(params["screens"], params["step_px"],
                             params["start"] + k, res, params["mask"], mag)
            inside = ph[params["mask"]]
            vals.append(np.sqrt(np.mean((inside - inside.mean()) ** 2)))
        return np.asarray(vals)

    for d in d_grid:
        mag = mag_conv(d)
        p = dict(params, mag=mag)
        rms_t = turb_rms(mag)
        for gn in (0, 1):
            rng = np.random.default_rng(11)
            noise = std * rng.standard_normal((n_steps, est.n_pixels))
            t0 = time.time()
            _, rms_res = oracle_loop(
                p, n_steps, noise, solver="fastmpc",
                cold_start=cfg.mpc.cold_start, gauss_newton_iters=gn)
            s = n_steps // 2
            row = {
                "mean_rms_res_rad": round(float(rms_res[s:].mean()), 4),
                "p95_rms_res_rad": round(
                    float(np.percentile(rms_res[s:], 95)), 4),
                "mean_rms_turb_rad": round(float(rms_t[s:].mean()), 4),
                "rejection": round(
                    float(rms_t[s:].mean() / rms_res[s:].mean()), 3),
                "mean_strehl_marechal": round(
                    float(np.exp(-(rms_res[s:] ** 2)).mean()), 4),
                "collapsed": bool(rms_res[s:].mean() > rms_t[s:].mean()),
                "oracle_s": round(time.time() - t0, 1),
            }
            report["rows"][f"d_over_r0={d:g}_gn={gn}"] = row
            print(json.dumps({f"d={d:g} gn={gn}": row}), file=sys.stderr,
                  flush=True)

    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
