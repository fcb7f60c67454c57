"""Excursion-tail experiment at flagship scale.

The tuned d>=15 rows (benchmarks/protocol_sweep.py) hold a high MEAN
Strehl but take deep self-recovering excursions.  Higher modal order
needs var_max_radius=0.85 (plain order-14 VAR sits at companion radius
~0.996 and collapses); this tests whether that recipe -- order 14
+ VAR stability clamp + MMSE shrinkage + warm start -- cuts the
excursion TAIL (min Strehl, p95 rms, time-under-0.5) at R=512,
d in {15, 20}, vs the shipped order-10 recipe.  Both arms share the
protocol of benchmarks/protocol_sweep.py (README.md:277-284 mag_conv).

Usage: python benchmarks/excursion_tail.py [resolution] [out.json]
Env:   XT_CPU=1  XT_DR0=15,20  XT_STEPS=500  XT_TRAIN=1000
"""

import dataclasses
import json
import os
import sys
import time

try:
    import mpc_sensorlessao_tpu  # noqa: F401  (installed package)
except ImportError:  # source checkout without `pip install -e .`
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from mpc_sensorlessao_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
if os.environ.get("XT_CPU"):
    jax.config.update("jax_platforms", "cpu")

from mpc_sensorlessao_tpu.models import pipeline                      # noqa
from mpc_sensorlessao_tpu.utils.config import reference_config        # noqa


def _row(out):
    res = np.asarray(out.rms_res, np.float64)
    s = res.shape[-1] // 2
    res_t = res[s:]
    strehl = np.asarray(out.strehl_exact, np.float64)[s:]
    turb = np.asarray(out.rms_turb, np.float64)[s:]
    # excursion tail metrics on the settled half
    below = strehl < 0.5
    # longest contiguous run under 0.5
    runs, cur = [], 0
    for b in below:
        cur = cur + 1 if b else 0
        runs.append(cur)
    return {
        "mean_strehl": round(float(strehl.mean()), 4),
        "min_strehl": round(float(strehl.min()), 4),
        "p5_strehl": round(float(np.percentile(strehl, 5)), 4),
        "mean_rms_res_rad": round(float(res_t.mean()), 4),
        "p95_rms_res_rad": round(float(np.percentile(res_t, 95)), 4),
        "max_rms_res_rad": round(float(res_t.max()), 4),
        "rejection": round(float(turb.mean() / res_t.mean()), 3),
        "frac_steps_strehl_below_0.5": round(float(below.mean()), 4),
        "longest_excursion_steps": int(max(runs) if runs else 0),
        "finite": bool(np.isfinite(res_t).all()),
    }


def main():
    res = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    out_path = sys.argv[2] if len(sys.argv) > 2 else "RESULTS_TAIL.json"
    d_grid = [float(d) for d in os.environ.get("XT_DR0", "15,20").split(",")]

    cfg0 = reference_config(resolution=res)
    if os.environ.get("XT_TRAIN"):
        n_tr = int(os.environ["XT_TRAIN"])
        cfg0 = cfg0.replace(sim=dataclasses.replace(
            cfg0.sim, n_train=n_tr, n_valid=max(50, n_tr // 20)))
    n_steps = int(os.environ.get("XT_STEPS", cfg0.sim.n_test))
    cfg0 = cfg0.replace(sim=dataclasses.replace(cfg0.sim, n_test=n_steps))

    report = {
        "what": ("Order-14 + var_max_radius=0.85 (modes_horizon recipe) vs "
                 "the shipped order-10 tuned recipe at flagship scale: "
                 "does the excursion tail shrink at d>=15?"),
        "resolution": res, "n_steps": n_steps,
        "n_train": cfg0.sim.n_train,
        "device": str(jax.devices()[0]), "rows": {},
    }
    if os.path.exists(out_path):  # resume: keep completed rows
        with open(out_path) as f:
            prior = json.load(f)
        if (prior.get("resolution") == res
                and prior.get("n_steps") == n_steps):
            report["rows"] = prior.get("rows", {})

    def _save():
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")

    for d in d_grid:
        for arm, order, vmr in (("order10", 10, None),
                                ("order14_clamp", 14, 0.85)):
            if f"d={d:g}_{arm}" in report["rows"]:
                continue
            cfg = cfg0.replace(
                zernike=dataclasses.replace(cfg0.zernike,
                                            radial_order=order),
                mpc=dataclasses.replace(cfg0.mpc, warm_start=True,
                                        var_ridge=1e-2, r_weight=30.0,
                                        var_max_radius=vmr),
                estimator=dataclasses.replace(
                    cfg0.estimator, method="mmse",
                    prior_scale=min(0.15, 0.5 / d)),
                sim=dataclasses.replace(cfg0.sim, d_over_r0=d),
            )
            t0 = time.time()
            system = pipeline.build(cfg, jax.random.PRNGKey(0))
            jax.block_until_ready(system.loop.est.A_s)
            build_s = time.time() - t0
            t0 = time.time()
            out = pipeline.run_closed_loop(system, cfg,
                                           jax.random.PRNGKey(1))
            jax.block_until_ready(out.rms_res)
            row = _row(out)
            row["build_s"] = round(build_s, 1)
            row["loop_s"] = round(time.time() - t0, 2)
            report["rows"][f"d={d:g}_{arm}"] = row
            print(json.dumps({f"d={d:g}_{arm}": row}), file=sys.stderr,
                  flush=True)
            _save()

    # verdict summary: per d, did the tail improve?
    for d in d_grid:
        a = report["rows"].get(f"d={d:g}_order10")
        b = report["rows"].get(f"d={d:g}_order14_clamp")
        if a and b:
            report[f"d={d:g}_tail_verdict"] = {
                "min_strehl": [a["min_strehl"], b["min_strehl"]],
                "p95_rms": [a["p95_rms_res_rad"], b["p95_rms_res_rad"]],
                "improved": bool(
                    b["min_strehl"] > a["min_strehl"]
                    and b["p95_rms_res_rad"] < a["p95_rms_res_rad"]),
            }

    _save()
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
