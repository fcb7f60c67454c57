"""Flagship protocol on the reference-parity conditional-Gaussian flow.

VERDICT r4 #1: the 512-px/500-step RESULTS protocol had only ever run on
the periodic fast-path turbulence; the reference's actual L1 physics is
the conditional-Gaussian screen extension
(telescopeAbstract.m:854-884 operators, :335-342 per-step extension).
This runs the same protocol rows (README.md:36-37,112-115,277-284) with
flow="conditional":

  reference rows  one 28-mode/LS build; the D/r0 grid sweeps at runtime
                  as a vmapped scenario axis SHARING one turbulence
                  realization (shared_turbulence=True -- the exact
                  analogue of the reference scaling one frozen-flow
                  tensor by each mag_conv multiplier).
  periodic rows   the identical protocol on the periodic fast path,
                  re-run here for a controlled same-session quality
                  delta (other runs' numbers come from another
                  session / HEAD).
  tuned rows      per-D/r0 tuned builds (order 10, ridge VAR, MMSE,
                  warm start) on the conditional flow, single scenario
                  via pipeline.run_closed_loop.
  monte_carlo     a BATCHED conditional-flow Monte-Carlo over noise
                  seeds (shared turbulence realization), demonstrating
                  ops/edge_flow.py at Monte-Carlo batch 512 px.

Usage: python benchmarks/protocol_edge.py [resolution] [out.json]
Env:   PE_CPU=1  PE_DR0=5,10  PE_STEPS=500  PE_TRAIN=1000  PE_MC_B=32
       PE_SKIP_TUNED=1  PE_TUNED_DR0=5,10
       PE_STAGES=ref,mc,periodic,tuned  -- run a subset of the protocol
       sections; if out.json already exists it is loaded and updated in
       place, so a long run can be split into bounded-duration stages
       (each stage re-verifies nothing from the others).
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
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mpc_sensorlessao_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
if os.environ.get("PE_CPU"):
    jax.config.update("jax_platforms", "cpu")

from mpc_sensorlessao_tpu.models import pipeline, var                 # noqa
from mpc_sensorlessao_tpu.parallel import montecarlo                  # noqa
from mpc_sensorlessao_tpu.utils.config import (                       # noqa
    mag_conv, reference_config)


def _settled_row(out, i=None, crop_half=None):
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
    # stays inside the diversity crop; an unlocked loop (rejection ~< 1)
    # pushes the peak outside and strehl_exact underestimates
    if row["rejection"] < 1.2 or row["mean_strehl"] < 0.1:
        row["strehl_exact_crop_valid"] = False
    return row


def _var_validation(cfg, system):
    states = system.coeff_series[:, 1:]
    _, rmse, rrmse = var.validate(
        system.var_model, states[cfg.sim.n_train - cfg.mpc.var_order:])
    return {"var_rmse_mean": round(float(jnp.mean(rmse)), 5),
            "var_rrmse_mean": round(float(jnp.mean(rrmse)), 5)}


def _save(report, out_path):
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")


def _apply_sim_env(cfg, n_steps):
    if os.environ.get("PE_TRAIN"):
        n_tr = int(os.environ["PE_TRAIN"])
        cfg = cfg.replace(sim=dataclasses.replace(
            cfg.sim, n_train=n_tr, n_valid=max(50, n_tr // 20)))
    return cfg.replace(sim=dataclasses.replace(cfg.sim, n_test=n_steps))


def main():
    res = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    out_path = sys.argv[2] if len(sys.argv) > 2 else "RESULTS_EDGE.json"
    d_grid = [float(d) for d in
              os.environ.get("PE_DR0", "5,10,15,20").split(",")]
    tuned_grid = [float(d) for d in
                  os.environ.get("PE_TUNED_DR0", "5,10").split(",")]
    mc_b = int(os.environ.get("PE_MC_B", "32"))

    stages = set(os.environ.get(
        "PE_STAGES", "ref,mc,periodic,tuned").split(","))

    cfg0 = reference_config(resolution=res)
    n_steps = int(os.environ.get("PE_STEPS", cfg0.sim.n_test))

    report = {
        "protocol": ("README.md:36-37,112-115,277-284 on the reference-"
                     "parity conditional-Gaussian turbulence "
                     "(telescopeAbstract.m:854-884,335-342; "
                     "ops/edge_flow.py)"),
        "resolution": res, "n_steps": n_steps,
        "device": str(jax.devices()[0]),
        "reference_rows": {}, "periodic_rows": {}, "tuned_rows": {},
    }
    if os.path.exists(out_path):  # staged run: merge into the prior file
        with open(out_path) as f:
            prior = json.load(f)
        if (prior.get("resolution") == res
                and prior.get("n_steps") == n_steps):
            report.update(prior)
        else:
            print("out file exists with different protocol params; "
                  "starting fresh", file=sys.stderr)

    cfg = _apply_sim_env(cfg0.replace(
        atmosphere=dataclasses.replace(cfg0.atmosphere,
                                       flow="conditional")), n_steps)
    report["n_train"], report["n_valid"] = cfg.sim.n_train, cfg.sim.n_valid
    start = float(cfg.sim.n_train + cfg.sim.n_valid)
    scen = montecarlo.ScenarioBatch(
        start_step=jnp.full((len(d_grid),), start, dtype=jnp.float32),
        mag=jnp.asarray([mag_conv(d) for d in d_grid], dtype=jnp.float32),
        noise_scale=jnp.ones((len(d_grid),), dtype=jnp.float32),
        key=jax.random.split(jax.random.PRNGKey(1), len(d_grid)),
    )

    system = None
    if stages & {"ref", "mc"}:
        t0 = time.time()
        system = pipeline.build(cfg, jax.random.PRNGKey(0))
        jax.block_until_ready(system.loop.est.A_s)
        report["conditional_build_s"] = round(time.time() - t0, 1)
        report["conditional_var"] = _var_validation(cfg, system)

    # ---- conditional-flow reference rows ----
    if "ref" in stages:
        t0 = time.time()
        out = montecarlo.run_batch(
            system.loop, system.layers, cfg, scen, n_steps=n_steps,
            edge_model=system.edge_model, edge_state=system.edge_state,
            shared_turbulence=True)
        jax.block_until_ready(out.rms_res)
        t_loop = time.time() - t0
        report["conditional_loop_s"] = round(t_loop, 2)
        report["conditional_solves_per_s"] = round(
            len(d_grid) * n_steps / t_loop, 1)
        for i, d in enumerate(d_grid):
            report["reference_rows"][f"d_over_r0={d:g}"] = (
                _settled_row(out, i))
        print(json.dumps({"reference_rows": report["reference_rows"]}),
              file=sys.stderr, flush=True)
        _save(report, out_path)

    # ---- batched conditional Monte-Carlo over noise seeds (d=5) ----
    if "mc" in stages:
        scen_mc = montecarlo.make_scenarios(cfg, jax.random.PRNGKey(2),
                                            mc_b)
        t0 = time.time()
        out_mc = montecarlo.run_batch(
            system.loop, system.layers, cfg, scen_mc, n_steps=n_steps,
            edge_model=system.edge_model, edge_state=system.edge_state,
            shared_turbulence=True)
        jax.block_until_ready(out_mc.rms_res)
        t_mc = time.time() - t0
        sx = np.asarray(out_mc.strehl_exact, np.float64)[:, n_steps // 2:]
        per_scen = sx.mean(axis=1)
        report["monte_carlo"] = {
            "batch": mc_b, "d_over_r0": 5.0,
            "loop_s": round(t_mc, 2),
            "solves_per_s": round(mc_b * n_steps / t_mc, 1),
            "mean_strehl": round(float(per_scen.mean()), 4),
            "p10_strehl": round(float(np.percentile(per_scen, 10)), 4),
            "min_strehl": round(float(per_scen.min()), 4),
        }
        print(json.dumps({"monte_carlo": report["monte_carlo"]}),
              file=sys.stderr, flush=True)
        _save(report, out_path)

    # ---- periodic rows, same session, controlled delta ----
    if "periodic" in stages:
        cfg_p = _apply_sim_env(cfg0, n_steps)
        t0 = time.time()
        system_p = pipeline.build(cfg_p, jax.random.PRNGKey(0))
        jax.block_until_ready(system_p.loop.est.A_s)
        report["periodic_build_s"] = round(time.time() - t0, 1)
        t0 = time.time()
        out_p = montecarlo.run_batch(system_p.loop, system_p.layers,
                                     cfg_p, scen, n_steps=n_steps,
                                     shared_window=True)
        jax.block_until_ready(out_p.rms_res)
        report["periodic_loop_s"] = round(time.time() - t0, 2)
        for i, d in enumerate(d_grid):
            report["periodic_rows"][f"d_over_r0={d:g}"] = (
                _settled_row(out_p, i))
        if report["reference_rows"]:
            report["quality_delta_strehl"] = {
                k: round(row["mean_strehl"]
                         - report["periodic_rows"][k]["mean_strehl"], 4)
                for k, row in report["reference_rows"].items()
                if k in report["periodic_rows"]}
        print(json.dumps({"periodic_rows": report["periodic_rows"],
                          "delta": report.get("quality_delta_strehl")}),
              file=sys.stderr, flush=True)
        _save(report, out_path)

    # ---- tuned rows on the conditional flow ----
    if "tuned" in stages and not os.environ.get("PE_SKIP_TUNED"):
        for d in tuned_grid:
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
            print(json.dumps({f"tuned d={d:g}": row}), file=sys.stderr,
                  flush=True)
            _save(report, out_path)

    _save(report, out_path)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
