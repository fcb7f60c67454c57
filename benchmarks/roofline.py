"""Roofline accounting for the hot kernels on the GPU.

For each target this records achieved FLOP/s and bytes/s against the
device's published peaks (utils/profiling.device_peaks, keyed by
device_kind: an unknown device is an error), with a bound
classification.

Method:
* TIME: differenced scans (two scan lengths; the difference cancels the
  per-dispatch latency and fixed scan overhead), median over repeats.
* WORK: the measure's work is analytic (measure_work: the same math
  whichever path -- GPU kernel or plain XLA -- runs it); the other
  targets use XLA cost analysis of ONE application (cost analysis counts
  a `while` body once regardless of trip count, so work comes from a
  single-step lowering, not the scanned program).

Targets:
  measure_sym3   symmetric-triple diversity-PSF measure (ops/psf.py)
  step           the composed closed-loop control step (one scan body)
  solve_fixed    constant-slack Newton-KKT real-time solver

Usage: python benchmarks/roofline.py out.json
Env:   ROOFLINE_REPEATS=9  ROOFLINE_STEPS=25  ROOFLINE_GN=0
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

import jax.numpy as jnp  # noqa: E402

from mpc_sensorlessao_tpu.models import estimator as est_mod      # noqa
from mpc_sensorlessao_tpu.models import pipeline                  # noqa
from mpc_sensorlessao_tpu.ops import newton_kkt                   # noqa
from mpc_sensorlessao_tpu.parallel import montecarlo              # noqa
from mpc_sensorlessao_tpu.utils.config import reference_config    # noqa
from mpc_sensorlessao_tpu.utils.profiling import device_peaks     # noqa

REPEATS = int(os.environ.get("ROOFLINE_REPEATS", "9"))
STEPS = int(os.environ.get("ROOFLINE_STEPS", "25"))

def measure_work(R: int, w: int, batch: int) -> dict:
    """Analytic work of the symmetric-triple measure (ops.psf).

    Per scenario: cos+sin of the (R, R) phase; 6 R^2 elementwise products
    and ~6 R^2 +/- combinations; first DFT stage 3 fields x 2 parts x
    2h x R^2 MACs with 2h = 2w padded (counted at 2w: useful work);
    second stage 3 x (2w)^2 R MACs; |.|^2 of 3 w^2.  Device memory: the
    phase in (R^2 f32) and the crops out (3 w^2 f32) -- the least any
    implementation must move; constants (3 R^2 + 2 w R f32) once per
    call."""
    per_flops = (2.0 * (6.0 * 2 * w * R * R + 3.0 * 4 * w * w * R)
                 + 12.0 * R * R + 9.0 * w * w)
    per_bytes = 4.0 * (R * R + 3.0 * w * w)
    const_bytes = 4.0 * (3.0 * R * R + 2.0 * w * R)
    return {"flops": batch * per_flops,
            "bytes_accessed": batch * per_bytes + const_bytes}


def _scan_time(step_fn, carry0, length):
    """Jit a scan of `length` applications; step_fn: carry -> carry,
    scalar-perturbed so nothing hoists."""
    @jax.jit
    def run(c0):
        def body(c, _):
            c2, s = step_fn(c)
            return c2, s
        _, ys = jax.lax.scan(body, c0, None, length=length)
        return ys
    return run


def differenced_time(step_fn, carry0, n_items, steps=STEPS,
                     repeats=REPEATS):
    """Median per-item wall time via the two-length differenced-scan
    method (benchmarks/_timing.py).  Returns (per_iter_s, per_item_s,
    differenced_work_s): the caller should treat the estimate as
    unreliable when the differenced work is not well above the
    ~ms-scale dispatch jitter."""
    from _timing import differenced_median

    short = _scan_time(step_fn, carry0, steps)
    long = _scan_time(step_fn, carry0, 2 * steps)
    per_iter, _ = differenced_median(
        lambda: short(carry0).block_until_ready(),
        lambda: long(carry0).block_until_ready(),
        steps, repeats)
    return per_iter, per_iter / n_items, per_iter * steps


def one_shot_cost(fn, *args):
    """flops / bytes of ONE application (XLA cost analysis; body counted
    once)."""
    c = jax.jit(fn).lower(*args).compile().cost_analysis() or {}
    return {"flops": float(c.get("flops", 0.0)),
            "bytes_accessed": float(c.get("bytes accessed", 0.0))}


def roofline_row(label, cost, t_iter, n_items):
    peaks = device_peaks()
    fps = cost["flops"] / t_iter
    bps = cost["bytes_accessed"] / t_iter
    shares = {"f32_compute": fps / peaks["f32_flops"],
              "tf32_compute": fps / peaks["tf32_flops"],
              "hbm_bandwidth": bps / peaks["hbm_bytes"]}
    bound = max(("tf32_compute", "hbm_bandwidth"), key=shares.get)
    return {
        "label": label,
        "wall_us_per_iter": t_iter * 1e6,
        "wall_us_per_item": t_iter / n_items * 1e6,
        "flops_per_iter": cost["flops"],
        "bytes_per_iter": cost["bytes_accessed"],
        "achieved_tflops": fps / 1e12,
        "achieved_gbps": bps / 1e9,
        **{f"pct_peak_{k}": 100 * v for k, v in shares.items()},
        "bound": bound,
        "pct_of_binding_peak": 100 * shares[bound],
    }


def target_measure(res, batch, gn, steps=None):
    cfg = reference_config(resolution=res)
    cfg = cfg.replace(
        sim=dataclasses.replace(cfg.sim, n_train=300, n_valid=50,
                                n_test=4),
        estimator=dataclasses.replace(cfg.estimator,
                                      gauss_newton_iters=gn))
    system = pipeline.build(cfg, jax.random.PRNGKey(0))
    est = system.loop.est
    rng = np.random.default_rng(0)
    phase0 = jnp.asarray(
        rng.normal(size=(batch, res, res)).astype(np.float32) * 0.3)

    def step(p):
        y = jax.vmap(lambda ph: est_mod.measure(est, ph, None))(p)
        s = jnp.sum(y)
        return p * (1.0 + 1e-12 * s), s

    t_iter, _, work = differenced_time(step, phase0, batch,
                                       steps=steps or STEPS)
    w = 2 * cfg.estimator.crop_half + 1
    row = roofline_row(f"measure_sym3_R{res}_B{batch}",
                       measure_work(res, w, batch), t_iter, batch)
    row["differenced_work_ms"] = work * 1e3
    row["harness_note"] = ("timing includes one (B,R,R) carry-"
                           "perturbation read+write per scan iteration "
                           "that the work model does not count")
    return row, system, cfg


def target_step(system, cfg, batch, steps=8):
    scen = montecarlo.make_scenarios(
        cfg, jax.random.PRNGKey(1), batch,
        d_over_r0_grid=(5.0,), snr_db_grid=(10.0,))
    montecarlo.assert_shared_window(scen)

    def run_n(n):
        return jax.jit(lambda s: montecarlo.run_batch(
            system.loop, system.layers, cfg, s,
            n_steps=n, shared_window="verified").rms_res)

    from _timing import differenced_median

    short, long = run_n(steps), run_n(2 * steps)
    t_iter, _ = differenced_median(
        lambda: short(scen).block_until_ready(),
        lambda: long(scen).block_until_ready(), steps, REPEATS)
    gn = cfg.estimator.gauss_newton_iters
    row = roofline_row(f"step_R{cfg.resolution}_B{batch}_gn{gn}",
                       one_shot_cost(run_n(1), scen), t_iter, batch)
    row["differenced_work_ms"] = t_iter * steps * 1e3
    row["work_model"] = ("XLA cost analysis of the one-step lowering; a "
                         "Pallas kernel in it is a custom call that cost "
                         "analysis does not count")
    return row


def target_solve_fixed(system, batch):
    prob, op = system.loop.prob, system.loop.fixed_op
    nx = prob.A1.shape[0]
    N = 2
    rng = np.random.default_rng(1)
    x0 = jnp.asarray(rng.normal(size=(batch, nx)).astype(np.float32) * .3)
    xp = jnp.asarray(rng.normal(size=(batch, nx)).astype(np.float32) * .3)
    w = jnp.zeros((batch, N * nx), dtype=jnp.float32)

    def solve_batch(a):
        x0_, xp_, w_ = a
        U = jax.vmap(lambda x, p, ww: newton_kkt.solve_fixed(
            prob, op, x, p, ww, horizon=N).U)(x0_, xp_, w_)
        s = jnp.sum(U)
        return (x0_ * (1.0 + 1e-12 * s), xp_, w_), s

    t_iter, _, work = differenced_time(solve_batch, (x0, xp, w), batch,
                                       steps=4 * STEPS)
    cost = one_shot_cost(
        lambda x, p, ww: jax.vmap(lambda a, b, c: newton_kkt.solve_fixed(
            prob, op, a, b, c, horizon=N).U)(x, p, ww), x0, xp, w)
    row = roofline_row(f"solve_fixed_N{N}_B{batch}", cost, t_iter, batch)
    row["differenced_work_ms"] = work * 1e3
    return row


def main():
    out_path = sys.argv[1]
    # gn=0 is the reference-parity estimator; gn=1 the robustness
    # default -- record the step at both
    gn = int(os.environ.get("ROOFLINE_GN", "0"))
    rows = []
    for res, b_meas, b_step in ((512, 256, 256), (128, 1024, 4096)):
        row, system, cfg = target_measure(res, b_meas, gn, steps=2 * STEPS)
        rows.append(row)
        for g in (gn, 1 - gn):
            rows.append(target_step(system, cfg.replace(
                estimator=dataclasses.replace(cfg.estimator,
                                              gauss_newton_iters=g)),
                b_step))
        if res == 512:
            rows.append(target_solve_fixed(system, 1024))
    d = jax.devices()[0]
    report = {
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
        "peaks": device_peaks(),
        "repeats": REPEATS, "scan_steps": STEPS,
        "rows": rows,
    }
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
