"""On-chip decomposition of the closed-loop control step.

Times each stage of the R=512 step (turbulence window + residual
formation, fused PSF measure, estimate + QP solve, DM synthesis)
separately with the differenced-scan method (two scan lengths; the
difference cancels per-dispatch latency AND fixed scan overhead -- see
benchmarks/_timing.py), so the sum can be compared
against the full `closed_loop.simulate` step to find unaccounted cost.

Run from the repository root:

    python benchmarks/step_breakdown.py [R] [B] [STEPS]
"""

from __future__ import annotations

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

from mpc_sensorlessao_tpu.models import (closed_loop, estimator, mpc,
                                         pipeline)  # noqa: E402
from mpc_sensorlessao_tpu.ops import newton_kkt, phase_screens, zernike  # noqa: E402
from mpc_sensorlessao_tpu.parallel import montecarlo  # noqa: E402
from mpc_sensorlessao_tpu.utils.config import reference_config  # noqa: E402


def timed_scan(step_fn, init, steps, repeats=4):
    """Best-of differenced-scan seconds-per-iteration."""

    def build(n):
        @jax.jit
        def run(c0):
            c, ys = jax.lax.scan(step_fn, c0, None, length=n)
            return jax.tree.map(
                lambda a: jnp.sum(a) if a.ndim else a, ys)
        return run

    short, long = build(steps), build(2 * steps)
    jax.block_until_ready(short(init))
    jax.block_until_ready(long(init))

    def best(run):
        b = np.inf
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(run(init))
            b = min(b, time.perf_counter() - t0)
        return b

    return (best(long) - best(short)) / steps


def main():
    R = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    B = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    steps = int(sys.argv[3]) if len(sys.argv) > 3 else 25

    cfg = reference_config(resolution=R)
    cfg = cfg.replace(sim=dataclasses.replace(
        cfg.sim, n_train=300, n_valid=50, n_test=steps))
    system = pipeline.build(cfg, jax.random.PRNGKey(0))
    models = system.loop
    layers = system.layers
    est = models.est
    nx = models.influence.shape[0]
    nu = models.influence.shape[1]
    N = cfg.mpc.horizon

    key = jax.random.PRNGKey(7)
    mags = jnp.full((B,), float(cfg.sim.magnification), jnp.float32)
    keys = jax.random.split(key, B)
    us = 1e6 / B

    out = {"R": R, "B": B, "steps": steps,
           "device": str(jax.devices()[0].device_kind)}

    # 1. turbulence window + piston removal + residual formation + rms
    #    (phase_cor carried per scenario, scalar-perturbed feedback)
    pc0 = (jnp.zeros((B, R, R), jnp.float32), jnp.int32(0))

    def turb_step(carry, _):
        pc, idx = carry
        raw = phase_screens.phase_at(layers, 1000 + idx, R)

        def one(mag, pc_b):
            pt = zernike.piston_removed_phase_masked(
                raw, models.mask, models.mask_npix) * mag
            pr = pt + pc_b
            return (closed_loop._pupil_rms(models, pr)
                    + closed_loop._pupil_rms(models, pt))

        s = jnp.sum(jax.vmap(one)(mags, pc))
        return (pc * (1.0 + 1e-12 * s), idx + 1), s

    out["turb_residual_us"] = round(timed_scan(turb_step, pc0, steps) * us, 2)

    # 2. fused PSF measure + noise (per scenario)
    ph0 = jnp.asarray(
        np.random.default_rng(0).normal(size=(B, R, R)) * 0.2, jnp.float32)

    def meas_step(carry, _):
        ph, idx = carry

        def one(k, p):
            noise = estimator.sample_noise(est, jax.random.fold_in(k, idx))
            return jnp.sum(estimator.measure(est, p, noise))

        s = jnp.sum(jax.vmap(one, in_axes=(0, 0))(keys, ph))
        return (ph * (1.0 + 1e-12 * s), idx + 1), s

    out["measure_us"] = round(
        timed_scan(meas_step, (ph0, jnp.int32(0)), steps) * us, 2)

    # 3. estimate + QP assembly + fixed-Newton solve (per scenario).
    # NOTE: gauss_newton_iters >= 1 re-runs the fused PSF measure once
    # per iteration inside the estimate -- with the default gn=1 this
    # stage costs ~as much as stage 2 again (the round-3 knockout
    # finding: benchmarks/step_knockouts.py); gn=0 is the reference's
    # linear estimator and makes this stage negligible.
    gn = cfg.estimator.gauss_newton_iters
    y0 = jnp.asarray(
        np.random.default_rng(1).normal(size=(B, est.n_pixels)) * 0.1,
        jnp.float32) + est.b_s

    def ctrl_step(carry, _):
        y, u1, u2, xp = carry

        def one(yb, u1b, u2b, xpb):
            if gn > 0:
                x0 = estimator.estimate_gauss_newton(
                    est, yb, models.state_stack, gn)
            else:
                x0 = estimator.estimate(est, yb)
            bref = mpc.b_ref(models.mats, u1b, u2b)
            r, c, x_free = mpc.gradient_terms(models.mats, x0, xpb, bref)
            state = newton_kkt.solve_fixed(
                models.prob, models.fixed_op, x0, xpb, bref, horizon=N)
            U = state.U.reshape(-1)
            u = U[:nu]
            return (u, x0, mpc.cost(models.mats, U, r, c)
                    + jnp.linalg.norm(mpc.predicted_states(
                        models.mats, U, x_free)[:nx]))

        u, x0, s = jax.vmap(one)(y, u1, u2, xp)
        ssum = jnp.sum(s)
        return (y * (1.0 + 1e-12 * ssum), u, u1, x0), ssum

    c0 = (y0, jnp.zeros((B, nu), jnp.float32),
          jnp.zeros((B, nu), jnp.float32), jnp.zeros((B, nx), jnp.float32))
    out["estimate_qp_us"] = round(timed_scan(ctrl_step, c0, steps) * us, 2)

    # 4. DM modal synthesis (B, nu) -> (B, R, R)
    u0 = jnp.asarray(
        np.random.default_rng(2).normal(size=(B, nu)) * 0.1, jnp.float32)

    def synth_step(u, _):
        ad = u @ models.influence.T                      # (B, nx)
        pc = jnp.einsum("bk,kij->bij", ad, models.state_stack)
        s = jnp.sum(pc)
        return u * (1.0 + 1e-12 * s), s

    out["synthesis_us"] = round(timed_scan(synth_step, u0, steps) * us, 2)

    # 5. the real full step for comparison (shared-window bench path)
    scen = montecarlo.make_scenarios(
        cfg, jax.random.PRNGKey(1), B,
        d_over_r0_grid=(5.0,), snr_db_grid=(10.0,))
    montecarlo.assert_shared_window(scen)

    def full(n):
        @jax.jit
        def run(s):
            o = montecarlo.run_batch(models, layers, cfg, s, n_steps=n,
                                     shared_window="verified")
            return o.rms_res
        return run

    short, long = full(steps), full(2 * steps)
    jax.block_until_ready(short(scen))
    jax.block_until_ready(long(scen))

    def best(run):
        b = np.inf
        for _ in range(4):
            t0 = time.perf_counter()
            jax.block_until_ready(run(scen))
            b = min(b, time.perf_counter() - t0)
        return b

    out["full_step_us"] = round((best(long) - best(short)) / steps * us, 2)
    out["sum_of_parts_us"] = round(
        out["turb_residual_us"] + out["measure_us"]
        + out["estimate_qp_us"] + out["synthesis_us"], 2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
