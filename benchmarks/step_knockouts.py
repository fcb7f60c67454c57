"""Knockout timing of the closed-loop step: which piece costs what.

`step_breakdown.py` times the stages in isolation, and their sum can
fall well below the full `closed_loop.simulate` step -- isolated stages
fuse differently than the composed step, so the gap must be attributed
empirically.  This
harness re-builds the *composed* step with individual pieces knocked
out (all knobs replicate `closed_loop.simulate` exactly when on) and
times each variant with the differenced-scan method, so each knockout's
delta is that piece's true marginal cost inside the real fusion
context.

Variants:
  full          -- replica of the simulate step (sanity: matches the
                   montecarlo.run_batch shared-window number)
  fused_noise   -- no y_clean/noisy split: noise added inside measure,
                   exact Strehl from the noisy crop (biased ~+noise)
  no_exact      -- no exact-Strehl peak ratio (keep the clean split)
  no_rms        -- no rms_res / rms_turb pupil reductions
  no_noise      -- no per-step threefry noise synthesis
  lean          -- measure -> estimate -> solve -> actuate only

Run from the repository root:

    python benchmarks/step_knockouts.py [R] [B] [STEPS]
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
from mpc_sensorlessao_tpu.utils.config import reference_config  # noqa: E402


def build_step(models, layers, cfg, key, start_step, *, clean_split=True,
               exact_strehl=True, rms=True, noise_on=True, telemetry=True,
               gn=None):
    """One scenario's step(carry, idx) with knockout flags.

    With every flag True (and gn=None -> cfg) this is line-for-line the
    fastmpc/newton=1 path of closed_loop.simulate
    (models/closed_loop.py step()).
    """
    if gn is None:
        gn = cfg.estimator.gauss_newton_iters
    R = cfg.resolution
    nu = models.influence.shape[1]
    N = cfg.mpc.horizon
    w2 = (2 * cfg.estimator.crop_half + 1) ** 2

    def step(carry, idx):
        u1, u2, x_pre, ad_cor, mag, noise_scale = carry
        raw = phase_screens.phase_at(layers, start_step + idx, R)
        pt_unit = zernike.piston_removed_phase_masked(
            raw, models.mask, models.mask_npix)
        phase_turb = pt_unit * mag
        phase_cor = jnp.einsum("k,kij->ij", ad_cor, models.state_stack)
        phase_res = phase_turb + phase_cor

        if noise_on:
            noise = noise_scale * estimator.sample_noise(
                models.est, jax.random.fold_in(key, idx))
        else:
            noise = None
        if clean_split:
            y_clean = estimator.measure(models.est, phase_res, None)
            y = y_clean if noise is None else y_clean + noise
        else:
            y = estimator.measure(models.est, phase_res, noise)
            y_clean = y
        if gn > 0:
            x0 = estimator.estimate_gauss_newton(
                models.est, y, models.state_stack, gn)
        else:
            x0 = estimator.estimate(models.est, y)

        bref = mpc.b_ref(models.mats, u1, u2)
        r, c, x_free = mpc.gradient_terms(models.mats, x0, x_pre, bref)
        state = newton_kkt.solve_fixed(
            models.prob, models.fixed_op, x0, x_pre, bref, horizon=N)
        U = state.U.reshape(-1)
        u = U[:nu]
        ad_cor_new = models.influence @ u

        outs = [u]
        if telemetry:
            x_pred = mpc.predicted_states(models.mats, U, x_free)
            outs += [jnp.linalg.norm(x0),
                     jnp.linalg.norm(x_pred[:models.influence.shape[0]]),
                     mpc.cost(models.mats, U, r, c)]
        if rms == "reduction":
            # the pre-round-3 layout: batched (B, R^2) reduction
            rms_res = closed_loop._pupil_rms(models, phase_res)
            outs += [rms_res, mag * closed_loop._pupil_rms(models, pt_unit)]
        elif rms:
            # the shipped algebraic path (closed_loop.step telemetry)
            rms_pt = closed_loop._pupil_rms(models, pt_unit)
            ct = jnp.einsum("kij,ij->k", models.state_stack,
                            pt_unit) / models.mask_npix
            var_res = ((mag * rms_pt) ** 2
                       + 2.0 * mag * jnp.dot(ad_cor, ct)
                       + ad_cor @ models.mode_gram @ ad_cor
                       - jnp.dot(ad_cor, models.mode_mean) ** 2)
            rms_res = jnp.sqrt(jnp.maximum(var_res, 0.0))
            outs += [rms_res, mag * rms_pt]
        if exact_strehl:
            outs += [jnp.max(y_clean[w2:2 * w2])
                     / jnp.max(models.est.b_s[w2:2 * w2])]
        if telemetry == "stacked":
            # the real StepOutputs shape: one scan output per field
            # (11 separate per-iteration dynamic-update-slices)
            volts = outs[0] * 17.2
            ys = (u, u - u1, volts, x0, outs[1], outs[2], outs[3],
                  outs[4], outs[5], jnp.exp(-outs[4] ** 2), outs[6])
            return (u, u1, x0, ad_cor_new, mag, noise_scale), ys
        if telemetry == "packed":
            # one concatenated row per iteration: a single update-slice
            volts = outs[0] * 17.2
            flat = jnp.concatenate(
                [u, u - u1, volts, x0,
                 jnp.stack([outs[1], outs[2], outs[3], outs[4], outs[5],
                            jnp.exp(-outs[4] ** 2), outs[6]])])
            return (u, u1, x0, ad_cor_new, mag, noise_scale), flat
        return ((u, u1, x0, ad_cor_new, mag, noise_scale),
                sum(jnp.sum(o) for o in outs))

    return step


def timed(run, arg, repeats=4):
    jax.block_until_ready(run(arg))
    b = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run(arg))
        b = min(b, time.perf_counter() - t0)
    return b


def main():
    R = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    B = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    steps = int(sys.argv[3]) if len(sys.argv) > 3 else 25

    cfg = reference_config(resolution=R)
    cfg = cfg.replace(sim=dataclasses.replace(
        cfg.sim, n_train=300, n_valid=50, n_test=steps))
    system = pipeline.build(cfg, jax.random.PRNGKey(0))
    models, layers = system.loop, system.layers
    nu = models.influence.shape[1]
    nx = models.influence.shape[0]
    s0 = cfg.sim.n_train + cfg.sim.n_valid

    keys = jax.random.split(jax.random.PRNGKey(7), B)
    mags = jnp.full((B,), float(cfg.sim.magnification), jnp.float32)
    ns = jnp.ones((B,), jnp.float32)
    us = 1e6 / B
    out = {"R": R, "B": B, "steps": steps,
           "device": str(jax.devices()[0].device_kind)}

    variants = {
        "full": dict(),
        "fused_noise": dict(clean_split=False),
        "no_exact": dict(exact_strehl=False),
        "no_rms": dict(rms=False),
        "no_noise": dict(noise_on=False),
        "lean": dict(clean_split=False, exact_strehl=False, rms=False,
                     noise_on=False, telemetry=False),
        # telemetry layout A/B: per-field stacking (the round-2
        # closed_loop.StepOutputs shape) vs one packed row per step
        "stacked": dict(telemetry="stacked"),
        "packed": dict(telemetry="packed"),
        # the round-3 finding: the default gn=1 runs the fused PSF
        # measure TWICE per step (y and the Gauss-Newton re-measure);
        # gn=0 is the reference's linear estimator (README.md:478)
        "gn0": dict(gn=0),
        "gn1": dict(gn=1),
        "rms_reduction": dict(rms="reduction"),
    }
    if len(sys.argv) > 4:
        only = sys.argv[4].split(",")
        variants = {k: v for k, v in variants.items() if k in only}
    for name, kw in variants.items():
        def make(n, kw=kw):
            @jax.jit
            def run(carries):
                def one(key, mag, nsc):
                    step = build_step(models, layers, cfg, key, s0, **kw)
                    init = (jnp.zeros((nu,), jnp.float32),
                            jnp.zeros((nu,), jnp.float32),
                            jnp.zeros((nx,), jnp.float32),
                            jnp.zeros((nx,), jnp.float32), mag, nsc)
                    _, ys = jax.lax.scan(step, init, jnp.arange(n))
                    return sum(jnp.sum(y) for y in jax.tree.leaves(ys))
                k, m, nsc = carries
                return jnp.sum(jax.vmap(one)(k, m, nsc))
            return run
        short, long = make(steps), make(2 * steps)
        arg = (keys, mags, ns)
        t = (timed(long, arg) - timed(short, arg)) / steps
        out[name + "_us"] = round(t * us, 2)
        print(name, out[name + "_us"], flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
