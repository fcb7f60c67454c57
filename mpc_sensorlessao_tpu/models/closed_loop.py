"""Closed-loop sensorless-AO MPC simulation engine.

Re-design of the reference's 500-step control loop
(reference: README.md:444-626).  Two key structural changes:

* the reference replays a precomputed (512,512,2000) phase tensor
  (SURVEY.md section 1); here the frozen-flow turbulence is *evolved inside
  the loop* from per-layer periodic screens, so the whole closed loop is a
  single `lax.scan` with a small carry and no giant HBM-resident tensor;
* everything is batched: `vmap` the simulate function over scenario axes
  (turbulence realization, D/r0, SNR) -- the design center of the
  framework (SURVEY.md section 7).

Loop step (matching README.md:444-626 exactly in structure):
  residual phase -> diversity PSFs + noise -> LS estimate -> b_ref ->
  QP solve (fastmpc / closed-form / ADMM) -> first-stage input ->
  DM modal correction -> next-step corrected phase.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import edge_flow as edge_flow_mod
from ..ops import newton_kkt, phase_screens, zernike
from ..utils import hostcompute
from ..utils.config import SystemConfig
from . import dm as dm_model
from . import estimator as estimator_model
from . import mpc, solvers


class LoopModels(NamedTuple):
    """Precomputed operators shared across scenarios (device arrays)."""

    est: estimator_model.EstimatorModel
    influence: jnp.ndarray        # (nx, n_act)
    mats: mpc.MPCMatrices
    prob: newton_kkt.FastMPCProblem
    fixed_op: newton_kkt.FixedNewtonOperator
    state_stack: jnp.ndarray      # (nx, R, R) Zernike modes excl. piston
    mask: jnp.ndarray             # (R, R) pupil mask
    mask_npix: jnp.ndarray        # scalar
    # discrete pupil moments of the state modes (zernike.make_basis):
    # mean_pupil(Z_j Z_k) and mean_pupil(Z_k) -- used by the algebraic
    # residual-RMS telemetry (see step()); None in hand-built fixtures
    # (the step then falls back to the (R, R) reduction)
    mode_gram: jnp.ndarray = None     # (nx, nx)
    mode_mean: jnp.ndarray = None     # (nx,)


class StepOutputs(NamedTuple):
    """Per-step telemetry (the reference's accumulator arrays,
    README.md:420-427,588-624)."""

    u: jnp.ndarray              # applied first-stage input (nu,)
    du: jnp.ndarray             # input increment
    volts: jnp.ndarray          # DM voltages
    x_est: jnp.ndarray          # estimated residual coefficients
    x_est_norm: jnp.ndarray     # ||ad_est|| (X_est_err)
    x_pred_norm: jnp.ndarray    # ||x_prev|| (X_acc_err)
    cost: jnp.ndarray           # J = U'HU + r'U + c
    rms_res: jnp.ndarray        # true residual-phase RMS in pupil [rad]
    rms_turb: jnp.ndarray       # uncorrected turbulence RMS [rad]
    strehl: jnp.ndarray         # Marechal approximation exp(-sigma^2)
    # Exact OTF-volume Strehl (imager.m:98-115): peak of the noiseless
    # on-axis (zd=0) diversity PSF crop over the diffraction-limited
    # peak b_s -- total flux is phase-invariant (Parseval), so the peak
    # ratio IS sum(OTF_res)/sum(OTF_DL).  Valid while the residual PSF
    # peak stays inside the (2c+1)^2 crop (any locked loop).  None in
    # hand-built telemetry fixtures.
    strehl_exact: jnp.ndarray = None


def make_loop_models(basis, est, dm_mod, mats, prob,
                     horizon: int = 2) -> LoopModels:
    import numpy as np
    mask = basis.mask
    return LoopModels(
        est=est,
        influence=dm_mod.influence,
        mats=mats,
        prob=prob,
        fixed_op=hostcompute.to_default(newton_kkt.precompute_fixed_newton(
            jax.tree.map(lambda a: jax.device_put(
                a, hostcompute.cpu_device()), prob), horizon)),
        state_stack=basis.stack[1:],
        mask=mask,
        mask_npix=jnp.asarray(float(np.asarray(mask).sum()),
                              dtype=jnp.float32),
        mode_gram=(None if basis.gram is None else basis.gram[1:, 1:]),
        mode_mean=(None if basis.mode_mean is None
                   else basis.mode_mean[1:]),
    )


def _pupil_rms(models: LoopModels, phase):
    msk = models.mask.astype(phase.dtype)
    mean = jnp.sum(phase * msk) / models.mask_npix
    var = jnp.sum(((phase - mean) * msk) ** 2) / models.mask_npix
    return jnp.sqrt(var)


@partial(jax.jit, static_argnames=("cfg", "n_steps", "solver"))
def simulate(
    models: LoopModels,
    layers: phase_screens.FrozenFlowLayers,
    cfg: SystemConfig,
    key,
    n_steps: int,
    start_step=0,
    solver: str | None = None,
    mag=None,
    noise_scale=1.0,
    edge_model: edge_flow_mod.EdgeFlowModel | None = None,
    edge_state: edge_flow_mod.EdgeFlowState | None = None,
    init_u: jnp.ndarray | None = None,
    noise_seq: jnp.ndarray | None = None,
    turb_key: jnp.ndarray | None = None,
) -> StepOutputs:
    """Run the closed loop for n_steps starting at absolute turbulence step
    ``start_step`` (the reference starts at the test split,
    README.md:429-430).  Single scenario; vmap over (models-shared)
    scenario axes for Monte-Carlo batches.

    ``start_step``, ``mag`` (turbulence magnification, default from
    cfg.sim) and ``noise_scale`` are traced, so scenario sweeps over
    turbulence window / D-over-r0 / SNR batch without recompiling.

    ``edge_model``/``edge_state`` switch turbulence to the stateful
    conditional-Gaussian frozen flow (reference-parity screen extension,
    ops/edge_flow.py); the default is the periodic sampled flow.

    ``turb_key`` (optional) decouples the turbulence PRNG stream from
    the per-scenario ``key``: pass ONE unbatched key (plus an unbatched
    ``edge_state``) under ``vmap`` and the conditional-flow evolution
    traces UNBATCHED -- one shared turbulence realization amortized over
    the whole scenario batch, the edge-flow analogue of the
    shared-window fast path (parallel/montecarlo.run_batch).  Default:
    folded from ``key`` (per-scenario independent turbulence).
    """
    solver = solver or cfg.mpc.solver
    if noise_seq is not None and noise_seq.shape[0] < n_steps:
        # jax would silently CLAMP the out-of-bounds scan index and
        # replay the last noise row -- a quietly wrong trajectory
        raise ValueError(
            f"noise_seq has {noise_seq.shape[0]} rows < n_steps="
            f"{n_steps}")
    R = cfg.resolution
    nu_dim = models.influence.shape[1]
    nx = models.influence.shape[0]
    N = cfg.mpc.horizon
    if mag is None:
        mag = jnp.asarray(cfg.sim.magnification, dtype=jnp.float32)

    du = cfg.mpc.du_max
    U_min = jnp.full((N * nu_dim,), -cfg.mpc.u_max, dtype=jnp.float32)
    U_max = jnp.full((N * nu_dim,), cfg.mpc.u_max, dtype=jnp.float32)
    dU_base_min = jnp.full((N * nu_dim,), -du, dtype=jnp.float32)
    dU_base_max = jnp.full((N * nu_dim,), du, dtype=jnp.float32)

    if turb_key is None:
        turb_key = jax.random.fold_in(key, 0x7e5)

    fuse = (cfg.mpc.est_gain != 1.0
            or cfg.mpc.innovation_gate is not None)
    track = cfg.estimator.track_gn_iters

    def step(carry, idx):
        u1, u2, u3, x_pre, x_pre2, ad_cor, eflow = carry

        # -- turbulence + correction (README.md:447-453) --
        # The DM correction is carried as MODAL coefficients (nx,) and
        # synthesized here, at its single point of use: under vmap the
        # (R, R) phase-map carry would be a per-scenario HBM round-trip
        # every scan iteration, while the einsum output fuses straight
        # into the residual add.
        if edge_model is not None:
            eflow, raw = edge_flow_mod.advance(
                edge_model, eflow, start_step + idx, turb_key)
        else:
            raw = phase_screens.phase_at(layers, start_step + idx, R)
        # piston-removed screen BEFORE the mag scaling: shared across
        # scenarios in shared-window batches (vmap keeps it unbatched)
        pt_unit = zernike.piston_removed_phase_masked(
            raw, models.mask, models.mask_npix)
        phase_turb = pt_unit * mag
        phase_cor = estimator_model.mode_phase(ad_cor, models.state_stack)
        phase_res = phase_turb + phase_cor

        # -- estimator (README.md:457-480) --
        # noise_seq: externally injected per-step noise (n_steps, n_pix)
        # -- lets an oracle share the exact measurement-noise sequence
        # for end-to-end noisy golden-trajectory parity (the reference
        # loads precomputed noise from SNR_10.mat, README.md:473-475)
        if noise_seq is not None:
            noise = noise_scale * noise_seq[idx]
        else:
            noise = noise_scale * estimator_model.sample_noise(
                models.est, jax.random.fold_in(key, idx))
        y_clean = estimator_model.measure(models.est, phase_res, None)
        y = y_clean + noise
        gn = cfg.estimator.gauss_newton_iters
        if gn > 0:
            x0 = estimator_model.estimate_gauss_newton(
                models.est, y, models.state_stack, gn)
        else:
            x0 = estimator_model.estimate(models.est, y)

        # -- tracking estimator (EstimatorConfig.track_gn_iters): full
        # re-linearized Gauss-Newton seeded by continuity -- the previous
        # accepted estimate propagated by the applied command change --
        # so the capture basin is the per-step innovation |x[k] - x[k-1]
        # - B du|, not the absolute aberration |x|.  RECOVERY-ONLY rule:
        # the tracked estimate replaces the base one only when the base
        # estimate has clearly stopped explaining the measured PSFs
        # (chi-square per pixel far beyond both the tracked candidate and
        # an absolute floor).  A head-to-head chi-square pick is WRONG
        # here: the better-regularized base estimator fits the data worse
        # by design yet has the lower truth error in lock -- data fit
        # cannot rank differently-regularized estimators.
        if track > 0:
            seed_cont = x_pre + models.prob.B @ (u1 - u2)
            seed = jnp.where(idx <= cfg.mpc.var_order, x0, seed_cont)
            x_gn = estimator_model.estimate_full_gn(
                models.est, y, models.state_stack, track, x_init=seed)
            # model-error floor keeps the chi-square meaningful in
            # (near-)noiseless scenarios: without it c_base > 20 is
            # vacuously true and the rule degenerates into the
            # head-to-head pick declared WRONG above
            sig2 = ((noise_scale * models.est.noise_std) ** 2
                    + (1e-3 * jnp.sqrt(jnp.mean(models.est.b_s ** 2))) ** 2)

            def chi2(xc):
                ph = estimator_model.mode_phase(xc, models.state_stack)
                dy = y - estimator_model.measure(models.est, ph, None)
                return jnp.mean(dy * dy) / sig2

            c_base = chi2(x0)
            unlocked = jnp.logical_and(c_base > 3.0 * chi2(x_gn),
                                       c_base > 20.0)
            x0 = jnp.where(unlocked, x_gn, x0)

        # -- estimator-VAR fusion (MPCConfig.est_gain/innovation_gate) --
        if fuse:
            # VAR prediction of the current residual from the loop's own
            # history: x[k] = a[k] + B u[k-1] with a following the fitted
            # VAR on a[k-j] = x[k-j] - B u[k-j-1].  NOTE: the MPC nulls
            # the predictable part by design, so x_pred ~ 0 in lock; the
            # gate is a last-resort clamp for noise spikes, NOT a tracking
            # mechanism (see track_gn_iters for that).
            a1_prev = x_pre - models.prob.B @ u2
            a2_prev = x_pre2 - models.prob.B @ u3
            x_pred_now = (models.prob.A1 @ a1_prev
                          + models.prob.A2 @ a2_prev
                          + models.prob.B @ u1)
            innov = x0 - x_pred_now
            if cfg.mpc.innovation_gate is not None:
                gate = cfg.mpc.innovation_gate
                nrm = jnp.linalg.norm(innov)
                innov = innov * jnp.minimum(1.0, gate / (nrm + 1e-12))
            fused = x_pred_now + cfg.mpc.est_gain * innov
            # no history on the first var_order+1 steps: use the raw
            # estimate (after a warm start the residual is small and the
            # estimator is in capture there)
            x0 = jnp.where(idx <= cfg.mpc.var_order, x0, fused)

        # -- QP assembly (README.md:483-501) --
        if cfg.mpc.cold_start == "hold":
            # first step: x0_pre=x0 instead of zeros (see MPCConfig)
            x_pre_eff = jnp.where(idx == 0, x0, x_pre)
        else:
            x_pre_eff = x_pre
        bref = mpc.b_ref(models.mats, u1, u2)
        r, c, x_free = mpc.gradient_terms(models.mats, x0, x_pre_eff, bref)

        # -- solve (README.md:504-570) --
        if solver == "fastmpc":
            if cfg.mpc.newton_steps == 1:
                # real-time mode: constant-slack single Newton step via
                # precomputed operators (see newton_kkt.FixedNewtonOperator)
                state = newton_kkt.solve_fixed(
                    models.prob, models.fixed_op, x0, x_pre_eff, bref,
                    horizon=N)
            else:
                state = newton_kkt.solve(
                    models.prob, x0, x_pre_eff, bref, horizon=N,
                    n_newton=cfg.mpc.newton_steps, x_box=cfg.mpc.x_box)
            U = state.U.reshape(-1)
        elif solver == "fastmpc_ramp":
            # VAR_1-style active ramp rows with the loop's running u_prev
            prob_r = models.prob._replace(u_prev=u1)
            state = newton_kkt.solve(
                prob_r, x0, x_pre_eff, bref, horizon=N,
                n_newton=cfg.mpc.newton_steps, x_box=cfg.mpc.x_box,
                ramp=True)
            U = state.U.reshape(-1)
        elif solver == "closed_form":
            U = solvers.closed_form(models.mats, r)
        elif solver == "admm":
            # first-block ramp bounds shifted by u_prev (README.md:449-451)
            dmin = dU_base_min.at[:nu_dim].add(u1)
            dmax = dU_base_max.at[:nu_dim].add(u1)
            U = solvers.admm_condensed(models.mats, r, U_min, U_max,
                                       dmin, dmax)
        else:
            raise ValueError(f"unknown solver '{solver}'")

        # -- actuate (README.md:576-601) --
        u = U[:nu_dim]
        volts = dm_model.rad_to_volts(
            u, cfg.dm.coeff_a, cfg.dm.coeff_b, cfg.estimator.rad_to_nm)
        ad_cor_new = models.influence @ u

        x_pred = mpc.predicted_states(models.mats, U, x_free)
        cost = mpc.cost(models.mats, U, r, c)
        # pt_unit is masked-mean-removed, so rms(phase_turb) = mag *
        # rms(pt_unit) exactly -- and rms(pt_unit) stays UNBATCHED under
        # vmap in shared-window batches (one reduction instead of B)
        rms_pt = _pupil_rms(models, pt_unit)
        rms_turb = mag * rms_pt
        if models.mode_gram is not None:
            # algebraic residual RMS: with p = mag pt + sum_k ad_k Z_k
            # (both zero outside the pupil, pt pupil-mean-removed),
            #   mean(p^2) = mag^2 rms(pt)^2 + 2 mag ad.ct + ad'G ad
            #   mean(p)   = ad.mbar
            # with ct_k = mean_pupil(pt Z_k) (UNBATCHED: one stack pass
            # per step, amortized over the scenario batch), G/mbar the
            # precomputed mode moments -- O(nx^2) per scenario instead
            # of a batched (B, R^2) reduction.
            ct = jnp.einsum("kij,ij->k", models.state_stack,
                            pt_unit) / models.mask_npix
            var_res = ((mag * rms_pt) ** 2
                       + 2.0 * mag * jnp.dot(ad_cor, ct)
                       + ad_cor @ models.mode_gram @ ad_cor
                       - jnp.dot(ad_cor, models.mode_mean) ** 2)
            rms_res = jnp.sqrt(jnp.maximum(var_res, 0.0))
        else:
            rms_res = _pupil_rms(models, phase_res)

        # exact Strehl from the already-computed zd=0 diversity crop
        # (the middle w^2 block of y_clean; div order is (-amp, 0, +amp))
        w2 = (2 * cfg.estimator.crop_half + 1) ** 2
        strehl_exact = (jnp.max(y_clean[w2:2 * w2])
                        / jnp.max(models.est.b_s[w2:2 * w2]))

        # ONE packed row per step instead of 11 separate scan outputs
        # (11 per-iteration dynamic-update-slices of tiny arrays);
        # unpacked into StepOutputs after the scan.
        out = jnp.concatenate([
            u, u - u1, volts, x0,
            jnp.stack([jnp.linalg.norm(x0),
                       jnp.linalg.norm(x_pred[:nx]),
                       cost, rms_res, rms_turb,
                       jnp.exp(-rms_res ** 2), strehl_exact]),
        ])
        return (u, u1, u2, x0, x_pre, ad_cor_new, eflow), out

    # Precision policy (EstimatorConfig): every product of the loop runs
    # at full float32; only products that state their own precision (the
    # measure's first DFT stage, the turbulence border draws) differ.
    with jax.default_matmul_precision("highest"):
        if init_u is not None:
            # acquisition warm start (MPCConfig.warm_start): pre-load the
            # DM with the calibration-handover command so step 0 sees
            # only the prediction error
            u_init = init_u.astype(jnp.float32)
            ad_init = models.influence @ u_init
        else:
            u_init = jnp.zeros((nu_dim,), dtype=jnp.float32)
            ad_init = jnp.zeros((nx,), dtype=jnp.float32)
        init = (
            u_init,
            jnp.zeros((nu_dim,), dtype=jnp.float32),
            jnp.zeros((nu_dim,), dtype=jnp.float32),
            jnp.zeros((nx,), dtype=jnp.float32),
            jnp.zeros((nx,), dtype=jnp.float32),
            ad_init,
            edge_state,
        )
        _, packed = jax.lax.scan(step, init, jnp.arange(n_steps))
    # unpack the (n_steps, 3 nu + nx + 7) telemetry rows (see step())
    cols = [nu_dim, nu_dim, nu_dim, nx]
    ofs = [0]
    for c in cols:
        ofs.append(ofs[-1] + c)
    s = ofs[-1]
    return StepOutputs(
        u=packed[:, ofs[0]:ofs[1]], du=packed[:, ofs[1]:ofs[2]],
        volts=packed[:, ofs[2]:ofs[3]], x_est=packed[:, ofs[3]:ofs[4]],
        x_est_norm=packed[:, s], x_pred_norm=packed[:, s + 1],
        cost=packed[:, s + 2], rms_res=packed[:, s + 3],
        rms_turb=packed[:, s + 4], strehl=packed[:, s + 5],
        strehl_exact=packed[:, s + 6])


@partial(jax.jit, static_argnames=("n_steps", "start_step", "resolution"))
def turbulence_rollout(
    layers: phase_screens.FrozenFlowLayers,
    fit_full: jnp.ndarray,
    mask: jnp.ndarray,
    mask_npix: jnp.ndarray,
    n_steps: int,
    resolution: int,
    start_step: int = 0,
    mag: float = 1.0,
) -> jnp.ndarray:
    """Open-loop pre-pass: frozen-flow evolution -> piston-removed phase ->
    Zernike coefficients, as one scan.  Equivalent of the reference's
    2000-step generation + zernmodfit loop (README.md:69-93) without ever
    materializing the (R,R,T) tensor.
    Returns (n_steps, n_modes) coefficients (piston column included).
    """

    def one(idx):
        raw = phase_screens.phase_at(layers, start_step + idx, resolution)
        msk = mask.astype(raw.dtype)
        mean = jnp.sum(raw * msk) / mask_npix
        ph = (raw - mean) * msk * mag
        return jnp.matmul(fit_full, ph.reshape(-1),
                          precision=jax.lax.Precision.HIGHEST)

    # steps are independent open-loop replays: chunk-vectorized map
    return jax.lax.map(one, jnp.arange(n_steps), batch_size=32)
