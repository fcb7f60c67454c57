"""End-to-end pipeline: turbulence -> system ID -> closed-loop MPC.

Orchestrates the full reference workflow (SURVEY.md section 1 layer map):
  L1 frozen-flow generation  -> L2 Zernike series  -> L3 VAR fit
  -> L4 DM influence        -> L5 estimator model -> L6 MPC matrices
  -> L7 closed-loop simulation,
with the open-loop pre-pass and the closed loop both running on device.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import edge_flow, phase_screens, zernike
from ..utils import hostcompute
from ..utils.config import SystemConfig
from . import closed_loop, dm, estimator, mpc, solvers, var


class System(NamedTuple):
    """All precomputed models for a configured scenario."""

    basis: zernike.ZernikeBasis
    layers: phase_screens.FrozenFlowLayers
    est: estimator.EstimatorModel
    dm_model: dm.DMModel
    var_model: var.VARModel
    mats: mpc.MPCMatrices
    loop: closed_loop.LoopModels
    coeff_series: jnp.ndarray     # (n_total, n_modes) open-loop Zernike ts
    # conditional-Gaussian flow (atmosphere.flow == "conditional") only:
    edge_model: edge_flow.EdgeFlowModel | None = None
    edge_state: edge_flow.EdgeFlowState | None = None  # at the test split


def _design_matrices_host(cfg: SystemConfig, A1, A2, influence):
    """Condensed MPC design matrices on the host CPU backend.

    The single definition of the Q/P/R weighting, shared by build() and
    with_horizon() so horizon sweeps always benchmark exactly the
    controller build() produces."""
    import numpy as np

    nx = A1.shape[0]
    nu = influence.shape[1]
    Q = jnp.asarray(cfg.mpc.q_weight * np.eye(nx), dtype=jnp.float32)
    P = jnp.asarray(cfg.mpc.p_weight_scale * cfg.mpc.q_weight * np.eye(nx),
                    dtype=jnp.float32)
    Rm = jnp.asarray(cfg.mpc.r_weight * np.eye(nu), dtype=jnp.float32)
    cpu = hostcompute.cpu_device()
    with hostcompute.on_cpu():
        mats = mpc.design_matrices(
            jax.device_put(A1, cpu), jax.device_put(A2, cpu),
            jax.device_put(influence, cpu), cfg.mpc.horizon, Q, P, Rm)
    return hostcompute.to_default(mats)


def build(cfg: SystemConfig, key) -> System:
    """Build every subsystem from a config + PRNG key."""
    import dataclasses

    R = cfg.resolution
    tel = dataclasses.replace(cfg.telescope, resolution=R)

    basis = zernike.make_basis(cfg.zernike.radial_order, R)
    # turbulence screens are seeded from the config (host-side setup)
    layers = phase_screens.make_layers(int(cfg.sim.seed), cfg.atmosphere,
                                       tel)
    prior_cov = None
    if cfg.estimator.method == "mmse":
        # analytic Von Karman Zernike-coefficient covariance as the
        # residual-aberration prior (piston excluded; magnification scales
        # coefficients linearly -> covariance by mag^2).  Spectral-domain
        # quadrature (Noll formulation): exact and resolution-free, unlike
        # the former grid-fit covariance which aliased above order ~8 at
        # its 48-px grid.
        from ..ops import zernike_stats
        C = zernike_stats.covariance_analytic(
            cfg.atmosphere, cfg.telescope.diameter,
            cfg.zernike.radial_order)
        prior_cov = (C[1:, 1:] * cfg.sim.magnification ** 2
                     * cfg.estimator.prior_scale ** 2)
    est = estimator.build(cfg.estimator, basis, prior_cov=prior_cov)
    dm_model = dm.build(cfg.dm, basis)

    # Open-loop pre-pass over train+valid (the closed loop runs on the test
    # window, README.md:112-115,429-430); magnification applied like
    # README.md:283-284.
    import numpy as np
    mask_npix = jnp.asarray(float(np.asarray(basis.mask).sum()),
                            dtype=jnp.float32)
    n_id = cfg.sim.n_train + cfg.sim.n_valid
    # rollout + VAR fit on the host CPU backend: one-off set-up work at
    # exact float32 (utils.hostcompute)
    cpu = hostcompute.cpu_device()
    if cfg.atmosphere.flow not in ("periodic", "conditional"):
        raise ValueError(
            f"unknown atmosphere.flow '{cfg.atmosphere.flow}' "
            "(expected 'periodic' or 'conditional')")
    edge_model = edge_state = None
    with hostcompute.on_cpu():
        if cfg.atmosphere.flow == "conditional":
            edge_model, state0 = edge_flow.build(
                int(cfg.sim.seed), cfg.atmosphere, tel,
                op_dtype=jnp.dtype(cfg.atmosphere.edge_op_dtype))
            edge_model = jax.device_put(edge_model, cpu)
            edge_state, coeffs = edge_flow.rollout(
                edge_model, jax.device_put(state0, cpu),
                jax.random.PRNGKey(int(cfg.sim.seed)),
                n_id, jax.device_put(basis.fit_full, cpu),
                jax.device_put(basis.mask, cpu),
                jax.device_put(mask_npix, cpu),
                mag=cfg.sim.magnification)
        else:
            coeffs = closed_loop.turbulence_rollout(
                jax.device_put(layers, cpu),
                jax.device_put(basis.fit_full, cpu),
                jax.device_put(basis.mask, cpu),
                jax.device_put(mask_npix, cpu),
                n_steps=n_id, resolution=R, start_step=0,
                mag=cfg.sim.magnification)

        # VAR fit on the training window, piston removed (README.md:110-130)
        if cfg.mpc.var_ridge < 0.0:
            raise ValueError(f"var_ridge must be >= 0, got "
                             f"{cfg.mpc.var_ridge}")
        states = coeffs[:, 1:]
        vmodel = var.fit(states[:cfg.sim.n_train], cfg.mpc.var_order,
                         ridge=cfg.mpc.var_ridge)
        if cfg.mpc.var_max_radius is not None:
            vmodel = var.stabilize(vmodel, cfg.mpc.var_max_radius)
    coeffs = hostcompute.to_default(coeffs)
    if edge_model is not None:
        edge_model = hostcompute.to_default(edge_model)
        edge_state = hostcompute.to_default(edge_state)
    vmodel = hostcompute.to_default(vmodel)
    A1 = vmodel.coefficient(1)
    A2 = (vmodel.coefficient(2) if cfg.mpc.var_order >= 2
          else jnp.zeros_like(A1))

    mats = _design_matrices_host(cfg, A1, A2, dm_model.influence)
    prob = solvers.make_fastmpc_problem(
        A1, A2, dm_model.influence,
        q_weight=cfg.mpc.q_weight,
        p_weight=cfg.mpc.p_weight_scale * cfg.mpc.q_weight,
        r_weight=cfg.mpc.r_weight,
        u_max=cfg.mpc.u_max, barrier_k=cfg.mpc.barrier_k,
        du_max=cfg.mpc.du_max)

    loop = closed_loop.make_loop_models(basis, est, dm_model, mats, prob,
                                        horizon=cfg.mpc.horizon)
    return System(basis=basis, layers=layers, est=est, dm_model=dm_model,
                  var_model=vmodel, mats=mats, loop=loop,
                  coeff_series=coeffs, edge_model=edge_model,
                  edge_state=edge_state)


def with_horizon(system: System, cfg: SystemConfig) -> System:
    """Rebuild only the horizon-dependent MPC operators on a built System.

    The expensive layers (turbulence screens, Zernike basis, estimator
    linearization, VAR fit) are horizon-independent; sweeping the MPC
    horizon N (BASELINE config 3: "longer MPC horizons") only needs new
    condensed design matrices (mpc.design_matrices) and a new
    constant-slack fixed-Newton operator.  The structured Newton problem
    (`prob`) is horizon-free by construction: `newton_kkt.solve` takes
    the horizon per call (the reference rebuilds its whole 23-arg
    Fast_MPC2 object instead, Fast_MPC/VAR_2/Fast_MPC2.m:28-55).
    """
    A1 = system.var_model.coefficient(1)
    A2 = (system.var_model.coefficient(2) if cfg.mpc.var_order >= 2
          else jnp.zeros_like(A1))
    mats = _design_matrices_host(cfg, A1, A2, system.dm_model.influence)
    loop = closed_loop.make_loop_models(
        system.basis, system.est, system.dm_model, mats, system.loop.prob,
        horizon=cfg.mpc.horizon)
    return system._replace(mats=mats, loop=loop)


def run_closed_loop(system: System, cfg: SystemConfig, key,
                    n_steps: int | None = None,
                    solver: str | None = None) -> closed_loop.StepOutputs:
    """Closed loop over the test window (after train+valid)."""
    n = n_steps if n_steps is not None else cfg.sim.n_test
    start = cfg.sim.n_train + cfg.sim.n_valid
    init_u = None
    if cfg.mpc.warm_start:
        init_u = warm_start_command(system, cfg, start)
    return closed_loop.simulate(system.loop, system.layers, cfg, key,
                                n_steps=n, start_step=start, solver=solver,
                                edge_model=system.edge_model,
                                edge_state=system.edge_state,
                                init_u=init_u)


def warm_start_command(system: System, cfg: SystemConfig,
                       start: int) -> jnp.ndarray:
    """Calibration-handover DM command (MPCConfig.warm_start).

    Predicts the state at the first closed-loop step from the last two
    identification states (known with direct phase access during ID,
    README.md:86-93) through the fitted VAR model, and fits the DM to
    cancel it: u0 = argmin ||B u + x_pred||^2, clipped to the input box.
    Host-side one-time setup.
    """
    import numpy as np
    states = np.asarray(system.coeff_series[:, 1:], dtype=np.float64)
    A1 = np.asarray(system.var_model.coefficient(1), dtype=np.float64)
    x_pred = A1 @ states[start - 1]
    if cfg.mpc.var_order >= 2:
        A2 = np.asarray(system.var_model.coefficient(2), dtype=np.float64)
        x_pred = x_pred + A2 @ states[start - 2]
    B = np.asarray(system.dm_model.influence, dtype=np.float64)
    # ridge-regularized fit: cancel only what the DM reaches with bounded
    # effort (a plain pinv at high mode counts demands commands far past
    # the box; clipping those injects garbage instead of correcting)
    gram = B.T @ B
    lam0 = 1e-6 * np.trace(gram) / gram.shape[0]
    lam = lam0
    for _ in range(20):
        u0 = np.linalg.solve(gram + lam * np.eye(gram.shape[0]),
                             -B.T @ x_pred)
        if np.abs(u0).max() <= 0.5 * cfg.mpc.u_max:
            break
        lam *= 10.0
    return jnp.asarray(u0, dtype=jnp.float32)
