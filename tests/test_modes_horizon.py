"""BASELINE config 3 pinning tests: 120-mode (radial order 14) build path
and long-horizon (N >= CR_MIN_HORIZON) closed loop.

The reference's mode count and horizon are free constructor arguments it
never scales (Fast_MPC/VAR_2/Fast_MPC2.m:28-55, README.md:38); the
framework must build and close the loop at radial order 14 (120 modes,
119 non-piston states) and at horizons long enough to engage the
O(log T) cyclic-reduction Newton-KKT path (ops/newton_kkt.py
CR_MIN_HORIZON).  Chip-scale quality/throughput cells come from
benchmarks/modes_horizon.py; these tests pin the build and solve paths
in the default suite.
"""

import dataclasses

import numpy as np
import jax
import pytest

from mpc_sensorlessao_tpu.models import pipeline
from mpc_sensorlessao_tpu.ops import newton_kkt
from mpc_sensorlessao_tpu.utils.config import reference_config


def _tuned(cfg, order):
    """The strong-mode recipe (benchmarks/protocol_sweep.py tuned rows)."""
    return cfg.replace(
        zernike=dataclasses.replace(cfg.zernike, radial_order=order),
        mpc=dataclasses.replace(cfg.mpc, var_ridge=1e-2, warm_start=True,
                                r_weight=30.0),
        estimator=dataclasses.replace(cfg.estimator, method="mmse",
                                      prior_scale=0.1),
    )


def test_order14_build_and_lock():
    """Radial order 14 -> 120 modes -> 119 non-piston states; the whole
    stack (basis, A_s regeneration, MMSE prior, VAR fit, DM projection)
    builds and the loop locks at D/r0=5 (R=128: order-14 estimator
    columns alias below ~128 px, CLAUDE.md)."""
    cfg = reference_config(resolution=128)
    cfg = _tuned(cfg, 14)
    cfg = cfg.replace(sim=dataclasses.replace(
        cfg.sim, n_train=300, n_valid=50, n_test=10))
    system = pipeline.build(cfg, jax.random.PRNGKey(0))
    assert system.est.A_s.shape == (2883, 119)
    assert system.dm_model.influence.shape == (119, 144)
    assert system.basis.stack.shape[0] == 120
    out = pipeline.run_closed_loop(system, cfg, jax.random.PRNGKey(1))
    rms = np.asarray(out.rms_res)
    assert np.isfinite(rms).all()
    # locked: settled residual well under the ~0.5 rad turbulence
    assert rms[-3:].mean() < 0.25
    assert np.asarray(out.strehl_exact)[-3:].mean() > 0.9


def test_long_horizon_closed_loop_engages_cyclic_reduction():
    """N=32 >= CR_MIN_HORIZON with newton_steps=2 routes the in-loop
    solve through the general Newton-KKT path, whose Schur solve uses
    block cyclic reduction at this horizon (newton_kkt.newton_direction);
    the loop must stay locked."""
    assert 32 >= newton_kkt.CR_MIN_HORIZON
    cfg = reference_config(resolution=64)
    cfg = cfg.replace(
        mpc=dataclasses.replace(cfg.mpc, horizon=32, newton_steps=2),
        sim=dataclasses.replace(cfg.sim, n_train=300, n_valid=50,
                                n_test=6))
    system = pipeline.build(cfg, jax.random.PRNGKey(0))
    out = pipeline.run_closed_loop(system, cfg, jax.random.PRNGKey(1))
    rms = np.asarray(out.rms_res)
    assert np.isfinite(rms).all()
    assert rms[-1] < np.asarray(out.rms_turb)[-1]  # rejecting turbulence


def test_long_horizon_fixed_operator_matches_general():
    """The N=32 constant-slack fixed operator (the newton_steps=1
    real-time path) agrees with the general n_newton=1 solve at the
    same operating point (symmetric box, midpoint init)."""
    cfg = reference_config(resolution=64)
    cfg = cfg.replace(
        mpc=dataclasses.replace(cfg.mpc, horizon=32),
        sim=dataclasses.replace(cfg.sim, n_train=300, n_valid=50,
                                n_test=4))
    system = pipeline.build(cfg, jax.random.PRNGKey(0))
    prob = system.loop.prob
    rng = np.random.default_rng(3)
    nx = prob.A1.shape[0]
    x0 = rng.normal(size=(nx,)).astype(np.float32) * 0.3
    xp = rng.normal(size=(nx,)).astype(np.float32) * 0.3
    w = np.zeros((32 * nx,), dtype=np.float32)
    st_fixed = newton_kkt.solve_fixed(prob, system.loop.fixed_op,
                                      x0, xp, w, horizon=32)
    st_gen = newton_kkt.solve(prob, x0, xp, w, horizon=32, n_newton=1)
    np.testing.assert_allclose(np.asarray(st_fixed.U),
                               np.asarray(st_gen.U), atol=2e-3)
