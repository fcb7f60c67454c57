"""Sharded Monte-Carlo closed-loop rollouts.

Implements BASELINE configs 4-5: thousands of parallel frozen-flow
scenarios (varying turbulence window, D/r0, SNR, noise realization) with
per-chip `vmap` batches, the scenario axis sharded over the device mesh via
`shard_map`, and Strehl/RMS statistics reduced with `psum`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

shard_map = jax.shard_map

from ..models import closed_loop
from ..utils.config import SystemConfig, mag_conv
from .mesh import SCENARIO_AXIS


class ScenarioBatch(NamedTuple):
    """Per-scenario traced parameters (leading axis = scenario).

    start_step:  window offset into the periodic frozen-flow screens
                 (decorrelated turbulence per scenario);
    mag:         turbulence magnification (D/r0 sweep, README.md:277-284);
    noise_scale: multiplier on the SNR-defined noise std (SNR sweep);
    key:         per-scenario noise PRNG key.
    """

    start_step: jnp.ndarray
    mag: jnp.ndarray
    noise_scale: jnp.ndarray
    key: jnp.ndarray


class MonteCarloStats(NamedTuple):
    """psum-reduced aggregate statistics over all scenarios.

    Divergence containment (utils/guards.py's in-loop counterpart): a
    scenario whose settled telemetry is non-finite or whose residual
    exceeds ``DIVERGED_REJECTION_FLOOR`` x its own turbulence is counted
    in ``n_diverged`` and EXCLUDED from the means -- one blown-up
    scenario cannot poison a whole shard's psum the way a raw NaN mean
    would."""

    mean_rms_res: jnp.ndarray     # settled mean residual RMS [rad]
    mean_rms_turb: jnp.ndarray
    mean_strehl: jnp.ndarray      # Marechal
    mean_strehl_exact: jnp.ndarray  # OTF-volume (imager.m:115)
    max_rms_res: jnp.ndarray
    mean_cost: jnp.ndarray
    n_scenarios: jnp.ndarray
    n_diverged: jnp.ndarray = None


# a "settled" loop whose residual exceeds this multiple of the raw
# turbulence is injecting aberration, not correcting it
DIVERGED_REJECTION_FLOOR = 10.0


def make_scenarios(
    cfg: SystemConfig,
    key,
    n_scenarios: int,
    d_over_r0_grid=(5.0,),
    snr_db_grid=(10.0,),
    start_range=None,
) -> ScenarioBatch:
    """Sample a scenario batch over (noise, D/r0, SNR[, window]) axes.

    By default every scenario cold-starts at the test-split step like the
    reference loop (README.md:429-444) -- a cold start inside a strong
    turbulence patch is outside the phase-diversity estimator's capture
    range (physics, not implementation), so window sweeps are opt-in via
    ``start_range=(lo, hi)``.
    """
    k1, k2, k3, k4 = jax.random.split(key, 4)
    if start_range is None:
        s0 = cfg.sim.n_train + cfg.sim.n_valid
        start = jnp.full((n_scenarios,), float(s0), dtype=jnp.float32)
    else:
        start = jax.random.randint(
            k1, (n_scenarios,), start_range[0],
            max(start_range[1], start_range[0] + 1)).astype(jnp.float32)
    mags = jnp.asarray([mag_conv(d) for d in d_over_r0_grid],
                       dtype=jnp.float32)
    mag = mags[jax.random.randint(k2, (n_scenarios,), 0, len(mags))]
    # noise_scale = 10^((SNR_cfg - SNR_scenario)/20)
    scales = jnp.asarray(
        [10.0 ** ((cfg.estimator.snr_db - s) / 20.0) for s in snr_db_grid],
        dtype=jnp.float32)
    noise_scale = scales[jax.random.randint(k3, (n_scenarios,), 0,
                                            len(scales))]
    keys = jax.random.split(k4, n_scenarios)
    return ScenarioBatch(start_step=start, mag=mag,
                         noise_scale=noise_scale, key=keys)


def _settled_slice(n_steps: int) -> int:
    return max(n_steps // 2, 1)


def assert_shared_window(scen: ScenarioBatch) -> None:
    """Concrete-value check that every scenario shares one turbulence
    window.  Call OUTSIDE jit, then pass ``shared_window="verified"`` to
    run_batch (inside jit the starts are tracers and cannot be checked).

    Multi-process global arrays span non-addressable devices and cannot
    be materialized with np.asarray; only this process's addressable
    shards are checked there (sufficient in practice: the deterministic
    per-process scenario builds agree, and every process runs the same
    check on its own shard)."""
    x = scen.start_step
    if (isinstance(x, jax.Array) and not isinstance(x, jax.core.Tracer)
            and not x.is_fully_addressable):
        starts = np.concatenate(
            [np.asarray(s.data).ravel() for s in x.addressable_shards])
    else:
        starts = np.asarray(x)
    if not (starts == starts.flat[0]).all():
        raise ValueError(
            "scenarios have distinct start_steps; use the batched path")


def run_batch(models, layers, cfg: SystemConfig, scen: ScenarioBatch,
              n_steps: int, solver: str | None = None,
              shared_window: bool | str = False,
              edge_model=None, edge_state=None,
              shared_turbulence: bool | str = False,
              turb_key=None,
              init_u=None) -> closed_loop.StepOutputs:
    """vmap the closed loop over the scenario axis (single device).

    ``shared_window=True`` asserts every scenario uses the SAME
    turbulence window (the make_scenarios default, start_range=None):
    the frozen-flow evolution is then traced UNBATCHED inside the scan
    and broadcast across scenarios -- the batched window gather is the
    single most expensive stage of the step (~9 us/scenario of the
    ~13 us R=128 step, measured), and it is pure waste when the offsets
    are identical.  Trajectories are bit-identical to the batched path.
    When calling from inside jit (starts are tracers and cannot be
    value-checked), run ``assert_shared_window(scen)`` on the concrete
    batch first and pass ``shared_window="verified"``.

    ``edge_model``/``edge_state`` switch turbulence to the conditional-
    Gaussian frozen flow (reference-parity, ops/edge_flow.py).  Two
    Monte-Carlo modes:

    * ``shared_turbulence=True`` -- ONE turbulence realization shared by
      every scenario (the edge-flow analogue of ``shared_window``): the
      stateful evolution traces unbatched under vmap and is amortized
      over the batch.  Requires a shared start step (same check /
      "verified" escape hatch as ``shared_window``).  ``turb_key``
      selects the realization (default: folded from cfg.sim.seed).
    * default -- per-scenario turbulence: each scenario folds its own
      turbulence stream from ``scen.key``; pass an ``edge_state`` with a
      leading scenario axis (L->B,L,n,n) for per-scenario initial
      screens (ops/edge_flow.batch_states), or an unbatched one to
      share the initial condition and let the border redraw decorrelate.

    ``init_u`` (optional, (nu,) or (B, nu)) is the warm-start command
    (MPCConfig.warm_start; pipeline.warm_start_command).
    """
    if edge_model is not None:
        import jax.random as jrandom

        init_axis = (None if init_u is None or init_u.ndim == 1 else 0)
        if shared_turbulence:
            s0 = scen.start_step[0]
            try:
                assert_shared_window(scen)
            except jax.errors.TracerArrayConversionError:
                if shared_turbulence != "verified":
                    raise ValueError(
                        "run_batch(shared_turbulence=True) with traced "
                        "start_steps: check the concrete batch with "
                        "assert_shared_window() and pass "
                        "shared_turbulence='verified'.") from None
            if turb_key is None:
                turb_key = jrandom.fold_in(
                    jrandom.PRNGKey(int(cfg.sim.seed)), 0x7e5)
            if edge_state.phases.ndim != 3:
                raise ValueError(
                    "shared_turbulence needs ONE unbatched edge_state")

            def one_edge_shared(key, mag, noise_scale, iu):
                return closed_loop.simulate(
                    models, layers, cfg, key, n_steps=n_steps,
                    start_step=s0, solver=solver, mag=mag,
                    noise_scale=noise_scale, edge_model=edge_model,
                    edge_state=edge_state, turb_key=turb_key, init_u=iu)

            return jax.vmap(one_edge_shared,
                            in_axes=(0, 0, 0, init_axis))(
                scen.key, scen.mag, scen.noise_scale, init_u)

        state_axis = 0 if edge_state.phases.ndim == 4 else None

        def one_edge(s: ScenarioBatch, est, iu):
            return closed_loop.simulate(
                models, layers, cfg, s.key, n_steps=n_steps,
                start_step=s.start_step, solver=solver, mag=s.mag,
                noise_scale=s.noise_scale, edge_model=edge_model,
                edge_state=est, init_u=iu)

        return jax.vmap(one_edge, in_axes=(0, state_axis, init_axis))(
            scen, edge_state, init_u)

    if shared_window:
        s0 = scen.start_step[0]
        try:  # guard: silently replaying one window as N would corrupt
            # the statistics
            assert_shared_window(scen)
        except jax.errors.TracerArrayConversionError:
            # traced start_steps can't be value-checked at trace time --
            # a silent fall-through would replay start_step[0] for every
            # scenario and quietly corrupt the statistics, so REFUSE:
            # the caller has an explicit escape hatch (check the concrete
            # batch with assert_shared_window, pass "verified")
            if shared_window != "verified":
                raise ValueError(
                    "run_batch(shared_window=True) called with traced "
                    "start_steps: the identical-window invariant cannot "
                    "be verified at trace time and every scenario would "
                    "replay start_step[0].  Check the concrete batch "
                    "with assert_shared_window() and pass "
                    "shared_window='verified'.") from None

        def one_shared(key, mag, noise_scale):
            return closed_loop.simulate(
                models, layers, cfg, key, n_steps=n_steps,
                start_step=s0, solver=solver, mag=mag,
                noise_scale=noise_scale)

        return jax.vmap(one_shared)(scen.key, scen.mag, scen.noise_scale)

    def one(s: ScenarioBatch):
        return closed_loop.simulate(
            models, layers, cfg, s.key, n_steps=n_steps,
            start_step=s.start_step, solver=solver, mag=s.mag,
            noise_scale=s.noise_scale)

    return jax.vmap(one)(scen)


def make_sharded_runner(models, layers, cfg: SystemConfig, n_steps: int,
                        mesh, solver: str | None = None,
                        shared_window: bool | str = False,
                        edge_model=None, edge_state=None,
                        shared_turbulence: bool | str = False,
                        turb_key=None):
    """Build the shard_map Monte-Carlo program ONCE; returns a callable
    ``scen -> MonteCarloStats`` reusable across scenario batches of the
    same shape -- repeated sweeps (throughput timing, chunked
    populations) pay tracing/compilation a single time.
    ``run_sharded`` is the one-shot convenience wrapper.

    ``edge_model``/``edge_state`` run the conditional-Gaussian
    reference-parity flow on every shard (replicated operators;
    ``shared_turbulence=True`` shares ONE realization across the whole
    global batch -- each shard traces the evolution unbatched)."""
    settle = _settled_slice(n_steps)
    # shared_window=True: each concrete batch is verified in run();
    # inside the traced program the starts are tracers, so the traced
    # path is built with the "verified" escape hatch
    verify_each = (shared_window is True
                   or (edge_model is not None
                       and shared_turbulence is True))
    sw_traced = "verified" if shared_window else False
    st_traced = "verified" if shared_turbulence else False
    if (edge_model is not None and shared_turbulence
            and turb_key is None):
        turb_key = jax.random.fold_in(
            jax.random.PRNGKey(int(cfg.sim.seed)), 0x7e5)

    def local(models, layers, edge_tree,
              scen_shard: ScenarioBatch) -> MonteCarloStats:
        em, es, tk = edge_tree
        out = run_batch(models, layers, cfg, scen_shard, n_steps, solver,
                        shared_window=sw_traced,
                        edge_model=em, edge_state=es,
                        shared_turbulence=st_traced, turb_key=tk)
        res = out.rms_res[:, settle:]
        turb = out.rms_turb[:, settle:]
        strehl = out.strehl[:, settle:]
        strehl_x = out.strehl_exact[:, settle:]
        cost = out.cost[:, settle:]
        res_m = jnp.mean(res, axis=1)
        turb_m = jnp.mean(turb, axis=1)
        # per-scenario divergence containment (see MonteCarloStats)
        finite = jnp.isfinite(res_m) & jnp.isfinite(turb_m)
        ok = finite & (jnp.nan_to_num(res_m, nan=jnp.inf)
                       <= DIVERGED_REJECTION_FLOOR
                       * jnp.nan_to_num(turb_m, nan=0.0))
        okf = ok.astype(jnp.float32)

        def safe_sum(x_m):
            return jax.lax.psum(
                jnp.sum(jnp.where(ok, jnp.nan_to_num(x_m), 0.0)),
                SCENARIO_AXIS)

        stats = MonteCarloStats(
            mean_rms_res=safe_sum(res_m),
            mean_rms_turb=safe_sum(turb_m),
            mean_strehl=safe_sum(jnp.mean(strehl, axis=1)),
            mean_strehl_exact=safe_sum(jnp.mean(strehl_x, axis=1)),
            # max over INSTANTANEOUS settled residuals of non-diverged
            # scenarios (the worst-case excursion indicator)
            max_rms_res=jax.lax.pmax(
                jnp.max(jnp.where(ok[:, None], jnp.nan_to_num(res), 0.0)),
                SCENARIO_AXIS),
            mean_cost=safe_sum(jnp.mean(cost, axis=1)),
            n_scenarios=jax.lax.psum(jnp.sum(okf), SCENARIO_AXIS),
            n_diverged=jax.lax.psum(jnp.sum(1.0 - okf), SCENARIO_AXIS),
        )
        return stats

    if (edge_state is not None
            and getattr(edge_state, "phases", None) is not None
            and edge_state.phases.ndim == 4):
        raise ValueError(
            "sharded runner supports a replicated (unbatched) edge_state "
            "only; shard per-scenario initial screens with run_batch per "
            "shard instead")

    sharded = shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), P(SCENARIO_AXIS)),
        out_specs=P(),
        check_vma=False,
    )
    # place inputs explicitly (setup-time arrays may be committed to a
    # single device by the host-compute path).  Under jax.distributed
    # (process_count > 1) device_put cannot move committed local arrays
    # onto a global sharding; replicated inputs are assembled from the
    # identical per-process copies instead (the deterministic build
    # guarantees they agree), and scenario batches must arrive already
    # global (multihost.global_scenarios).
    from jax.sharding import NamedSharding

    multiproc = jax.process_count() > 1

    def _place(tree, spec):
        sh = NamedSharding(mesh, spec)

        def put(x):
            if (isinstance(x, jax.Array) and hasattr(x, "sharding")
                    and x.sharding.is_equivalent_to(sh, x.ndim)):
                return x
            if multiproc:
                if spec != P():
                    raise ValueError(
                        "multi-process run_sharded needs the scenario "
                        "batch pre-assembled as a global array; build "
                        "it with parallel.multihost.global_scenarios")
                arr = np.asarray(x)
                return jax.make_array_from_process_local_data(
                    sh, arr, arr.shape)
            return jax.device_put(x, sh)

        return jax.tree.map(put, tree)

    jitted = jax.jit(sharded)
    models_p = _place(models, P())
    layers_p = _place(layers, P())
    edge_p = _place((edge_model, edge_state, turb_key), P())
    n_dev = mesh.devices.size

    def run(scen: ScenarioBatch) -> MonteCarloStats:
        if verify_each:
            try:
                assert_shared_window(scen)
            except jax.errors.TracerArrayConversionError:
                raise ValueError(
                    "sharded runner built with shared_window=True got a "
                    "traced scenario batch; verify the concrete batch "
                    "with assert_shared_window() and build the runner "
                    "with shared_window='verified'.") from None
        n = scen.start_step.shape[0]
        assert n % n_dev == 0, (n, n_dev)
        scen_p = _place(scen, P(SCENARIO_AXIS))
        stats = jitted(models_p, layers_p, edge_p, scen_p)
        n_f = jnp.maximum(stats.n_scenarios, 1.0)
        return MonteCarloStats(
            mean_rms_res=stats.mean_rms_res / n_f,
            mean_rms_turb=stats.mean_rms_turb / n_f,
            mean_strehl=stats.mean_strehl / n_f,
            mean_strehl_exact=stats.mean_strehl_exact / n_f,
            max_rms_res=stats.max_rms_res,
            mean_cost=stats.mean_cost / n_f,
            n_scenarios=stats.n_scenarios,
            n_diverged=stats.n_diverged,
        )

    return run


def run_sharded(models, layers, cfg: SystemConfig, scen: ScenarioBatch,
                n_steps: int, mesh, solver: str | None = None,
                shared_window: bool | str = False) -> MonteCarloStats:
    """shard_map over the mesh scenario axis; psum-reduced statistics.

    Scenario count must be a multiple of the mesh size
    (mesh.pad_to_devices).  Models/layers are replicated (broadcast once),
    per-scenario parameters sharded; only O(1) statistics cross chips.
    One-shot wrapper over ``make_sharded_runner`` (use the runner
    directly to amortize tracing/compilation across repeated batches).
    """
    return make_sharded_runner(models, layers, cfg, n_steps, mesh,
                               solver, shared_window)(scen)
