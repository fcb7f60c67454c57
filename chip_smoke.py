"""Smoke test of the closed-loop AO/MPC main path on NVIDIA GPUs.

    python chip_smoke.py               # one card: phases 1-5 + gpu tests
    python chip_smoke.py --four-cards  # four cards: run_sharded only

One process drives every card it uses.  Each phase goes through the
entry points a user calls (pipeline.build, closed_loop.simulate /
pipeline.run_closed_loop, montecarlo.run_batch / run_sharded) at the
reference widths, checks its result and prints its numbers with the
card's name and power limit.  Any failed check raises, and the script
exits nonzero without printing a result line.  On success the last line
of stdout is one JSON object naming the devices.

One card:
  1. the estimator's measure (the path the loop selects) at R=512/B=256
     and R=128/B=4096 against the float64 NumPy full-FFT crop;
  2. R=512, 50-step trajectory against the float64 NumPy oracle
     (tests/oracle_numpy.py): rtol 1% on residual RMS, 1% of max|u| on u;
  3. the reference protocol at B=1, R=512 (1000 train / 500 test steps,
     after 500 and after 50 validation steps): settled Strehl > 0.9,
     rejection > 3 on the flagship window;
  4. batched Monte-Carlo (run_batch) at R=128/B=4096 and R=512/B=256,
     with the fused measure kernel and, in turns, without it;
  5. conditional (reference-parity) flow at R=128, B=1, plus advance()
     timings of both size-dispatch sides at R=128 and R=512;
  then the tests marked ``gpu`` (compiled kernels on the card).
Four cards: run_sharded over a 1-D mesh of 4 GPUs at R=128, B=4x1024,
against the same scenarios through run_batch on one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

CARD = ""   # "name, power limit" from nvidia-smi, set in main()


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def report(phase: str, **numbers) -> None:
    """One line per measurement, always tagged with the card."""
    items = " ".join(f"{k}={v}" for k, v in numbers.items())
    print(f"[{phase}] {items} [card: {CARD}]", flush=True)


def timed(fn, *args, repeats: int = 3):
    """(first-call seconds incl. compile, best steady seconds, output)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return first, best, out


def peak_gb() -> float:
    """Peak device memory of this process so far [GB]."""
    return jax.devices()[0].memory_stats()["peak_bytes_in_use"] / 1e9


def program_gb(compiled) -> float:
    """Arguments + outputs + temporaries of one compiled program [GB]."""
    m = compiled.memory_analysis()
    return (m.argument_size_in_bytes + m.output_size_in_bytes
            + m.temp_size_in_bytes) / 1e9


def config(resolution: int, n_train=300, n_valid=50, n_test=50, **est):
    from mpc_sensorlessao_tpu.utils.config import reference_config
    cfg = reference_config(resolution=resolution)
    return cfg.replace(
        sim=dataclasses.replace(cfg.sim, n_train=n_train, n_valid=n_valid,
                                n_test=n_test),
        estimator=dataclasses.replace(cfg.estimator, **est))


def build(cfg, label: str):
    from mpc_sensorlessao_tpu.models import pipeline
    t0 = time.perf_counter()
    system = pipeline.build(cfg, jax.random.PRNGKey(0))
    jax.block_until_ready(system.loop.est.A_s)
    s = time.perf_counter() - t0
    report("build", system=label, build_s=s)
    return system, s


# ---------------------------------------------------------------- phase 1

def measure_float64(phase, pupil, diversity_phases, crop_half, scale):
    """Full FFT2 + crop in float64 NumPy (ops.psf.diversity_measurements'
    reference recipe, independent of the code under test)."""
    ph = np.asarray(phase, np.float64)[:, None] + np.asarray(
        diversity_phases, np.float64)
    field = np.asarray(pupil, np.float64) * np.exp(1j * ph)
    F = np.fft.fftshift(np.fft.fft2(np.fft.fftshift(field, axes=(-2, -1))),
                        axes=(-2, -1))
    c = ph.shape[-1] // 2
    crop = (np.abs(F) ** 2)[..., c - crop_half:c + crop_half + 1,
                            c - crop_half:c + crop_half + 1] * scale
    return np.swapaxes(crop, -1, -2).reshape(ph.shape[0], -1)


def phase_measure(R: int, B: int, n_ref: int = 64, tol: float = 1e-4):
    """The loop's measure path vs the float64 full-FFT crop.  ``tol`` is
    on max error / max|b_s|; the SNR-10 dB noise floor is printed beside
    it (0.316 mean|b_s|, ~4e-4 max|b_s| at the reference widths)."""
    from mpc_sensorlessao_tpu.models import estimator
    from mpc_sensorlessao_tpu.ops import dft, psf, psf_kernel, zernike
    from mpc_sensorlessao_tpu.utils.config import EstimatorConfig

    basis = zernike.make_basis(6, R)
    est = estimator.build(EstimatorConfig(resolution=R), basis)
    rng = np.random.default_rng(R)
    x = jnp.asarray(rng.normal(size=(B, basis.n_modes - 1)) * 0.3,
                    jnp.float32)
    phase = jax.block_until_ready(
        estimator.mode_phase(x, basis.stack[1:]))
    measure = jax.jit(lambda p: estimator.measure(est, p))
    first, best, y = timed(measure, phase)
    y = np.asarray(y, np.float64)
    check(y.shape == (B, est.n_pixels) and np.isfinite(y).all(),
          f"measure R={R}: shape {y.shape} or non-finite")
    n = min(n_ref, B)
    y64 = measure_float64(phase[:n], est.pupil, est.diversity_phases,
                          est.crop_half, est.scale)
    b = np.abs(np.asarray(est.b_s, np.float64))
    err = float(np.abs(y[:n] - y64).max() / b.max())
    floor = float(0.316 * b.mean() / b.max())
    report("1 measure", R=R, B=B, precision=psf.MEASURE_PRECISION.name,
           kernel=psf.uses_kernel(B, R), compared=n,
           max_err_over_max_bs=err, tolerance=tol,
           noise_floor_over_max_bs=floor, first_call_s=first,
           ms_per_call=best * 1e3, us_per_scenario=best * 1e6 / B)
    check(err < tol, f"measure R={R}: error {err} >= {tol}")
    if psf.uses_kernel(B, R):
        # the compiled kernel against the plain jnp first stage
        a2 = dft.packed_operator(est.dft_op)
        args = (phase, est.pupil, est.pcd, est.psd, a2)
        rows_k = jax.jit(psf_kernel.thin_rows)(*args)
        rows_p = jax.jit(lambda *a: psf.thin_rows_reference(
            *a, precision=jax.lax.Precision.HIGHEST))(*args)
        rel = float(jnp.max(jnp.abs(rows_k - rows_p))
                    / jnp.max(jnp.abs(rows_p)))
        report("1 kernel", R=R, B=B, max_rel_err_vs_plain=rel,
               tolerance=1e-3)
        check(rel < 1e-3, f"kernel R={R}: {rel} vs plain rows")


# ---------------------------------------------------------------- phase 2

def phase_parity(R: int = 512, n_steps: int = 50):
    """Golden trajectory vs the float64 NumPy oracle (the logic of
    tests/test_golden_trajectory.py::test_reference_scale_trajectory_
    parity).  Returns the built system for phase 4."""
    import oracle_numpy
    import test_golden_trajectory as golden
    from mpc_sensorlessao_tpu.models import closed_loop

    cfg = config(R, n_test=n_steps)
    system, _ = build(cfg, f"parity R={R}")
    params = golden._oracle_params(cfg, system, "fastmpc")
    t0 = time.perf_counter()
    u_ref, rms_ref = oracle_numpy.closed_loop(
        params, n_steps, np.zeros((n_steps, system.loop.est.n_pixels)),
        solver="fastmpc", cold_start=cfg.mpc.cold_start,
        gauss_newton_iters=cfg.estimator.gauss_newton_iters)
    oracle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = closed_loop.simulate(
        system.loop, system.layers, cfg, jax.random.PRNGKey(9),
        n_steps=n_steps, start_step=float(cfg.sim.n_train + cfg.sim.n_valid),
        solver="fastmpc", noise_scale=0.0)
    rms = np.asarray(jax.block_until_ready(out.rms_res), np.float64)
    sim_s = time.perf_counter() - t0
    u = np.asarray(out.u, np.float64)
    rms_rel = float(np.max(np.abs(rms - rms_ref) / np.abs(rms_ref)))
    u_err = float(np.abs(u - u_ref).max() / np.abs(u_ref).max())
    report("2 parity", R=R, steps=n_steps, max_rel_err_rms_res=rms_rel,
           rms_tolerance=0.01, max_err_u_over_max_u=u_err, u_tolerance=0.01,
           oracle_s=oracle_s, simulate_first_call_s=sim_s)
    np.testing.assert_allclose(rms, rms_ref, rtol=0.01, atol=1e-4)
    np.testing.assert_allclose(u, u_ref, atol=0.01 * np.abs(u_ref).max())
    return cfg, system


# ---------------------------------------------------------------- phase 3

def phase_protocol(R: int = 512):
    """The reference protocol at B=1 (1000 train steps, 500 test steps),
    on two test windows of the same seeded turbulence: after the
    reference's 500 validation steps, and after 50
    (benchmarks/protocol_sweep.py's flagship protocol, on whose window
    the rejection bar of 3 was set).  Strehl > 0.9 on both; rejection
    (turbulence RMS / residual RMS, settled half) > 3 on the second.
    Rejection depends on the window's turbulence strength, the residual
    on the loop: both are printed for both windows."""
    from mpc_sensorlessao_tpu.models import pipeline
    from mpc_sensorlessao_tpu.utils import metrics

    for n_valid in (500, 50):
        cfg = config(R, n_train=1000, n_valid=n_valid, n_test=500)
        system, build_s = build(cfg, f"protocol R={R} n_valid={n_valid}")
        run = jax.jit(lambda k: pipeline.run_closed_loop(system, cfg, k))
        key = jax.random.PRNGKey(1)
        first, best, out = timed(run, key)
        s = metrics.to_dict(metrics.summarize(out))
        n = cfg.sim.n_test
        report("3 protocol", R=R, B=1, n_valid=n_valid, steps=n,
               build_s=build_s, compile_s=first - best,
               ms_per_step=best * 1e3 / n, strehl=s["mean_strehl_exact"],
               strehl_marechal=s["mean_strehl"], rejection=s["rejection"],
               rms_res=s["mean_rms_res"], rms_turb=s["mean_rms_turb"],
               program_gb=program_gb(run.lower(key).compile()),
               peak_gb_so_far=peak_gb())
        check(np.isfinite(np.asarray(out.u)).all(), "protocol: non-finite u")
        check(s["mean_strehl_exact"] > 0.9,
              f"protocol n_valid={n_valid}: Strehl "
              f"{s['mean_strehl_exact']} <= 0.9")
    check(s["rejection"] > 3.0,
          f"protocol n_valid=50: rejection {s['rejection']} <= 3")


# ---------------------------------------------------------------- phase 4

def alternate(runs: dict, arg, rounds: int = 2) -> dict:
    """Best steady seconds per compiled run, taken in turns (a, b, b, a,
    ...) so that a drift of the card's clock hits both alike."""
    best = {k: float("inf") for k in runs}
    order = list(runs)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            jax.block_until_ready(runs[k](arg))
            best[k] = min(best[k], time.perf_counter() - t0)
    return best


def phase_batched(cfg, system, B: int, steps: int = 25):
    """run_batch over B scenarios sharing one turbulence window (the
    bench.py cell: gn=0, D/r0=5, SNR 10 dB).  The loop as it selects its
    measure (the fused kernel at these batches), then the same loop with
    the kernel held off, timed in turns."""
    from unittest import mock

    from mpc_sensorlessao_tpu.ops import psf
    from mpc_sensorlessao_tpu.parallel import montecarlo

    cfg = cfg.replace(estimator=dataclasses.replace(
        cfg.estimator, gauss_newton_iters=0))
    scen = montecarlo.make_scenarios(cfg, jax.random.PRNGKey(1), B)
    montecarlo.assert_shared_window(scen)

    def compiled():
        """AOT-compiled loop and whether it holds the fused kernel."""
        t0 = time.perf_counter()
        lowered = jax.jit(lambda s: montecarlo.run_batch(
            system.loop, system.layers, cfg, s, n_steps=steps,
            shared_window="verified")).lower(scen)
        run = lowered.compile()
        return run, time.perf_counter() - t0, (
            "psf_thin_rows" in lowered.as_text())

    run, compile_s, has_kernel = compiled()
    with mock.patch.object(psf, "KERNEL_MIN_PROGRAMS", sys.maxsize):
        jax.clear_caches()         # retrace: the inner jits cached the kernel
        run_plain, _, plain_has_kernel = compiled()
    jax.clear_caches()             # and later traces take the kernel again
    check(has_kernel == psf.uses_kernel(B, cfg.resolution)
          and not plain_has_kernel,
          f"batched R={cfg.resolution}: kernel in the loop {has_kernel}, "
          f"in the plain loop {plain_has_kernel}")
    best = alternate({"kernel": run, "plain": run_plain}, scen)
    out, out_plain = run(scen), run_plain(scen)
    res = np.asarray(out.rms_res)
    strehl = float(np.mean(np.asarray(out.strehl_exact)[:, steps // 2:]))
    strehl_plain = float(np.mean(
        np.asarray(out_plain.strehl_exact)[:, steps // 2:]))
    report("4 batched", R=cfg.resolution, B=B, steps=steps,
           kernel=has_kernel, compile_s=compile_s,
           ms_per_step=best["kernel"] * 1e3 / steps,
           control_steps_per_s=B * steps / best["kernel"],
           plain_measure_ms_per_step=best["plain"] * 1e3 / steps,
           strehl=strehl, strehl_plain_measure=strehl_plain,
           program_gb=program_gb(run), peak_gb_so_far=peak_gb())
    check(np.isfinite(res).all() and np.isfinite(np.asarray(out.u)).all(),
          f"batched R={cfg.resolution}: non-finite output")
    check(strehl > 0.9, f"batched R={cfg.resolution}: Strehl {strehl}")
    check(abs(strehl - strehl_plain) < 1e-3,
          f"batched R={cfg.resolution}: kernel Strehl {strehl} vs plain "
          f"{strehl_plain}")


# ---------------------------------------------------------------- phase 5

def time_advance(model, state, steps: int = 20):
    """Seconds per edge_flow.advance() inside a scan (steady state)."""
    from mpc_sensorlessao_tpu.ops import edge_flow
    key = jax.random.PRNGKey(0)

    @jax.jit
    def run(st):
        def body(st, idx):
            st, ph = edge_flow.advance(model, st, idx, key)
            return st, ph[0, 0]
        return jax.lax.scan(body, st, jnp.arange(steps))

    _, best, (_, out) = timed(run, state)
    check(np.isfinite(np.asarray(out)).all(), "advance: non-finite")
    return best / steps


def phase_conditional(R: int = 128, steps: int = 20,
                      advance_sizes=(128, 512)):
    """Reference-parity conditional flow through pipeline.build /
    run_closed_loop, then advance() on both sides of the size dispatch
    (vectorized+switch, chosen at R<=256; per_layer+where above)."""
    from mpc_sensorlessao_tpu.models import pipeline
    from mpc_sensorlessao_tpu.ops import edge_flow

    cfg = config(R, n_test=steps)
    cfg = cfg.replace(atmosphere=dataclasses.replace(
        cfg.atmosphere, flow="conditional"))
    system, _ = build(cfg, f"conditional R={R}")
    run = jax.jit(lambda k: pipeline.run_closed_loop(system, cfg, k))
    first, best, out = timed(run, jax.random.PRNGKey(1))
    res, turb = np.asarray(out.rms_res), np.asarray(out.rms_turb)
    settled = slice(steps // 2, None)
    report("5 conditional", R=R, B=1, steps=steps, compile_s=first - best,
           ms_per_step=best * 1e3 / steps,
           rms_res=float(res[settled].mean()),
           rms_turb=float(turb[settled].mean()))
    check(np.isfinite(res).all(), "conditional: non-finite residual")
    check(res[settled].mean() < 0.5 * turb[settled].mean(),
          "conditional: loop does not reject")
    for n in advance_sizes:
        c = config(n)
        t0 = time.perf_counter()
        model, state = edge_flow.build(0, c.atmosphere, c.telescope)
        build_s = time.perf_counter() - t0
        times = {}
        for impl, select in (("vectorized", "switch"),
                             ("per_layer", "where")):
            times[f"{impl}+{select}_ms"] = 1e3 * time_advance(
                model.replace(impl=impl, shift_select=select), state)
        report("5 advance", R=n, dispatch_picks=f"{model.impl}+"
               f"{model.shift_select}", operator_build_s=build_s, **times)


# ------------------------------------------------------------- gpu tests

def phase_gpu_tests():
    """The tests marked ``gpu``, in this process (one process per card)."""
    import pytest

    class Count:
        passed = 0
        skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Count.passed += 1
            if report.skipped:
                Count.skipped += 1

    # only the files that hold such tests: the others may import
    # packages this machine need not have
    tests = os.path.join(ROOT, "tests")
    files = []
    for name in sorted(os.listdir(tests)):
        if name.startswith("test_") and name.endswith(".py"):
            with open(os.path.join(tests, name)) as f:
                if "mark.gpu" in f.read():
                    files.append(os.path.join(tests, name))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", *files],
                     plugins=[Count()])
    report("gpu tests", passed=Count.passed, skipped=Count.skipped,
           exit_code=int(rc))
    check(rc == 0 and Count.passed > 0 and Count.skipped == 0,
          "gpu-marked tests failed or did not run")


# ------------------------------------------------------------ four cards

def phase_four_cards(R: int = 128, per_card: int = 1024, steps: int = 25):
    """run_sharded over 4 GPUs vs run_batch of the same scenarios on one."""
    from mpc_sensorlessao_tpu.parallel import mesh as mesh_lib
    from mpc_sensorlessao_tpu.parallel import montecarlo

    n_dev = len(jax.devices())
    check(n_dev == 4, f"--four-cards needs 4 GPUs, found {n_dev}")
    cfg = config(R, n_test=steps)
    system, _ = build(cfg, f"sharded R={R}")
    B = n_dev * per_card
    scen = montecarlo.make_scenarios(cfg, jax.random.PRNGKey(1), B)
    mesh = mesh_lib.scenario_mesh(n_devices=n_dev)
    runner = montecarlo.make_sharded_runner(
        system.loop, system.layers, cfg, steps, mesh)
    first, best, stats = timed(runner, scen)
    devs = sorted(str(d) for d in stats.mean_rms_res.devices())
    report("4cards sharded", R=R, B=B, steps=steps, compile_s=first - best,
           ms_per_step=best * 1e3 / steps,
           control_steps_per_s=B * steps / best,
           mean_rms_res=float(stats.mean_rms_res),
           mean_strehl=float(stats.mean_strehl_exact),
           n_scenarios=float(stats.n_scenarios),
           n_diverged=float(stats.n_diverged), stats_devices=devs)

    one = jax.jit(lambda s: montecarlo.run_batch(
        system.loop, system.layers, cfg, s, n_steps=steps).rms_res)
    first1, best1, rms = timed(one, scen)
    settle = steps // 2
    ref = float(np.mean(np.asarray(rms)[:, settle:]))
    report("4cards one-card", R=R, B=B, steps=steps,
           ms_per_step=best1 * 1e3 / steps,
           control_steps_per_s=B * steps / best1, mean_rms_res=ref,
           scaling_4_over_1=best1 / best)
    check(float(stats.n_scenarios) == B and float(stats.n_diverged) == 0,
          "sharded: scenario count")
    np.testing.assert_allclose(float(stats.mean_rms_res), ref, rtol=1e-3)


def main(argv=None):
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only run_sharded over 4 GPUs vs run_batch")
    args = ap.parse_args(argv)

    if jax.default_backend() != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX backend is "
                 f"{jax.default_backend()!r}")
    from mpc_sensorlessao_tpu.utils import compile_cache

    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().replace("\n", " | ")
    print(CARD, flush=True)
    print(f"jax {jax.__version__}", flush=True)
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')}", flush=True)
    print(f"compile cache: {compile_cache.enable()}", flush=True)

    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        phase_measure(512, 256)
        phase_measure(128, 4096)
        cfg512, sys512 = phase_parity()
        phase_protocol()
        phase_batched(config(128), build(config(128), "batched R=128")[0],
                      4096)
        phase_batched(cfg512, sys512, 256)
        phase_conditional()
        phase_gpu_tests()
    d = jax.devices()
    print(f"total_s={time.perf_counter() - t0} [card: {CARD}]", flush=True)
    print(CARD, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))


if __name__ == "__main__":
    main()
