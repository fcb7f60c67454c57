"""Where the conditional-Gaussian flow's step cost goes (VERDICT r4 #3).

The r4 artifact showed the reference-parity conditional flow
(ops/edge_flow.py, telescopeAbstract.m:288-372) costs ~255 us/step of
overhead over the periodic fast path at R=128 single-scenario, and that
number had never been decomposed.  This measures, with the shared
differenced-scan median protocol (benchmarks/_timing.py):

  breakdown rows (one advance() per scan iteration, state carried):
    draws        border conditional-Gaussian draws only (A Z + B eps)
    draws_embed  + frame assembly (pad + ring scatter)
    no_frac      + exact whole-pixel shifts (no output-side bilinear)
    full_new     the round-5 layer-vectorized advance()
    full_old     the round-4 per-layer advance (A/B: the attempted fix)

  amortization rows (full closed loop, montecarlo.run_batch):
    per-step marginal cost of conditional vs periodic flow at B=1 and
    at Monte-Carlo batch sizes with shared_turbulence=True -- the
    shared-realization path traces the evolution UNBATCHED under vmap,
    so its cost is amortized over the whole batch.

Usage: python benchmarks/edge_flow_breakdown.py [out.json]
Env:   EFB_RES=128  EFB_STEPS=25  EFB_REPEATS=9  EFB_BATCH=64  EFB_CPU=1
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
if os.environ.get("EFB_CPU"):
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from _timing import differenced_median  # noqa: E402
from mpc_sensorlessao_tpu.models import pipeline  # noqa: E402
from mpc_sensorlessao_tpu.ops import edge_flow  # noqa: E402
from mpc_sensorlessao_tpu.parallel import montecarlo  # noqa: E402
from mpc_sensorlessao_tpu.utils.config import reference_config  # noqa: E402

STEPS = int(os.environ.get("EFB_STEPS", "25"))
REPEATS = int(os.environ.get("EFB_REPEATS", "9"))


def _measure_scan(step_fn, carry0, steps=STEPS, repeats=REPEATS):
    def scan_of(length):
        @jax.jit
        def run(c0):
            def body(c, idx):
                return step_fn(c, idx)
            c, ys = jax.lax.scan(body, c0, jnp.arange(length))
            return ys
        return lambda: run(carry0).block_until_ready()

    med, est = differenced_median(scan_of(steps), scan_of(2 * steps),
                                  steps, repeats)
    q = np.percentile(est, [25, 75])
    return med, (float(q[0]), float(q[1]))


def breakdown_rows(model, state0, key, done=None, save=None):
    """Component knockouts of one advance() application."""
    L = model.n_layers
    n = model.size
    K_max = max((max(ns) for ns in model.nsub), default=0)

    def perturb(st, x):
        return edge_flow.EdgeFlowState(
            phases=st.phases * (1.0 + 1e-12 * x))

    def step_draws(st, idx):
        k = jax.random.fold_in(key, idx)
        tot = jnp.float32(0.0)
        for s in range(K_max + 1):
            b = edge_flow._draw_borders_all(model, st.phases,
                                            jax.random.fold_in(k, s))
            tot = tot + jnp.sum(b)
        return perturb(st, tot), tot

    def step_draws_embed(st, idx):
        k = jax.random.fold_in(key, idx)
        tot = jnp.float32(0.0)
        for s in range(K_max + 1):
            b = edge_flow._draw_borders_all(model, st.phases,
                                            jax.random.fold_in(k, s))
            f = edge_flow._embed_all(model, st.phases, b)
            tot = tot + jnp.sum(f)
        return perturb(st, tot), tot

    def step_no_frac(st, idx):
        # full integer-lattice update, skip the output-side bilinear
        idxf = jnp.asarray(idx, jnp.float32)
        kstep = jax.random.fold_in(key, idx)
        phases = st.phases
        for s in range(K_max):
            borders = edge_flow._draw_borders_all(
                model, phases, jax.random.fold_in(kstep, s))
            frames = edge_flow._embed_all(model, phases, borders)
            new = []
            for l in range(L):
                sy, sx = model.step_px[l]
                ky = (jnp.floor((idxf + 1) * sy)
                      - jnp.floor(idxf * sy)).astype(jnp.int32)
                kx = (jnp.floor((idxf + 1) * sx)
                      - jnp.floor(idxf * sx)).astype(jnp.int32)
                sgn_y, sgn_x = (1 if sy > 0 else -1), (1 if sx > 0 else -1)
                do_y, do_x = s < jnp.abs(ky), s < jnp.abs(kx)
                new.append(jnp.where(
                    do_y & do_x,
                    edge_flow._shift_exact(frames[l], n, sgn_y, sgn_x),
                    jnp.where(
                        do_y, edge_flow._shift_exact(frames[l], n, sgn_y, 0),
                        jnp.where(do_x, edge_flow._shift_exact(
                            frames[l], n, 0, sgn_x), phases[l]))))
            phases = jnp.stack(new)
        # one more draw (parity with full advance's op count budget)
        b = edge_flow._draw_borders_all(model, phases,
                                        jax.random.fold_in(kstep, K_max))
        st2 = edge_flow.EdgeFlowState(phases=phases)
        return st2, jnp.sum(b)

    def step_full_new(st, idx):
        st2, ph = edge_flow.advance(model, st, idx, key)
        return st2, jnp.sum(ph)

    def step_full_old(st, idx):
        st2, ph = edge_flow.advance_per_layer(model, st, idx, key)
        return st2, jnp.sum(ph)

    rows = dict(done or {})
    for name, fn in [("draws", step_draws),
                     ("draws_embed", step_draws_embed),
                     ("no_frac", step_no_frac),
                     ("full_new", step_full_new),
                     ("full_old", step_full_old)]:
        if name in rows:
            continue
        med, iqr = _measure_scan(fn, state0)
        rows[name] = {"us_per_step": round(med * 1e6, 2),
                      "iqr_us": [round(x * 1e6, 2) for x in iqr]}
        print(name, rows[name], file=sys.stderr, flush=True)
        if save is not None:
            save(rows)
    return rows


def loop_marginal(res, batches, steps=STEPS, repeats=REPEATS,
                  done=None, save=None):
    """Per-step closed-loop cost: periodic vs conditional(shared), one
    build per flow reused across every batch size."""
    out = {f"B={b}": {} for b in batches}
    for b, row in (done or {}).items():  # staged resume
        if b in out:
            out[b].update({k: v for k, v in row.items()
                           if k in ("periodic", "conditional")})
    for flow in ("periodic", "conditional"):
        if all(flow in out[f"B={b}"] for b in batches):
            continue
        cfg = reference_config(resolution=res)
        cfg = cfg.replace(
            atmosphere=dataclasses.replace(cfg.atmosphere, flow=flow),
            sim=dataclasses.replace(cfg.sim, n_train=300, n_valid=50,
                                    n_test=steps))
        t0 = time.time()
        system = pipeline.build(cfg, jax.random.PRNGKey(0))
        jax.block_until_ready(system.loop.est.A_s)
        build_s = time.time() - t0
        for batch in batches:
            scen = montecarlo.make_scenarios(cfg, jax.random.PRNGKey(1),
                                             batch)
            montecarlo.assert_shared_window(scen)

            def run_of(n_steps):
                if flow == "conditional":
                    f = jax.jit(lambda s: montecarlo.run_batch(
                        system.loop, system.layers, cfg, s,
                        n_steps=n_steps,
                        edge_model=system.edge_model,
                        edge_state=system.edge_state,
                        shared_turbulence="verified").rms_res)
                else:
                    f = jax.jit(lambda s: montecarlo.run_batch(
                        system.loop, system.layers, cfg, s,
                        n_steps=n_steps,
                        shared_window="verified").rms_res)
                return lambda: f(scen).block_until_ready()

            med, est = differenced_median(run_of(steps),
                                          run_of(2 * steps),
                                          steps, repeats)
            q = np.percentile(est, [25, 75])
            out[f"B={batch}"][flow] = {
                "build_s": round(build_s, 1),
                "us_per_step": round(med * 1e6, 1),
                "us_per_step_per_scen": round(med / batch * 1e6, 2),
                "iqr_us": [round(float(x) * 1e6, 1) for x in q],
            }
            print(f"B={batch} {flow}", out[f"B={batch}"][flow],
                  file=sys.stderr, flush=True)
            if save is not None:
                save(out)
    for b in batches:
        row = out[f"B={b}"]
        row["conditional_overhead_us_per_step"] = round(
            row["conditional"]["us_per_step"]
            - row["periodic"]["us_per_step"], 1)
    return out


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else "EDGEFLOW.json"
    res = int(os.environ.get("EFB_RES", "128"))
    batch = int(os.environ.get("EFB_BATCH", "64"))
    smoke = bool(os.environ.get("EFB_CPU"))

    cfg = reference_config(resolution=res)
    tel = dataclasses.replace(cfg.telescope, resolution=res)
    t0 = time.time()
    model, state0 = edge_flow.build(0, cfg.atmosphere, tel)
    model = jax.device_put(model)
    state0 = jax.device_put(state0)
    build_s = time.time() - t0
    key = jax.random.PRNGKey(3)

    report = {
        "what": ("Conditional-Gaussian flow cost breakdown "
                 "(telescopeAbstract.m:288-372 parity path): component "
                 "knockouts of advance(), r4-vs-r5 implementation A/B, "
                 "and closed-loop marginal cost with the shared-"
                 "turbulence Monte-Carlo amortization.  Differenced-"
                 "scan medians (benchmarks/_timing.py)."),
        "resolution": res, "device": str(jax.devices()[0]),
        "scan_steps": STEPS, "repeats": REPEATS,
        "n_layers": model.n_layers,
        "nsub": list(map(list, model.nsub)),
        "operator_build_s": round(build_s, 1),
        "advance_breakdown": {},
        "closed_loop": {},
    }
    if os.path.exists(out_path):  # staged run: resume completed rows
        with open(out_path) as f:
            prior = json.load(f)
        if prior.get("resolution") == res:
            report["advance_breakdown"] = prior.get(
                "advance_breakdown", {})
            report["closed_loop"] = prior.get("closed_loop", {})

    def _save(rows=None):
        if rows is not None:
            report["advance_breakdown"] = rows
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")

    report["advance_breakdown"] = breakdown_rows(
        model, state0, key, done=report["advance_breakdown"],
        save=_save)

    # bf16-stored conditioning operators (half the device-memory traffic
    # of the draw stage)
    model_bf = jax.device_put(dataclasses.replace(
        model, A=model.A.astype(jnp.bfloat16),
        Bc=model.Bc.astype(jnp.bfloat16)))

    def step_full_bf(st, idx):
        st2, ph = edge_flow.advance(model_bf, st, idx, key)
        return st2, jnp.sum(ph)

    if "full_new_bf16ops" not in report["advance_breakdown"]:
        med, iqr = _measure_scan(step_full_bf, state0)
        report["advance_breakdown"]["full_new_bf16ops"] = {
            "us_per_step": round(med * 1e6, 2),
            "iqr_us": [round(x * 1e6, 2) for x in iqr]}
        print("full_new_bf16ops",
              report["advance_breakdown"]["full_new_bf16ops"],
              file=sys.stderr, flush=True)
        _save()

    # shift-selection strategy A/B (full_new uses the size-based default)
    report["shift_select_default"] = model.shift_select
    alt = "where" if model.shift_select == "switch" else "switch"
    model_alt = jax.device_put(dataclasses.replace(model,
                                                   shift_select=alt))

    def step_full_alt(st, idx):
        st2, ph = edge_flow.advance(model_alt, st, idx, key)
        return st2, jnp.sum(ph)

    if f"full_new_{alt}" not in report["advance_breakdown"]:
        med, iqr = _measure_scan(step_full_alt, state0)
        report["advance_breakdown"][f"full_new_{alt}"] = {
            "us_per_step": round(med * 1e6, 2),
            "iqr_us": [round(x * 1e6, 2) for x in iqr]}
        print(f"full_new_{alt}",
              report["advance_breakdown"][f"full_new_{alt}"],
              file=sys.stderr, flush=True)
        _save()
    # hybrid impl (batched draws + per-layer frames/shifts), both
    # shift-select strategies
    for sel in ("switch", "where"):
        rname = f"full_hybrid_{sel}"
        if rname in report["advance_breakdown"]:
            continue
        model_h = jax.device_put(dataclasses.replace(
            model, impl="hybrid", shift_select=sel))

        def step_full_h(st, idx, m=model_h):
            st2, ph = edge_flow.advance(m, st, idx, key)
            return st2, jnp.sum(ph)

        med, iqr = _measure_scan(step_full_h, state0)
        report["advance_breakdown"][rname] = {
            "us_per_step": round(med * 1e6, 2),
            "iqr_us": [round(x * 1e6, 2) for x in iqr]}
        print(rname, report["advance_breakdown"][rname],
              file=sys.stderr, flush=True)
        _save()

    if not os.environ.get("EFB_SKIP_LOOPS"):
        bsizes = [1, 4] if smoke else [1, batch]
        need = any(f not in report["closed_loop"].get(f"B={b}", {})
                   for b in bsizes for f in ("periodic", "conditional"))
        if need:
            def _save_loops(out):
                report["closed_loop"] = out
                _save()
            report["closed_loop"] = loop_marginal(
                res, bsizes, done=report["closed_loop"],
                save=_save_loops)

    _save()
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
