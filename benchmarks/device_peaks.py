"""Measured device ceilings beside the published peaks.

Published peaks (utils/profiling.device_peaks) are what no program
reaches; a kernel's share of what a large plain product and a large copy
reach on the same card says more about the kernel.  This measures them
with the differenced-scan median protocol the kernel timings use
(benchmarks/_timing.py):

  matmul_*             dense (N, N) @ (N, N) sustained FLOP/s at TF32
                       (default), full float32 and bf16
  hbm                  x <- x + 1 streaming read+write bytes/s
  transc_cos / _exp    chained elementwise cos / exp, SLOPE method:
                       rate = (k2 - k1) * M / (t_k2 - t_k1) -- the
                       difference in chain depth cancels the memory
                       traffic and fixed overhead entirely.

Usage: python benchmarks/device_peaks.py out.json
Env:   PK_STEPS=64  PK_REPEATS=7
"""

from __future__ import annotations

import json
import os
import sys

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

from _timing import differenced_median  # noqa: E402

STEPS = int(os.environ.get("PK_STEPS", "64"))
REPEATS = int(os.environ.get("PK_REPEATS", "7"))


def _scan_med(step_fn, carry0, probe, steps=STEPS, repeats=REPEATS):
    """`probe(final_carry)` returns a scalar, fetched to the host to end
    each timed call."""
    def scan_of(length):
        @jax.jit
        def run(c0):
            c, _ = jax.lax.scan(lambda c, _: (step_fn(c), None), c0,
                                None, length=length)
            return probe(c)
        return lambda: float(run(carry0))

    med, est = differenced_median(scan_of(steps), scan_of(2 * steps),
                                  steps, repeats)
    q = np.percentile(est, [25, 75])
    return med, (float(q[0]), float(q[1]))


def matmul_peak(dtype, n, precision=None, steps=None):
    """precision=None measures jnp.dot DEFAULT precision (TF32 tensor-core
    passes for float32 operands on the GPU); Precision.HIGHEST the full
    float32 rate."""
    rng = np.random.default_rng(0)
    A = jnp.asarray(rng.normal(size=(n, n)), dtype)
    B = jnp.asarray(rng.normal(size=(n, n)), dtype)

    def step(c):
        A, B = c
        C = jnp.dot(A, B, preferred_element_type=jnp.float32,
                    precision=precision)
        # fold the product back so nothing hoists; cast keeps dtype
        return ((A + 1e-12 * C.astype(jnp.float32)).astype(dtype), B)

    steps = steps or STEPS
    med, iqr = _scan_med(step, (A, B), lambda c: c[0][0, 0], steps=steps)
    flops = 2.0 * n ** 3
    return {"n": n, "precision": str(precision or "default"),
            "s_per_iter": med, "iqr_s": iqr,
            "differenced_work_s": round(med * steps, 3),
            "reliable": bool(med > 0 and med * steps > 0.05),
            "tflops": round(flops / med / 1e12, 2)}


def hbm_peak(m):
    x = jnp.zeros((m,), jnp.float32)

    def step(c):
        return c + 1.0

    med, iqr = _scan_med(step, x, lambda c: c[0])
    by = 2.0 * 4.0 * m          # read + write
    return {"elements": m, "s_per_iter": med, "iqr_s": iqr,
            "differenced_work_s": round(med * STEPS, 3),
            "reliable": bool(med > 0 and med * STEPS > 0.05),
            "gbps": round(by / med / 1e9, 1)}


def transc_peak(op, m, k1, k2, steps=None):
    x = jnp.full((m,), 0.7, jnp.float32)
    fn = {"cos": jnp.cos, "exp": lambda v: jnp.exp(-v * v)}[op]

    def step_of(k):
        def step(c):
            for _ in range(k):
                c = fn(c)
            return c
        return step

    steps = steps or STEPS
    t1, _ = _scan_med(step_of(k1), x, lambda c: c[0], steps=steps)
    t2, iqr = _scan_med(step_of(k2), x, lambda c: c[0], steps=steps)
    per = (t2 - t1) / ((k2 - k1) * m)     # seconds per transcendental
    return {"elements": m, "k1": k1, "k2": k2,
            "t_k1_s": t1, "t_k2_s": t2, "iqr_k2_s": iqr,
            "differenced_work_s": round((t2 - t1) * steps, 3),
            "reliable": bool(per > 0 and (t2 - t1) * steps > 0.05),
            "gtransc_per_s": round(1.0 / per / 1e9, 2)}


def main():
    out_path = sys.argv[1]
    n = 8192
    m_hbm = 1 << 28          # 1 GB f32
    m_tr = 1 << 25
    d = jax.devices()[0]
    report = {
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
        "scan_steps": STEPS, "repeats": REPEATS,
        "matmul_default": matmul_peak(jnp.float32, n),
        "matmul_f32_highest": matmul_peak(jnp.float32, n,
                                       jax.lax.Precision.HIGHEST),
        "matmul_bf16": matmul_peak(jnp.bfloat16, n, steps=2 * STEPS),
        "hbm": hbm_peak(m_hbm),
        "transc_cos": transc_peak("cos", m_tr, 8, 32),
        "transc_exp": transc_peak("exp", m_tr, 8, 32, steps=4 * STEPS),
    }
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
