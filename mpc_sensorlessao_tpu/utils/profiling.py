"""Profiling and roofline utilities.

The reference instruments only tic/toc wall-clock arrays
(reference: README.md:423,445,505-570; SURVEY.md section 5.1).  Here:
`jax.profiler` trace capture plus an XLA-cost-analysis-based roofline
report (achieved FLOP/s and bytes/s vs device peaks) for any jitted
function -- the per-kernel speed-of-light accounting BASELINE.json asks
for.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass

import jax

# Published peaks per device, keyed by jax.devices()[0].device_kind.
# NVIDIA H100 SXM data sheet (dense, no sparsity, at its 700 W limit):
# 67 TFLOP/s float32 outside the tensor cores, 495 TFLOP/s TF32,
# 989 TFLOP/s bf16, 3.35 TB/s HBM3.  A card set below 700 W cannot hold
# these clocks; report its power limit beside any share of them.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12, "tf32_flops": 495e12, "bf16_flops": 989e12,
        "hbm_bytes": 3.35e12, "source": "NVIDIA H100 SXM data sheet, 700 W",
    },
}


def device_peaks(kind: str | None = None) -> dict:
    """Peaks of ``kind`` (default: this process's first device).  A device
    missing from DEVICE_PEAKS is an error, never a default."""
    if kind is None:
        kind = jax.devices()[0].device_kind
    try:
        return DEVICE_PEAKS[kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {kind!r}; add "
                       f"them to profiling.DEVICE_PEAKS with their "
                       f"source") from None


@dataclass
class RooflineReport:
    wall_s: float
    flops: float
    bytes_accessed: float
    achieved_flops_per_s: float
    achieved_bytes_per_s: float
    flop_utilization: float       # vs the float32 (non-tensor-core) peak
    bandwidth_utilization: float
    bound: str                    # "compute" | "memory"

    def __str__(self) -> str:
        return (f"wall {self.wall_s*1e3:.2f} ms | "
                f"{self.achieved_flops_per_s/1e12:.2f} TFLOP/s "
                f"({self.flop_utilization*100:.1f}% peak) | "
                f"{self.achieved_bytes_per_s/1e9:.1f} GB/s "
                f"({self.bandwidth_utilization*100:.1f}% peak) | "
                f"{self.bound}-bound")


def roofline(fn, *args, repeats: int = 5) -> RooflineReport:
    """Compile fn(*args), read XLA cost analysis, time it, and place it on
    the device roofline."""
    jitted = jax.jit(fn)
    lowered = jitted.lower(*args)
    compiled = lowered.compile()
    cost = compiled.cost_analysis() or {}
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))

    out = compiled(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = compiled(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)

    peaks = device_peaks()
    peak_f32, peak_bw = peaks["f32_flops"], peaks["hbm_bytes"]
    fps = flops / best
    bps = bytes_accessed / best
    fu = fps / peak_f32
    bu = bps / peak_bw
    return RooflineReport(
        wall_s=best, flops=flops, bytes_accessed=bytes_accessed,
        achieved_flops_per_s=fps, achieved_bytes_per_s=bps,
        flop_utilization=fu, bandwidth_utilization=bu,
        bound="compute" if fu >= bu else "memory",
    )


@contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@contextmanager
def timed(label: str, sink=None):
    """tic/toc equivalent (README.md:445,624) with optional sink list."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink.append((label, dt))
