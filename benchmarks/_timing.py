"""Shared differenced-scan timing protocol.

Per-dispatch latency and fixed scan overhead can dwarf the kernels being
measured, and single differenced estimates spread from run to run: the
one protocol every benchmark uses is
  - two pre-compiled runs of scan length L and 2L,
  - one differenced estimate per repeat: (t_long - t_short) / L,
  - median (+ optional IQR) over the repeats.
"""

from __future__ import annotations

import time

import numpy as np


def differenced_median(short_run, long_run, steps: int,
                       repeats: int = 9, warmed: bool = False):
    """Median per-scan-iteration seconds from paired short/long runs.

    short_run/long_run: argless callables that execute the compiled
    scans of length `steps` and `2*steps` and block until ready.
    Returns (median_s_per_iter, estimates_array)."""
    if not warmed:
        short_run()
        long_run()
    est = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        short_run()
        t1 = time.perf_counter()
        long_run()
        t2 = time.perf_counter()
        est.append(((t2 - t1) - (t1 - t0)) / steps)
    est = np.asarray(est)
    return float(np.median(est)), est
