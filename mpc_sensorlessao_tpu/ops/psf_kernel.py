"""Fused first DFT stage of the symmetric-triple PSF measure, for GPUs.

A Pallas kernel on the Triton route.  Each program takes one scenario
and one tile of rows of its residual phase.  It walks the columns tile by
tile: loads the phase and the constant maps (pupil, pupil cos aZ,
pupil sin aZ), takes cos/sin once per pixel, forms the three diversity
fields (-a, 0, +a) in registers, and accumulates their products with the
packed DFT operator on the tensor cores.  Only the thin rows
(B, 3, R, 2h) are written: the plain path's (B, 6, R, R) products never
reach device memory.

``ops.psf.thin_rows_reference`` is the same map in plain jnp, and the
tests hold this kernel to it in interpret mode.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Tile sizes: rows per program, columns per inner step; warps and
# pipeline stages per program.  The fastest of a sweep over rows
# {64, 128, 256} x columns {16, 32} x warps {4, 8} on an H100 (700 W)
# at R=512/B=256 and at R=128/B=4096 alike.
BLOCK_ROWS = 64
BLOCK_COLS = 16
NUM_WARPS = 4
NUM_STAGES = 2


def tiles(resolution: int) -> tuple[int, int]:
    """(rows per program, columns per inner step) for an R x R grid."""
    return min(BLOCK_ROWS, resolution), min(BLOCK_COLS, resolution)


def supports(resolution: int) -> bool:
    """The kernel's blocks need a power-of-two grid of at least 16 px
    (Triton block shapes are powers of two, matmul tiles >= 16)."""
    R = resolution
    return R >= 16 and R & (R - 1) == 0


def _kernel(phase_ref, pupil_ref, pcd_ref, psd_ref, ar_ref, ai_ref,
            out_ref, *, block_cols, precision, compute_dtype):
    rows, R = phase_ref.shape
    width = ar_ref.shape[-1]

    def dot(f, a):
        if compute_dtype is not None:
            f = f.astype(compute_dtype)
        return pl.dot(f, a, precision=precision)

    def body(k, accs):
        cols = pl.ds(k * block_cols, block_cols)
        ph = phase_ref[:, cols]
        pup = pupil_ref[:, cols]
        pcd = pcd_ref[:, cols]
        psd = psd_ref[:, cols]
        ar = ar_ref[cols, :]
        ai = ai_ref[cols, :]
        if compute_dtype is not None:
            ar = ar.astype(compute_dtype)
            ai = ai.astype(compute_dtype)
        cp = jnp.cos(ph)
        sp = jnp.sin(ph)
        t1, t2, t3, t4 = cp * pcd, sp * psd, sp * pcd, cp * psd
        fields = ((t1 + t2, t3 - t4),            # -a
                  (cp * pup, sp * pup),          # 0
                  (t1 - t2, t3 + t4))            # +a
        # [rr | ri] = fr [are | aim]^T + fi [-aim | are]^T
        return tuple(acc + dot(fr, ar) + dot(fi, ai)
                     for acc, (fr, fi) in zip(accs, fields))

    zero = jnp.zeros((rows, width), jnp.float32)
    accs = jax.lax.fori_loop(0, R // block_cols, body, (zero, zero, zero))
    for d in range(3):
        out_ref[d] = accs[d]


def thin_rows(phase, pupil, pcd, psd, a_packed,
              precision=jax.lax.Precision.DEFAULT, compute_dtype=None,
              interpret: bool = False):
    """Same contract as ops.psf.thin_rows_reference: (B, R, R) phases ->
    (B, 3, R, 2h) rows, diversities ordered (-a, 0, +a)."""
    B, R, _ = phase.shape
    if not supports(R):
        raise ValueError(f"psf_kernel needs a power-of-two grid >= 16, "
                         f"got {R}")
    h = a_packed.shape[0] // 2
    block_rows, block_cols = tiles(R)
    ar = a_packed.T                                              # (R, 2h)
    ai = jnp.concatenate([-a_packed[h:], a_packed[:h]]).T        # (R, 2h)
    kernel = functools.partial(
        _kernel, block_cols=block_cols, precision=precision,
        compute_dtype=compute_dtype)
    plane = pl.BlockSpec((block_rows, R), lambda b, i: (i, 0))
    operator = pl.BlockSpec((R, 2 * h), lambda b, i: (0, 0))
    return pl.pallas_call(
        kernel,
        grid=(B, R // block_rows),
        in_specs=[pl.BlockSpec((None, block_rows, R),
                               lambda b, i: (b, i, 0)),
                  plane, plane, plane, operator, operator],
        out_specs=pl.BlockSpec((None, 3, block_rows, 2 * h),
                               lambda b, i: (b, 0, i, 0)),
        out_shape=jax.ShapeDtypeStruct((B, 3, R, 2 * h), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="psf_thin_rows",
    )(phase, pupil, pcd, psd, ar, ai)
