"""Partial centered 2-D DFT as matmuls.

The estimator needs only the central (2c+1)^2 crop of
fftshift(fft2(fftshift(P))) (reference: README.md:468-471).  For that the
right primitive is not an FFT at all: a *partial centered DFT*

    Y[u, v] = sum_{x,y} X[x, y] e^{-2pi i (u-c)(x-c)/N} e^{-2pi i (v-c)(y-c)/N}
            = (A X A^T)[u, v],     A in C^{w x N},  w = crop width << N

costs two thin complex matmuls (w*N^2 MACs) that run on the matrix
units, versus a full N^2 log N FFT of which all but w^2 outputs are
thrown away.

The identity with the fftshift sandwich holds exactly for even N:
fft2(fftshift(X))[k] = sum_x X[x] e^{-2pi i k(x-c)/N}; re-centering the
output index k=(u+c) mod N multiplies by e^{-2pi i (x-c)} = 1.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=16)
def _centered_partial_dft_np(n: int, crop_half: int) -> np.ndarray:
    """A[u, x] = exp(-2pi i (u-c)(x-c)/n), u in [c-half, c+half]."""
    c = n // 2
    u = np.arange(c - crop_half, c + crop_half + 1)
    x = np.arange(n)
    phase = -2.0 * np.pi * np.outer(u - c, x - c) / n
    return np.exp(1j * phase).astype(np.complex64)


def centered_partial_dft(n: int, crop_half: int) -> jnp.ndarray:
    """(2, w, n) float32 operator [real; imag], w = 2*crop_half+1.

    Stored as stacked real parts, the layout the real-arithmetic measure
    (ops.psf.sym3_measurements) consumes; partial_centered_fft2
    reassembles the complex operator inside the compiled program.
    """
    A = _centered_partial_dft_np(n, crop_half)
    return jnp.asarray(np.stack([A.real, A.imag]), dtype=jnp.float32)


def partial_centered_fft2(field: jnp.ndarray, A_ri: jnp.ndarray) -> jnp.ndarray:
    """A @ field @ A.T for batched complex fields (..., N, N) -> (..., w, w).

    ``A_ri`` is the (2, w, N) real/imag stack from centered_partial_dft;
    ``field`` is complex built inside the surrounding jit.  Equals
    fftshift(fft2(fftshift(field)))[crop] exactly (see module docstring).
    """
    A = jax.lax.complex(A_ri[0], A_ri[1])
    rows = jnp.einsum("un,...nm->...um", A, field)      # (..., w, N)
    return jnp.einsum("...um,vm->...uv", rows, A)       # (..., w, w)


def packed_half(w: int) -> int:
    """Row count each operator half is padded to: the next power of two
    >= w, at least 16 (the GPU kernel's matmul tiles need power-of-two
    widths of 16 or more)."""
    return max(16, 1 << (w - 1).bit_length())


def packed_operator(A_ri: jnp.ndarray) -> jnp.ndarray:
    """(2, w, N) [real; imag] -> (2h, N) = [real; 0; imag; 0].

    h = packed_half(w): each half is zero-padded to h rows, so one matmul
    against this operand yields both the real- and the imaginary-operator
    products, split at the power-of-two column h.
    """
    w = A_ri.shape[1]
    pad = ((0, 0), (0, packed_half(w) - w), (0, 0))
    return jnp.pad(A_ri, pad).reshape(-1, A_ri.shape[-1])
