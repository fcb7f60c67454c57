"""Toeplitz-block-Toeplitz (TBT) operator.

Equivalent of the reference's bundled-but-unused
`toeplitzBlockToeplitz.m` (172 LoC, SURVEY.md 2d): a matrix-free
representation of 2-D stationary covariance operators (the storage/
matvec engine behind OOMAO's slopesLinearMMSE reconstructors), storing
only the (nBr+nBc-1) x (nR+nC-1) generator instead of the full
(nBr nR) x (nBc nC) matrix.

Reference semantics and their re-design:

* toeplitzBlockToeplitz.m:25-48,115-123 computes the matvec by
  embedding the generator in a length-na 1-D FFT convolution with
  precomputed gather indices (mu/xi).  Here the primitive is not an FFT
  but a 2-D
  convolution: with x reshaped to its (block, inner) grid, the TBT
  matvec IS the full 2-D convolution of x with the generator --
  one `lax.conv_general_dilated` call,
  batched over right-hand sides for free.
* full() materialization (:73-90) for small systems / testing.
* transpose (:92-103): flip the generator both ways.
* mldivide (:125-131): the reference inverts the dense matrix and
  caches it; solve() here does the dense solve directly (same
  semantics, no hidden cache state).

Convention: dense[(bi nR + i), (bj nC + j)] = gen[bi - bj + nBc - 1,
i - j + nC - 1]; gen rows index block diagonals, columns intra-block
diagonals.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import struct


@struct.dataclass
class TBTOperator:
    """gen: (nBr+nBc-1, nR+nC-1) generator (device); shapes static
    (pytree metadata, so the operator can cross jit boundaries)."""

    gen: jnp.ndarray
    n_block: Tuple[int, int] = struct.field(pytree_node=False)
    n_inner: Tuple[int, int] = struct.field(pytree_node=False)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_block[0] * self.n_inner[0],
                self.n_block[1] * self.n_inner[1])

    @property
    def compression(self) -> float:
        """Dense elements per stored element
        (toeplitzBlockToeplitz.m:68 `compressionFactor`)."""
        return (self.shape[0] * self.shape[1]) / self.gen.size


def build(n_block: Tuple[int, int], n_inner: Tuple[int, int],
          gen) -> TBTOperator:
    nBr, nBc = n_block
    nR, nC = n_inner
    gen = jnp.asarray(gen, dtype=jnp.float32)
    assert gen.shape == (nBr + nBc - 1, nR + nC - 1), gen.shape
    return TBTOperator(gen, (nBr, nBc), (nR, nC))


def from_stationary(cov_fn, n: int, pitch: float) -> TBTOperator:
    """Square TBT operator of a stationary 2-D kernel on an n x n grid:
    dense[(p1),(p2)] = cov_fn(|r1 - r2|) -- the covariance use case that
    motivates the reference class (slopesLinearMMSE.m).

    cov_fn: vectorized host function of separation [m].
    """
    d = np.arange(-(n - 1), n)
    dx, dy = np.meshgrid(d * pitch, d * pitch)
    gen = np.asarray(cov_fn(np.hypot(dx, dy)), dtype=np.float32)
    return build((n, n), (n, n), gen)


def matvec(op: TBTOperator, x: jnp.ndarray) -> jnp.ndarray:
    """y = T x as ONE 2-D convolution on the (block, inner) grid.

    x: (..., nBc*nC) -> (..., nBr*nR).  Batched over leading dims.
    """
    nBr, nBc = op.n_block
    nR, nC = op.n_inner
    lead = x.shape[:-1]
    xb = x.reshape(-1, 1, nBc, nC)
    # correlation with the double-flipped generator == convolution with
    # the generator; padding sized so output index bi in [0, nBr)
    ker = op.gen[::-1, ::-1][None, None]
    y = jax.lax.conv_general_dilated(
        xb, ker, window_strides=(1, 1),
        padding=((nBr - 1, nBr - 1), (nR - 1, nR - 1)))
    return y.reshape(*lead, nBr * nR)


def full(op: TBTOperator) -> np.ndarray:
    """Dense materialization (toeplitzBlockToeplitz.m:73-90)."""
    nBr, nBc = op.n_block
    nR, nC = op.n_inner
    gen = np.asarray(op.gen)
    bi, bj = np.meshgrid(np.arange(nBr), np.arange(nBc), indexing="ij")
    ii, jj = np.meshgrid(np.arange(nR), np.arange(nC), indexing="ij")
    blocks = gen[(bi - bj + nBc - 1)[:, :, None, None],
                 (ii - jj + nC - 1)[None, None]]
    return blocks.transpose(0, 2, 1, 3).reshape(nBr * nR, nBc * nC)


def transpose(op: TBTOperator) -> TBTOperator:
    """(toeplitzBlockToeplitz.m:92-103)."""
    return TBTOperator(op.gen[::-1, ::-1],
                       (op.n_block[1], op.n_block[0]),
                       (op.n_inner[1], op.n_inner[0]))


def solve(op: TBTOperator, b) -> np.ndarray:
    """T x = b via dense factorization (toeplitzBlockToeplitz.m:125-131;
    the reference materializes inv(full(T))).  Host setup-time path."""
    return np.linalg.solve(full(op).astype(np.float64), np.asarray(b))
