"""Zernike modal engine.

Re-design of the reference's Zernike pipeline
(reference: zernfun.m:134-192, zernmodfit.m:195-214):

* the mode table uses the reference's *modified* ordering -- per radial
  order n, azimuthal numbers m = (-n:2:-1) then fliplr(n:-2:0)
  (reference: zernmodfit.m:195-198), so mode 0 is piston and mode 4 is
  defocus (the diversity mode, MATLAB 1-based idx2=5, README.md:393);
* basis evaluation is a single power-table matmul instead of
  the reference's per-mode scalar loops (zernfun.m:161-178);
* decomposition ("zernmodfit") and synthesis are precomputed-operator
  matmuls so thousands of frames batch through `vmap`/`einsum`;
* the basis is generated on the grid x=(-N:2:N)/N, [X,Y]=meshgrid(x)
  (reference: README.md:78-84,246-253) -- this regenerates the missing
  `Zs.mat` blob (SURVEY.md section 2c).

All heavy precomputation happens once on host in float64 and is cast to the
requested on-device dtype.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=None)
def mode_indices(radial_order: int) -> Tuple[Tuple[int, int], ...]:
    """(n, m) pairs in the reference's modified ordering.

    Per n: m = [-n, -n+2, ..., -2 or -1] then [n%2, ..., n-2, n]
    (reference: zernmodfit.m:195-198).
    """
    modes = []
    for n in range(radial_order + 1):
        ms = list(range(-n, 0, 2)) + list(range(n % 2, n + 1, 2))
        modes.extend((n, m) for m in ms)
    return tuple(modes)


def n_modes(radial_order: int) -> int:
    return (radial_order + 1) * (radial_order + 2) // 2


@lru_cache(maxsize=None)
def radial_coeff_table(radial_order: int) -> np.ndarray:
    """Dense (n_modes, radial_order+1) table C with
    R_n^{|m|}(r) = sum_p C[k, p] r^p  (reference: zernfun.m:161-173)."""
    modes = mode_indices(radial_order)
    table = np.zeros((len(modes), radial_order + 1), dtype=np.float64)
    for k, (n, m) in enumerate(modes):
        am = abs(m)
        for s in range((n - am) // 2 + 1):
            p = n - 2 * s
            c = (
                (-1) ** s
                * math.factorial(n - s)
                / (
                    math.factorial(s)
                    * math.factorial((n + am) // 2 - s)
                    * math.factorial((n - am) // 2 - s)
                )
            )
            table[k, p] = c
    return table


def eval_points(
    radial_order: int,
    r: np.ndarray,
    theta: np.ndarray,
    norm: bool = False,
) -> np.ndarray:
    """Evaluate all modes at polar points -> (len(r), n_modes), float64 host.

    Azimuthal convention matches zernfun.m:184-192: m>0 -> cos(|m| theta),
    m<0 -> sin(|m| theta); default unnormalized (zernmodfit passes no 'norm'
    flag, zernmodfit.m:205).
    """
    modes = mode_indices(radial_order)
    coeff = radial_coeff_table(radial_order)
    r = np.asarray(r, dtype=np.float64).ravel()
    theta = np.asarray(theta, dtype=np.float64).ravel()
    powers = np.arange(radial_order + 1, dtype=np.float64)
    rp = r[:, None] ** powers[None, :]                    # (P, order+1)
    radial = rp @ coeff.T                                  # (P, K)
    m_arr = np.array([m for _, m in modes])
    n_arr = np.array([n for n, _ in modes])
    ang = theta[:, None] * np.abs(m_arr)[None, :]
    azim = np.where(m_arr[None, :] > 0, np.cos(ang),
                    np.where(m_arr[None, :] < 0, np.sin(ang), 1.0))
    z = radial * azim
    if norm:
        z = z * np.sqrt((1.0 + (m_arr != 0)) * (n_arr + 1) / math.pi)[None, :]
    return z


class ZernikeBasis(NamedTuple):
    """Precomputed modal basis on a square grid.

    Fields (all device arrays unless noted):
      stack:     (K, R, R) mode maps, zero outside the unit disc -- the
                 regenerated `Zs.mat` equivalent (README.md:266).
      mask:      (R, R) bool pupil membership r<=1.
      fit_full:  (K, R*R) operator: coeffs = fit_full @ phase.ravel(),
                 the least-squares decomposition z\\data of zernmodfit.m:209.
      n_arr,m_arr: (K,) int mode numbers.
      radial_order: static int.
    """

    stack: jnp.ndarray
    mask: jnp.ndarray
    fit_full: jnp.ndarray
    n_arr: jnp.ndarray
    m_arr: jnp.ndarray
    radial_order: int
    # Discrete-grid pupil moments of the modes (f64 precompute):
    #   gram[j,k] = mean_pupil(Z_j Z_k),  mode_mean[k] = mean_pupil(Z_k).
    # On the discrete masked grid these are NOT exactly delta_jk / 0 --
    # they let consumers evaluate pupil statistics of modal phases
    # algebraically (e.g. closed_loop's O(nx^2) residual RMS instead of
    # a batched (B, R^2) reduction).
    gram: jnp.ndarray | None = None
    mode_mean: jnp.ndarray | None = None

    @property
    def n_modes(self) -> int:
        return self.stack.shape[0]

    @property
    def resolution(self) -> int:
        return self.stack.shape[1]


@lru_cache(maxsize=8)
def _grid_polar(resolution: int):
    """Reference grid: x=(-N:2:N)/N, [X,Y]=meshgrid(x), cart2pol
    (reference: README.md:78-84). X varies along columns, Y along rows."""
    N = resolution - 1
    x = (np.arange(resolution) * 2.0 - N) / N
    X, Y = np.meshgrid(x, x)
    r = np.hypot(X, Y)
    theta = np.arctan2(Y, X)
    mask = r <= 1.0 + 1e-12
    return r, theta, mask


def make_basis(
    radial_order: int,
    resolution: int,
    dtype=jnp.float32,
) -> ZernikeBasis:
    """Build the basis stack + fit operator (host f64 precompute)."""
    r, theta, mask = _grid_polar(resolution)
    P = int(mask.sum())
    z_in = eval_points(radial_order, r[mask], theta[mask])      # (P, K)
    K = z_in.shape[1]

    stack = np.zeros((K, resolution, resolution), dtype=np.float64)
    stack[:, mask] = z_in.T

    # Least-squares fit operator: c = pinv(Z) data  (zernmodfit.m:209).
    w = np.linalg.pinv(z_in)                                     # (K, P)
    fit_full = np.zeros((K, resolution * resolution), dtype=np.float64)
    fit_full[:, mask.ravel()] = w

    modes = mode_indices(radial_order)
    return ZernikeBasis(
        stack=jnp.asarray(stack, dtype=dtype),
        mask=jnp.asarray(mask),
        fit_full=jnp.asarray(fit_full, dtype=dtype),
        n_arr=jnp.asarray([n for n, _ in modes]),
        m_arr=jnp.asarray([m for _, m in modes]),
        radial_order=radial_order,
        gram=jnp.asarray(z_in.T @ z_in / P, dtype=dtype),
        mode_mean=jnp.asarray(z_in.sum(axis=0) / P, dtype=dtype),
    )


def fit(basis: ZernikeBasis, phase: jnp.ndarray) -> jnp.ndarray:
    """Zernike decomposition of phase map(s).

    phase: (..., R, R) -> coeffs (..., K).  Equivalent to zernmodfit's
    c = z\\data (zernmodfit.m:209) but a single batched matmul.
    """
    R = basis.resolution
    flat = phase.reshape(*phase.shape[:-2], R * R)
    return flat @ basis.fit_full.T


def synthesize(basis: ZernikeBasis, coeffs: jnp.ndarray) -> jnp.ndarray:
    """Weighted mode sum: coeffs (..., K) -> phase (..., R, R).

    Equivalent of the reference's correction synthesis loop
    (README.md:596-601) as one contraction.
    """
    R = basis.resolution
    flat = coeffs @ basis.stack.reshape(basis.n_modes, R * R)
    return flat.reshape(*coeffs.shape[:-1], R, R)


def piston_removed_phase(basis: ZernikeBasis, phase: jnp.ndarray) -> jnp.ndarray:
    """Mean-removed phase inside the pupil mask, zero outside.

    Equivalent of stochasticWave.meanRmPhase (stochasticWave.m:132-142).
    """
    mask = basis.mask.astype(phase.dtype)
    return piston_removed_phase_masked(phase, mask, jnp.sum(mask))


def piston_removed_phase_masked(phase: jnp.ndarray, mask: jnp.ndarray,
                                mask_npix) -> jnp.ndarray:
    """meanRmPhase with a precomputed mask/pixel count (hot-loop variant)."""
    msk = mask.astype(phase.dtype)
    mean = jnp.sum(phase * msk, axis=(-2, -1), keepdims=True) / mask_npix
    return (phase - mean) * msk
