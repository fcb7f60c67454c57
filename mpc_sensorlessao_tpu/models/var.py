"""VAR(p) system identification of Zernike-coefficient dynamics.

Re-implements the reference's time-series identification
(reference: README.md:107-155): lagged least squares
PARA = (AA'AA)^-1 AA' BB over the training window, VAR matrices
A_j = PARA_j', plus held-out validation RMSE/RRMSE.

Conventions: we use the column form x[k] = sum_j A_j x[k-j] + w[k]
(A_j = PARA block transposed, reference README.md:129-130); the reference's
later double-transpose (README.md:286-287) applies only to its re-loaded
.mat workflow.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..utils import struct


@struct.dataclass
class VARModel:
    """Identified VAR model; A has shape (order, nx, nx)."""

    A: jnp.ndarray
    order: int = struct.field(pytree_node=False)

    @property
    def nx(self) -> int:
        return self.A.shape[-1]

    def coefficient(self, j: int) -> jnp.ndarray:
        """A_j for lag j in 1..order."""
        return self.A[j - 1]


def lag_matrix(series: jnp.ndarray, order: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Build (AA, BB): AA rows = [x[i-1], ..., x[i-p]], targets x[i].

    series: (T, nx).  Matches README.md:120-125 block layout (lag j occupies
    columns (j-1)*nx:(j)*nx).
    """
    T = series.shape[0]
    blocks = [series[order - j:T - j] for j in range(1, order + 1)]
    AA = jnp.concatenate(blocks, axis=1)        # (T-p, p*nx)
    BB = series[order:]                          # (T-p, nx)
    return AA, BB


@partial(jax.jit, static_argnames=("order",))
def fit(series: jnp.ndarray, order: int, ridge: float = 0.0) -> VARModel:
    """Least-squares VAR fit over the given window (README.md:127-130).

    ``ridge`` adds scale-invariant Tikhonov damping
    lambda = ridge * mean(diag(AA'AA)) to the normal equations.  The
    reference's plain LS (README.md:127) is fine for 28 modes x 1000
    samples but overfits badly for high-order mode sets (130 regressors
    per row at order 10 / VAR(2)), producing unstable models whose
    prediction matrices amplify estimation noise; ridge=0 reproduces the
    reference exactly.
    """
    AA, BB = lag_matrix(series, order)
    gram = AA.T @ AA
    lam = ridge * jnp.mean(jnp.diag(gram))
    gram = gram + lam * jnp.eye(gram.shape[0], dtype=gram.dtype)
    para = jnp.linalg.solve(gram, AA.T @ BB)     # (p*nx, nx)
    nx = series.shape[1]
    A = jnp.stack([para[(j - 1) * nx:j * nx].T for j in range(1, order + 1)])
    return VARModel(A=A, order=order)


def companion_spectral_radius(model: VARModel) -> float:
    """Spectral radius of the VAR companion matrix (host-side)."""
    import numpy as np
    p, nx = model.order, model.nx
    comp = np.zeros((p * nx, p * nx))
    A = np.asarray(model.A, dtype=np.float64)
    for j in range(p):
        comp[:nx, j * nx:(j + 1) * nx] = A[j]
    if p > 1:
        comp[nx:, :-nx] = np.eye((p - 1) * nx)
    return float(np.abs(np.linalg.eigvals(comp)).max())


def stabilize(model: VARModel, max_radius: float = 0.999) -> VARModel:
    """Shrink the model to spectral radius <= max_radius (host-side).

    Scaling lag-j coefficients by gamma^j scales every companion
    eigenvalue by exactly gamma, so the damped model keeps the fitted
    mode shapes while guaranteeing stable predictions (the LS fit can
    come out explosive on short windows; an unstable predictor inside
    the MPC free response is a positive-feedback path for estimator
    noise).
    """
    rho = companion_spectral_radius(model)
    if rho <= max_radius:
        return model
    gamma = max_radius / rho
    scales = jnp.asarray([gamma ** j for j in range(1, model.order + 1)],
                         dtype=model.A.dtype)
    return VARModel(A=model.A * scales[:, None, None], order=model.order)


def predict_one_step(model: VARModel, history: jnp.ndarray) -> jnp.ndarray:
    """x_hat[k] from history[..., -j, :] = x[k-j]."""
    out = 0.0
    for j in range(1, model.order + 1):
        out = out + history[..., -j, :] @ model.A[j - 1].T
    return out


def validate(model: VARModel, series: jnp.ndarray):
    """One-step-ahead predictions and per-mode RMSE / RRMSE over a window.

    Mirrors README.md:135-155 (the validation loop keys off the train/test
    boundary; here the caller passes the window including `order` warmup
    samples at the front).
    """
    AA, BB = lag_matrix(series, model.order)
    nx = model.nx
    para = jnp.concatenate(
        [model.A[j - 1].T for j in range(1, model.order + 1)], axis=0)
    pred = AA @ para
    err = pred - BB
    rmse = jnp.sqrt(jnp.mean(err ** 2, axis=0))
    spread = jnp.max(BB, axis=0) - jnp.min(BB, axis=0)
    rrmse = rmse / spread
    return pred, rmse, rrmse


def innovation_covariance(model: VARModel, series) -> "np.ndarray":
    """(nx, nx) sample covariance of the one-step prediction residuals
    over a series window (host-side diagnostics; float64)."""
    import numpy as np
    s = np.asarray(series, dtype=np.float64)
    p = model.order
    # pure-numpy lag construction (lag_matrix is jnp and would round-trip
    # through the default device at f32)
    AA = np.concatenate([s[p - j:len(s) - j] for j in range(1, p + 1)],
                        axis=1)
    BB = s[p:]
    para = np.concatenate(
        [np.asarray(model.A[j - 1], dtype=np.float64).T
         for j in range(1, p + 1)], axis=0)
    err = AA @ para - BB
    return err.T @ err / err.shape[0]


def power_spectrum(model: VARModel, sigma_w, freqs, fs: float):
    """Two-sided PSD [state^2/Hz] of the VAR process at frequencies
    ``freqs`` [Hz], sampled at ``fs``:  S(nu) = H Sigma_w H^H / fs with
    H(nu) = (I - sum_j A_j e^{-i 2 pi nu j / fs})^{-1}.

    Returns (len(freqs), nx) diagonal.  Host-side diagnostics: the
    natural cross-check of the identified model against the analytic
    frozen-flow temporal spectra (ops.zernike_stats.
    temporal_spectrum_analytic) -- integral_{-fs/2}^{fs/2} S dnu equals
    the modeled state variance.
    """
    import numpy as np
    freqs = np.atleast_1d(np.asarray(freqs, dtype=np.float64))
    Sw = np.asarray(sigma_w, dtype=np.float64)
    nx = model.nx
    A = [np.asarray(model.A[j], dtype=np.float64)
         for j in range(model.order)]
    out = np.empty((len(freqs), nx))
    eye = np.eye(nx)
    for i, nu in enumerate(freqs):
        z = np.exp(-2j * np.pi * nu / fs)
        M = eye.astype(complex).copy()
        for j, Aj in enumerate(A, start=1):
            M -= Aj * z ** j
        H = np.linalg.inv(M)
        out[i] = np.real(np.diag(H @ Sw @ H.conj().T)) / fs
    return out
