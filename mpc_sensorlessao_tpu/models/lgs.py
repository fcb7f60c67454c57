"""Laser guide star: sodium-layer profile and spot elongation.

Equivalent capability to the reference's `laserGuideStar.m` (73 LoC,
bundled OOMAO; SURVEY.md 2d "source LGS branches").  The reference
models an LGS as a stack of `source` objects at the sodium-layer slab
heights whose photon fluxes follow the Na density profile weighted by
1/h^2 (laserGuideStar.m:57-64), and prints/sets the spot's angular
extent from the launch-aperture geometry (laserGuideStar.m:36-53).
The cone-effect footprint projection for finite-height sources already
lives in ops/relay.py; this module adds the photometric and spot-shape
pieces, redesigned for batched execution:

* slab flux weights  w_k = rho_k / h_k^2 / sum(rho/h^2)
  (laserGuideStar.m:59-63);
* per-subaperture elongation: a subaperture at transverse offset r from
  the launch axis sees slab k displaced by  theta_k = |r| (1/h_mean -
  1/h_k)  along the radial direction -- the classic radial-elongation
  pattern.  The angular extent matches laserGuideStar.m:37-38
  (apertureDistance * (h_max - h_min) / h_mean^2 for the furthest
  subaperture);
* elongated spot formation: each subaperture's diffraction spot
  (wfs.spot_frames) is convolved with its own elongation kernel --
  built as ONE (n_subap, kw, kw) stack and applied as a single batched
  `lax.conv_general_dilated` with feature groups (one batched op, no
  per-subap Python loop).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

RAD2ARCSEC = 180.0 / math.pi * 3600.0


class LGSModel(NamedTuple):
    """Sodium-layer LGS description.

    heights:  (n_slab,) slab altitudes [m] (e.g. 90e3 + (-5..5) km);
    weights:  (n_slab,) photon fraction per slab (sums to 1);
    n_photon: total photons/m^2/s (laserGuideStar nPhoton);
    launch:   (2,) transverse launch position in the pupil [m]
              (viewPoint semantics, laserGuideStar.m example);
    mean_altitude: focus altitude [m] (objectiveFocalLength).
    """

    heights: jnp.ndarray
    weights: jnp.ndarray
    n_photon: float
    launch: jnp.ndarray
    mean_altitude: float


def build(heights, na_density=None, n_photon: float = 1e6,
          launch=(0.0, 0.0), mean_altitude: float | None = None) -> LGSModel:
    """Na profile -> slab weights (laserGuideStar.m:57-64).

    ``na_density=None`` = flat profile (the reference's
    `isempty(naDensityProfile)` branch normalizes by sum(1/h^2))."""
    h = np.asarray(heights, dtype=np.float64)
    rho = (np.ones_like(h) if na_density is None
           else np.asarray(na_density, dtype=np.float64))
    w = rho / h ** 2
    w = w / w.sum()
    if mean_altitude is None:
        mean_altitude = float((w * h).sum())
    return LGSModel(
        heights=jnp.asarray(h, dtype=jnp.float32),
        weights=jnp.asarray(w, dtype=jnp.float32),
        n_photon=float(n_photon),
        launch=jnp.asarray(launch, dtype=jnp.float32),
        mean_altitude=float(mean_altitude),
    )


def angular_size_arcsec(aperture_distance: float, heights,
                        mean_altitude: float) -> float:
    """LGS angular extent seen from the furthest aperture
    (laserGuideStar.m:36-38):  d (h_max - h_min) / h_mean^2."""
    h = np.asarray(heights, dtype=np.float64)
    return float(aperture_distance * (h.max() - h.min())
                 / mean_altitude ** 2 * RAD2ARCSEC)


def elongation_offsets(model: LGSModel, sub_pos) -> jnp.ndarray:
    """Per-(subaperture, slab) angular offsets (n_sub, n_slab, 2) [rad].

    sub_pos: (n_sub, 2) subaperture-center positions in the pupil [m].
    A slab at h_k, focused at h_mean, appears displaced by
    (r - launch) (1/h_mean - 1/h_k) -- zero at the launch axis, radial
    elsewhere (the elongation axis points along r - launch).
    """
    r = jnp.asarray(sub_pos, dtype=jnp.float32) - model.launch[None]
    dinv = 1.0 / model.mean_altitude - 1.0 / model.heights   # (n_slab,)
    return r[:, None, :] * dinv[None, :, None]


def elongation_kernels(model: LGSModel, sub_pos, plate_scale_rad: float,
                       kw: int, fwhm_arcsec: float = 0.0) -> jnp.ndarray:
    """(n_sub, kw, kw) normalized elongation kernels on the spot grid.

    Each slab contributes weights[k] at its angular offset (bilinearly
    deposited); ``fwhm_arcsec`` > 0 additionally blurs with the Na-spot
    Gaussian (tools.gaussian profile, laserGuideStar.m:47-52).
    ``plate_scale_rad``: spot-plane pixel size [rad/px].
    """
    off = elongation_offsets(model, sub_pos) / plate_scale_rad  # px
    n_sub, n_slab, _ = off.shape
    c = (kw - 1) / 2.0
    y = off[..., 1] + c
    x = off[..., 0] + c
    y0 = jnp.clip(jnp.floor(y), 0, kw - 2).astype(jnp.int32)
    x0 = jnp.clip(jnp.floor(x), 0, kw - 2).astype(jnp.int32)
    fy = jnp.clip(y - y0, 0.0, 1.0)
    fx = jnp.clip(x - x0, 0.0, 1.0)
    ker = jnp.zeros((n_sub, kw, kw), dtype=jnp.float32)
    sub_idx = jnp.arange(n_sub)[:, None].repeat(n_slab, 1)
    w = model.weights[None, :]
    ker = ker.at[sub_idx, y0, x0].add(w * (1 - fy) * (1 - fx))
    ker = ker.at[sub_idx, y0, x0 + 1].add(w * (1 - fy) * fx)
    ker = ker.at[sub_idx, y0 + 1, x0].add(w * fy * (1 - fx))
    ker = ker.at[sub_idx, y0 + 1, x0 + 1].add(w * fy * fx)
    if fwhm_arcsec > 0.0:
        sig = fwhm_arcsec / RAD2ARCSEC / plate_scale_rad / 2.3548
        ax = jnp.arange(kw, dtype=jnp.float32) - c
        g = jnp.exp(-0.5 * (ax / sig) ** 2)
        g2 = g[:, None] * g[None, :]
        g2 = g2 / jnp.sum(g2)
        ker = jax.vmap(lambda k: jax.scipy.signal.convolve2d(
            k, g2, mode="same"))(ker)
    return ker / (jnp.sum(ker, axis=(-2, -1), keepdims=True) + 1e-20)


def elongate_spots(spots: jnp.ndarray, kernels: jnp.ndarray) -> jnp.ndarray:
    """Convolve each subaperture spot with its own elongation kernel.

    spots: (n_sub, w, w); kernels: (n_sub, kw, kw).  ONE grouped
    convolution (feature_group_count = n_sub): every subaperture is a
    channel with its private filter -- no Python loop, batched.
    """
    n_sub, w, _ = spots.shape
    kw = kernels.shape[-1]
    lhs = spots[None]                                  # (1, n_sub, w, w)
    rhs = kernels[:, None, ::-1, ::-1]                 # (n_sub, 1, kw, kw)
    pad = (kw - 1) // 2
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1, 1),
        padding=((pad, kw - 1 - pad), (pad, kw - 1 - pad)),
        feature_group_count=n_sub)
    return out[0]


def subaperture_positions(n_lenslet: int, diameter: float) -> np.ndarray:
    """(nl^2, 2) lenslet-center positions [m], row-major like
    wfs.SHModel.valid.ravel()."""
    d = diameter / n_lenslet
    c = (np.arange(n_lenslet) + 0.5) * d - diameter / 2.0
    X, Y = np.meshgrid(c, c)
    return np.stack([X.ravel(), Y.ravel()], axis=1)
