"""Detector noise model + science imager metrics.

Equivalent of the reference's bundled-but-unused imaging
chain (SURVEY.md 2d): `detector.m` (367 LoC) and `imager.m` (168 LoC).
The sensorless pipeline injects precomputed SNR-10dB noise instead
(README.md:473-475); these components complete the camera capability
surface for the WFS models (pyramid.m's camera is a detector) and for
science-path evaluation.

Reference semantics replicated:

* detector.m:299-304  -- intensity binning to the detector resolution
  (utilities.binning: block sums, flux-preserving);
* detector.m:305-311  -- frame integration over `exposure_frames` ticks;
* detector.m:315-321  -- noise chain order: Poisson photon noise on
  (image + background), background subtracted, THEN quantum efficiency,
  THEN additive Gaussian readout noise;
* detector.m:9-15     -- photonNoise off / readOutNoise 0 / QE 1
  defaults;
* imager.m:98-115     -- Strehl ratio as the OTF-volume ratio
  sum(OTF_AO)/sum(OTF_DL).  The OTF volume equals the PSF peak over the
  total flux, so it is computed here peak/flux-normalized without any
  Fourier transform;
* imager.m:117-126    -- encircled energy within a square of given
  width centered on the diffraction peak (the commented-out eeFilter
  semantics, evaluated directly in the image plane).

Design: `expose` is jit/vmap-friendly (static shapes, jax.random
noise keys, reshape-sum binning) so a whole Monte-Carlo batch of frames
is one program; metrics are simple reductions.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class DetectorConfig(NamedTuple):
    """detector.m knobs (detector.m:9-15,63)."""

    resolution: int                 # output frame is resolution x resolution
    photon_noise: bool = False
    read_out_noise: float = 0.0     # e- rms per pixel
    quantum_efficiency: float = 1.0
    n_photon_background: float = 0.0
    exposure_frames: int = 1        # frames integrated per readout


def bin_frame(image: jnp.ndarray, resolution: int) -> jnp.ndarray:
    """Flux-preserving block binning (utilities.binning via
    detector.m:299-304).  Input side must be a multiple of resolution."""
    n = image.shape[-1]
    if n == resolution:
        return image
    b = n // resolution
    lead = image.shape[:-2]
    return image.reshape(*lead, resolution, b, resolution, b).sum(
        axis=(-3, -1))


def read_out(cfg: DetectorConfig, key, image: jnp.ndarray) -> jnp.ndarray:
    """Apply the detector noise chain to an integrated intensity frame
    (detector.m:292-330)."""
    image = bin_frame(image, cfg.resolution)
    if cfg.photon_noise:
        key, sub = jax.random.split(key)
        image = jax.random.poisson(
            sub, image + cfg.n_photon_background).astype(jnp.float32) \
            - cfg.n_photon_background
    image = cfg.quantum_efficiency * image
    if cfg.read_out_noise > 0:
        image = image + cfg.read_out_noise * jax.random.normal(
            key, image.shape, dtype=jnp.float32)
    return image


def expose(cfg: DetectorConfig, key, frames: jnp.ndarray) -> jnp.ndarray:
    """Integrate `exposure_frames` intensity frames then read out once
    (detector.m:305-311).  frames: (T, n, n) with T >= exposure_frames."""
    acc = jnp.sum(frames[:cfg.exposure_frames], axis=0)
    return read_out(cfg, key, acc)


# ------------------------------------------------------------------ imager

def strehl_ratio(image: jnp.ndarray, reference: jnp.ndarray,
                 center: bool = False) -> jnp.ndarray:
    """OTF-volume Strehl (imager.m:115): sum(OTF_AO)/sum(OTF_DL).

    The OTF volume is the flux-normalized PSF peak, so no transform is
    needed: S = (peak/flux)_image / (peak/flux)_reference.

    ``center=False`` (default) takes the frame maximum as the peak --
    exact only for NOISELESS frames (detector noise biases the maximum
    high) but robust to residual tip/tilt shifting the peak off-center.
    ``center=True`` samples the known on-axis pixel instead: unbiased
    under zero-mean noise, assumes a centered PSF (use it on noisy
    frames of a tip/tilt-stabilized path).
    """
    if center:
        ci, cj = image.shape[-2] // 2, image.shape[-1] // 2
        pk_i = image[..., ci, cj] / jnp.sum(image, axis=(-2, -1))
        cr_i, cr_j = reference.shape[-2] // 2, reference.shape[-1] // 2
        pk_r = reference[..., cr_i, cr_j] / jnp.sum(reference,
                                                    axis=(-2, -1))
    else:
        pk_i = jnp.max(image) / jnp.sum(image)
        pk_r = jnp.max(reference) / jnp.sum(reference)
    return pk_i / pk_r


def encircled_energy(image: jnp.ndarray, width: int) -> jnp.ndarray:
    """Fraction of total flux inside a centered width x width window
    (imager.m:117-126 eeFilter semantics, image-plane form)."""
    n = image.shape[-1]
    c = n // 2
    h = width // 2
    win = image[..., c - h:c + h + width % 2, c - h:c + h + width % 2]
    return jnp.sum(win, axis=(-2, -1)) / jnp.sum(image, axis=(-2, -1))


class ImagerResult(NamedTuple):
    frame: jnp.ndarray
    strehl: jnp.ndarray
    ee: jnp.ndarray


def imager(cfg: DetectorConfig, key, frames: jnp.ndarray,
           reference: jnp.ndarray, ee_width: int = 4) -> ImagerResult:
    """Science camera: expose + Strehl + encircled energy
    (imager.m:70-130)."""
    frame = expose(cfg, key, frames)
    ref = bin_frame(reference, cfg.resolution)
    return ImagerResult(frame=frame,
                        strehl=strehl_ratio(frame, ref),
                        ee=encircled_energy(frame, ee_width))


# ------------------------------------------------- image-domain utilities

def gaussian_frame(resolution: int, fwhm: float,
                   n_f: int | None = None) -> jnp.ndarray:
    """Unit-flux Gaussian kernel frame (utilities.m:748-779 `gaussian`).

    Grid convention matches the reference: u = (0:n-1) - n/2.  When
    ``n_f < resolution/2`` the reference deletes n_f rows/columns from
    each edge; replicated here as a centered crop to
    resolution - 2 n_f."""
    u = jnp.arange(resolution, dtype=jnp.float32) - resolution / 2.0
    x, y = jnp.meshgrid(u, u)
    sig = fwhm / (2.0 * jnp.sqrt(2.0 * jnp.log(2.0)))
    f = jnp.exp(-(x * x + y * y) / (2.0 * sig * sig))
    f = f / jnp.sum(f)
    if n_f is not None and n_f < resolution / 2:
        f = f[n_f:resolution - n_f, n_f:resolution - n_f]
    return f


def barycenter(x: jnp.ndarray, y: jnp.ndarray, body: jnp.ndarray):
    """Intensity-weighted centroid (utilities.m:898-921 `barycenter`).

    x, y: coordinate arrays (any shape, flattened); body: weights with
    matching leading size, optionally with trailing frame axes reshaped
    to (n, k) like the reference.  Returns (x_bary, y_bary) arrays of
    length k."""
    n = x.size
    b = jnp.reshape(body, (n, -1))
    mass = jnp.sum(b, axis=0)
    xb = jnp.sum(x.reshape(-1, 1) * b, axis=0) / mass
    yb = jnp.sum(y.reshape(-1, 1) * b, axis=0) / mass
    return xb, yb


def fit_fwhm(profile: jnp.ndarray) -> jnp.ndarray:
    """Half-max contour radius of a 2-D profile (utilities.m:676-683
    `fitFwhm`).

    The reference traces the 0.5 contour with MATLAB `contourc` and
    averages the point distances from the contour centroid.  Contour
    tracing is data-dependent control flow; the jit-friendly equivalent
    integrates the indicator of the above-half-max region with a
    subpixel fractional band: radius = sqrt(area / pi) of the half-max
    region, which equals the mean contour radius for the (near-)convex
    peaks this is used on.  Returns the RADIUS in pixels (the reference's
    `rc`; FWHM = 2 rc for a circular peak).

    Subpixel model: within a crossing pixel the profile is locally
    linear, so the covered fraction is 0.5 + (p - 0.5)/|grad p| clipped
    to [0, 1] -- the ramp width adapts to the local gradient magnitude
    (a fixed-width band would over/under-count area depending on how
    steep the peak is; ADVICE r4).  For elongated peaks the returned
    area-equivalent radius is the geometric mean of the semi-axes,
    which lower-bounds the reference's contour-mean radius by
    (2 sqrt(ab)/(a+b)) -- exact for circular contours
    (tests/test_imaging.py covers both)."""
    p = profile / jnp.max(profile)
    gy, gx = jnp.gradient(p)
    g = jnp.sqrt(gx * gx + gy * gy)
    frac = jnp.clip(0.5 + (p - 0.5) / jnp.maximum(g, 1e-12), 0.0, 1.0)
    area = jnp.sum(frac)
    return jnp.sqrt(area / jnp.pi)


def gerchberg_saxton(pupil_plane_intensity, focal_plane_intensity,
                     n_iterations: int = 300, seed: int = 0):
    """Gerchberg-Saxton phase retrieval (utilities.m:843-905, minus the
    figure plumbing).

    Host-side NumPy implementation: this is an offline calibration/
    analysis tool built on full-frame fft2/ifft2 that runs once, off the
    hot path -- the hot path PSFs use partial-DFT matmuls instead
    (ops/dft.py), which cannot invert.
    Returns (phase, convergence) with convergence[k] the Frobenius
    mismatch per iteration, matching the reference."""
    import numpy as np

    source = np.sqrt(np.asarray(pupil_plane_intensity, dtype=np.float64))
    target = np.sqrt(np.asarray(focal_plane_intensity, dtype=np.float64))
    rng = np.random.default_rng(seed)
    phase = np.pi * (rng.random(source.shape) * 2.0 - 1.0)
    cvgce = np.zeros(n_iterations)
    fsh = np.fft.fftshift
    for k in range(n_iterations):
        B = source * np.exp(1j * phase)
        C = fsh(np.fft.fft2(fsh(B)))
        D = target * np.exp(1j * np.angle(C))
        A = fsh(np.fft.ifft2(fsh(D)))
        phase = np.angle(A)
        cvgce[k] = np.linalg.norm(np.abs(C) ** 2
                                  - np.asarray(focal_plane_intensity))
    return phase, cvgce
