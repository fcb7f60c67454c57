"""Shack-Hartmann wavefront sensing + slope-based reconstructors.

Equivalent of the reference's bundled-but-unused OOMAO sensing
stack (SURVEY.md 2d): `shackHartmann.m` (1457 LoC), `lensletArray.m`,
and the slope reconstructors `linearMMSE.m` / `slopesLinearMMSE.m`.
The sensorless pipeline never instantiates them (the paper's estimator is
phase diversity), but they define the optional capability surface; here
they are rebuilt for batched execution:

* geometric slopes are ONE precomputed matmul: a (2 n_valid, R^2)
  operator averaging the phase x/y finite differences over each valid
  subaperture (the OOMAO "geometric" mode, shackHartmann.m `slopes`
  semantics) -- batched over scenarios as matmuls;
* diffractive spots use the same partial-DFT-as-matmul trick as the
  estimator (ops/dft.py): per-subaperture tiles -> centered partial DFT
  -> intensity -> centroid, batched over (subaps x scenarios), no FFT
  custom call;
* reconstructors: zonal/modal LS pinv (the `calibrationVault` role) and
  the Bayesian MMSE gain  R = C D' (D C D' + sigma^2 I)^-1  with the
  analytic Von Karman Zernike-coefficient prior from
  ops/zernike_stats.py -- the linearMMSE capability
  (linearMMSE.m:1-60) specialized to modal estimation from slopes.

Host-side float64 setup, float32 device operators, everything jit/vmap
compatible.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import dft, psf


class SHModel(NamedTuple):
    """Precomputed Shack-Hartmann operators.

    slope_op:  (2 n_valid, R*R) geometric-slopes matmul [rad/subap -> rad
               mean-gradient per subaperture, x block then y block].
    valid:     (nl, nl) bool valid-subaperture map.
    sub_px:    subaperture width in pixels.
    dft_op:    (2, w, sub_px) partial-DFT operator for diffractive spots.
    pupil:     (R, R) pupil mask.
    """

    slope_op: jnp.ndarray
    valid: np.ndarray
    sub_px: int
    dft_op: jnp.ndarray
    pupil: jnp.ndarray

    @property
    def n_valid(self) -> int:
        return self.slope_op.shape[0] // 2

    @property
    def n_slopes(self) -> int:
        return self.slope_op.shape[0]


def build(resolution: int, n_lenslet: int = 10,
          min_light_ratio: float = 0.5, crop_half: int = 3,
          dtype=jnp.float32) -> SHModel:
    """Build the SH geometry + operators.

    ``n_lenslet`` subapertures across the pupil diameter;
    ``min_light_ratio`` = minimum pupil fill to validate a subaperture
    (lensletArray.minLightRatio semantics); ``crop_half`` sets the
    diffractive spot window (2c+1)^2.
    """
    R = resolution
    if R % n_lenslet != 0:
        raise ValueError(f"resolution {R} not divisible by n_lenslet "
                         f"{n_lenslet}")
    sub = R // n_lenslet
    pupil = np.asarray(psf.pupil_mask_np(R), dtype=np.float64)

    fill = pupil.reshape(n_lenslet, sub, n_lenslet, sub).sum((1, 3))
    valid = fill / (sub * sub) >= min_light_ratio

    # geometric slope operator: masked mean of centered differences
    # over each valid subaperture, x then y
    n_valid = int(valid.sum())
    G = np.zeros((2 * n_valid, R * R))

    # build per-subap averaging of gradients via composition:
    # grad_x(phase)[i,j] = (phase[i,j+1]-phase[i,j-1])/2 inside the pupil
    k = 0
    idx = np.arange(R * R).reshape(R, R)
    for li in range(n_lenslet):
        for lj in range(n_lenslet):
            if not valid[li, lj]:
                continue
            rows = slice(li * sub, (li + 1) * sub)
            cols = slice(lj * sub, (lj + 1) * sub)
            m = np.zeros((R, R))
            m[rows, cols] = pupil[rows, cols]
            w = m.sum()
            # x gradient: phase[i, j+1] - phase[i, j-1]
            gx = np.zeros(R * R)
            gy = np.zeros(R * R)
            ii, jj = np.nonzero(m)
            for i, j in zip(ii, jj):
                if 0 < j < R - 1:
                    gx[idx[i, j + 1]] += 0.5 / w
                    gx[idx[i, j - 1]] -= 0.5 / w
                if 0 < i < R - 1:
                    gy[idx[i + 1, j]] += 0.5 / w
                    gy[idx[i - 1, j]] -= 0.5 / w
            G[k] = gx
            G[n_valid + k] = gy
            k += 1

    # spots are formed on a 2x zero-padded grid: the un-padded DFT
    # critically samples the subaperture diffraction spot (1 bin = lambda/d)
    # and the windowed centroid loses its linear response to sub-bin
    # shifts; padding to lambda/(2d) bins (Nyquist) restores gain ~1
    return SHModel(
        slope_op=jnp.asarray(G, dtype=dtype),
        valid=valid,
        sub_px=sub,
        dft_op=dft.centered_partial_dft(2 * sub, min(crop_half, sub - 1)),
        pupil=jnp.asarray(pupil, dtype=dtype),
    )


def geometric_slopes(model: SHModel, phase: jnp.ndarray) -> jnp.ndarray:
    """(.., R, R) phase -> (.., 2 n_valid) mean-gradient slopes [rad/px].
    One matmul (the hot path)."""
    flat = phase.reshape(*phase.shape[:-2], -1)
    return flat @ model.slope_op.T


def diffractive_slopes(model: SHModel, phase: jnp.ndarray) -> jnp.ndarray:
    """Spot-centroid slopes from per-subaperture diffraction.

    Tiles the pupil-masked field into subapertures, zero-pads 2x (Nyquist
    spot sampling), forms each spot with the partial centered DFT (two
    thin matmuls, ops/dft.py), and converts intensity-weighted centroids
    to mean-gradient units [rad/px] so the output is directly comparable
    to geometric_slopes.  Single phase map; vmap over batches.
    """
    inten = spot_frames(model, phase)                  # (nl^2, w, w)
    cx, cy = _centroid(inten, quad_cell=False)
    vmask = jnp.asarray(model.valid.ravel())
    sel = jnp.nonzero(vmask, size=int(model.valid.sum()))[0]
    # centroid bin -> gradient: one bin = 2 pi / (2 sub) rad/px
    scale = jnp.pi / model.sub_px
    return jnp.concatenate([cx[sel], cy[sel]]) * scale


def spot_frames(model: SHModel, phase: jnp.ndarray) -> jnp.ndarray:
    """Per-subaperture diffraction spot intensities (nl^2, w, w) --
    the lensletArray imagelets surface (lensletArray.m:1-437), Nyquist
    sampled via 2x zero-padding (see diffractive_slopes)."""
    R = phase.shape[-1]
    sub = model.sub_px
    nl = R // sub
    field = model.pupil * jnp.exp(1j * phase)
    tiles = field.reshape(nl, sub, nl, sub).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(nl * nl, sub, sub)
    pad = sub // 2
    tiles = jnp.pad(tiles, ((0, 0), (pad, pad), (pad, pad)))
    spots = dft.partial_centered_fft2(tiles, model.dft_op)
    return spots.real ** 2 + spots.imag ** 2


def _centroid(inten: jnp.ndarray, quad_cell: bool):
    """Intensity (N, w, w) -> (cx, cy) in pixels (centroiding) or
    normalized quadrant imbalance (quad-cell), shackHartmann.m:515-566."""
    w = inten.shape[-1]
    tot = jnp.sum(inten, axis=(-2, -1)) + 1e-20
    ax = jnp.arange(w, dtype=inten.dtype) - (w - 1) / 2.0
    if quad_cell:
        ax = jnp.sign(ax)
    cx = jnp.sum(inten * ax[None, None, :], axis=(-2, -1)) / tot
    cy = jnp.sum(inten * ax[None, :, None], axis=(-2, -1)) / tot
    return cx, cy


def camera_slopes(model: SHModel, phase: jnp.ndarray, key,
                  detector=None, n_photons: float = 0.0,
                  threshold=None, quad_cell: bool = False,
                  ref_slopes: jnp.ndarray | None = None,
                  remove_mean: bool = False,
                  flat_field: jnp.ndarray | float = 0.0,
                  pixel_gains: jnp.ndarray | float = 1.0,
                  slopes_units: float = 1.0) -> jnp.ndarray:
    """Full SH camera chain: spots -> detector noise -> thresholding ->
    centroiding -> slopes [rad/px].

    The shackHartmann.m dataProcessing pipeline (:480-566) routed
    through the detector noise model (models/imaging.py):

    * ``detector``: imaging.DetectorConfig applied per spot frame
      (photon noise -> QE -> readout, detector.m:292-330); None = ideal.
    * ``n_photons``: mean photons per VALID subaperture (scales the
      intensity before the noise chain); 0 keeps raw intensity units.
    * ``threshold``: None | scalar t | (t_abs, t_rel).  Scalar subtracts
      t and clamps at 0 (the 'usual thresholding',
      shackHartmann.m:504-507); a pair uses per-subaperture
      max(frame)*t_rel floored at t_abs (intensity-based thresholding,
      shackHartmann.m:493-503).
    * ``quad_cell``: quadrant imbalance instead of center-of-mass
      (shackHartmann.m:123-124,515-527); calibrate its gain externally.
    * ``ref_slopes``: subtracted reference (flat-wavefront) slopes
      (shackHartmann.m referenceSlopes semantics); None = 0.
    * ``remove_mean``: rmMeanSlopes tip/tilt removal
      (shackHartmann.m:566-571).  (The reference also declares
      matchedFilter/correlation algorithm flags, but their processing
      branches are EMPTY stubs -- shackHartmann.m:562-563 and
      lensletProcessing.m:205-206 -- so there is no behavior to match.)
    * ``flat_field``/``pixel_gains``: per-pixel camera calibration
      applied to the raw frames before thresholding,
      buffer = (frame - flatField) / pixelGains
      (lensletProcessing.m:181); scalars or (w, w) / (nl^2, w, w) maps.
    * ``slopes_units``: output unit scale (lensletProcessing.m:47,208).

    Single phase map; vmap over batches (split keys per scenario).
    """
    from . import imaging

    inten = spot_frames(model, phase)
    vmask = jnp.asarray(model.valid.ravel())
    sel = jnp.nonzero(vmask, size=int(model.valid.sum()))[0]
    if n_photons > 0.0:
        mean_flux = jnp.mean(jnp.sum(inten, axis=(-2, -1))[sel])
        inten = inten * (n_photons / (mean_flux + 1e-20))
    if detector is not None:
        inten = imaging.read_out(detector, key, inten)
    inten = (inten - flat_field) / pixel_gains
    if threshold is not None:
        if np.ndim(threshold) == 0:
            t = jnp.asarray(threshold, dtype=inten.dtype)
        else:
            t_abs, t_rel = threshold
            t = jnp.maximum(
                jnp.max(inten, axis=(-2, -1), keepdims=True) * t_rel,
                t_abs)
        inten = jnp.maximum(inten - t, 0.0)
    cx, cy = _centroid(inten, quad_cell)
    sub = model.sub_px
    scale = jnp.pi / sub          # centroid bin -> mean gradient [rad/px]
    s = jnp.concatenate([cx[sel], cy[sel]]) * scale
    if ref_slopes is not None:
        s = s - ref_slopes
    s = s * slopes_units
    if remove_mean:
        # rmMeanSlopes (shackHartmann.m:566-571): subtract the mean x
        # and mean y slope (tip/tilt removal at the slopes level)
        n = s.shape[-1] // 2
        s = jnp.concatenate([s[:n] - jnp.mean(s[:n]),
                             s[n:] - jnp.mean(s[n:])])
    return s


def reference_slopes(model: SHModel, quad_cell: bool = False) -> jnp.ndarray:
    """Flat-wavefront slopes for the camera chain (noise-free,
    threshold-free): the calibration zero point."""
    zero = jnp.zeros_like(model.pupil)
    return camera_slopes(model, zero, jax.random.PRNGKey(0),
                         quad_cell=quad_cell)


def interaction_matrix(model: SHModel, mode_stack: jnp.ndarray,
                       amplitude: float = 0.1,
                       diffractive: bool = False) -> jnp.ndarray:
    """Calibration: poke each mode, record slopes -> (n_slopes, K).

    The geometric path is exact (linear operator); the diffractive path
    uses +/- amplitude pokes (centroid nonlinearity symmetrized), the
    OOMAO calibration procedure (calibrationVault role).
    """
    if not diffractive:
        return (geometric_slopes(model, mode_stack)).T
    plus = jax.vmap(lambda m: diffractive_slopes(model, amplitude * m))(
        mode_stack)
    minus = jax.vmap(lambda m: diffractive_slopes(model, -amplitude * m))(
        mode_stack)
    return ((plus - minus) / (2.0 * amplitude)).T


def ls_reconstructor(D: jnp.ndarray, rcond: float = 1e-6) -> jnp.ndarray:
    """Zonal/modal least-squares reconstructor pinv(D): (K, n_slopes)."""
    Dn = np.asarray(D, dtype=np.float64)
    return jnp.asarray(np.linalg.pinv(Dn, rcond=rcond), dtype=D.dtype)


def mmse_reconstructor(D: jnp.ndarray, prior_cov: np.ndarray,
                       noise_var: float) -> jnp.ndarray:
    """Bayesian MMSE gain R = C D' (D C D' + sigma^2 I)^-1.

    The linearMMSE / slopesLinearMMSE capability (linearMMSE.m,
    slopesLinearMMSE.m) for modal estimation: ``prior_cov`` is the
    analytic Zernike-coefficient covariance
    (ops/zernike_stats.coefficient_covariance), ``noise_var`` the
    per-slope measurement noise variance.  Host f64 build.
    """
    Dn = np.asarray(D, dtype=np.float64)
    C = np.asarray(prior_cov, dtype=np.float64)
    CD = C @ Dn.T
    G = Dn @ CD + noise_var * np.eye(Dn.shape[0])
    return jnp.asarray(np.linalg.solve(G, CD.T).T, dtype=D.dtype)


def reconstruct(Rop: jnp.ndarray, slopes: jnp.ndarray) -> jnp.ndarray:
    """x_hat = R s (batched matmul)."""
    return slopes @ Rop.T
