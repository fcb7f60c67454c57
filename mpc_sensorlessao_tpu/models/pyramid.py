"""Pyramid wavefront sensor (Fourier-filtering WFS).

Equivalent of the reference's bundled-but-unused `pyramid.m`
(504 LoC, SURVEY.md 2d).  Reference semantics replicated (file:line in
OOMAO-master/pyramid.m):

* 4-faceted focal-plane phase mask with face tilt `alpha` (default
  pi/2), normalized and fftshifted                         (:456-483)
* field embedded centered in a 2c-times padded grid
  (px_side = 2 c resolution, c default 2)                  (:148-154,400)
* tip-tilt modulation: nTheta = round(2 pi c modulation) circular
  phasor steps exp(-i pi 4 mod c r cos(o+theta)), intensities summed
  over the circle                                          (:403-420)
* detector binning px_side -> 2 c nLenslet pixels          (:91,321)
* 4-quadrant slope maps Sx = (I1-I4+I2-I3)/I, Sy = (I1-I2+I4-I3)/I,
  flux-normalized by the integrated intensity over the valid pupil
  (normalisation option 2)                                 (:463-481)
* valid pupil = disc of diameter nLenslet in the c nLenslet quadrant
  (:157-158), slopes = valid pixels of [Sx Sy] x slopesUnits (:479-481)
* gain calibration: 5-point tilt ramp, linear fit, slopesUnits =
  1/gain                                                   (:350-367)

Deliberate deviation: dataProcessing's quadrant windows (:324-344) are
off by one pixel (quadrants share a row/column); the pupil images lie
strictly inside each c nLenslet quadrant so a clean half split reads
identical valid pixels.

Design: a pyramid needs TWO full 2-D transforms per modulation step;
both are expressed as complex matmuls  fft2(X) = F X F  with the
symmetric DFT matrix F (F[j,k] = exp(-2 pi i j k / N)), so the whole
sensor is one batched einsum over modulation steps.  The DFT operator is
stored as a stacked real/imag float32 pair (like ops/dft.py) and is
reassembled in-program.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def _dft_matrix_ri(n: int) -> np.ndarray:
    j = np.arange(n)
    ph = -2.0 * np.pi * np.outer(j, j) / n
    return np.stack([np.cos(ph), np.sin(ph)]).astype(np.float32)


def _pyr_mask_ri(n: int, alpha: float) -> np.ndarray:
    """Pyramid face transmittance+phase, normalized, fftshifted
    (pyramid.m:456-483).  heaviside(0)=1/2 as in MATLAB."""
    half = n // 2
    f = (np.arange(n) - half) / half * (n // 2)   # freqspace * floor(n/2)
    fx, fy = np.meshgrid(f, f, indexing="xy")

    def heav(x):
        return np.where(x > 0, 1.0, np.where(x == 0, 0.5, 0.0))

    pym = (heav(fx) * heav(fy) * np.exp(-1j * alpha * (fx + fy))
           + heav(fx) * heav(-fy) * np.exp(-1j * alpha * (fx - fy))
           + heav(-fx) * heav(-fy) * np.exp(1j * alpha * (fx + fy))
           + heav(-fx) * heav(fy) * np.exp(-1j * alpha * (-fx + fy)))
    pym = np.fft.fftshift(pym / np.abs(pym).sum())
    return np.stack([pym.real, pym.imag]).astype(np.float32)


class PyramidModel(NamedTuple):
    """Precomputed pyramid-WFS operators (all float32 device arrays)."""

    dft_op: jnp.ndarray        # (2, N, N) DFT matrix [real; imag]
    pyr_mask: jnp.ndarray      # (2, N, N) fftshifted pyramid mask
    phasors: jnp.ndarray       # (nTheta, 2, N, N) modulation phasors
    pupil: jnp.ndarray         # (R, R) pupil amplitude mask
    valid: np.ndarray          # (c nl, c nl) bool valid-pupil map (host)
    reference_slopes: jnp.ndarray  # (2 n_valid,)
    slopes_units: jnp.ndarray      # scalar
    resolution: int
    n_lenslet: int
    c: int

    @property
    def px_side(self) -> int:
        return 2 * self.c * self.resolution

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())

    @property
    def n_slopes(self) -> int:
        return 2 * self.n_valid


def build(resolution: int, n_lenslet: int, modulation: float = 0.0,
          c: int = 2, alpha: float = np.pi / 2) -> PyramidModel:
    """Host-side precompute of every pyramid operator."""
    N = 2 * c * resolution
    n_theta = max(int(round(2 * np.pi * c * modulation)), 1)

    if modulation > 0:
        # corner-origin polar grid, as the reference uses (pyramid.m:126-127)
        uu, vv = np.meshgrid(np.arange(N) / N, np.arange(N) / N,
                             indexing="ij")
        r = np.hypot(uu, vv)
        o = np.arctan2(vv, uu)
        thetas = 2.0 * np.pi * np.arange(n_theta) / n_theta
        ph = (-np.pi * 4.0 * modulation * c
              * r[None] * np.cos(o[None] + thetas[:, None, None]))
        phasors = np.stack([np.cos(ph), np.sin(ph)], axis=1)
    else:
        phasors = np.stack([np.ones((1, N, N)), np.zeros((1, N, N))],
                           axis=1)

    # pupil: disc of diameter `resolution` (utilities.piston)
    x = (np.arange(resolution) - (resolution - 1) / 2) / (resolution / 2)
    X, Y = np.meshgrid(x, x)
    pupil = (np.hypot(X, Y) <= 1.0).astype(np.float32)

    # valid intensity pupil: disc of diameter nl in the (c nl) quadrant
    q = c * n_lenslet
    xq = (np.arange(q) - (q - 1) / 2) / (n_lenslet / 2)
    Xq, Yq = np.meshgrid(xq, xq)
    valid = np.hypot(Xq, Yq) <= 1.0

    model = PyramidModel(
        dft_op=jnp.asarray(_dft_matrix_ri(N)),
        pyr_mask=jnp.asarray(_pyr_mask_ri(N, alpha)),
        phasors=jnp.asarray(phasors.astype(np.float32)),
        pupil=jnp.asarray(pupil),
        valid=valid,
        reference_slopes=jnp.zeros(2 * int(valid.sum()), jnp.float32),
        slopes_units=jnp.float32(1.0),
        resolution=resolution, n_lenslet=n_lenslet, c=c)
    # reference slopes of the flat wavefront (pyramid.m INIT, :276-284)
    ref = raw_slopes(model, jnp.zeros((resolution, resolution),
                                      jnp.float32))
    return model._replace(reference_slopes=ref)


def intensity_map(model: PyramidModel, phase: jnp.ndarray) -> jnp.ndarray:
    """(R, R) phase [rad] -> (2 c nl, 2 c nl) binned detector image.

    The pyramid transform (pyramid.m:394-420): embed, modulate, fft2,
    mask, fft2, |.|^2, sum over the modulation circle, bin.
    """
    N = model.px_side
    R = model.resolution
    F = model.dft_op[0] + 1j * model.dft_op[1]
    mask = model.pyr_mask[0] + 1j * model.pyr_mask[1]
    wave = model.pupil * jnp.exp(1j * phase)
    lo = R * (2 * model.c - 1) // 2
    q = jnp.zeros((N, N), jnp.complex64).at[lo:lo + R, lo:lo + R].set(wave)

    def one_step(ph_ri):
        phasor = ph_ri[0] + 1j * ph_ri[1]
        buf = F @ (q * phasor) @ F
        buf = F @ (buf * mask) @ F
        return buf.real ** 2 + buf.imag ** 2

    inten = jnp.sum(jax.vmap(one_step)(model.phasors), axis=0)
    npx = 2 * model.c * model.n_lenslet
    b = N // npx
    return inten.reshape(npx, b, npx, b).sum(axis=(1, 3))


def raw_slopes(model: PyramidModel, phase: jnp.ndarray) -> jnp.ndarray:
    """Un-referenced slope vector [Sx_valid, Sy_valid]
    (pyramid.m:463-481, flux normalisation option 2)."""
    img = intensity_map(model, phase)
    h = model.c * model.n_lenslet
    I1 = img[:h, :h]          # top-left
    I2 = img[h:, :h]          # bottom-left
    I3 = img[h:, h:]          # bottom-right
    I4 = img[:h, h:]          # top-right
    vmask = jnp.asarray(model.valid)
    flux = jnp.sum((I1 + I2 + I3 + I4) * vmask) + 1e-20
    sy = (I1 - I2 + I4 - I3) / flux
    sx = (I1 - I4 + I2 - I3) / flux
    sel = jnp.nonzero(vmask.ravel(), size=model.n_valid)[0]
    return jnp.concatenate([sx.ravel()[sel], sy.ravel()[sel]])


def slopes(model: PyramidModel, phase: jnp.ndarray) -> jnp.ndarray:
    """Calibrated, reference-subtracted slopes (the sensor output)."""
    return (raw_slopes(model, phase) - model.reference_slopes) \
        * model.slopes_units


def gain_calibration(model: PyramidModel,
                     tilt_mode: jnp.ndarray) -> PyramidModel:
    """Set slopesUnits from a 5-point tilt ramp (pyramid.m:350-367).

    ``tilt_mode`` is a unit-amplitude tilt phase map (e.g. Zernike mode
    index 2, the y-tilt the reference pokes via zernike(3)).
    """
    amps = (np.arange(5) - 2) * 0.1
    sy = []
    for a in amps:
        s = slopes(model, jnp.float32(a) * tilt_mode)
        sy.append(float(jnp.mean(s[model.n_valid:])))
    gain = np.polyfit(4.0 * amps, np.asarray(sy), 1)[0]
    return model._replace(slopes_units=jnp.float32(1.0 / gain))


def interaction_matrix(model: PyramidModel, mode_stack: jnp.ndarray,
                       amplitude: float = 0.05) -> jnp.ndarray:
    """Poke-matrix calibration, symmetric +/- pokes -> (n_slopes, K)."""
    plus = jax.vmap(lambda m: slopes(model, amplitude * m))(mode_stack)
    minus = jax.vmap(lambda m: slopes(model, -amplitude * m))(mode_stack)
    return ((plus - minus) / (2.0 * amplitude)).T
