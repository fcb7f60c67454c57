"""Von Karman phase-screen synthesis and frozen-flow evolution.

Re-design of the reference turbulence engine
(reference: atmosphere.m:423-475 `fourierPhaseScreen`,
telescopeAbstract.m:288-372 frozen-flow `update`):

* each layer gets ONE oversampled periodic FFT screen (the reference also
  synthesizes on a 4x oversampled grid, atmosphere.m:447), with optional
  subharmonic low-frequency compensation (the reference ships the same idea
  as `fourierSubHarmonicPhaseScreen`, atmosphere.m:518-591);
* frozen flow becomes *sampling*: the pupil window slides across the
  periodic screen along the wind vector, implemented as a roll + 4-tap
  bilinear blend -- replacing the reference's data-dependent
  conditional-Gaussian edge extension + interpolation
  (telescopeAbstract.m:335-353), which cannot be expressed as a fixed-shape
  XLA program.  Periodicity substitutes for the reference's stochastic
  extension; statistics inside the window follow the sampled Von Karman
  PSD exactly and are validated against phaseStats analytics in tests;
* multi-layer projection for the on-axis NGS is a plain sum
  (telescopeAbstract.m:446-447 fast path), piston-removed downstream
  (stochasticWave.m:132-142).

Everything is fixed-shape, jit/vmap/scan-friendly; `jax.random` keys
replace the reference's dedicated rngStream (atmosphere.m:66-68).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import AtmosphereConfig, TelescopeConfig
from . import phase_stats


class FrozenFlowLayers(NamedTuple):
    """Per-layer periodic screens + wind stepping (device arrays).

    screens:   (L, Ns, Ns) phase screens [rad].
    step_px:   (L, 2) wind displacement per time step in (row, col) pixels.
    """

    screens: jnp.ndarray
    step_px: jnp.ndarray

    @property
    def n_layers(self) -> int:
        return self.screens.shape[0]

    @property
    def screen_size(self) -> int:
        return self.screens.shape[-1]


def synthesize_screen(
    key,
    atm: AtmosphereConfig,
    n_pixels: int,
    pitch: float,
    oversample: int | None = None,
    subharmonic_levels: int | None = None,
    method: str = "fourier",
    dtype=jnp.float32,
) -> jnp.ndarray:
    """One Von Karman screen, (os*n_pixels)^2, periodic.

    Methods (mirroring the reference's synthesis family):
      "fourier":  fourierPhaseScreen (atmosphere.m:449-474):
                  map = real(ifft2(psdRoot .* fft2(randn(N))/N)) * N^2 * df,
                  plus subharmonic patches below the fundamental frequency;
      "straight": fourierPhaseScreenStraight (atmosphere.m:476-516):
                  complex spectral draws, DC zeroed, no oversampling gain;
      "cholesky": choleskyPhaseScreen (atmosphere.m:593-641): exact dense
                  covariance factorization -- small grids only
                  (O(N^4) memory), no periodicity.
    ``atm`` should be a single-layer slab (atm.layer(i)) so the fractional
    r0 weighting is per layer.
    """
    if oversample is None:
        oversample = atm.oversample
    if subharmonic_levels is None:
        subharmonic_levels = atm.subharmonic_levels
    if method == "cholesky":
        return _cholesky_screen(key, atm, oversample * n_pixels, pitch)
    if method == "straight":
        return _straight_screen(key, atm, oversample * n_pixels, pitch)
    if method != "fourier":
        raise ValueError(f"unknown screen method '{method}'")
    N = oversample * n_pixels
    extent = N * pitch
    df = 1.0 / extent

    # Host-side synthesis: screens are set-up artifacts; the per-step hot
    # path never FFTs (frozen flow is sampling, PSFs are partial DFTs).
    fx = np.fft.fftfreq(N, d=pitch)
    fr = np.sqrt(fx[:, None] ** 2 + fx[None, :] ** 2)
    psd_root = np.sqrt(phase_stats.spectrum(fr, atm, np))
    # zero DC: the fundamental patch of the subharmonics (or piston removal)
    # covers it (cf. fourierPhaseScreenStraight, atmosphere.m:505)
    psd_root[0, 0] = 0.0

    rng = _host_rng(key)
    w = rng.standard_normal((N, N))
    c = np.fft.fft2(w) / N
    screen = np.real(np.fft.ifft2(psd_root * c)) * (N * N) * df

    if subharmonic_levels > 0:
        screen = screen + _subharmonics(
            rng, atm, N, pitch, df, subharmonic_levels)
    return np.asarray(screen, dtype=np.float32)


def _straight_screen(key, atm: AtmosphereConfig, N: int,
                     pitch: float) -> np.ndarray:
    """fourierPhaseScreenStraight (atmosphere.m:476-516): independent
    complex spectral draws cn = (randn + i randn) sqrt(PSD) df, DC zeroed,
    out = real(ifftshift(ifft2(ifftshift(cn)))) N^2."""
    rng = _host_rng(key)
    del_f = 1.0 / (N * pitch)
    fx = (np.arange(N) - N // 2) * del_f
    f = np.hypot(fx[:, None], fx[None, :])
    psd = phase_stats.spectrum(f, atm, np)
    psd[N // 2, N // 2] = 0.0
    cn = ((rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N)))
          * np.sqrt(psd) * del_f)
    out = np.real(np.fft.ifftshift(np.fft.ifft2(np.fft.ifftshift(cn)))) * N * N
    return np.asarray(out, dtype=np.float32)


def _cholesky_screen(key, atm: AtmosphereConfig, N: int,
                     pitch: float) -> np.ndarray:
    """choleskyPhaseScreen (atmosphere.m:593-641): exact sampling via a
    dense covariance Cholesky factor; O(N^4) -- small N only."""
    if N > 96:
        raise ValueError("cholesky screens are O(N^4); use N<=96")
    rng = _host_rng(key)
    ax = np.arange(N) * pitch
    pts = (ax[:, None] + 1j * ax[None, :]).ravel()
    C = phase_stats.covariance_matrix(pts, pts, atm)
    L = np.linalg.cholesky(C + 1e-9 * np.eye(N * N))
    return np.asarray((L @ rng.standard_normal(N * N)).reshape(N, N),
                      dtype=np.float32)


def _host_rng(key) -> np.random.Generator:
    """Deterministic host RNG from an int seed or a JAX PRNG key.

    Screens are host-side set-up artifacts, so set-up accepts plain
    seeds as well as keys."""
    if isinstance(key, (int, np.integer)):
        entropy = [int(key)]
    else:
        entropy = [int(v) for v in
                   np.asarray(jax.random.key_data(key)).ravel()]
    return np.random.default_rng(np.random.SeedSequence(entropy))


def _subharmonics(rng: np.random.Generator, atm: AtmosphereConfig, N: int,
                  pitch: float, df: float, levels: int) -> np.ndarray:
    """Low-frequency compensation patches (Lane et al. 1992 method; the
    reference's equivalent is fourierSubHarmonicPhaseScreen,
    atmosphere.m:518-591).  Host-side (setup time).

    For each level l, a 3x3 grid of frequencies at spacing df/3^l replaces
    the coarser cell it subdivides; modes whose cell is covered by a deeper
    level (the central 1/3 block) are skipped, as is DC.
    """
    x = np.arange(N) * pitch
    XX = x[:, None, None].transpose(2, 0, 1)   # (1, N, 1)
    YY = x[None, None, :]                      # (1, 1, N)
    total = np.zeros((N, N))
    for lvl in range(1, levels + 1):
        df_l = df / (3.0 ** lvl)
        freqs = [(p * df_l, q * df_l)
                 for p in (-1, 0, 1) for q in (-1, 0, 1)
                 if not (p == 0 and q == 0)]  # center: next level's cell
        f = np.asarray(freqs)                                   # (8, 2)
        amp = np.sqrt(
            phase_stats.spectrum(np.hypot(f[:, 0], f[:, 1]), atm, np)
        ) * df_l
        a = rng.standard_normal(f.shape[0]) * amp
        b = rng.standard_normal(f.shape[0]) * amp
        phase_arg = 2.0 * math.pi * (XX * f[:, 0:1, None]
                                     + YY * f[:, 1:2, None])
        total = total + np.sum(
            a[:, None, None] * np.cos(phase_arg)
            + b[:, None, None] * np.sin(phase_arg), axis=0)
    return total


def make_layers(
    key,
    atm: AtmosphereConfig,
    tel: TelescopeConfig,
    cover_steps: int | None = None,
    max_screen: int = 4096,
    dtype=jnp.float32,
) -> FrozenFlowLayers:
    """Build all layer screens + per-step pixel shifts.

    Wind shift per step: v * dt / pitch pixels along (cos, sin) of the wind
    direction (telescopeAbstract.m:322-372 leap bookkeeping becomes a
    plain float displacement).

    ``cover_steps``: size the screens so a rollout of that many steps never
    revisits screen area (the role of the reference's conditional-Gaussian
    edge extension, telescopeAbstract.m:335-342, without its finite
    conditioning window).  None -> the default periodic oversampled screen
    (wrap after ~os*R/|d| steps).  Capped at ``max_screen`` px per side.
    """
    R = tel.resolution
    pitch = tel.pixel_pitch
    if isinstance(key, (int, np.integer)):
        seeds = [int(key) * 1000003 + i for i in range(atm.n_layers)]
    else:
        data = np.asarray(jax.random.key_data(key)).astype(np.uint64).ravel()
        seeds = [int(data[-1]) * 1000003 + i for i in range(atm.n_layers)]
    steps = []
    for i in range(atm.n_layers):
        v = atm.wind_speeds[i]
        th = atm.wind_directions[i]
        dpx = v * tel.sampling_time / pitch
        steps.append((dpx * math.sin(th), dpx * math.cos(th)))  # (row, col)

    oversample = atm.oversample
    if cover_steps is not None:
        max_d = max(max(abs(sy), abs(sx)) for sy, sx in steps)
        need = R + 2 + int(math.ceil(cover_steps * max_d))
        need = min(need, max_screen)
        oversample = max(oversample, int(math.ceil(need / R)))

    screens = []
    for i in range(atm.n_layers):
        slab = atm.layer(i)
        scr = np.asarray(synthesize_screen(seeds[i], slab, R, pitch,
                                           oversample=oversample,
                                           dtype=dtype))
        # wrap-pad by the window size so per-step sampling is a plain
        # dynamic_slice (no runtime modular gather)
        scr = np.pad(scr, ((0, R + 1), (0, R + 1)), mode="wrap")
        screens.append(scr)
    return FrozenFlowLayers(
        screens=jnp.asarray(np.stack(screens), dtype=dtype),
        step_px=jnp.asarray(np.asarray(steps), dtype=dtype),
    )


def _bilinear_window(screen: jnp.ndarray, offset_rc, size: int) -> jnp.ndarray:
    """Periodic bilinear sampling of a (size, size) window at float offset.

    Equivalent role to the reference's `linear` interpolator
    (telescopeAbstract.m:1011-1062), but on a periodic screen: integer part
    handled by jnp.roll (wraps), fractional part by a 4-tap blend.
    """
    N = screen.shape[0] - (size + 1)   # period of the wrap-padded screen
    oy, ox = offset_rc[0], offset_rc[1]
    iy = jnp.floor(oy).astype(jnp.int32)
    ix = jnp.floor(ox).astype(jnp.int32)
    fy = (oy - iy).astype(screen.dtype)
    fx = (ox - ix).astype(screen.dtype)
    # screens are wrap-padded by size+1 (make_layers), so a single
    # dynamic_slice at the wrapped start covers the whole window
    w = jax.lax.dynamic_slice(
        screen, (jnp.mod(iy, N), jnp.mod(ix, N)), (size + 1, size + 1))
    return ((1 - fy) * (1 - fx) * w[:size, :size]
            + (1 - fy) * fx * w[:size, 1:]
            + fy * (1 - fx) * w[1:, :size]
            + fy * fx * w[1:, 1:])


def phase_at(layers: FrozenFlowLayers, step, resolution: int) -> jnp.ndarray:
    """Summed multi-layer pupil phase at (traced) time step index.

    `step` may be float; the window slides continuously.  Equivalent of
    +tel / relay for a single on-axis NGS (telescopeAbstract.m:384-395,
    446-447).  NOT piston-removed (apply zernike.piston_removed_phase).
    """
    offsets = layers.step_px * jnp.asarray(step, dtype=layers.step_px.dtype)

    def one(screen, off):
        return _bilinear_window(screen, off, resolution)

    return jnp.sum(jax.vmap(one)(layers.screens, offsets), axis=0)
