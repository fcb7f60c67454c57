"""Spatial-frequency AO error budget (Fourier AO analytics).

Equivalent of the reference's bundled-but-unused
`fourierAdaptiveOptics.m` (400 LoC, SURVEY.md 2d): the analytic
decomposition of a closed-loop AO system's residual-phase power spectrum
into fitting / noise / aliasing / servo-lag / anisoplanatism terms, the
closed-loop temporal rejection transfer functions, error-variance
integrals, and the long-exposure PSF reconstructed from the residual PSD.

These are design-time analytics (choose actuator count, loop gain, frame
rate before running the Monte-Carlo framework), so they follow the repo's
host-compute convention: numpy float64 on the host, no device work.  The
heavy Monte-Carlo validation of what these formulas predict runs on the
accelerator through models/pipeline.py.

Reference semantics replicated (file:line in fourierAdaptiveOptics.m):

* fc = 0.5 (nActuator-1)/D                                   (:53-55)
* pistonFilter(f) = 1 - 4 (J1(pi D f)/(pi D f))^2            (:277-281,
  utilities.m:334-337 `sombrero`)
* fittingPSD: atmospheric PSD outside the correction box     (:61-71)
* noisePSD: sigma^2/(2 pi f sinc(fx/2fc) sinc(fy/2fc))^2 in-box,
  filtered by the closed-loop noise TF                       (:73-85)
* aliasingPSD: PSD replicas folded at 2 l fc with the geometric
  gradient-sensing weight 0.25 sin(2 fo)^2 (fx/fmy + fy/flx)^2,
  filtered by the closed-loop aliasing TF                    (:87-138)
* servoLagPSD: in-box PSD times the average rejection TF     (:139-151)
* anisoplanatismPSD: sum_l fr0_l (1-cos(2 pi h_l f.theta))   (:153-165)
* closed-loop TFs with red = g sinc(nu T)/(2 pi nu T):
  rejection 1/(1+red^2-2 red sin(2 pi nu (T+tau))), aliasing
  red^2/(same), noise (red/sinc)^2/(same)                    (:283-331)
* averageRejection: per-layer temporal frequency nu = f . v,
  fr0-weighted sum over layers                               (:336-344)
* variance integrals varFitting/varServoLag/varNoise         (:179-195)
* image(): sf = 2 (FT[psd](0) - FT[psd]), OTF_AO = OTF_tel
  exp(-sf/2), PSF by inverse FFT; Strehl = sum(OTF_AO)/sum(OTF_tel)
                                                             (:201-260)
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy.special import j1

from ..utils.config import AtmosphereConfig
from . import phase_stats, telescope_optics


@dataclasses.dataclass(frozen=True)
class FourierAOConfig:
    """AO system description (fourierAdaptiveOptics.m:34-51)."""

    diameter: float
    atm: AtmosphereConfig
    n_actuator: int
    noise_variance: float = 0.0     # slope-noise variance [rad^2]
    loop_gain: float = 0.5
    exposure_time: float = 1.0 / 200.0   # WFS integration T [s]
    latency: float = 0.0                 # pure loop delay tau [s]

    @property
    def fc(self) -> float:
        """DM correction cutoff [1/m] (fourierAdaptiveOptics.m:53-55)."""
        return 0.5 * (self.n_actuator - 1) / self.diameter


def _sinc(x):
    """MATLAB/tools.sinc convention: sin(pi x)/(pi x), 1 at 0."""
    return np.sinc(x)


def piston_filter(cfg: FourierAOConfig, f):
    """1 - 4 sombrero(1, pi D f)^2 (fourierAdaptiveOptics.m:277-281)."""
    f = np.asarray(f, dtype=np.float64)
    u = np.pi * cfg.diameter * f
    som = np.full(u.shape, 0.5)        # lim_{x->0} J1(x)/x = 1/2
    nz = u != 0
    som[nz] = j1(u[nz]) / u[nz]
    return 1.0 - 4.0 * som ** 2


# ---------------------------------------------------------------- temporal TFs

def _red(cfg: FourierAOConfig, nu):
    return cfg.loop_gain * _sinc(nu * cfg.exposure_time) / (
        2.0 * np.pi * nu * cfg.exposure_time)


def closed_loop_rejection(cfg: FourierAOConfig, nu):
    """|E(nu)|^2 residual rejection (fourierAdaptiveOptics.m:283-292)."""
    nu = np.asarray(nu, dtype=np.float64)
    out = np.zeros(nu.shape)
    idx = nu != 0
    red = _red(cfg, nu[idx])
    out[idx] = 1.0 / (1.0 + red ** 2 - 2.0 * red * np.sin(
        2.0 * np.pi * nu[idx] * (cfg.exposure_time + cfg.latency)))
    return out


def closed_loop_aliasing(cfg: FourierAOConfig, nu):
    """Aliasing propagation TF (fourierAdaptiveOptics.m:301-310)."""
    nu = np.asarray(nu, dtype=np.float64)
    out = np.ones(nu.shape)
    idx = nu != 0
    red = _red(cfg, nu[idx])
    out[idx] = red ** 2 / (1.0 + red ** 2 - 2.0 * red * np.sin(
        2.0 * np.pi * nu[idx] * (cfg.exposure_time + cfg.latency)))
    return out


def closed_loop_noise(cfg: FourierAOConfig, nu):
    """Noise propagation TF (fourierAdaptiveOptics.m:319-328).

    The reference computes (red/sinc(nu T))^2, which is 0/0 at every
    nu = k/T; since red = g sinc(nu T)/(2 pi nu T), the sinc cancels
    analytically -- red/sinc = g/(2 pi nu T) -- so we use that closed
    form (the limit value) instead of dividing, keeping the automated
    trapezoid integrals in variance_integral finite (deliberate fix of
    the reference's 0/0 quirk)."""
    nu = np.asarray(nu, dtype=np.float64)
    out = np.ones(nu.shape)
    idx = nu != 0
    red = _red(cfg, nu[idx])
    red_over_sinc = cfg.loop_gain / (
        2.0 * np.pi * nu[idx] * cfg.exposure_time)
    out[idx] = red_over_sinc ** 2 / (
        1.0 + red ** 2 - 2.0 * red * np.sin(
            2.0 * np.pi * nu[idx] * (cfg.exposure_time + cfg.latency)))
    return out


def _average_tf(cfg: FourierAOConfig, fx, fy, fun):
    """fr0-weighted layer sum at nu_l = f . v_l
    (fourierAdaptiveOptics.m:336-344 `averageRejection`).

    The reference uses the RAW fractionnalR0 weights (no normalization),
    so with weights that do not sum to 1 (e.g. the pipeline's
    [0.7,0.1,0.2]/25 config, README.md:45-49) the "average" is scaled by
    sum(fr0) -- replicated exactly here."""
    atm = cfg.atm
    E = np.zeros(np.shape(fx))
    for vs, vd, fr0 in zip(atm.wind_speeds, atm.wind_directions,
                           atm.fractional_r0):
        vx, vy = vs * math.cos(vd), vs * math.sin(vd)
        nu = fx * vx + fy * vy
        E = E + fr0 * fun(cfg, nu)
    return E


# ----------------------------------------------------------------- PSD terms

def fitting_psd(cfg: FourierAOConfig, fx, fy):
    """Uncorrectable high-frequency PSD (fourierAdaptiveOptics.m:61-71)."""
    fx = np.asarray(fx, dtype=np.float64)
    fy = np.asarray(fy, dtype=np.float64)
    out = np.zeros(fx.shape)
    idx = (np.abs(fx) > cfg.fc) | (np.abs(fy) > cfg.fc)
    f = np.hypot(fx[idx], fy[idx])
    out[idx] = phase_stats.spectrum(f, cfg.atm)
    return out * piston_filter(cfg, np.hypot(fx, fy))


def noise_psd(cfg: FourierAOConfig, fx, fy):
    """Propagated WFS noise PSD (fourierAdaptiveOptics.m:73-85)."""
    fx = np.asarray(fx, dtype=np.float64)
    fy = np.asarray(fy, dtype=np.float64)
    out = np.zeros(fx.shape)
    if cfg.noise_variance <= 0:
        return out
    fc = cfg.fc
    idx = ~((np.abs(fx) > fc) | (np.abs(fy) > fc)) & (np.hypot(fx, fy) > 0)
    f = np.hypot(fx[idx], fy[idx])
    out[idx] = cfg.noise_variance / (
        2.0 * np.pi * f * _sinc(0.5 * fx[idx] / fc)
        * _sinc(0.5 * fy[idx] / fc)) ** 2
    return out * _average_tf(cfg, fx, fy, closed_loop_noise) \
        * piston_filter(cfg, np.hypot(fx, fy))


def aliasing_psd(cfg: FourierAOConfig, fx, fy, n_fold: int = 5):
    """Gradient-sensing aliasing PSD (fourierAdaptiveOptics.m:87-138).

    Sums the (2 n_fold+1)^2 - 1 spectral replicas displaced by 2 l fc,
    each weighted by the geometric gradient-aliasing factor
    0.25 sin(2 fo)^2 (fx/fmy + fy/flx)^2; pure-axis replicas (l=0 or
    m=0 at the singular points) fold with weight 1.
    """
    fx = np.asarray(fx, dtype=np.float64)
    fy = np.asarray(fy, dtype=np.float64)
    fc = cfg.fc
    out = np.zeros(fx.shape)
    idx = ~((np.abs(fx) > fc) | (np.abs(fy) > fc))
    pf = piston_filter(cfg, np.hypot(fx, fy))
    fxi, fyi = fx[idx], fy[idx]
    fo = np.arctan2(fyi, fxi)
    al = np.zeros(fxi.shape)
    w_geom = 0.25 * np.sin(2.0 * fo) ** 2

    def replica(l, m):
        flx = fxi - 2 * l * fc
        fmy = fyi - 2 * m * fc
        flm = np.hypot(flx, fmy)
        spec = phase_stats.spectrum(flm, cfg.atm)
        if l != 0 and m != 0:
            return w_geom * (fxi / fmy + fyi / flx) ** 2 * spec
        # on-axis replica rows: where the displaced axis frequency is
        # exactly zero the geometric weight degenerates to 1 (:114-135)
        zero = flx == 0 if l == 0 else fmy == 0
        r = np.zeros(fxi.shape)
        r[zero] = spec[zero]
        nz = ~zero
        with np.errstate(divide="ignore", invalid="ignore"):
            g = w_geom[nz] * (fxi[nz] / fmy[nz] + fyi[nz] / flx[nz]) ** 2
        r[nz] = g * spec[nz]
        return r

    rng = [v for v in range(-n_fold, n_fold + 1) if v != 0]
    for l in rng:
        for m in rng:
            al += replica(l, m)
    for m in rng:                     # l = 0 row (:113-124)
        al += replica(0, m)
    for l in rng:                     # m = 0 row (:125-135)
        al += replica(l, 0)
    out[idx] = al * _average_tf(cfg, fxi, fyi, closed_loop_aliasing)
    return out * pf


def servo_lag_psd(cfg: FourierAOConfig, fx, fy):
    """Temporal-error PSD (fourierAdaptiveOptics.m:139-151)."""
    fx = np.asarray(fx, dtype=np.float64)
    fy = np.asarray(fy, dtype=np.float64)
    out = np.zeros(fx.shape)
    idx = ~((np.abs(fx) > cfg.fc) | (np.abs(fy) > cfg.fc))
    out[idx] = phase_stats.spectrum(np.hypot(fx[idx], fy[idx]), cfg.atm) \
        * _average_tf(cfg, fx[idx], fy[idx], closed_loop_rejection)
    return out * piston_filter(cfg, np.hypot(fx, fy))


def anisoplanatism_psd(cfg: FourierAOConfig, fx, fy, direction):
    """Off-axis decorrelation PSD for a source offset ``direction``
    = (theta_x, theta_y) [rad] (fourierAdaptiveOptics.m:153-165).

    Raw fractionnalR0 weights, like the reference (see _average_tf)."""
    fx = np.asarray(fx, dtype=np.float64)
    fy = np.asarray(fy, dtype=np.float64)
    atm = cfg.atm
    A = np.zeros(fx.shape)
    for h, fr0 in zip(atm.altitudes, atm.fractional_r0):
        red = 2.0 * np.pi * h * (fx * direction[0] + fy * direction[1])
        A = A + fr0 * (1.0 - np.cos(red))
    f = np.hypot(fx, fy)
    return piston_filter(cfg, f) * A * phase_stats.spectrum(f, cfg.atm)


def power_spectrum_density(cfg: FourierAOConfig, fx, fy, direction=None):
    """Total residual PSD (fourierAdaptiveOptics.m:167-177)."""
    out = fitting_psd(cfg, fx, fy) + noise_psd(cfg, fx, fy) \
        + aliasing_psd(cfg, fx, fy) + servo_lag_psd(cfg, fx, fy)
    if direction is not None:
        out = out + anisoplanatism_psd(cfg, fx, fy, direction)
    return out


# ---------------------------------------------------------- variance budget

def _box_quad(cfg: FourierAOConfig, fun, n: int = 512):
    """Trapezoid quadrature of fun(fx,fy) over the correction box."""
    g = np.linspace(-cfg.fc, cfg.fc, n)
    fx, fy = np.meshgrid(g, g)
    v = fun(fx, fy)
    return float(np.trapezoid(np.trapezoid(v, g, axis=1), g))


def var_fitting(cfg: FourierAOConfig, n: int = 512) -> float:
    """Fitting variance: atmospheric power outside the correction box
    [rad^2] (fourierAdaptiveOptics.m:179-185).

    The reference computes total - dblquad(in-box); a fixed grid cannot
    resolve the von Karman peak at f ~ 1/L0 << fc, so here the outside-
    box integral is split into the exact radial tail beyond the
    circumscribed circle f > sqrt(2) fc,

        2 pi cst (3/5) (2 fc^2 + 1/L0^2)^{-5/6},

    (antiderivative of f (f^2 + 1/L0^2)^{-11/6}) plus a smooth 2-D
    quadrature over the box-to-circle band, where the integrand has no
    singular structure.
    """
    atm = cfg.atm
    fc = cfg.fc
    cst = phase_stats.spectrum(np.array([1.0]), atm)[0] \
        * (1.0 + 1.0 / atm.L0 ** 2) ** (11.0 / 6.0)
    F2 = 2.0 * fc ** 2
    tail = 2.0 * np.pi * cst * 0.6 * (F2 + 1.0 / atm.L0 ** 2) ** (-5.0 / 6.0)
    s = math.sqrt(2.0) * fc
    g = np.linspace(-s, s, n)
    fx, fy = np.meshgrid(g, g)
    f = np.hypot(fx, fy)
    band = ((np.abs(fx) > fc) | (np.abs(fy) > fc)) & (f <= s)
    v = np.where(band, phase_stats.spectrum(np.maximum(f, fc), atm), 0.0)
    return tail + float(np.trapezoid(np.trapezoid(v, g, axis=1), g))


def var_servo_lag(cfg: FourierAOConfig) -> float:
    """(fourierAdaptiveOptics.m:187-190)."""
    return _box_quad(cfg, lambda fx, fy: servo_lag_psd(cfg, fx, fy))


def var_noise(cfg: FourierAOConfig) -> float:
    """(fourierAdaptiveOptics.m:192-195)."""
    return _box_quad(cfg, lambda fx, fy: noise_psd(cfg, fx, fy))


def var_total(cfg: FourierAOConfig, f_lim: float | None = None,
              n: int = 512) -> float:
    """Integral of the full residual PSD over [-f_lim, f_lim]^2
    (fourierAdaptiveOptics.m:197-199)."""
    if f_lim is None:
        f_lim = 2.0 * cfg.fc
    g = np.linspace(-f_lim, f_lim, n)
    fx, fy = np.meshgrid(g, g)
    v = power_spectrum_density(cfg, fx, fy)
    return float(np.trapezoid(np.trapezoid(v, g, axis=1), g))


# ------------------------------------------------------------------- imaging

def psf(cfg: FourierAOConfig, resolution: int, pixel_scale_mas: float):
    """Long-exposure AO PSF from the residual PSD; returns (psf, strehl)
    (fourierAdaptiveOptics.m:201-260).

    Host-side numpy FFT (set-up analytics that never run in the hot
    loop).
    """
    arcsec2rad = math.pi / 180.0 / 3600.0
    pixel_scale = pixel_scale_mas * 1e-3 * arcsec2rad / cfg.atm.wavelength

    half = np.fft.fftshift(np.fft.fftfreq(resolution)) * 2.0  # freqspace
    fx, fy = np.meshgrid(half * pixel_scale * resolution / 2,
                         half * pixel_scale * resolution / 2)
    psd = power_spectrum_density(cfg, fx, fy)
    sf = np.fft.fft2(np.fft.fftshift(psd)) * pixel_scale ** 2
    sf = 2.0 * np.fft.fftshift(sf.flat[0] - sf).real       # D_phi(rho)

    rho_x, rho_y = np.meshgrid(0.5 * half / pixel_scale,
                               0.5 * half / pixel_scale)
    rho = np.hypot(rho_x, rho_y)
    tel_otf = telescope_optics.diffraction_otf(rho, cfg.diameter)
    ao_otf = tel_otf * np.exp(-0.5 * sf)

    u, v = np.meshgrid(half, half)
    phasor = np.exp(1j * np.pi * (u + v) * 0.5)
    img = np.real(np.fft.ifftshift(np.fft.ifft2(
        np.fft.ifftshift(ao_otf * phasor)))) / pixel_scale ** 2
    img = img / (np.pi * cfg.diameter ** 2 / 4.0)
    strehl = float(ao_otf.sum() / tel_otf.sum())
    return img, strehl
