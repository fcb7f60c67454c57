"""Von Karman phase statistics.

Equivalent of the reference's `phaseStats` static class
(reference: OOMAO-master/phaseStats.m:6-39,194-209).  The PSD is
jnp-friendly (used inside jitted screen synthesis); covariance/variance use
the from-scratch K_{5/6} in utils.special and run either on host (numpy,
float64 -- used for setup-time covariance matrices) or on device.
"""

from __future__ import annotations

import math

import numpy as np

from ..utils.config import AtmosphereConfig
from ..utils.special import kv_frac

# (24 Gamma(6/5) / 5)^(5/6) appears in every constant (phaseStats.m:14,30,203)
_C24 = (24.0 * math.gamma(6.0 / 5.0) / 5.0) ** (5.0 / 6.0)
_VAR_CST = _C24 * math.gamma(11.0 / 6.0) * math.gamma(5.0 / 6.0) / (
    2.0 * math.pi ** (8.0 / 3.0))
_COV_CST = _C24 * math.gamma(11.0 / 6.0) / (
    2.0 ** (5.0 / 6.0) * math.pi ** (8.0 / 3.0))
_PSD_CST = _C24 * math.gamma(11.0 / 6.0) ** 2 / (2.0 * math.pi ** (11.0 / 3.0))


def _frac_sum(atm: AtmosphereConfig) -> float:
    return float(sum(atm.fractional_r0))


def variance(atm: AtmosphereConfig) -> float:
    """Phase variance [rad^2] (phaseStats.m:6-18)."""
    return _VAR_CST * (atm.L0 / atm.r0) ** (5.0 / 3.0) * _frac_sum(atm)


def covariance(rho, atm: AtmosphereConfig, xp=np):
    """Phase covariance at separation rho [m] (phaseStats.m:20-39)."""
    rho = xp.asarray(rho)
    L0r0 = (atm.L0 / atm.r0) ** (5.0 / 3.0)
    var = _VAR_CST * L0r0
    u = 2.0 * math.pi * rho / atm.L0
    safe_u = xp.where(u > 0, u, xp.ones_like(u))
    cov = _COV_CST * L0r0 * safe_u ** (5.0 / 6.0) * kv_frac(5.0 / 6.0, safe_u, xp)
    out = xp.where(u > 0, cov, var)
    return out * _frac_sum(atm)


def structure_function(rho, atm: AtmosphereConfig, xp=np):
    """D_phi(rho) = 2 (var - cov) (phaseStats.m:186-190)."""
    return 2.0 * (variance(atm) - covariance(rho, atm, xp))


def spectrum(f, atm: AtmosphereConfig, xp=np):
    """Phase PSD at spatial frequency f [1/m] (phaseStats.m:194-209).

    W(f) = cst r0^{-5/3} (f^2 + 1/L0^2)^{-11/6}, scaled by the layer
    fractional-r0 sum.  Works on numpy or jax.numpy arrays.
    """
    f = xp.asarray(f)
    out = _PSD_CST * atm.r0 ** (-5.0 / 3.0) * (
        f * f + 1.0 / atm.L0 ** 2) ** (-11.0 / 6.0)
    return out * _frac_sum(atm)


def _layer_sum(atm: AtmosphereConfig, fn) -> np.ndarray:
    """Sum fn(single-layer slab, i) over layers (atmosphere.m:169 slab)."""
    out = 0.0
    for i in range(atm.n_layers):
        out = out + fn(atm.layer(i), i)
    return out


def angular_covariance(theta, atm: AtmosphereConfig, xp=np):
    """Phase angular covariance at field-angle separation theta [rad]
    (phaseStats.m:62-76): per layer, covariance at rho = h tan(theta)."""
    theta = xp.asarray(theta)
    return _layer_sum(atm, lambda slab, i: covariance(
        slab.altitudes[0] * xp.tan(theta), slab, xp))


def angular_structure_function(theta, atm: AtmosphereConfig, xp=np):
    """(phaseStats.m:77-92)."""
    theta = xp.asarray(theta)
    return _layer_sum(atm, lambda slab, i: 2.0 * (
        variance(slab) - covariance(slab.altitudes[0] * xp.tan(theta),
                                    slab, xp)))


def temporal_covariance(tau, atm: AtmosphereConfig, xp=np):
    """Phase temporal covariance at delay tau [s] under frozen flow
    (phaseStats.m:94-108): per layer, covariance at rho = v tau."""
    tau = xp.asarray(tau)
    return _layer_sum(atm, lambda slab, i: covariance(
        slab.wind_speeds[0] * tau, slab, xp))


def temporal_structure_function(tau, atm: AtmosphereConfig, xp=np):
    """(phaseStats.m:109-124)."""
    tau = xp.asarray(tau)
    return _layer_sum(atm, lambda slab, i: 2.0 * (
        variance(slab) - covariance(slab.wind_speeds[0] * tau, slab, xp)))


# --------------------------------------------------- derived scalar quantities
# The atmosphere "observables" (reference: atmosphere.m:296-374).

RADIAN2ARCSEC = 180.0 / math.pi * 3600.0


def _decay(coherence_decay) -> float:
    """coherenceFunctionDecay conventions (atmosphere.m:303-317):
    'roddier' = exp(-1) (default), 'fried' = exp(-1/2), or numeric."""
    if coherence_decay == "roddier":
        return math.exp(-1.0)
    if coherence_decay == "fried":
        return math.exp(-0.5)
    return float(coherence_decay)


def seeing_arcsec(atm: AtmosphereConfig) -> float:
    """Seeing FWHM = 0.98 lambda / r0 [arcsec] (atmosphere.m:297-300)."""
    return RADIAN2ARCSEC * 0.98 * atm.wavelength / atm.r0


def _sf_root(sf_fn, target: float) -> float:
    """Smallest x > 0 with sf_fn(x) = target (the reference's fzero,
    atmosphere.m:330,349).  sf is monotone from 0 to 2 var; returns inf
    if the target is never reached."""
    import scipy.optimize
    hi = 1e-6
    for _ in range(80):
        if sf_fn(hi) >= target:
            break
        hi *= 2.0
    else:
        return math.inf
    return float(scipy.optimize.brentq(lambda x: sf_fn(x) - target,
                                       hi / 2.0 if hi > 1e-6 else 0.0,
                                       hi, xtol=1e-12, rtol=1e-12))


def theta0_arcsec(atm: AtmosphereConfig,
                  coherence_decay="roddier") -> float:
    """Isoplanatic angle [arcsec] (atmosphere.m:319-334).

    Kolmogorov (L0 = inf): closed form
    theta0 = (-ln(decay) (24 Gamma(6/5)/5)^(-5/6) r0^{5/3}
              / sum_l fr0_l z_l^{5/3})^{3/5};
    Von Karman: root of the angular structure function hitting
    -2 ln(decay).
    """
    z = atm.altitudes
    if all(h == 0 for h in z):
        return math.inf
    decay = _decay(coherence_decay)
    if math.isinf(atm.L0):
        cst = (-math.log(decay) * (24.0 * math.gamma(6.0 / 5.0) / 5.0)
               ** (-5.0 / 6.0) * atm.r0 ** (5.0 / 3.0))
        s = sum(f * h ** (5.0 / 3.0)
                for f, h in zip(atm.fractional_r0, z))
        out = (cst / s) ** (3.0 / 5.0)
    else:
        out = _sf_root(
            lambda x: float(angular_structure_function(x, atm)),
            -2.0 * math.log(decay))
    return out * RADIAN2ARCSEC


def tau0_ms(atm: AtmosphereConfig, coherence_decay="roddier") -> float:
    """Coherence time [ms] (atmosphere.m:337-353)."""
    v = atm.wind_speeds
    if len(v) == 1 and v[0] == 0:
        return math.inf
    decay = _decay(coherence_decay)
    if math.isinf(atm.L0):
        cst = (-math.log(decay) * (24.0 * math.gamma(6.0 / 5.0) / 5.0)
               ** (-5.0 / 6.0) * atm.r0 ** (5.0 / 3.0))
        s = sum(f * w ** (5.0 / 3.0)
                for f, w in zip(atm.fractional_r0, v))
        out = (cst / s) ** (3.0 / 5.0)
    else:
        out = _sf_root(
            lambda x: float(temporal_structure_function(x, atm)),
            -2.0 * math.log(decay))
    return out * 1e3


def mean_height(atm: AtmosphereConfig) -> float:
    """fr0-weighted 5/3-moment height [m] (atmosphere.m:356-360)."""
    return sum(f * h ** (5.0 / 3.0) for f, h in
               zip(atm.fractional_r0, atm.altitudes)) ** (3.0 / 5.0)


def mean_wind(atm: AtmosphereConfig) -> float:
    """fr0-weighted 5/3-moment wind speed [m/s] (atmosphere.m:362-366)."""
    return sum(f * v ** (5.0 / 3.0) for f, v in
               zip(atm.fractional_r0, atm.wind_speeds)) ** (3.0 / 5.0)


def greenwood_frequency(atm: AtmosphereConfig) -> float:
    """f_G = 0.4292 meanWind / r0 [Hz] (atmosphere.m:368-374)."""
    return 0.4292 * mean_wind(atm) / atm.r0


def covariance_matrix(points1: np.ndarray, points2: np.ndarray,
                      atm: AtmosphereConfig) -> np.ndarray:
    """Dense covariance between two complex-coded point sets [m].

    Host float64 equivalent of phaseStats.covarianceMatrix
    (phaseStats.m:305-371); used at setup time for the conditional-Gaussian
    screen-extension operators (telescopeAbstract.m:854-884).
    """
    p1 = np.asarray(points1, dtype=np.complex128).ravel()
    p2 = np.asarray(points2, dtype=np.complex128).ravel()
    rho = np.abs(p1[:, None] - p2[None, :])
    return covariance(rho, atm, np)
