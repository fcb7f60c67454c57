"""Spatial MMSE wavefront reconstruction from Shack-Hartmann slopes.

Equivalent of the reference's `slopesLinearMMSE.m` (469 LoC,
SURVEY.md 2d): minimum-mean-square-error estimation of the pupil phase
on the (nl+1)^2 corner lattice from 2 nl^2 slope measurements,

    phi_hat = C_ox (C_xx + sigma^2 I)^{-1} s,

with both covariance operators Toeplitz-block-Toeplitz (stationary
turbulence statistics on regular lattices).  The reference stores the
TBT generators and solves with MINRES whose matvec is an FFT embedding
(slopesLinearMMSE.m:160-204, toeplitzBlockToeplitz.m:115-123); here the
operator apply is `ops.toeplitz.matvec` -- ONE 2-D convolution per block
that XLA lowers to one convolution kernel -- inside a jittable conjugate-gradient
loop (`lax.while_loop`), batched over scenarios with `vmap`.

Kernel construction (host-side numpy FFT at set-up; it runs once):
slopes are subaperture-averaged phase gradients, so in the frequency
domain the slope filters are  i 2 pi f_x sinc(d f_x) sinc(d f_y)  (and
y alike), giving (slopesLinearMMSE.m:289-341 `slopestoSlopesCovariance`)

    S_xx = (2 pi f_x)^2 sinc^2(d f_x) sinc^2(d f_y) W(f)
    S_xy = (2 pi)^2 f_x f_y sinc^2(d f_x) sinc^2(d f_y) W(f)

and the phase(corner)-to-slope cross spectra carry a single sinc pair
plus the half-subaperture offset phasor between the corner and lenslet-
center lattices (slopesLinearMMSE.m:350-378 `phaseToSlopesCovariance`,
the `0.5*d` phasor).  Kernels are sampled on the displacement lattice by
an sf-times oversampled FFT exactly like the reference (NF/sf grid,
slopesLinearMMSE.m:165-175,368-370).

Units: slopes in [rad/m] (mean physical phase gradient); phase in [rad].
`reconstruct` accepts the [rad/px] output of wfs.geometric_slopes with
its grid pitch and converts.

Off-axis science direction (mmseStar != guideStar): per-layer
displacement phasors exp(2 i pi h (dtheta . f)) inside the Cox kernel
quadrature, the reference's deltaSrc branch
(slopesLinearMMSE.m:119-127,363,380-410 for the layered NGS case).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import toeplitz
from ..utils import gridtools, hostcompute, struct
from ..utils.config import AtmosphereConfig
from ..ops import phase_stats


@struct.dataclass
class SlopesMMSE:
    """Precomputed TBT covariance operators (device arrays)."""

    cxx: toeplitz.TBTOperator      # <s_x s_x> on the nl^2 lattice
    cyy: toeplitz.TBTOperator
    cxy: toeplitz.TBTOperator
    cox: toeplitz.TBTOperator      # <phi s_x>, (nl+1)^2 x nl^2
    coy: toeplitz.TBTOperator
    noise_var: jnp.ndarray         # per-slope noise variance [rad^2/m^2]
    valid: jnp.ndarray             # (nl, nl) bool valid-lenslet map
    n_lenslet: int = struct.field(pytree_node=False)

    @property
    def n_phase(self) -> int:
        return (self.n_lenslet + 1) ** 2


def _kernels(atm: AtmosphereConfig, d: float, n_lenslet: int,
             nf: int = 512, sf: int = 4, mmse_dir=(0.0, 0.0),
             lag: float = 0.0):
    """Covariance kernels on the displacement lattices via oversampled
    FFT quadrature (slopesLinearMMSE.m:289-341,350-378).

    Returns (kxx, kyy, kxy) on the (2nl-1)^2 slope-displacement lattice
    and (kox, koy) on the 2nl x 2nl corner-to-center lattice.
    ``mmse_dir``: science-direction offset from the guide star [rad];
    each layer's Cox kernel gains the displacement phasor
    exp(2 i pi h (dtheta . f)) (the deltaSrc branch,
    slopesLinearMMSE.m:119-127,363).  ``lag`` [s]: frozen-flow temporal
    prediction -- the science phase is taken ``lag`` seconds AFTER the
    slopes, adding the per-layer wind displacement v*lag (the
    reference's CoxLag, linearMMSE.m:190-196 lag semantics).
    """
    cxx, cyy, cxy = _slope_kernels_pair(atm, d, n_lenslet, (0.0, 0.0),
                                        nf, sf)
    fx, fy, ff, delta, cov_of = _freq_grid(d, nf, sf)
    two_pi = 2.0 * np.pi

    # corner-phase to slope: corner lattice sits -d/2 off the lenslet
    # centers in both axes; the half-pixel lands on the oversampled
    # lattice when sf is even (offset sf/2), the reference's 0.5*d phasor
    assert sf % 2 == 0, "sf must be even (half-subaperture offset)"
    phasor_off = sf // 2
    b0 = nf // 2
    # cross spectrum S_{phi,sx} = U conj(V) W with U = 1 (phase) and
    # V = i 2 pi f_x sinc sinc (slope filter) -> the CONJUGATE flips the
    # sign (validated against empirical screen covariances)
    base_ox = (-1j * two_pi * fx) * np.sinc(d * fx) * np.sinc(d * fy)
    base_oy = (-1j * two_pi * fy) * np.sinc(d * fx) * np.sinc(d * fy)
    off_axis = (mmse_dir[0] != 0.0 or mmse_dir[1] != 0.0
                or lag != 0.0)
    if not off_axis:
        # spectrum is linear in fractional_r0: one combined-W transform
        W = phase_stats.spectrum(ff, atm)
        kox = cov_of(base_ox * W)
        koy = cov_of(base_oy * W)
    else:
        kox = np.zeros((nf, nf))
        koy = np.zeros((nf, nf))
        for il in range(atm.n_layers):
            slab = atm.layer(il)
            Wl = phase_stats.spectrum(ff, slab)
            h = slab.altitudes[0]
            v = slab.wind_speeds[0]
            wd = slab.wind_directions[0]
            # frozen flow: phi(t + lag) samples the layer at +v lag
            # along the wind (phase_screens.make_layers window
            # convention: x = v cos(dir), y = v sin(dir))
            sx_ = h * mmse_dir[0] + v * lag * np.cos(wd)
            sy_ = h * mmse_dir[1] + v * lag * np.sin(wd)
            phz = np.exp(2j * np.pi * (sx_ * fx + sy_ * fy))
            kox = kox + cov_of(base_ox * Wl * phz)
            koy = koy + cov_of(base_oy * Wl * phz)
    bo = (np.arange(-n_lenslet + 1, n_lenslet + 1) * sf - phasor_off + b0)
    kox = kox[np.ix_(bo, bo)]
    koy = koy[np.ix_(bo, bo)]
    return cxx, cyy, cxy, kox, koy


def build(atm: AtmosphereConfig, diameter: float, n_lenslet: int,
          valid, noise_var: float, nf: int = 512, sf: int = 4,
          mag: float = 1.0, mmse_dir=(0.0, 0.0),
          lag: float = 0.0) -> SlopesMMSE:
    """Build the reconstructor for an NGS guide star.

    ``valid``: (nl, nl) bool valid-lenslet map (wfs.SHModel.valid);
    ``noise_var``: per-slope measurement noise variance [rad^2/m^2];
    ``mag``: turbulence magnification (scales covariances by mag^2,
    README.md:277-284 semantics);
    ``mmse_dir``: (theta_x, theta_y) [rad] science direction relative to
    the guide star -- (0, 0) reconstructs the sensed direction, anything
    else the off-axis wavefront (anisoplanatic MMSE interpolation);
    ``lag`` [s]: predict the wavefront this long AFTER the measurement
    (frozen-flow temporal prediction, the CoxLag capability).
    """
    d = diameter / n_lenslet
    kxx, kyy, kxy, kox, koy = _kernels(atm, d, n_lenslet, nf, sf,
                                       mmse_dir=tuple(mmse_dir),
                                       lag=lag)
    m2 = float(mag) ** 2
    nl = n_lenslet
    return hostcompute.to_default(SlopesMMSE(
        cxx=toeplitz.build((nl, nl), (nl, nl), kxx * m2),
        cyy=toeplitz.build((nl, nl), (nl, nl), kyy * m2),
        cxy=toeplitz.build((nl, nl), (nl, nl), kxy * m2),
        cox=toeplitz.build((nl + 1, nl), (nl + 1, nl), kox * m2),
        coy=toeplitz.build((nl + 1, nl), (nl + 1, nl), koy * m2),
        noise_var=jnp.asarray(noise_var, dtype=jnp.float32),
        valid=jnp.asarray(np.asarray(valid, dtype=bool)),
        n_lenslet=nl,
    ))


def _apply_cxx(model: SlopesMMSE, v: jnp.ndarray) -> jnp.ndarray:
    """(C_xx + sigma^2 I) v on the masked full lattice, v = (2 nl^2,).

    Invalid-lenslet entries are zeroed in and out (the reference's
    mtimes4squareBlocks validLenslet masking) with the noise diagonal
    keeping those rows trivially invertible.
    """
    m = model.valid.reshape(-1).astype(v.dtype)
    mask2 = jnp.concatenate([m, m])
    vm = v * mask2
    sx, sy = jnp.split(vm, 2, axis=-1)
    yx = toeplitz.matvec(model.cxx, sx) + toeplitz.matvec(model.cxy, sy)
    yy = (toeplitz.matvec(toeplitz.transpose(model.cxy), sx)
          + toeplitz.matvec(model.cyy, sy))
    out = jnp.concatenate([yx, yy]) * mask2
    # identity on INVALID rows uses the pre-mask input so those
    # coordinates are trivially invertible (not mapped to zero)
    return out + model.noise_var * vm + (1.0 - mask2) * v


def _cg(matvec, b, tol: float, maxit: int):
    """Plain conjugate gradient as a lax.while_loop (SPD system; the
    reference uses MINRES at RTOL=5e-2 -- slopesLinearMMSE.m:105-107)."""
    b2 = jnp.sum(b * b)

    def cond(state):
        _, r, _, rs, it = state
        return jnp.logical_and(it < maxit, rs > tol ** 2 * b2)

    def body(state):
        x, r, p, rs, it = state
        Ap = matvec(p)
        alpha = rs / (jnp.sum(p * Ap) + 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = jnp.sum(r * r)
        p = r + (rs_new / (rs + 1e-30)) * p
        return (x, r, p, rs_new, it + 1)

    x0 = jnp.zeros_like(b)
    state = (x0, b, b, b2, jnp.asarray(0))
    x, _, _, _, _ = jax.lax.while_loop(cond, body, state)
    return x


@partial(jax.jit, static_argnames=("tol", "maxit"))
def reconstruct(model: SlopesMMSE, slopes: jnp.ndarray, pitch: float,
                tol: float = 5e-2, maxit: int = 100) -> jnp.ndarray:
    """Slopes -> (nl+1, nl+1) phase map [rad].

    ``slopes``: (2 n_valid,) [rad/px] from wfs.geometric_slopes (x block
    then y block); ``pitch``: phase-grid pixel pitch [m] (converts to
    rad/m).  Single measurement; vmap over batches.
    """
    nl = model.n_lenslet
    vmask = model.valid.reshape(-1)
    n_valid = slopes.shape[-1] // 2
    sel = jnp.nonzero(vmask, size=n_valid)[0]
    full = jnp.zeros((2, nl * nl), dtype=slopes.dtype)
    full = full.at[0, sel].set(slopes[:n_valid] / pitch)
    full = full.at[1, sel].set(slopes[n_valid:] / pitch)
    c = full.reshape(-1)

    y = _cg(lambda v: _apply_cxx(model, v), c, tol, maxit)
    yx, yy = jnp.split(y, 2, axis=-1)
    phi = toeplitz.matvec(model.cox, yx) + toeplitz.matvec(model.coy, yy)
    return phi.reshape(nl + 1, nl + 1)


# ---------------------------------------------------------------------------
# Multi-guide-star zonal tomography (slopesLinearMMSE.m NGS meta-matrix,
# :110-127 -- arrayfun of slopestoSlopesCovariance over direction pairs)
# ---------------------------------------------------------------------------

def _freq_grid(d: float, nf: int, sf: int):
    """Shared oversampled frequency grid + quadrature for every kernel
    builder: C(Delta) = int S(f) e^{i 2 pi f Delta} df ~= ifft2 * N^2 d^2
    with the fftshift sandwich putting Delta = 0 at the center index."""
    lf = sf / (2.0 * d)
    f1 = (np.arange(nf) - nf // 2) / (nf // 2) * lf
    fx, fy = np.meshgrid(f1, f1)
    ff = np.hypot(fx, fy)
    delta = 2.0 * lf / nf

    def cov_of(spec):
        c = np.fft.fftshift(np.fft.ifft2(np.fft.ifftshift(spec)))
        return np.real(c) * (delta * nf) ** 2

    return fx, fy, ff, delta, cov_of


def _slope_kernels_pair(atm: AtmosphereConfig, d: float, n_lenslet: int,
                        dtheta, nf: int = 512, sf: int = 4):
    """Slope-slope covariance kernels between two apertures separated by
    the field angle ``dtheta`` [rad]: per-layer displacement phasors
    exp(2 i pi h (dtheta . f)) on the (xx, yy, xy) spectra
    (slopestoSlopesCovariance's deltaSrc phasor,
    slopesLinearMMSE.m:180-186).  On-axis pairs collapse to one
    combined-W transform (spectrum linear in fractional_r0)."""
    fx, fy, ff, delta, cov_of = _freq_grid(d, nf, sf)
    sinc2 = (np.sinc(d * fx) * np.sinc(d * fy)) ** 2
    two_pi = 2.0 * np.pi

    off = dtheta[0] != 0.0 or dtheta[1] != 0.0
    if not off:
        specs = [(phase_stats.spectrum(ff, atm), 1.0)]
    else:
        specs = []
        for il in range(atm.n_layers):
            slab = atm.layer(il)
            h = slab.altitudes[0]
            specs.append((phase_stats.spectrum(ff, slab),
                          np.exp(2j * np.pi * h * (dtheta[0] * fx
                                                   + dtheta[1] * fy))))
    kxx = np.zeros((nf, nf))
    kyy = np.zeros((nf, nf))
    kxy = np.zeros((nf, nf))
    for W, phz in specs:
        kxx += cov_of((two_pi * fx) ** 2 * sinc2 * W * phz)
        kyy += cov_of((two_pi * fy) ** 2 * sinc2 * W * phz)
        kxy += cov_of((two_pi ** 2) * fx * fy * sinc2 * W * phz)
    b0 = nf // 2
    bs = (np.arange(-(n_lenslet - 1), n_lenslet) * sf + b0)
    return (kxx[np.ix_(bs, bs)], kyy[np.ix_(bs, bs)], kxy[np.ix_(bs, bs)])


@struct.dataclass
class SlopesTomography:
    """Multi-GS zonal MMSE reconstructor (TBT blocks per direction pair).

    cxx_blocks: tuple over flattened (i, j) i<=j pairs of (xx, yy, xy)
    TBTOperators; cox_blocks: tuple over GS of (ox, oy) operators toward
    the science direction; layout mirrors the reference's cell-array
    meta-matrix (slopesLinearMMSE.m:110-127)."""

    cxx_blocks: tuple
    cxx_blocks_t: tuple           # pre-transposed (j > i applications)
    cox_blocks: tuple
    noise_var: jnp.ndarray
    valid: jnp.ndarray
    n_lenslet: int = struct.field(pytree_node=False)
    n_gs: int = struct.field(pytree_node=False)


def build_tomographic(atm: AtmosphereConfig, diameter: float,
                      n_lenslet: int, valid, noise_var: float,
                      gs_dirs, mmse_dir=(0.0, 0.0), nf: int = 512,
                      sf: int = 4, mag: float = 1.0) -> SlopesTomography:
    """Multi-guide-star zonal tomography: estimate the science-direction
    pupil phase from the stacked slopes of several NGS."""
    d = diameter / n_lenslet
    nl = n_lenslet
    m2 = float(mag) ** 2
    dirs = [np.asarray(g, dtype=np.float64) for g in gs_dirs]
    sci = np.asarray(mmse_dir, dtype=np.float64)
    n_gs = len(dirs)
    cxx = []
    for i in range(n_gs):
        for j in range(i, n_gs):
            kxx, kyy, kxy = _slope_kernels_pair(
                atm, d, nl, tuple(dirs[i] - dirs[j]), nf, sf)
            cxx.append((toeplitz.build((nl, nl), (nl, nl), kxx * m2),
                        toeplitz.build((nl, nl), (nl, nl), kyy * m2),
                        toeplitz.build((nl, nl), (nl, nl), kxy * m2)))
    cox = []
    for g in dirs:
        _, _, _, kox, koy = _kernels(atm, d, nl, nf, sf,
                                     mmse_dir=tuple(sci - g))
        cox.append((toeplitz.build((nl + 1, nl), (nl + 1, nl), kox * m2),
                    toeplitz.build((nl + 1, nl), (nl + 1, nl), koy * m2)))
    cxx_t = tuple((toeplitz.transpose(a), toeplitz.transpose(b),
                   toeplitz.transpose(c)) for a, b, c in cxx)
    return hostcompute.to_default(SlopesTomography(
        cxx_blocks=tuple(cxx),
        cxx_blocks_t=cxx_t,
        cox_blocks=tuple(cox),
        noise_var=jnp.asarray(noise_var, dtype=jnp.float32),
        valid=jnp.asarray(np.asarray(valid, dtype=bool)),
        n_lenslet=nl,
        n_gs=n_gs,
    ))


def _pair_index(i, j, n):
    """Flat index of the upper-triangular (i, j), i <= j."""
    return i * n - i * (i - 1) // 2 + (j - i)


def _apply_block(blocks, v):
    """Apply one (xx, yy, xy) TBT block pair to v = (2 nl^2,).

    The x<->y cross blocks BOTH use the same operator: C_{sx,sy} and
    C_{sy,sx} come from the identical even kernel k_xy(delta) (the
    spectrum (2 pi)^2 fx fy sinc^2 W is real and even), so the dense
    blocks are equal -- NOT transposes -- for displaced aperture pairs.
    The full pair block is [[A, B], [B, C]]; its transpose (the j < i
    half of the meta-matrix, pre-computed in build_tomographic as
    cxx_blocks_t) transposes each of A, B, C and keeps the structure
    (TBT transpose = even-kernel lattice flip)."""
    bxx, byy, bxy = blocks
    sx, sy = jnp.split(v, 2, axis=-1)
    yx = toeplitz.matvec(bxx, sx) + toeplitz.matvec(bxy, sy)
    yy_ = toeplitz.matvec(bxy, sx) + toeplitz.matvec(byy, sy)
    return jnp.concatenate([yx, yy_])


def _apply_cxx_tomo(model: SlopesTomography, v: jnp.ndarray) -> jnp.ndarray:
    """(C_xx + sigma^2 I) v over the stacked (n_gs, 2 nl^2) lattice."""
    nl = model.n_lenslet
    n_gs = model.n_gs
    m = model.valid.reshape(-1).astype(v.dtype)
    mask2 = jnp.concatenate([m, m])
    V = v.reshape(n_gs, 2 * nl * nl)
    Vm = V * mask2[None]
    out = []
    for i in range(n_gs):
        acc = 0.0
        for j in range(n_gs):
            if i <= j:
                blk = model.cxx_blocks[_pair_index(i, j, n_gs)]
            else:
                blk = model.cxx_blocks_t[_pair_index(j, i, n_gs)]
            acc = acc + _apply_block(blk, Vm[j])
        out.append(acc * mask2 + model.noise_var * Vm[i]
                   + (1.0 - mask2) * V[i])
    return jnp.stack(out).reshape(-1)


@partial(jax.jit, static_argnames=("tol", "maxit"))
def reconstruct_tomographic(model: SlopesTomography, slopes: jnp.ndarray,
                            pitch: float, tol: float = 5e-2,
                            maxit: int = 150) -> jnp.ndarray:
    """(n_gs, 2 n_valid) stacked guide-star slopes [rad/px] ->
    (nl+1, nl+1) science-direction phase [rad]."""
    nl = model.n_lenslet
    n_gs = model.n_gs
    vmask = model.valid.reshape(-1)
    n_valid = slopes.shape[-1] // 2
    sel = jnp.nonzero(vmask, size=n_valid)[0]
    full = jnp.zeros((n_gs, 2, nl * nl), dtype=slopes.dtype)
    full = full.at[:, 0, sel].set(slopes[:, :n_valid] / pitch)
    full = full.at[:, 1, sel].set(slopes[:, n_valid:] / pitch)
    c = full.reshape(-1)
    y = _cg(lambda w: _apply_cxx_tomo(model, w), c, tol, maxit)
    Y = y.reshape(n_gs, 2, nl * nl)
    phi = 0.0
    for g in range(n_gs):
        ox, oy = model.cox_blocks[g]
        phi = phi + toeplitz.matvec(ox, Y[g, 0]) \
            + toeplitz.matvec(oy, Y[g, 1])
    return phi.reshape(nl + 1, nl + 1)


# ---------------------------------------------------------------------------
# Laser guide star: finite-height cone geometry (slopesLinearMMSE.m LGS
# branch, :128-156 -- per-layer compressed lattices + interpolation back
# onto the pupil)
# ---------------------------------------------------------------------------

@struct.dataclass
class LGSSlopesMMSE:
    """Finite-height (cone-beam) slopes-MMSE reconstructor.

    An LGS at height H samples layer h on a footprint compressed by
    g = 1 - h/H (telescopeAbstract.m:472), so the slope covariances live
    on per-layer g-compressed lattices and the phase cannot be estimated
    directly on the pupil lattice (corner-to-slope displacements are no
    longer stationary).  Following the reference (slopesLinearMMSE.m:
    128-156), each LAYER's phase is MMSE-estimated on its own padded
    compressed lattice (Cox per layer, pad = ceil(nl (1-g) / (2 g)),
    :141-142) and interpolated back onto the pupil corner lattice with a
    bilinear operator (tools.bilinearSparseInterpolator, :152-154) --
    here a dense matmul (utils.gridtools.bilinear_interp_matrix).

    Slope-filter convention (validated Monte-Carlo against the
    framework's own cone projection + geometric slopes, and DIFFERENT
    from the reference's 1/g): the pupil-plane gradient of the cone
    wave from layer h is g times the layer gradient averaged over the
    compressed g*d subaperture, so each layer's slope filter is
    i 2 pi f g sinc(g d fx) sinc(g d fy) on its compressed lattice --
    amplitude g, not 1/g (the reference's slopes carry per-instrument
    calibration factors that absorb the difference for single-g use,
    but the relative layer weighting g^2 matters for multi-layer cones).

    Fields mirror SlopesMMSE (so `_apply_cxx`/CG are shared) plus the
    per-layer Cox operators and interpolation matrices.
    """

    cxx: toeplitz.TBTOperator
    cyy: toeplitz.TBTOperator
    cxy: toeplitz.TBTOperator
    cox_layers: tuple          # per layer: (ox, oy) ((nl+1+2p)^2 x nl^2)
    interp: tuple              # per layer: ((nl+1)^2, (nl+1+2p)^2)
    noise_var: jnp.ndarray
    valid: jnp.ndarray
    n_lenslet: int = struct.field(pytree_node=False)


def _cone_cox_kernels(slab, d: float, g: float, n_lenslet: int, pad: int,
                      nf: int, sf: int, mmse_dir=(0.0, 0.0)):
    """Corner-phase-to-slope kernels for ONE layer on its g-compressed
    lattice, padded to cover the (uncompressed) science footprint
    (slopesLinearMMSE.m:350-378 phaseToSlopesCovariance with pad)."""
    assert sf % 2 == 0, "sf must be even (half-subaperture offset)"
    fx, fy, ff, delta, cov_of = _freq_grid(d * g, nf, sf)
    h = slab.altitudes[0]
    base = g * np.sinc(g * d * fx) * np.sinc(g * d * fy)
    W = phase_stats.spectrum(ff, slab)
    if mmse_dir[0] != 0.0 or mmse_dir[1] != 0.0:
        # science-direction offset phasor (the deltaSrc branch,
        # slopesLinearMMSE.m:143-147: deltaSrc = h * (gs - mmse))
        W = W * np.exp(2j * np.pi * h * (mmse_dir[0] * fx
                                         + mmse_dir[1] * fy))
    kox = cov_of((-1j * 2.0 * np.pi * fx) * base * W)
    koy = cov_of((-1j * 2.0 * np.pi * fy) * base * W)
    b0 = nf // 2
    bo = (np.arange(-n_lenslet + 1 - pad, n_lenslet + 1 + pad) * sf
          - sf // 2 + b0)
    if bo.min() < 0 or bo.max() >= nf:
        raise ValueError("padded lattice exceeds the FFT quadrature "
                         "grid; raise nf or lower sf")
    return kox[np.ix_(bo, bo)], koy[np.ix_(bo, bo)]


def build_lgs(atm: AtmosphereConfig, diameter: float, n_lenslet: int,
              valid, noise_var: float, lgs_height: float,
              nf: int = 512, sf: int = 4, mag: float = 1.0,
              mmse_dir=(0.0, 0.0)) -> LGSSlopesMMSE:
    """Build the cone-geometry reconstructor for an LGS at
    ``lgs_height`` [m] (e.g. 90e3 sodium, 10-20e3 Rayleigh).

    ``mmse_dir``: science direction relative to the guide star [rad].
    The estimate is the infinite-height (science) pupil phase on the
    (nl+1)^2 corner lattice, assembled from per-layer estimates.
    """
    d = diameter / n_lenslet
    nl = n_lenslet
    m2 = float(mag) ** 2
    kxx = np.zeros((2 * nl - 1, 2 * nl - 1))
    kyy = np.zeros_like(kxx)
    kxy = np.zeros_like(kxx)
    cox_ops = []
    interps = []
    corner_1d = (np.arange(nl + 1) - nl / 2.0) * d
    ci, cj = np.meshgrid(corner_1d, corner_1d, indexing="ij")  # (y, x)
    for il in range(atm.n_layers):
        slab = atm.layer(il)
        h = slab.altitudes[0]
        g = 1.0 - h / lgs_height
        if g <= 0:
            raise ValueError(f"layer altitude {h} above the guide star")
        a, b, c = _slope_kernels_pair(slab, d * g, nl, (0.0, 0.0), nf, sf)
        kxx += g * g * a
        kyy += g * g * b
        kxy += g * g * c
        pad = int(np.ceil(0.5 * nl * (1.0 - g) / g)) if g < 1.0 else 0
        kox, koy = _cone_cox_kernels(slab, d, g, nl, pad, nf, sf,
                                     mmse_dir=tuple(mmse_dir))
        npl = nl + 1 + 2 * pad
        cox_ops.append((toeplitz.build((npl, nl), (npl, nl), kox * m2),
                        toeplitz.build((npl, nl), (npl, nl), koy * m2)))
        lat_1d = (np.arange(npl) - pad - nl / 2.0) * (g * d)
        li, lj = np.meshgrid(lat_1d, lat_1d, indexing="ij")
        interps.append(jnp.asarray(gridtools.bilinear_interp_matrix(
            cj, ci, lj, li, g * d), dtype=jnp.float32))
    return hostcompute.to_default(LGSSlopesMMSE(
        cxx=toeplitz.build((nl, nl), (nl, nl), kxx * m2),
        cyy=toeplitz.build((nl, nl), (nl, nl), kyy * m2),
        cxy=toeplitz.build((nl, nl), (nl, nl), kxy * m2),
        cox_layers=tuple(cox_ops),
        interp=tuple(interps),
        noise_var=jnp.asarray(noise_var, dtype=jnp.float32),
        valid=jnp.asarray(np.asarray(valid, dtype=bool)),
        n_lenslet=nl,
    ))


@partial(jax.jit, static_argnames=("tol", "maxit"))
def reconstruct_lgs(model: LGSSlopesMMSE, slopes: jnp.ndarray,
                    pitch: float, tol: float = 5e-2,
                    maxit: int = 100) -> jnp.ndarray:
    """LGS slopes [rad/px] -> (nl+1, nl+1) science pupil phase [rad]:
    CG on the shared (Cxx + sigma^2) operator, then per-layer Cox apply
    + bilinear interpolation sum (slopesLinearMMSE.m:205-239 mtimes)."""
    nl = model.n_lenslet
    vmask = model.valid.reshape(-1)
    n_valid = slopes.shape[-1] // 2
    sel = jnp.nonzero(vmask, size=n_valid)[0]
    full = jnp.zeros((2, nl * nl), dtype=slopes.dtype)
    full = full.at[0, sel].set(slopes[:n_valid] / pitch)
    full = full.at[1, sel].set(slopes[n_valid:] / pitch)
    c = full.reshape(-1)
    y = _cg(lambda v: _apply_cxx(model, v), c, tol, maxit)
    yx, yy = jnp.split(y, 2, axis=-1)
    phi = 0.0
    for (ox, oy), B in zip(model.cox_layers, model.interp):
        phi_l = toeplitz.matvec(ox, yx) + toeplitz.matvec(oy, yy)
        phi = phi + B @ phi_l
    return phi.reshape(nl + 1, nl + 1)
