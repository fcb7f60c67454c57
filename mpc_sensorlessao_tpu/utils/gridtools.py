"""Grid / geometry / conversion utilities.

Equivalent capability to the scientifically-meaningful pieces of the
reference's `utilities.m` grab-bag (1197 LoC static class; SURVEY.md 2a
"utilities").  Pieces the pipeline already rebuilt elsewhere are NOT
duplicated (piston pupil -> ops/psf.pupil_mask*, binning ->
models/imaging.bin_frame, meanRm -> ops/zernike.piston_removed_*,
sombrero -> ops/zernike_stats.sombrero, bilinear interpolation ->
ops/relay._bilinear); this module adds the remaining named functions
with the reference's exact semantics, vectorized.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

# physical constants (the reference's `constants` class)
G_GRAV = 6.67384e-11
M_EARTH = 5.9722e24
R_EARTH = 6378.137e3
C_LIGHT = 299792458.0


def mean_sub(data, mask):
    """Subtract the in-mask mean from each frame (utilities.m:67-81).

    data: (..., R, R); mask: (R, R) bool.  The mean is computed over the
    mask and subtracted everywhere inside it (outside untouched), the
    reference's per-frame loop vectorized over leading dims."""
    data = jnp.asarray(data)
    m = jnp.asarray(mask, dtype=data.dtype)
    npix = jnp.sum(m)
    mean = jnp.sum(data * m, axis=(-2, -1), keepdims=True) / npix
    return data - mean * m


def cart_and_pol(n: int, radius: float = 1.0, output: str = "polar"):
    """Cartesian + polar coordinate grids (utilities.m:83-161).

    Returns (x, y, r, theta) for output="all", (r, theta) for "polar",
    or (x, y) for "cartesian"; n points spanning [-radius, radius].
    """
    u = np.linspace(-radius, radius, n)
    x, y = np.meshgrid(u, u)
    r = np.hypot(x, y)
    theta = np.arctan2(y, x)
    if output == "all":
        return x, y, r, theta
    if output == "polar":
        return r, theta
    if output == "cartesian":
        return x, y
    raise ValueError(f"unknown output '{output}'")


def toggle_frame(frame, toggle: int | None = None):
    """2D <-> 3D frame reshaping (utilities.m:163-201): (R*R, T) flat
    stacks <-> (R, R, T) cubes in the MATLAB COLUMN-major pixel layout
    (p = i + j*R), so data exchanged with reference .mat stacks keeps
    its orientation.  Deliberate deviation: an already-2D stack with
    toggle=2 is returned unchanged (the reference re-flattens (P, T)
    into (P*T, 1), which mangles multi-frame stacks)."""
    frame = jnp.asarray(frame)
    n = frame.ndim
    if toggle is None:
        toggle = 3 if n == 2 else 2
    if toggle == 2:
        if n == 2:
            return frame
        m, _, t = frame.shape
        # column-major flatten of each frame: p = i + j*m
        return frame.transpose(1, 0, 2).reshape(m * m, t)
    if toggle == 3:
        m = int(math.isqrt(frame.shape[0]))
        if m * m != frame.shape[0]:
            raise ValueError("first dim is not a square pixel count")
        t = frame.shape[1] if n > 1 else 1
        # inverse of the column-major flatten
        return frame.reshape(m, m, t).transpose(1, 0, 2)
    raise ValueError("toggle must be 2 or 3")


def rearrange(size_array, size_sub) -> np.ndarray:
    """(n_pix_per_sub, n_sub) linear-index table tiling an array into
    contiguous sub-arrays (utilities.m:204-331, zero overlap, column
    major) -- the indexRasterLenslet machinery of shackHartmann.m."""
    ny, nx = size_array
    sy, sx = size_sub
    assert ny % sy == 0 and nx % sx == 0
    idx = np.arange(ny * nx).reshape(ny, nx, order="F")
    cols = []
    for bx in range(nx // sx):
        for by in range(ny // sy):
            cols.append(idx[by * sy:(by + 1) * sy,
                            bx * sx:(bx + 1) * sx].ravel(order="F"))
    return np.stack(cols, axis=1)


def fitting_error_variance(diameter: float, r0: float, L0: float,
                           n_valid_actuators: int) -> float:
    """DM fitting-error variance [rad^2] (utilities.m:364-375):
    c (D/r0)^{5/3} (N_act/pi + (D/L0)^2)^{-5/6}."""
    c = (3.0 / 5.0) * (math.gamma(11.0 / 6.0) ** 2 / math.pi ** (8.0 / 3.0)
                       ) * (24.0 * math.gamma(6.0 / 5.0) / 5.0) ** (5.0 / 6.0)
    return (c * (diameter / r0) ** (5.0 / 3.0)
            * (n_valid_actuators / math.pi
               + (diameter / L0) ** 2) ** (-5.0 / 6.0))


def defocus_distance(a4: float, focal_length: float, diameter: float,
                     wavelength: float) -> float:
    """Focal-point displacement [m] for a Noll-normalized Zernike focus
    coefficient [rad] (utilities.m:489-510) -- converts the estimator's
    defocus diversity to a physical camera stage motion."""
    k = 16.0 * math.sqrt(3.0) * a4
    return (k * (focal_length / diameter) ** 2
            / (2.0 * math.pi / wavelength
               - k * focal_length / diameter ** 2))


def out_of_focus(delta: float, focal_length: float, diameter: float,
                 wavelength: float) -> float:
    """Inverse of defocus_distance (utilities.m:511-528): Zernike focus
    coefficient [rad] for a focal-point displacement [m]."""
    return ((2.0 * math.pi * delta / wavelength)
            / (16.0 * math.sqrt(3.0)
               * ((focal_length / diameter) ** 2
                  + focal_length * delta / diameter ** 2)))


def orbital_velocity(h: float, zen: float = 0.0) -> float:
    """Orbital angular velocity [rad/s] at altitude h
    (utilities.m:529-545)."""
    return (math.sqrt(G_GRAV * M_EARTH / (R_EARTH + h))
            * (1.0 - R_EARTH * math.sin(zen) ** 2 / (R_EARTH + h)) / h)


def point_ahead_angle(h: float, zen: float = 0.0) -> float:
    """Laser point-ahead angle [rad] (utilities.m:546-560)."""
    return 2.0 * h * orbital_velocity(h, zen) / math.cos(zen) / C_LIGHT


def eye_block_diag(A: np.ndarray, n: int) -> np.ndarray:
    """kron(I_n, A) (utilities.m:601-609)."""
    return np.kron(np.eye(n), np.asarray(A))


def gram_schmidt(V: np.ndarray) -> np.ndarray:
    """Column-wise Gram-Schmidt orthonormalization
    (utilities.m:611-629)."""
    V = np.array(V, dtype=np.float64)
    for k in range(V.shape[1]):
        for j in range(k):
            V[:, k] -= (V[:, j] @ V[:, k]) * V[:, j]
        V[:, k] /= np.linalg.norm(V[:, k])
    return V


def bilinear_interp_matrix(xi, yi, xo, yo, do: float) -> np.ndarray:
    """Dense bilinear-spline interpolation matrix: zi = H @ zo.

    H[i, o] = tri((xi-xo)/do) * tri((yi-yo)/do) with tri(x) = max(0,
    1-|x|) -- the reference's sparse bi-harmonic operator
    (bilinearSplineInterpMat.m:83-131 `bilinearSplineInterp` /
    tools.bilinearSparseInterpolator), built dense: the lattices in this
    framework are small (hundreds of points) and the apply is a single
    dense matmul rather than a sparse gather.

    xi, yi: target point coordinates; xo, yo: source lattice point
    coordinates; do: source lattice pitch (same units).
    """
    xi = np.asarray(xi, dtype=np.float64).ravel()
    yi = np.asarray(yi, dtype=np.float64).ravel()
    xo = np.asarray(xo, dtype=np.float64).ravel()
    yo = np.asarray(yo, dtype=np.float64).ravel()
    u = np.maximum(0.0, 1.0 - np.abs(xi[:, None] - xo[None, :]) / do)
    v = np.maximum(0.0, 1.0 - np.abs(yi[:, None] - yo[None, :]) / do)
    return u * v
