"""Paraxial ABCD ray tracing.

Equivalent of the reference's `+rayTracing` package (149 LoC total:
abcd.m, freeSpace.m, thinLens.m, curvedMirror.m) -- 2x2 paraxial
transfer matrices applied to (offset, angle) ray vectors, with element
transverse offsets, stop vignetting, and z-propagation direction.

Re-design: the reference mutates a ray vector through a chain
of handle objects (abcd.m:46-53 `relay`); here elements are plain
(matrix, offset, stop) records, a system is their list, and
``trace``/``trace_path`` are pure jittable functions over RAY BATCHES
(..., 2) -- a million rays is one (2, 2) x (2, N) matmul chain.  The
composed system matrix (``system_matrix``) collapses any stop-free
chain into a single 2x2 matrix.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import jax.numpy as jnp
import numpy as np


class Element(NamedTuple):
    """One paraxial element.

    matrix:    (2, 2) ABCD matrix;
    offset:    transverse element decenter [m] (abcd.m:48 subtracts it
               from the ray offset before the matrix);
    stop_width: aperture full width [m] (inf = no stop); rays with
               |y - stop_offset| > stop_width/2 are vignetted;
    stop_offset: stop decenter [m];
    thickness: z extent [m] (free-space distance);
    z_dir:     +1 forward, -1 after a mirror (abcd.m:18 zPropDir).
    """

    matrix: jnp.ndarray
    offset: float = 0.0
    stop_width: float = math.inf
    stop_offset: float = 0.0
    thickness: float = 0.0
    z_dir: int = 1


def free_space(distance: float, **kw) -> Element:
    """[[1, d], [0, 1]] (freeSpace.m:24-26)."""
    return Element(jnp.asarray([[1.0, distance], [0.0, 1.0]],
                               dtype=jnp.float32),
                   thickness=float(distance), **kw)


def thin_lens(focal_length: float, **kw) -> Element:
    """[[1, 0], [-1/f, 1]] (thinLens.m:23-24)."""
    return Element(jnp.asarray([[1.0, 0.0],
                                [-1.0 / focal_length, 1.0]],
                               dtype=jnp.float32), **kw)


def curved_mirror(radius: float, **kw) -> Element:
    """[[1, 0], [-2/R, 1]], reverses propagation
    (curvedMirror.m:22-25)."""
    return Element(jnp.asarray([[1.0, 0.0], [-2.0 / radius, 1.0]],
                               dtype=jnp.float32), z_dir=-1, **kw)


def apply(elem: Element, rays: jnp.ndarray):
    """(..., 2) rays -> (rays_out, pass_mask).

    Mirrors abcd.relay (abcd.m:46-53): subtract the element decenter
    from the offset row, then multiply; the stop sets the vignette mask
    (the reference stores stopWidth but never culls -- culling is the
    obvious completion and is opt-in via the returned mask).
    """
    y = rays[..., 0] - elem.offset
    a = rays[..., 1]
    shifted = jnp.stack([y, a], axis=-1)
    out = shifted @ elem.matrix.T
    ok = jnp.abs(y - elem.stop_offset) <= elem.stop_width / 2.0
    return out, ok


def trace(elements: Sequence[Element], rays: jnp.ndarray):
    """Propagate a ray batch through the chain.

    Returns (rays_out, vignette_mask, z_total, z_dir): mask is the AND of
    every stop; z_total accumulates signed thickness (curved mirrors flip
    the direction for subsequent elements)."""
    ok = jnp.ones(rays.shape[:-1], dtype=bool)
    z = 0.0
    z_dir = 1
    for e in elements:
        rays, ok_e = apply(e, rays)
        ok = jnp.logical_and(ok, ok_e)
        z = z + z_dir * e.thickness
        z_dir = z_dir * e.z_dir
    return rays, ok, z, z_dir


def trace_path(elements: Sequence[Element], rays: jnp.ndarray) -> jnp.ndarray:
    """(n_elem+1, ..., 2) ray states at every surface (for plots/tests)."""
    out = [rays]
    for e in elements:
        rays, _ = apply(e, rays)
        out.append(rays)
    return jnp.stack(out)


def system_matrix(elements: Sequence[Element]) -> np.ndarray:
    """Composed 2x2 ABCD matrix of an offset-free chain (host float64).

    Offsets make the map affine; this raises if any element has one.
    """
    M = np.eye(2)
    for e in elements:
        if e.offset != 0.0:
            raise ValueError("system_matrix needs offset-free elements")
        M = np.asarray(e.matrix, dtype=np.float64) @ M
    return M


def effective_focal_length(elements: Sequence[Element]) -> float:
    """f_eff = -1/C of the composed matrix."""
    M = system_matrix(elements)
    if abs(M[1, 0]) < 1e-15:
        return math.inf
    return float(-1.0 / M[1, 0])
