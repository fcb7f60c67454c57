"""Source geometry + multi-layer relay projection (NGS off-axis / LGS cone).

Equivalent of the reference's general relay branch and the
LGS portions of `source.m` (SURVEY.md 2d "source.m LGS branches"):

* source.m:412-417  -- directionVector = (tan(zenith) cos(azimuth),
  tan(zenith) sin(azimuth), 1);
* telescopeAbstract.m:449-487 -- per-layer projection: a layer at
  altitude h seen by a source at height H is sampled on a pupil
  footprint of radius  R (1 - h/H)  (the LGS cone effect; H = inf for
  an NGS) centered at  h * directionVector  (off-axis anisoplanatism),
  by bilinear interpolation of the layer screen;
* telescopeAbstract.m:490     -- wavelength rescale
  (phase-screen wavelength / source wavelength);
* telescopeAbstract.m:493     -- airmass factor 1/sqrt(cos(elevation));
* source.m:558-597            -- fresnelPropagation contributes zero
  phase for a source at the telescope focus (NGS and focused LGS), so
  it is not modeled here;
* telescopeAbstract.m:446-447 -- on-axis NGS fast path = plain layer
  sum (already in ops/phase_screens.phase_at).

Design: the projection is a gather-based bilinear interpolation with
coordinates computed in-program from static geometry -- jit/vmap
friendly, no per-step host work; layers of different grid sizes are
unrolled at trace time (layer count is tiny and static).
"""

from __future__ import annotations

import math
from typing import Sequence

import jax.numpy as jnp
import numpy as np


def direction_vector(zenith: float, azimuth: float):
    """(theta_x, theta_y) transverse direction [rad for small angles]
    (source.m:412-417: tan(zenith) (cos, sin)(azimuth))."""
    return (math.tan(zenith) * math.cos(azimuth),
            math.tan(zenith) * math.sin(azimuth))


def _bilinear(screen: jnp.ndarray, rows: jnp.ndarray,
              cols: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample of (n, n) screen at fractional (rows, cols)
    index grids (the `linear` interpolator, telescopeAbstract.m:1000+).

    Out-of-bounds coordinates are clamped to the screen edge (the
    fractional part too, not just the base index, so sampling past the
    border holds the edge value instead of silently extrapolating --
    the reference's interp2 would return NaN there and surface the
    mis-sized footprint; clamping keeps the op jit-safe while staying
    bounded).  `project_layers` additionally asserts the footprint
    fits at setup time.
    """
    n = screen.shape[-1]
    rows = jnp.clip(rows, 0.0, n - 1.0)
    cols = jnp.clip(cols, 0.0, n - 1.0)
    r0 = jnp.clip(jnp.floor(rows), 0, n - 2).astype(jnp.int32)
    c0 = jnp.clip(jnp.floor(cols), 0, n - 2).astype(jnp.int32)
    fr = rows - r0
    fc = cols - c0
    v00 = screen[r0, c0]
    v01 = screen[r0, c0 + 1]
    v10 = screen[r0 + 1, c0]
    v11 = screen[r0 + 1, c0 + 1]
    return (v00 * (1 - fr) * (1 - fc) + v01 * (1 - fr) * fc
            + v10 * fr * (1 - fc) + v11 * fr * fc)


def project_layers(
    screens: Sequence[jnp.ndarray],
    pitches: Sequence[float],
    telescope_radius: float,
    altitudes: Sequence[float],
    resolution: int,
    direction: tuple[float, float] = (0.0, 0.0),
    source_height: float = math.inf,
    wavelength_ratio: float = 1.0,
    zenith_angle: float = 0.0,
) -> jnp.ndarray:
    """Sum layer screens onto a source's pupil footprint.

    Args:
      screens:   per-layer (n_k, n_k) phase maps, centered on the
                 telescope axis, grid pitch ``pitches[k]`` [m].
      telescope_radius: R [m].
      altitudes: layer heights h_k [m].
      resolution: output grid size (pupil sampling).
      direction: (theta_x, theta_y) source transverse direction.
      source_height: H [m]; inf for an NGS, e.g. 90e3 for a sodium LGS.
      wavelength_ratio: screen wavelength / source wavelength
                 (telescopeAbstract.m:490).
      zenith_angle: pointing angle from zenith; phase scales with
                 airmass 1/sqrt(cos(.)) (telescopeAbstract.m:492 --
                 OOMAO's `elevation` defaults to 0, i.e. zenith).

    Returns (resolution, resolution) phase [rad at source wavelength].
    """
    u = jnp.linspace(-1.0, 1.0, resolution)
    out = jnp.zeros((resolution, resolution), jnp.float32)
    for screen, pitch, h in zip(screens, pitches, altitudes):
        n = screen.shape[-1]
        if math.isinf(source_height):
            layer_r = telescope_radius
        else:
            layer_r = telescope_radius * (1.0 - h / source_height)
        xc = h * direction[0]
        yc = h * direction[1]
        # fail loudly at trace/setup time if the source footprint leaves
        # the screen (static geometry -> static check); _bilinear would
        # otherwise clamp to the edge value
        half_extent = (n - 1) / 2.0 * pitch
        reach = abs(layer_r) + max(abs(xc), abs(yc))
        if reach > half_extent + 1e-9:
            raise ValueError(
                f"source footprint (reach {reach:.3f} m) exceeds the "
                f"layer screen half-extent {half_extent:.3f} m at "
                f"altitude {h} m; enlarge the screen or reduce the "
                "off-axis angle")
        # physical coords -> fractional index (screen centered on axis)
        half = (n - 1) / 2.0
        cols = (u * layer_r + xc) / pitch + half
        rows = (u * layer_r + yc) / pitch + half
        ci, ri = jnp.meshgrid(cols, rows)
        out = out + _bilinear(screen, ri, ci)
    scale = wavelength_ratio / math.sqrt(math.cos(zenith_angle))
    return out * jnp.float32(scale)


def cone_compression(altitude: float, source_height: float) -> float:
    """Footprint shrink factor 1 - h/H (telescopeAbstract.m:472)."""
    if math.isinf(source_height):
        return 1.0
    return 1.0 - altitude / source_height
