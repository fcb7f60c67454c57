"""Conditional-Gaussian frozen-flow screen evolution (reference parity).

Equivalent of the reference's stochastic screen-extension
frozen flow (reference: telescopeAbstract.m:823-901 `init`,
telescopeAbstract.m:288-372 `update`):

* each layer's (n, n) phase screen lives inside an (n+2, n+2) frame
  (`mapShift`) whose 1-pixel border is redrawn by conditional-Gaussian
  sampling  X = A Z + B eps  (telescopeAbstract.m:898-901), where Z is the
  2-pixel inner ring of the current phase (innerMask,
  telescopeAbstract.m:855-861), A = Cov(X,Z) Cov(Z,Z)^-1 and
  B = chol(Cov(X,X) - A Cov(Z,X)) are precomputed once per layer from the
  Von Karman covariance (telescopeAbstract.m:863-884, phaseStats.m:305);
* per control step the screen translates along the wind: whole pixels by
  *exact* shifts that consume the freshly drawn border (the reference's
  `while any(pixelLeap>1)` loop with step = 1 px,
  telescopeAbstract.m:333-372), and the sub-pixel remainder by ONE
  output-side bilinear interpolation that is never written back.

Differences from the reference (documented deviations):
* the stored screen lives on the integer-pixel lattice; the fractional
  offset is applied only when *sampling* the pupil phase.  The reference
  instead writes the interpolated map back into the layer state
  (telescopeAbstract.m:353), so its screens accumulate a bilinear low-pass
  every step -- an artifact, not a feature.  Here the stored state is only
  ever shifted exactly, so the evolved screens keep the full Von Karman
  spectrum (validated in tests against phaseStats analytics);
* integer sub-steps are fixed at compile time (floor(|px/step|)+1 per
  component) with `where`-masked no-ops, replacing the data-dependent
  while loop;
* all conditioning operators are dense host-precomputed float64, shipped
  to device as float32 matmul operands; the per-step work is two small
  matmuls + a 4-tap stencil per layer -- fixed shapes, scan-friendly.

The default periodic-screen flow (`phase_screens.py`) remains the fast
path; this module is the reference-statistics path: fresh turbulence
enters through the border forever, no periodic revisit.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import struct
from ..utils.config import AtmosphereConfig, TelescopeConfig
from . import phase_screens, phase_stats


@struct.dataclass
class EdgeFlowModel:
    """Per-layer conditional-Gaussian extension operators (device arrays).

    A:         (L, nX, nZ) conditional-mean operators.
    Bc:        (L, nX, nX) lower Cholesky factors of the conditional cov.
    outer_idx: (nX,) int32 flat indices of the border ring in the
               (n+2, n+2) frame (row-major; ours, not MATLAB's).
    inner_idx: (nZ,) int32 flat indices of the 2-px inner ring in the
               (n, n) phase.
    step_px:   per-control-step (row, col) displacements [px] -- static
               (compile-time sub-step schedule).
    nsub:      per-layer static bound on whole-pixel shifts per step,
               floor(|step|)+1 per axis.
    """

    A: jnp.ndarray
    Bc: jnp.ndarray
    outer_idx: jnp.ndarray
    inner_idx: jnp.ndarray
    step_px: tuple = struct.field(pytree_node=False)
    nsub: tuple = struct.field(pytree_node=False)
    size: int = struct.field(pytree_node=False)
    # whole-pixel shift selection strategy: "switch" executes only the
    # taken branch; "where" materializes the 4 candidates and selects
    shift_select: str = struct.field(pytree_node=False, default="switch")
    # advance() implementation: "vectorized" (batched layer draws/
    # embeds AND stacked-frame shift selection), "per_layer" (one layer
    # at a time), or "hybrid" (batched draws + per-layer concat frames
    # and shift selection).  Distinct PRNG streams (per-step vs
    # per-layer key folds), all exact draws of the same
    # conditional-Gaussian process.  build() picks by grid size; the
    # GPU timings of both sides are printed by chip_smoke.py.
    impl: str = struct.field(pytree_node=False, default="vectorized")

    @property
    def n_layers(self) -> int:
        return self.A.shape[0]


@struct.dataclass
class EdgeFlowState:
    """Scan carry: integer-lattice screens per layer."""

    phases: jnp.ndarray   # (L, n, n)


def _ring_masks(n: int, n_inner: int = 2):
    """outerMask / innerMask index sets (telescopeAbstract.m:855-861).

    outer: the 1-px border of the (n+2)^2 frame; inner: the n_inner-px ring
    at the edge of the n^2 phase region.
    """
    frame = np.zeros((n + 2, n + 2), dtype=bool)
    frame[0, :] = frame[-1, :] = frame[:, 0] = frame[:, -1] = True
    outer_idx = np.flatnonzero(frame.ravel())

    phase_ring = np.zeros((n, n), dtype=bool)
    phase_ring[:n_inner, :] = phase_ring[-n_inner:, :] = True
    phase_ring[:, :n_inner] = phase_ring[:, -n_inner:] = True
    inner_idx = np.flatnonzero(phase_ring.ravel())
    return outer_idx, inner_idx


def extension_operators(atm_layer: AtmosphereConfig, n: int, pitch: float,
                        n_inner: int = 2):
    """A, B_chol for one layer (telescopeAbstract.m:863-884), host f64.

    Grid positions follow the reference's (0:n+1)*pitch frame meshgrid
    (telescopeAbstract.m:864); only pairwise distances matter.
    """
    outer_idx, inner_idx = _ring_masks(n, n_inner)
    u = np.arange(n + 2) * pitch
    cc, rr = np.meshgrid(u, u, indexing="xy")
    pts_frame = (cc + 1j * rr).ravel()
    # phase pixel (i, j) sits at frame pixel (i+1, j+1)
    pts_phase = pts_frame.reshape(n + 2, n + 2)[1:-1, 1:-1].ravel()

    Zp = pts_phase[inner_idx]
    Xp = pts_frame[outer_idx]
    ZZt = phase_stats.covariance_matrix(Zp, Zp, atm_layer)
    ZXt = phase_stats.covariance_matrix(Zp, Xp, atm_layer)
    XXt = phase_stats.covariance_matrix(Xp, Xp, atm_layer)

    A = np.linalg.solve(ZZt + 1e-12 * np.eye(len(Zp)), ZXt).T  # (nX, nZ)
    BBt = XXt - A @ ZXt
    BBt = 0.5 * (BBt + BBt.T)
    try:
        Bc = np.linalg.cholesky(BBt + 1e-12 * np.eye(len(Xp)))
    except np.linalg.LinAlgError:
        w, V = np.linalg.eigh(BBt)
        Bc = V * np.sqrt(np.clip(w, 0.0, None))
    return A, Bc


def build(seed, atm: AtmosphereConfig, tel: TelescopeConfig,
          dtype=jnp.float32, op_dtype=None):
    """Build the model + initial state. Host-side setup (one-time f64).

    Initial screens come from non-periodic crops of oversampled FFT
    synthesis (the reference seeds with fourierPhaseScreen,
    telescopeAbstract.m:850).

    ``op_dtype`` stores ONLY the conditioning operators A/Bc in a
    narrower dtype (state screens stay ``dtype``).  The R=512 border
    draws stream the operators from device memory every sub-step; bf16
    storage halves that traffic (accumulation stays f32 via
    preferred_element_type).
    """
    n = tel.resolution
    pitch = tel.pixel_pitch
    dt = tel.sampling_time
    L = atm.n_layers
    outer_idx, inner_idx = _ring_masks(n)

    A_l, B_l, steps, nsub, phases = [], [], [], [], []
    for i in range(L):
        slab = atm.layer(i)
        A, Bc = extension_operators(slab, n, pitch)
        A_l.append(A)
        B_l.append(Bc)
        v, th = atm.wind_speeds[i], atm.wind_directions[i]
        sy = v * math.sin(th) * dt / pitch
        sx = v * math.cos(th) * dt / pitch
        steps.append((sy, sx))
        nsub.append((int(math.floor(abs(sy))) + 1 if sy != 0.0 else 0,
                     int(math.floor(abs(sx))) + 1 if sx != 0.0 else 0))
        scr = np.asarray(phase_screens.synthesize_screen(
            int(seed) * 1000003 + i, slab, n, pitch))
        phases.append(scr[:n, :n])    # non-periodic crop

    model = EdgeFlowModel(
        A=jnp.asarray(np.stack(A_l), dtype=op_dtype or dtype),
        Bc=jnp.asarray(np.stack(B_l), dtype=op_dtype or dtype),
        outer_idx=jnp.asarray(outer_idx, dtype=jnp.int32),
        inner_idx=jnp.asarray(inner_idx, dtype=jnp.int32),
        step_px=tuple(steps),
        nsub=tuple(nsub),
        size=n,
        # size dispatch kept from an earlier platform's timings; its GPU
        # timings on both sides are printed by chip_smoke.py
        shift_select="switch" if n <= 256 else "where",
        impl="vectorized" if n <= 256 else "per_layer",
    )
    state = EdgeFlowState(
        phases=jnp.asarray(np.stack(phases), dtype=dtype))
    return model, state


def batch_states(seed, atm: AtmosphereConfig, tel: TelescopeConfig,
                 n_scenarios: int, dtype=jnp.float32) -> EdgeFlowState:
    """B independent initial screen sets -> (B, L, n, n) batched state.

    Per-scenario Monte-Carlo over turbulence realizations: pass to
    parallel/montecarlo.run_batch(edge_state=..., shared_turbulence=
    False); each scenario then evolves its own conditional-Gaussian flow
    from its own FFT-synthesized seed screen (host-side setup, same
    non-periodic crop as build())."""
    n = tel.resolution
    batch = []
    for b in range(n_scenarios):
        phases = []
        for i in range(atm.n_layers):
            scr = np.asarray(phase_screens.synthesize_screen(
                (int(seed) + 7919 * (b + 1)) * 1000003 + i, atm.layer(i),
                n, tel.pixel_pitch))
            phases.append(scr[:n, :n])
        batch.append(np.stack(phases))
    return EdgeFlowState(phases=jnp.asarray(np.stack(batch), dtype=dtype))


def _draw_border(model: EdgeFlowModel, layer: int, phase, key):
    """X = A Z + B eps (telescopeAbstract.m:898-901), one layer."""
    Z = phase.reshape(-1)[model.inner_idx]
    eps = jax.random.normal(key, (model.Bc.shape[-1],), dtype=phase.dtype)
    dp = jax.lax.Precision.DEFAULT      # as in _draw_borders_all
    return (jnp.matmul(model.A[layer], Z, precision=dp)
            + jnp.matmul(model.Bc[layer], eps, precision=dp))


def _embed(model: EdgeFlowModel, phase, border):
    """Assemble the (n+2, n+2) frame: interior = phase, ring = border
    (telescopeAbstract.m:899-901 mapShift fill), one layer."""
    frame = jnp.pad(phase, 1)
    flat = frame.reshape(-1).at[model.outer_idx].set(border)
    return flat.reshape(frame.shape)


def _draw_borders_all(model: EdgeFlowModel, phases, key):
    """X = A Z + B eps for ALL layers at once (telescopeAbstract.m:898-901).

    One (L, nZ) ring gather, two batched-over-layers matmuls, one
    (L, nX) threefry draw -- replaces 4L separate small ops (the r4
    per-layer path is dominated by op count, not arithmetic;
    benchmarks/edge_flow_breakdown.py)."""
    L = phases.shape[0]
    od = model.A.dtype
    Z = phases.reshape(L, -1)[:, model.inner_idx].astype(od)   # (L, nZ)
    eps = jax.random.normal(key, (L, model.Bc.shape[-1]),
                            dtype=phases.dtype).astype(od)
    # TF32 products: their ~1e-4 relative rounding is far inside the
    # sampling noise of the draw itself
    dp = jax.lax.Precision.DEFAULT
    return (jnp.einsum("lxz,lz->lx", model.A, Z, precision=dp,
                       preferred_element_type=jnp.float32)
            + jnp.einsum("lxy,ly->lx", model.Bc, eps, precision=dp,
                         preferred_element_type=jnp.float32)
            ).astype(phases.dtype)                             # (L, nX)


def _border_segments(borders, n: int):
    """Split the flat (L, nX) ring draw into top/bottom rows and
    left/right columns.  The ring ordering is row-major flatnonzero of
    the (n+2)^2 border mask (_ring_masks): first the full top row
    (n+2), then rows 1..n contributing (left, right) pairs, then the
    full bottom row."""
    top = borders[:, :n + 2]                                   # (L, n+2)
    bottom = borders[:, -(n + 2):]
    mid = borders[:, n + 2:-(n + 2)].reshape(borders.shape[0], n, 2)
    return top, bottom, mid[:, :, 0], mid[:, :, 1]


def _embed_all(model: EdgeFlowModel, phases, borders):
    """(L, n+2, n+2) frames: interior = phases, ring = borders.

    Assembled with two concatenates instead of pad + flat ring scatter
    (the ring scatter of `_embed`); concat lowers to plain contiguous
    copies."""
    L, n = phases.shape[0], phases.shape[1]
    top, bottom, left, right = _border_segments(borders, n)
    body = jnp.concatenate(
        [left[:, :, None], phases, right[:, :, None]], axis=2)
    return jnp.concatenate(
        [top[:, None, :], body, bottom[:, None, :]], axis=1)


def _shift_exact(frame, n: int, dy: int, dx: int):
    """phase'(i,j) = frame[i+1-dy, j+1-dx] for integer dy, dx in {-1,0,1}:
    an exact translation consuming the border on the leading edge -- no
    interpolation, no spectral loss."""
    return frame[1 - dy:1 - dy + n, 1 - dx:1 - dx + n]


def _shift_dynamic(frame, n: int, oy, ox):
    """Same sampling with traced offsets in (-1, 1]: dynamic_slice base +
    traced 4-tap weights (slow-wind accumulated offsets)."""
    ry, rx = 1.0 - oy, 1.0 - ox
    iy = jnp.clip(jnp.floor(ry).astype(jnp.int32), 0, 1)
    ix = jnp.clip(jnp.floor(rx).astype(jnp.int32), 0, 1)
    wy = (ry - iy).astype(frame.dtype)
    wx = (rx - ix).astype(frame.dtype)
    w = jax.lax.dynamic_slice(frame, (iy, ix), (n + 1, n + 1))
    return ((1 - wy) * (1 - wx) * w[:n, :n]
            + (1 - wy) * wx * w[:n, 1:]
            + wy * (1 - wx) * w[1:, :n]
            + wy * wx * w[1:, 1:])


def advance(model: EdgeFlowModel, state: EdgeFlowState, idx, key):
    """One control-step update of every layer; returns (state', pupil
    phase).  `idx` is the traced absolute step index (drives the
    integer-lattice schedule); `key` a per-rollout PRNG key (folded per
    step/sub-step; the (L, nX) draw covers all layers).

    Equivalent of `+tel` (telescopeAbstract.m:384-395 -> update :288-372)
    followed by the single on-axis relay sum (telescopeAbstract.m:446-447).
    The stored screens advance by floor(o)-floor(o_prev) exact pixel
    shifts (o = cumulative offset (idx+1)*step, each shift preceded by a
    conditional-Gaussian border draw); the sub-pixel remainder frac(o) is
    applied only to the *returned* pupil phase.

    Layer-vectorized (round 5): border draws and frame assembly run for
    all L layers in single batched ops; only the cheap per-layer slice
    selection stays a Python loop.  Layers whose own sub-step budget is
    below the global bound take masked no-op rounds (the wasted draw
    never touches the state).  Under ``vmap`` with an UNBATCHED
    state/key this whole function traces unbatched -- the shared-
    turbulence Monte-Carlo path (parallel/montecarlo.run_batch)
    amortizes the evolution over the entire scenario batch.
    """
    if model.impl == "per_layer":
        return advance_per_layer(model, state, idx, key)
    if model.impl == "hybrid":
        return advance_hybrid(model, state, idx, key)
    n = model.size
    L = model.n_layers
    idxf = jnp.asarray(idx, jnp.float32)
    kstep = jax.random.fold_in(key, idx)

    # per-layer whole-pixel shift counts this step (traced) and static
    # signs; K_max bounds the masked sub-step rounds for every layer
    kys, kxs, sgns = [], [], []
    fys, fxs = [], []
    for l in range(L):
        sy, sx = model.step_px[l]
        o_y, o_x = (idxf + 1) * sy, (idxf + 1) * sx
        kys.append((jnp.floor(o_y) - jnp.floor(idxf * sy)).astype(jnp.int32))
        kxs.append((jnp.floor(o_x) - jnp.floor(idxf * sx)).astype(jnp.int32))
        sgns.append((1 if sy > 0 else -1, 1 if sx > 0 else -1))
        fys.append(o_y - jnp.floor(o_y))
        fxs.append(o_x - jnp.floor(o_x))
    K_max = max((max(ns) for ns in model.nsub), default=0)

    phases = state.phases                                       # (L, n, n)
    for s in range(K_max):
        borders = _draw_borders_all(model, phases,
                                    jax.random.fold_in(kstep, s))
        frames = _embed_all(model, phases, borders)
        new = []
        for l in range(L):
            sgn_y, sgn_x = sgns[l]
            do_y = s < jnp.abs(kys[l])
            do_x = s < jnp.abs(kxs[l])
            if model.shift_select == "switch":
                # executes ONLY the taken branch -- wins where the
                # conditional's fixed cost beats materializing 4
                # candidates (R<=128; see shift_select docstring)
                new.append(jax.lax.switch(
                    do_y.astype(jnp.int32) * 2 + do_x.astype(jnp.int32),
                    [lambda fr, ph: ph,
                     lambda fr, ph, sx=sgn_x: _shift_exact(fr, n, 0, sx),
                     lambda fr, ph, sy=sgn_y: _shift_exact(fr, n, sy, 0),
                     lambda fr, ph, sy=sgn_y, sx=sgn_x:
                         _shift_exact(fr, n, sy, sx)],
                    frames[l], phases[l]))
            else:
                new.append(jnp.where(
                    do_y & do_x, _shift_exact(frames[l], n, sgn_y, sgn_x),
                    jnp.where(do_y, _shift_exact(frames[l], n, sgn_y, 0),
                              jnp.where(do_x,
                                        _shift_exact(frames[l], n, 0,
                                                     sgn_x),
                                        phases[l]))))
        phases = jnp.stack(new)

    # output-side fractional sampling (never written back)
    borders = _draw_borders_all(model, phases,
                                jax.random.fold_in(kstep, K_max))
    frames = _embed_all(model, phases, borders)
    out = jnp.zeros((n, n), dtype=phases.dtype)
    for l in range(L):
        out = out + _shift_dynamic(frames[l], n, fys[l], fxs[l])
    return EdgeFlowState(phases=phases), out


def _embed_layer(phase, top, bottom, left, right):
    """One (n+2, n+2) frame from a layer's phase and border segments
    (concat assembly, no scatter): body rows get (left, right) columns,
    then the full-width top/bottom rows close the ring."""
    body = jnp.concatenate([left[:, None], phase, right[:, None]], axis=1)
    return jnp.concatenate([top[None, :], body, bottom[None, :]], axis=0)


def _select_shift(frame, phase, n, do_y, do_x, sgn_y, sgn_x, strategy):
    """Pick phase' among the 4 candidate exact shifts of one layer's
    frame.  "switch" executes only the taken branch; "where"
    materializes the candidates and selects (see
    EdgeFlowModel.shift_select)."""
    if strategy == "switch":
        return jax.lax.switch(
            do_y.astype(jnp.int32) * 2 + do_x.astype(jnp.int32),
            [lambda fr, ph: ph,
             lambda fr, ph: _shift_exact(fr, n, 0, sgn_x),
             lambda fr, ph: _shift_exact(fr, n, sgn_y, 0),
             lambda fr, ph: _shift_exact(fr, n, sgn_y, sgn_x)],
            frame, phase)
    return jnp.where(
        do_y & do_x, _shift_exact(frame, n, sgn_y, sgn_x),
        jnp.where(do_y, _shift_exact(frame, n, sgn_y, 0),
                  jnp.where(do_x, _shift_exact(frame, n, 0, sgn_x),
                            phase)))


def advance_hybrid(model: EdgeFlowModel, state: EdgeFlowState, idx, key):
    """Batched border draws + per-layer frame/shift handling.

    This path keeps the (L, nX) batched draw
    (one einsum streaming the operators once) and assembles/slices
    UNSTACKED (n+2, n+2) frames per layer, where `_shift_exact` is a
    plain contiguous 2D slice.  Same per-step PRNG stream as the
    vectorized impl (bit-equal draws).
    """
    n = model.size
    L = model.n_layers
    idxf = jnp.asarray(idx, jnp.float32)
    kstep = jax.random.fold_in(key, idx)

    kys, kxs, sgns, fys, fxs = [], [], [], [], []
    for l in range(L):
        sy, sx = model.step_px[l]
        o_y, o_x = (idxf + 1) * sy, (idxf + 1) * sx
        kys.append((jnp.floor(o_y) - jnp.floor(idxf * sy)).astype(jnp.int32))
        kxs.append((jnp.floor(o_x) - jnp.floor(idxf * sx)).astype(jnp.int32))
        sgns.append((1 if sy > 0 else -1, 1 if sx > 0 else -1))
        fys.append(o_y - jnp.floor(o_y))
        fxs.append(o_x - jnp.floor(o_x))
    K_max = max((max(ns) for ns in model.nsub), default=0)

    phases = state.phases                                       # (L, n, n)
    for s in range(K_max):
        borders = _draw_borders_all(model, phases,
                                    jax.random.fold_in(kstep, s))
        top, bottom, left, right = _border_segments(borders, n)
        new = []
        for l in range(L):
            frame = _embed_layer(phases[l], top[l], bottom[l],
                                 left[l], right[l])
            new.append(_select_shift(
                frame, phases[l], n, s < jnp.abs(kys[l]),
                s < jnp.abs(kxs[l]), *sgns[l], model.shift_select))
        phases = jnp.stack(new)

    borders = _draw_borders_all(model, phases,
                                jax.random.fold_in(kstep, K_max))
    top, bottom, left, right = _border_segments(borders, n)
    out = jnp.zeros((n, n), dtype=phases.dtype)
    for l in range(L):
        frame = _embed_layer(phases[l], top[l], bottom[l],
                             left[l], right[l])
        out = out + _shift_dynamic(frame, n, fys[l], fxs[l])
    return EdgeFlowState(phases=phases), out


def advance_per_layer(model: EdgeFlowModel, state: EdgeFlowState, idx,
                      key):
    """The round-4 per-layer implementation, kept for the A/B breakdown
    (benchmarks/edge_flow_breakdown.py).  Distinct PRNG stream from
    `advance` (per-layer vs per-step folds) -- statistically equivalent,
    not bit-equal."""
    n = model.size
    idxf = jnp.asarray(idx, jnp.float32)
    new_phases, outs = [], []
    for l in range(model.n_layers):
        kl = jax.random.fold_in(jax.random.fold_in(key, l), idx)
        ph = state.phases[l]
        sy, sx = model.step_px[l]
        o_now = ((idxf + 1) * sy, (idxf + 1) * sx)
        ky = (jnp.floor(o_now[0]) - jnp.floor(idxf * sy)).astype(jnp.int32)
        kx = (jnp.floor(o_now[1]) - jnp.floor(idxf * sx)).astype(jnp.int32)
        sgn_y = 1 if sy > 0 else -1
        sgn_x = 1 if sx > 0 else -1
        K = max(model.nsub[l])
        for s in range(K):
            border = _draw_border(model, l, ph, jax.random.fold_in(kl, s))
            frame = _embed(model, ph, border)
            do_y = s < jnp.abs(ky)
            do_x = s < jnp.abs(kx)
            ph = jnp.where(
                do_y & do_x, _shift_exact(frame, n, sgn_y, sgn_x),
                jnp.where(do_y, _shift_exact(frame, n, sgn_y, 0),
                          jnp.where(do_x, _shift_exact(frame, n, 0, sgn_x),
                                    ph)))
        border = _draw_border(model, l, ph, jax.random.fold_in(kl, K))
        frame = _embed(model, ph, border)
        fy = o_now[0] - jnp.floor(o_now[0])
        fx = o_now[1] - jnp.floor(o_now[1])
        outs.append(_shift_dynamic(frame, n, fy, fx))
        new_phases.append(ph)
    state = EdgeFlowState(phases=jnp.stack(new_phases))
    return state, jnp.sum(jnp.stack(outs), axis=0)


def rollout(model: EdgeFlowModel, state: EdgeFlowState, key,
            n_steps: int, fit_full, mask, mask_npix, mag=1.0):
    """Open-loop pre-pass: evolve + piston-removed Zernike fit per step
    (the ID data generator; equivalent of README.md:69-93 with this flow).
    Returns (final state, (n_steps, n_modes) coefficients).
    """

    def step(st, idx):
        st, raw = advance(model, st, idx, key)
        msk = mask.astype(raw.dtype)
        mean = jnp.sum(raw * msk) / mask_npix
        ph = (raw - mean) * msk * mag
        return st, jnp.matmul(fit_full, ph.reshape(-1),
                              precision=jax.lax.Precision.HIGHEST)

    return jax.lax.scan(step, state, jnp.arange(n_steps))
