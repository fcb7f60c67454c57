"""Tensor-parallel estimator: measurement-dimension sharding.

The scenario axis (parallel/montecarlo.py) is the framework's
data-parallel design center; this module adds the TENSOR-parallel axis
for configurations where a single estimator evaluation outgrows one
chip -- extreme-resolution pupils (R >= 2k) or wide-field mosaics where
the stacked measurement p = n_div (2c+1)^2 and the linearized operators
A_s/S get large.  (The reference has no parallelism at all,
SURVEY.md 2/5.8; this axis exists only in this design.)

Sharding layout (shard_map over a named "tp" axis):

* estimate:  S (nx, p) is sharded along p (columns), y along its last
  dim; each device contracts its local slice and a single `psum` over
  a psum reduces the (nx,) partials -- the classic contraction split.
* measure:   the partial-DFT rows S1 = A X A^T contract over the pupil
  dimension R; A (w, R) is sharded along R and X row-sharded, partial
  products psum-reduced.  Here we shard the cheaper estimate path and
  the Jacobian normal equations, which dominate for large p.

Everything is a pure function over a `jax.sharding.Mesh`; tested
against the unsharded path on the virtual CPU mesh.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TP_AXIS = "tp"


def tp_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    import numpy as np
    return Mesh(np.asarray(devs[:n]), (TP_AXIS,))


def pad_to(x, mult: int, axis: int):
    """Zero-pad so shape[axis] is a multiple of mult (zeros are inert in
    every contraction here)."""
    n = x.shape[axis]
    r = (-n) % mult
    if r == 0:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, r)
    return jnp.pad(x, pad)


def sharded_estimate(solve_op: jnp.ndarray, b_s: jnp.ndarray,
                     y: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """x = solve_op @ (y - b_s) with the p-dimension sharded.

    solve_op: (nx, p); y: (..., p).  Each device holds a p/n shard of
    solve_op's columns and of y; one psum reduces the partials.
    """
    n = mesh.devices.size
    S = pad_to(solve_op, n, 1)
    b = pad_to(b_s, n, 0)
    yp = pad_to(y, n, -1)

    def local(S_loc, b_loc, y_loc):
        part = (y_loc - b_loc) @ S_loc.T
        return jax.lax.psum(part, TP_AXIS)

    # (...,p) batch dims replicate; only the last (pixel) dim shards
    y_spec = P(*([None] * (y.ndim - 1) + [TP_AXIS]))
    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, TP_AXIS), P(TP_AXIS), y_spec),
        out_specs=P(),
    )
    S = jax.device_put(S, NamedSharding(mesh, P(None, TP_AXIS)))
    b = jax.device_put(b, NamedSharding(mesh, P(TP_AXIS)))
    yp = jax.device_put(yp, NamedSharding(mesh, y_spec))
    return jax.jit(fn)(S, b, yp)


def sharded_normal_equations(A_s: jnp.ndarray, y_res: jnp.ndarray,
                             mesh: Mesh):
    """(A' A, A' y) with the p-dimension sharded -- the building block of
    re-linearized Gauss-Newton at scale: each device accumulates its
    shard's contribution to the (nx, nx) Gram and (nx,) gradient, then
    one psum pair reduces them (p can be millions; nx stays tiny)."""
    n = mesh.devices.size
    A = pad_to(A_s, n, 0)
    yp = pad_to(y_res, n, 0)

    def local(A_loc, y_loc):
        G = jax.lax.psum(A_loc.T @ A_loc, TP_AXIS)
        g = jax.lax.psum(y_loc @ A_loc, TP_AXIS)
        return G, g

    fn = jax.shard_map(local, mesh=mesh,
                       in_specs=(P(TP_AXIS, None), P(TP_AXIS)),
                       out_specs=(P(), P()))
    A = jax.device_put(A, NamedSharding(mesh, P(TP_AXIS, None)))
    yp = jax.device_put(yp, NamedSharding(mesh, P(TP_AXIS)))
    return jax.jit(fn)(A, yp)
