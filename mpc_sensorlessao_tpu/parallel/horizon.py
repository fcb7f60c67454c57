"""Device-distributed block-tridiagonal solves: horizon parallelism.

The framework's "sequence parallel" axis (SURVEY.md 5.7): the fastMPC
dual Schur complement is stage-block-tridiagonal over the horizon
(ops/newton_kkt.py, ops/block_tridiag.py).  Single-device cyclic
reduction already gives O(log T) depth; for horizons that outgrow one
chip this module distributes the stage axis over a device mesh by
SUB-STRUCTURING (the classic partitioned/Spike scheme):

1. each device owns a contiguous chunk of stages and condenses its
   INTERIOR unknowns onto its two boundary blocks with one local
   block-tridiagonal solve (ops.block_tridiag.cr_solve, multi-RHS);
2. the condensed system -- 2 blocks per device, still block-tridiagonal,
   size 2 P n instead of T n -- is `all_gather`ed (the ONLY collective:
   2P n^2 + 2P n floats between devices) and solved redundantly on every
   device;
3. each device back-substitutes its interior unknowns locally.

Communication volume is independent of the horizon length; arithmetic
is embarrassingly parallel except the tiny reduced solve.  SPD systems
(Cholesky-based elimination), like everything in block_tridiag.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import block_tridiag

HZ_AXIS = "hz"

# jitted solver cache: rebuilding the shard_map closure per call would
# retrace/recompile every time; key on the static configuration
_SOLVER_CACHE: dict = {}


def hz_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (HZ_AXIS,))


def _condense(diag, sub, rhs):
    """Condense one chunk's interior onto its (first, last) blocks.

    diag/sub/rhs: (Jl, n, n) / (Jl, n, n) / (Jl, n) local blocks --
    sub[0] couples to the PREVIOUS chunk's last block.  The coupling of
    this chunk's last row to the NEXT chunk's first block enters the
    reduced system through the neighbor's own gathered sub-block (the
    SPD solver uses S[j, j+1] = sub[j+1]^T).

    Returns the reduced 2x2-of-blocks quantities and the interior
    solve artifacts for back-substitution.
    """
    Jl, n, _ = diag.shape
    # interior system: stages 1..Jl-2
    d_i = diag[1:-1]
    s_i = sub[2:-1]                      # couplings inside the interior
    s_i = jnp.concatenate([jnp.zeros((1, n, n), diag.dtype), s_i], axis=0)
    # multi-RHS: [b_I | E_f L_1 | E_l L_{Jl-1}^T]
    k = 1 + 2 * n
    R = jnp.zeros((Jl - 2, n, k), diag.dtype)
    R = R.at[:, :, 0].set(rhs[1:-1])
    R = R.at[0, :, 1:1 + n].set(sub[1])                  # L_1
    R = R.at[-1, :, 1 + n:].set(sub[Jl - 1].T)           # L_{Jl-1}^T
    sol = block_tridiag.cr_solve(d_i, s_i, R)            # (Jl-2, n, k)
    z_i = sol[:, :, 0]
    Wf = sol[:, :, 1:1 + n]
    Wl = sol[:, :, 1 + n:]

    L1T = sub[1].T
    Lm = sub[Jl - 1]
    # row f:  [D_0 - L_1^T Wf_1] x_f - L_1^T Wl_1 x_l + L_0 x_prev = bf'
    Dff = diag[0] - L1T @ Wf[0]
    bf = rhs[0] - L1T @ z_i[0]
    # row l:  -Lm Wf_last x_f + [D_last - Lm Wl_last] x_l
    #         + (L_0^{next})^T x_next = bl'
    Dll = diag[-1] - Lm @ Wl[-1]
    Clf = -Lm @ Wf[-1]                                   # l <- f coupling
    bl = rhs[-1] - Lm @ z_i[-1]
    # the f <- l coupling (-L1^T Wl[0]) is Clf^T by symmetry of the
    # condensation and enters the reduced SPD system via cr_solve's
    # S[j, j+1] = sub[j+1]^T convention -- only Clf is needed
    return Dff, Dll, Clf, bf, bl, sub[0], z_i, Wf, Wl


def solve_distributed(diag, sub, rhs, mesh: Mesh) -> jnp.ndarray:
    """Solve the SPD block-tridiagonal system with the stage axis
    sharded over ``mesh``.

    diag: (J, n, n); sub: (J, n, n) with sub[0] ignored; rhs: (J, n).
    J must be a multiple of the device count with J/P >= 3.
    """
    J, n, _ = diag.shape
    Pn = mesh.devices.size
    assert J % Pn == 0 and J // Pn >= 3, (J, Pn)

    cache_key = (mesh, J, n)
    if cache_key in _SOLVER_CACHE:
        fn = _SOLVER_CACHE[cache_key]
        dshard = NamedSharding(mesh, P(HZ_AXIS))
        args = (jax.device_put(diag.reshape(Pn, J // Pn, n, n), dshard),
                jax.device_put(sub.reshape(Pn, J // Pn, n, n), dshard),
                jax.device_put(rhs.reshape(Pn, J // Pn, n), dshard))
        return fn(*args).reshape(J, n)

    def local(diag_l, sub_l, rhs_l):
        p = jax.lax.axis_index(HZ_AXIS)
        (Dff, Dll, Clf, bf, bl, L0,
         z_i, Wf, Wl) = _condense(diag_l[0], sub_l[0], rhs_l[0])
        # reduced block-tridiagonal pieces for this device: rows
        # (2p, 2p+1) with diag (Dff, Dll), sub-blocks (L0 into row f
        # from the previous device's l; Clf into row l from f)
        red_d = jnp.stack([Dff, Dll])
        red_s = jnp.stack([L0, Clf])
        red_b = jnp.stack([bf, bl])
        gd = jax.lax.all_gather(red_d, HZ_AXIS).reshape(2 * Pn, n, n)
        gs = jax.lax.all_gather(red_s, HZ_AXIS).reshape(2 * Pn, n, n)
        gb = jax.lax.all_gather(red_b, HZ_AXIS).reshape(2 * Pn, n)
        # symmetrize the reduced diagonal (condensation is symmetric in
        # exact arithmetic; enforce it for the SPD solver)
        gd = 0.5 * (gd + jnp.swapaxes(gd, -1, -2))
        y = block_tridiag.cr_solve(gd, gs, gb)           # (2P, n)
        xf = y[2 * p]
        xl = y[2 * p + 1]
        x_i = z_i - Wf @ xf - Wl @ xl
        x = jnp.concatenate([xf[None], x_i, xl[None]], axis=0)
        return x[None]

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(HZ_AXIS), P(HZ_AXIS), P(HZ_AXIS)),
        out_specs=P(HZ_AXIS),
    ))
    _SOLVER_CACHE[cache_key] = fn
    dshard = NamedSharding(mesh, P(HZ_AXIS))
    args = (jax.device_put(diag.reshape(Pn, J // Pn, n, n), dshard),
            jax.device_put(sub.reshape(Pn, J // Pn, n, n), dshard),
            jax.device_put(rhs.reshape(Pn, J // Pn, n), dshard))
    out = fn(*args)
    return out.reshape(J, n)
