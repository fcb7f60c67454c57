"""Condensed-QP MPC problem assembly.

Re-implements the reference's `MPC_DesignMatrices` factory and per-step QP
assembly (reference: main.mlx CDATA 13; README.md:414-501) as pure jitted
functions over static horizon N:

  X_pred = M1 x0 + M2 x0_pre + B_conv U + b_ref
  J      = U' H U + r' U + c

with M1/M2 the VAR(2) free-response recursions, B_conv = blkdiag(B,...,B),
H = 0.5 (B'QB + (B'QB)') + R_tilda, and the ramp-difference matrix E.

VAR(1) is the A2=0 special case (then M2 rows vanish and the reference's
Fast_MPC/VAR_1 semantics apply).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import struct


@struct.dataclass
class MPCMatrices:
    """Static-per-scenario condensed QP operators (device arrays)."""

    M1: jnp.ndarray           # (N*nx, nx)
    M2: jnp.ndarray           # (N*nx, nx)
    B_conv: jnp.ndarray       # (N*nx, N*nu) block diagonal
    Q_tilda: jnp.ndarray      # (N*nx, N*nx)
    R_tilda: jnp.ndarray      # (N*nu, N*nu)
    E: jnp.ndarray            # (N*nu, N*nu) ramp-difference
    H: jnp.ndarray            # (N*nu, N*nu)
    closed_form: jnp.ndarray  # (N*nu, N*nu): U = closed_form @ r
    M1B: jnp.ndarray          # (N*nx, nu) = M1 @ B (b_ref precompute)
    M2B: jnp.ndarray          # (N*nx, nu)
    horizon: int = struct.field(pytree_node=False)

    @property
    def nx(self) -> int:
        return self.M1.shape[1]

    @property
    def nu(self) -> int:
        return self.M1B.shape[1]


def free_response_matrices(A1, A2, horizon: int):
    """M1/M2 stage recursion (main.mlx CDATA 13):

    M1_0=A1, M1_1=A1^2+A2, M1_i=A1 M1_{i-1} + A2 M1_{i-2};
    M2_0=A2, M2_1=A1 A2,   M2_i=M1_{i-1} A2.
    """
    m1_blocks = [A1]
    m2_blocks = [A2]
    if horizon > 1:
        m1_blocks.append(A1 @ A1 + A2)
        m2_blocks.append(A1 @ A2)
    for i in range(2, horizon):
        m1_blocks.append(A1 @ m1_blocks[i - 1] + A2 @ m1_blocks[i - 2])
        m2_blocks.append(m1_blocks[i - 1] @ A2)
    return (jnp.concatenate(m1_blocks, axis=0),
            jnp.concatenate(m2_blocks, axis=0))


def ramp_difference_matrix(nu: int, horizon: int, dtype=jnp.float32):
    """E: bidiagonal +/-I blocks (main.mlx CDATA 13; N=1 -> I)."""
    E = np.eye(horizon * nu)
    for i in range(1, horizon):
        E[i * nu:(i + 1) * nu, (i - 1) * nu:i * nu] = -np.eye(nu)
    return jnp.asarray(E, dtype=dtype)


@partial(jax.jit, static_argnames=("horizon",))
def design_matrices(A1, A2, B, horizon: int, Q, P, R) -> MPCMatrices:
    """Full design-matrix factory (main.mlx CDATA 13, README.md:416-417).

    Q/P/R are full (nx,nx)/(nu,nu) stage-cost matrices; A2 may be zeros for
    VAR(1).
    """
    nx, nu = B.shape
    N = horizon
    dtype = B.dtype
    M1, M2 = free_response_matrices(A1, A2, N)

    eyeN = jnp.eye(N, dtype=dtype)
    B_conv = jnp.kron(eyeN, B)
    q_blocks = [Q] * (N - 1) + [P]
    Q_tilda = jnp.zeros((N * nx, N * nx), dtype=dtype)
    for i, Qi in enumerate(q_blocks):
        Q_tilda = Q_tilda.at[i * nx:(i + 1) * nx, i * nx:(i + 1) * nx].set(Qi)
    R_tilda = jnp.kron(eyeN, R)

    BtQB = B_conv.T @ Q_tilda @ B_conv
    H = 0.5 * (BtQB + BtQB.T) + R_tilda

    # closed-form solver operator: U = -0.5 pinv(H'H) H' r (README.md:417)
    closed_form = -0.5 * jnp.linalg.pinv(H.T @ H) @ H.T

    return MPCMatrices(
        M1=M1, M2=M2, B_conv=B_conv, Q_tilda=Q_tilda, R_tilda=R_tilda,
        E=ramp_difference_matrix(nu, N, dtype), H=H, closed_form=closed_form,
        M1B=M1 @ B, M2B=M2 @ B, horizon=N,
    )


def b_ref(mats: MPCMatrices, u_prev1, u_prev2) -> jnp.ndarray:
    """Reference-trajectory offset from past inputs (README.md:491-497).

    b_ref = -M1 B u[k-1] - M2 B u[k-2]; pass zeros for missing history.
    Batched over leading dims.
    """
    return -(u_prev1 @ mats.M1B.T) - (u_prev2 @ mats.M2B.T)


def gradient_terms(mats: MPCMatrices, x0, x0_pre, bref):
    """(r, c, x_free): r = 2 B' Q (M1 x0 + M2 x0_pre + b_ref), c = quad term
    (README.md:500-501).  Batched over leading dims."""
    x_free = x0 @ mats.M1.T + x0_pre @ mats.M2.T + bref       # (..., N*nx)
    qx = x_free @ mats.Q_tilda.T
    r = 2.0 * (qx @ mats.B_conv)
    c = jnp.sum(x_free * qx, axis=-1)
    return r, c, x_free


def predicted_states(mats: MPCMatrices, U, x_free) -> jnp.ndarray:
    """X = x_free + B_conv U (README.md:592)."""
    return x_free + U @ mats.B_conv.T


def cost(mats: MPCMatrices, U, r, c) -> jnp.ndarray:
    """J = U'HU + r'U + c (README.md:588)."""
    return jnp.sum(U * (U @ mats.H.T), axis=-1) + jnp.sum(r * U, axis=-1) + c
