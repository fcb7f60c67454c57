"""MPC solver backends.

The reference offers four interchangeable solvers: CVX (README.md:506-520),
fmincon (README.md:522-534), a closed-form pseudo-inverse (README.md:417)
and fastMPC (Fast_MPC/).  This module provides their batched JAX equivalents
on a single batched API:

* ``closed_form``      -- U = closed_form_matrix @ r (one matmul);
* ``fastmpc``          -- structured batched Newton-KKT
                          (ops.newton_kkt; the real-time path);
* ``fastmpc_dense``    -- literal dense assembly of the stacked problem
                          (z-interleaved, exactly the MATLAB layout) used
                          as cross-check oracle and for arbitrary
                          inequality rows (VAR_1 ramp constraints);
* ``admm``             -- fixed-iteration ADMM on the condensed box+ramp QP
                          (the CVX replacement: same constraint set as
                          README.md:512-517, deterministic cost per step).

All solvers are pure jittable functions; batch by `vmap`.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import newton_kkt
from .mpc import MPCMatrices


# ---------------------------------------------------------------------------
# closed form (README.md:417: U = -0.5 pinv(H'H) H' r)
# ---------------------------------------------------------------------------

def closed_form(mats: MPCMatrices, r: jnp.ndarray) -> jnp.ndarray:
    """Unconstrained minimizer of U'HU + r'U; batched over leading dims."""
    return r @ mats.closed_form.T


def geninv(G: jnp.ndarray, tol_factor: float = 1e-9) -> jnp.ndarray:
    """Moore-Penrose inverse via full-rank Cholesky (Courrieu 2008).

    Port of the reference's `geninv` timing variant (main.mlx CDATA 15):
    A = G'G (or GG'), full-rank Cholesky L with column dropping, then
    Y = L (L'L)^-2 L' G'.  Here the rank-revealing column drop is replaced
    by a fixed-shape pass that zeroes deficient columns (XLA needs static
    shapes); full-rank inputs match MATLAB's result.
    """
    m, n = G.shape
    transpose = m < n
    A = (G @ G.T) if transpose else (G.T @ G)
    k = A.shape[0]
    dA = jnp.diag(A)
    tol = jnp.min(jnp.where(dA > 0, dA, jnp.inf)) * tol_factor

    def body(j, L):
        col = A[:, j] - L @ L[j, :]
        piv = col[j]
        good = piv > tol
        denom = jnp.sqrt(jnp.where(good, piv, 1.0))
        newcol = jnp.where(good, col / denom, 0.0)
        newcol = newcol * (jnp.arange(k) >= j)
        return L.at[:, j].set(newcol)

    L = jax.lax.fori_loop(0, k, body, jnp.zeros_like(A))
    M = jnp.linalg.pinv(L.T @ L)
    core = L @ M @ M @ L.T
    return (G.T @ core) if transpose else (core @ G.T)


# ---------------------------------------------------------------------------
# dense stacked fastMPC (oracle; literal MATLAB layout)
# ---------------------------------------------------------------------------

class DenseProblem(NamedTuple):
    """Dense stacked-z problem: min z'Hz + g'z + k*(-sum log(h-Pz))
    s.t. Cz = b.  Matches Fast_MPC2's assembly exactly."""

    H: jnp.ndarray
    g: jnp.ndarray
    P: jnp.ndarray
    h: jnp.ndarray
    C: jnp.ndarray
    b: jnp.ndarray
    z_init: jnp.ndarray
    barrier_k: jnp.ndarray


def assemble_dense(Q, R, Qf, A1, A2, B, w, x0, x0_pre, u_prev,
                   u_min, u_max, du_min, du_max, horizon: int,
                   ramp: bool, barrier_k: float) -> DenseProblem:
    """Literal numpy/jnp port of the stacked assembly.

    Layout z = (u_0, x_1, u_1, x_2, ...) (fast_mpc_objective.m:50-55);
    equality rows per fast_mpc_eq_const.m:38-46 (VAR(1): pass A2=0);
    inequality = box rows (fast_mpc_ineq_const.m:42-56) plus, when
    ``ramp``, the VAR_1 ramp rows (VAR_1/fast_mpc_ineq_const.m:58-76).
    """
    n, m = B.shape[0], B.shape[1]
    T = horizon
    Z = T * (n + m)
    dt = B.dtype

    def u_off(t):
        return t * (n + m)

    def x_off(t):  # x_{t+1}
        return t * (n + m) + m

    H = jnp.zeros((Z, Z), dtype=dt)
    for t in range(T):
        H = H.at[u_off(t):u_off(t) + m, u_off(t):u_off(t) + m].set(R)
        Qt = Qf if t == T - 1 else Q
        H = H.at[x_off(t):x_off(t) + n, x_off(t):x_off(t) + n].set(Qt)
    g = jnp.zeros((Z,), dtype=dt)

    C = jnp.zeros((T * n, Z), dtype=dt)
    b = jnp.zeros((T * n,), dtype=dt)
    eye_n = jnp.eye(n, dtype=dt)
    w = w.reshape(T, n)
    for i in range(T):
        C = C.at[i * n:(i + 1) * n, u_off(i):u_off(i) + m].set(-B)
        C = C.at[i * n:(i + 1) * n, x_off(i):x_off(i) + n].set(eye_n)
        if i >= 1:
            C = C.at[i * n:(i + 1) * n, x_off(i - 1):x_off(i - 1) + n].set(-A1)
        if i >= 2:
            C = C.at[i * n:(i + 1) * n, x_off(i - 2):x_off(i - 2) + n].set(-A2)
        bi = w[i]
        if i == 0:
            bi = bi + A1 @ x0 + A2 @ x0_pre
        elif i == 1:
            bi = bi + A2 @ x0
        b = b.at[i * n:(i + 1) * n].set(bi)

    eye_m = jnp.eye(m, dtype=dt)
    rows_P = []
    rows_h = []
    for t in range(T):
        blk = jnp.zeros((2 * m, Z), dtype=dt)
        blk = blk.at[:m, u_off(t):u_off(t) + m].set(eye_m)
        blk = blk.at[m:, u_off(t):u_off(t) + m].set(-eye_m)
        rows_P.append(blk)
        rows_h.append(jnp.concatenate([u_max, -u_min]))
    if ramp:
        for t in range(T):
            blk = jnp.zeros((2 * m, Z), dtype=dt)
            blk = blk.at[:m, u_off(t):u_off(t) + m].set(eye_m)
            blk = blk.at[m:, u_off(t):u_off(t) + m].set(-eye_m)
            if t == 0:
                rows_h.append(jnp.concatenate(
                    [u_prev + du_max, -u_prev - du_min]))
            else:
                blk = blk.at[:m, u_off(t - 1):u_off(t - 1) + m].set(-eye_m)
                blk = blk.at[m:, u_off(t - 1):u_off(t - 1) + m].set(eye_m)
                rows_h.append(jnp.concatenate([du_max, -du_min]))
            rows_P.append(blk)
    P = jnp.concatenate(rows_P, axis=0)
    h = jnp.concatenate(rows_h, axis=0)

    z0 = jnp.zeros((Z,), dtype=dt)
    if ramp:
        # ramp-feasible init (see newton_kkt.init_state: the reference's
        # midpoint init is infeasible for ramp rows when |u_prev|>du_max)
        margin = 1e-3 * (u_max - u_min)
        u_init = jnp.clip(u_prev, u_min + margin, u_max - margin)
    else:
        u_init = (u_min + u_max) / 2.0
    for t in range(T):
        z0 = z0.at[u_off(t):u_off(t) + m].set(u_init)

    return DenseProblem(H=H, g=g, P=P, h=h, C=C, b=b, z_init=z0,
                        barrier_k=jnp.asarray(barrier_k, dtype=dt))


def _dense_residuals(p: DenseProblem, z, nu):
    d = 1.0 / (p.h - p.P @ z)
    rd = 2.0 * p.H @ z + p.g + p.barrier_k * (p.P.T @ d) + p.C.T @ nu
    rp = p.C @ z - p.b
    return rd, rp, d


def dense_newton_solve(p: DenseProblem, n_newton: int = 1,
                       n_candidates: int = 16) -> jnp.ndarray:
    """Infeasible-start Newton on the dense problem
    (inf_newton_solver.m:1-43), deterministic nu=0 init."""
    z = p.z_init
    nu = jnp.zeros_like(p.b)

    def step(carry):
        z, nu = carry
        rd, rp, d = _dense_residuals(p, z, nu)
        Phi = 2.0 * p.H + p.barrier_k * (p.P.T * d ** 2) @ p.P
        chol = jax.scipy.linalg.cho_factor(Phi, lower=True)
        phinv_ct = jax.scipy.linalg.cho_solve(chol, p.C.T)
        schur = p.C @ phinv_ct
        phinv_rd = jax.scipy.linalg.cho_solve(chol, rd)
        beta = -rp + p.C @ phinv_rd
        s_chol = jax.scipy.linalg.cho_factor(schur, lower=True)
        dnu = jax.scipy.linalg.cho_solve(s_chol, -beta)
        dz = jax.scipy.linalg.cho_solve(chol, -rd - p.C.T @ dnu)

        base = jnp.sqrt(jnp.sum(rd ** 2) + jnp.sum(rp ** 2))
        ts = 0.5 ** jnp.arange(n_candidates, dtype=z.dtype)

        def cand(t):
            zc, nc = z + t * dz, nu + t * dnu
            slack_ok = jnp.all(p.h - p.P @ zc > 0)
            rdc, rpc, _ = _dense_residuals(p, zc, nc)
            norm = jnp.sqrt(jnp.sum(rdc ** 2) + jnp.sum(rpc ** 2))
            return jnp.logical_and(norm <= (1 - 1e-4 * t) * base, slack_ok)

        oks = jax.vmap(cand)(ts)
        t = jnp.where(jnp.any(oks), ts[jnp.argmax(oks)], ts[-1])
        return z + t * dz, nu + t * dnu

    for _ in range(n_newton):
        z, nu = step((z, nu))
    return z


def unpack_controls(z: jnp.ndarray, n: int, m: int, horizon: int):
    """z -> (U (T,m), X (T,n)) (the unpack loop, README.md:558-568)."""
    zz = z.reshape(horizon, n + m)
    return zz[:, :m], zz[:, m:]


# ---------------------------------------------------------------------------
# ADMM on the condensed box+ramp QP (CVX-equivalent backend)
# ---------------------------------------------------------------------------

class ADMMInfo(NamedTuple):
    """Convergence telemetry (rms over constraint rows).

    primal_rms: rms of [U - z1; EU - z2] (constraint violation of the
                consensus split);
    dual_rms:   rms of rho [z1 - z1_prev; E'(z2 - z2_prev)] (stationarity);
    converged:  both below tol (False when tol is None -- nothing was
                requested, nothing is claimed).
    """

    primal_rms: jnp.ndarray
    dual_rms: jnp.ndarray
    rho: jnp.ndarray
    converged: jnp.ndarray


@partial(jax.jit, static_argnames=("n_iter", "tol", "adapt_rounds",
                                   "return_info"))
def admm_condensed(mats: MPCMatrices, r, U_min, U_max, dU_min, dU_max,
                   rho: float | None = None,
                   n_iter: int = 400,
                   tol: float | None = None,
                   adapt_rounds: int = 0,
                   return_info: bool = False):
    """min U'HU + r'U  s.t. U_min<=U<=U_max, dU_min<=E U<=dU_max
    (the CVX problem, README.md:512-518), via two-block ADMM with a
    precomputed factorization.  Batched over leading dims of r/U_min/...
    via vmap if needed (operators are shared).

    ``rho`` defaults to the mean curvature scale trace(2H)/Z so the dual
    updates are conditioned against the reference's Q~1.5e4 weights.
    ``adapt_rounds`` > 0 splits the budget into rounds with residual-
    balancing rho updates between them (rho *= sqrt(primal/dual); each
    round refactors once -- adaptive rho with a per-iteration
    factorization would defeat the precomputed Cholesky).
    ``return_info=True`` additionally returns :class:`ADMMInfo`, so a
    user sweeping Q/R scales can SEE non-convergence instead of silently
    consuming a half-converged iterate; with ``tol`` set, converged =
    primal_rms < tol and dual_rms < tol."""
    E = mats.E
    Z = mats.H.shape[0]
    if rho is None:
        rho = jnp.trace(2.0 * mats.H) / Z
    rho = jnp.asarray(rho, dtype=mats.H.dtype)

    def run(rho, init, n):
        M = 2.0 * mats.H + rho * (jnp.eye(Z, dtype=mats.H.dtype)
                                  + E.T @ E)
        chol = jax.scipy.linalg.cho_factor(M, lower=True)

        def body(_, carry):
            U, z1, z2, y1, y2, _, _ = carry
            rhs = -r + rho * (z1 - y1) + E.T @ (rho * (z2 - y2))
            U = jax.scipy.linalg.cho_solve(chol, rhs)
            EU = U @ E.T
            z1n = jnp.clip(U + y1, U_min, U_max)
            z2n = jnp.clip(EU + y2, dU_min, dU_max)
            y1 = y1 + U - z1n
            y2 = y2 + EU - z2n
            rp = jnp.sqrt((jnp.sum((U - z1n) ** 2)
                           + jnp.sum((EU - z2n) ** 2)) / (2 * Z))
            rd = rho * jnp.sqrt(
                (jnp.sum((z1n - z1) ** 2)
                 + jnp.sum(((z2n - z2) @ E) ** 2)) / (2 * Z))
            return U, z1n, z2n, y1, y2, rp, rd

        return jax.lax.fori_loop(0, n, body, init)

    U0 = jnp.zeros_like(r)
    zero = jnp.asarray(0.0, dtype=mats.H.dtype)
    state = (U0, U0, U0 @ E.T, U0, U0 @ E.T, zero, zero)
    rounds = max(1, adapt_rounds + 1)
    per = max(1, n_iter // rounds)
    for k in range(rounds):
        state = run(rho, state, per)
        if k < rounds - 1:
            rp, rd = state[-2], state[-1]
            # residual balancing (Boyd et al. 2011 sect. 3.4.1); the
            # scaled duals y = lambda/rho must be rescaled with rho
            ratio = jnp.sqrt((rp + 1e-12) / (rd + 1e-12))
            scale = jnp.clip(ratio, 0.1, 10.0)
            rho_new = rho * scale
            U, z1, z2, y1, y2, rp, rd = state
            state = (U, z1, z2, y1 * rho / rho_new, y2 * rho / rho_new,
                     rp, rd)
            rho = rho_new
    U, _, _, _, _, rp, rd = state
    if not return_info:
        return U
    if tol is None:
        converged = jnp.asarray(False)
    else:
        converged = jnp.logical_and(rp < tol, rd < tol)
    return U, ADMMInfo(primal_rms=rp, dual_rms=rd, rho=rho,
                       converged=converged)


# ---------------------------------------------------------------------------
# structured fastMPC facade
# ---------------------------------------------------------------------------

def make_fastmpc_problem(A1, A2, B, q_weight, p_weight, r_weight,
                         u_max, barrier_k, du_max=0.0, u_prev=None,
                         dtype=jnp.float32):
    """Build a FastMPCProblem from reference-style scalar weights
    (README.md:344-356: Q=q*I, P=p*Q..., R=r*I, symmetric box).

    ``du_max``/``u_prev`` populate the VAR_1-style ramp-row data (used only
    with solve(..., ramp=True))."""
    n, m = B.shape
    host = lambda v, size: jnp.asarray(np.full(size, v), dtype=dtype)
    if u_prev is None:
        u_prev = host(0.0, m)
    return newton_kkt.FastMPCProblem(
        A1=A1.astype(dtype), A2=A2.astype(dtype), B=B.astype(dtype),
        q_diag=host(q_weight, n),
        qf_diag=host(p_weight, n),
        r_diag=host(r_weight, m),
        u_min=host(-u_max, m),
        u_max=host(u_max, m),
        barrier_k=jnp.asarray(barrier_k, dtype=dtype),
        du_min=host(-du_max, m),
        du_max=host(du_max, m),
        u_prev=u_prev.astype(dtype),
    )


def fastmpc(prob, x0, x0_pre, w, horizon: int, n_newton: int = 1):
    """Real-time solve; returns stacked U (horizon*m,) like the reference's
    u_lgnw (README.md:558-570).  Single scenario; vmap for batches."""
    state = newton_kkt.solve(prob, x0, x0_pre, w, horizon=horizon,
                             n_newton=n_newton)
    return state.U.reshape(-1)
