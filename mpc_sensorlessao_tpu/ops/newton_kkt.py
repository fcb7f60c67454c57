"""Batched fixed-barrier infeasible-start Newton KKT solves ("fastMPC").

Re-design of the reference solver stack
(reference: Fast_MPC/VAR_2/{inf_newton_solver.m, inf_newton_KKT_H.m,
fast_mpc_objective.m, fast_mpc_eq_const.m, fast_mpc_ineq_const.m,
fast_mpc_init.m, backtracking_inf_newton.m}).  Same mathematics --

  minimize  z'Hz + g'z + k * sum(-log(h - Pz))   s.t.  Cz = b

with z = (u_0, x_1, u_1, x_2, ..., u_{T-1}, x_T), one (or a fixed number
of) infeasible-start Newton steps, barrier k fixed, midpoint primal init --
but a completely different computational shape:

* instead of dense T(n+m) Cholesky + dense Schur (inf_newton_solver.m:24-31,
  which ignores the problem's stage structure), the primal Hessian
  Phi = 2H + k P' D P is handled *blockwise* (it is stage-block-diagonal for
  box constraints, fast_mpc_ineq_const.m:42-56), and the dual Schur
  complement S = C Phi^-1 C' is assembled as a block-banded matrix (n x n
  blocks, bandwidth = VAR order) and factorized once per iteration;
* state is kept as (T, m) control / (T, n) state arrays, so every operation
  is a batched matmul and the whole solver `vmap`s over thousands of
  scenarios into batched einsums;
* the backtracking line search (backtracking_inf_newton.m:3-9, whose loop
  guard never decrements -- a latent infinite loop) becomes a fixed bank of
  candidate step sizes evaluated in parallel, with explicit slack-positivity
  rejection;
* the reference's *random* dual initialization (inf_newton_solver.m:2) is
  replaced by nu=0: for a full Newton step the resulting iterate
  (z+dz, nu+dnu) is exactly independent of the dual init -- S(nu+dnu) =
  rp - C Phi^-1 rd(0) regardless of nu -- so this is equivalence-preserving
  whenever the unit step is accepted, and deterministic.

Costs here are diagonal (the reference pipeline uses scalar * I weights,
README.md:344-346); `solvers.fastmpc_dense` covers general dense costs and
arbitrary inequality rows as a cross-check oracle.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import block_tridiag

# Horizon at which the Schur solve switches from one dense Cholesky to
# block cyclic reduction (O(log T) depth, O(T n^3) work -- see
# ops/block_tridiag.py).  Dense wins for short horizons (fewer, larger
# matmul calls); CR wins asymptotically (the dense factorization is
# O(T^3 n^3)).
CR_MIN_HORIZON = 16


class FastMPCProblem(NamedTuple):
    """Static problem data (per scenario; vmap-compatible).

    A1, A2: (n, n) VAR coefficients (A2 zeros for VAR(1));
    B: (n, m) modal influence;
    q_diag, qf_diag: (n,) stage / terminal state cost diagonals;
    r_diag: (m,) control cost diagonal;
    u_min, u_max: (m,) box bounds (fast_mpc_ineq_const box rows);
    barrier_k: scalar fixed log-barrier parameter.
    """

    A1: jnp.ndarray
    A2: jnp.ndarray
    B: jnp.ndarray
    q_diag: jnp.ndarray
    qf_diag: jnp.ndarray
    r_diag: jnp.ndarray
    u_min: jnp.ndarray
    u_max: jnp.ndarray
    barrier_k: jnp.ndarray
    # Ramp-rate rows (VAR_1/fast_mpc_ineq_const.m:58-76); used only when
    # solve(..., ramp=True): du_min <= u_t - u_{t-1} <= du_max with
    # u_{-1} = u_prev.
    du_min: jnp.ndarray
    du_max: jnp.ndarray
    u_prev: jnp.ndarray


class SolverState(NamedTuple):
    U: jnp.ndarray    # (T, m)
    X: jnp.ndarray    # (T, n); X[t] holds x_{t+1}
    nu: jnp.ndarray   # (T, n) equality multipliers


def init_state(prob: FastMPCProblem, horizon: int, x_box: float,
               ramp: bool = False) -> SolverState:
    """Strictly feasible init.

    Box-only: midpoints (fast_mpc_init.m:19-27); x box +/-x_box is
    inactive (README.md:538) -> 0.  With ramp rows the midpoint u=0 is
    infeasible whenever |u_prev| > du_max (a latent bug in the reference's
    VAR_1 path, whose init ignores ramp rows); we start at u_t = u_prev
    (zero increments -> all ramp slacks = du bounds) clipped strictly
    inside the box.
    """
    m = prob.u_min.shape[-1]
    n = prob.A1.shape[-1]
    if ramp:
        margin = 1e-3 * (prob.u_max - prob.u_min)
        u_base = jnp.clip(prob.u_prev, prob.u_min + margin,
                          prob.u_max - margin)
    else:
        u_base = (prob.u_min + prob.u_max) / 2.0
    u0 = jnp.broadcast_to(u_base, (horizon, m))
    return SolverState(
        U=u0,
        X=jnp.zeros((horizon, n), dtype=u0.dtype),
        nu=jnp.zeros((horizon, n), dtype=u0.dtype),
    )


def _ramp_slacks(prob: FastMPCProblem, U):
    """(hi, lo) ramp slacks per stage: stage t row covers u_t - u_{t-1}
    with u_{-1} = u_prev (VAR_1/fast_mpc_ineq_const.m:58-76)."""
    u_shift = jnp.concatenate([prob.u_prev[None], U[:-1]], axis=0)
    dU = U - u_shift
    return prob.du_max - dU, dU - prob.du_min


def equality_rhs(prob: FastMPCProblem, x0, x0_pre, w, horizon: int):
    """Stacked equality rhs b (fast_mpc_eq_const.m:38-46):

    b_0 = A1 x0 + A2 x0_pre + w_0 ; b_1 = A2 x0 + w_1 ; b_i = w_i.
    ``w`` is the per-stage offset (the sim passes b_ref, README.md:546).
    """
    b = w.reshape(horizon, -1)
    b0 = b[0] + prob.A1 @ x0 + prob.A2 @ x0_pre
    rows = [b0]
    if horizon > 1:
        rows.append(b[1] + prob.A2 @ x0)
        rows.extend(b[2:])
    return jnp.stack(rows) if horizon > 1 else b0[None]


def _shift_down(arr, k):
    """out[t] = arr[t-k] with zero padding (stage-index shifts)."""
    pad = jnp.zeros((k,) + arr.shape[1:], dtype=arr.dtype)
    return jnp.concatenate([pad, arr[:-k]], axis=0) if k else arr


def _shift_up(arr, k):
    """out[t] = arr[t+k] with zero padding."""
    pad = jnp.zeros((k,) + arr.shape[1:], dtype=arr.dtype)
    return jnp.concatenate([arr[k:], pad], axis=0) if k else arr


def residuals(prob: FastMPCProblem, b, state: SolverState,
              ramp: bool = False):
    """Dual and primal residuals (inf_newton_solver.m:12-13).

    rd_u = 2 R u + k P'd|_u - B' nu_t
    rd_x = 2 Qt x + nu_t - A1' nu_{t+1} - A2' nu_{t+2}
    rp_i = x_{i+1} - A1 x_i - A2 x_{i-1} - B u_i - b_i
    """
    U, X, nu = state
    T = U.shape[0]
    d_hi = 1.0 / (prob.u_max - U)
    d_lo = 1.0 / (U - prob.u_min)
    k = prob.barrier_k

    rd_u = 2.0 * prob.r_diag * U + k * (d_hi - d_lo) - nu @ prob.B
    if ramp:
        # stage-t ramp row has +I on u_t, -I on u_{t-1}
        r_hi, r_lo = _ramp_slacks(prob, U)
        s = 1.0 / r_hi - 1.0 / r_lo                 # (T, m)
        rd_u = rd_u + k * (s - _shift_up(s, 1))
    q_stack = jnp.concatenate(
        [jnp.broadcast_to(prob.q_diag, (T - 1, X.shape[1])),
         prob.qf_diag[None]], axis=0) if T > 1 else prob.qf_diag[None]
    rd_x = (2.0 * q_stack * X + nu
            - _shift_up(nu, 1) @ prob.A1
            - _shift_up(nu, 2) @ prob.A2)

    rp = (X - _shift_down(X, 1) @ prob.A1.T - _shift_down(X, 2) @ prob.A2.T
          - U @ prob.B.T - b)
    return rd_u, rd_x, rp


def residual_norm(rd_u, rd_x, rp):
    return jnp.sqrt(jnp.sum(rd_u ** 2) + jnp.sum(rd_x ** 2)
                    + jnp.sum(rp ** 2))


def newton_direction(prob: FastMPCProblem, b, state: SolverState,
                     ramp: bool = False):
    """One Newton direction via blockwise Phi and block-banded Schur.

    Follows inf_newton_solver.m:24-35 mathematically, exploiting:
      Phi_u = 2R + k diag(d_hi^2 + d_lo^2)      (diagonal per stage;
              with ramp rows: per-coordinate tridiagonal across stages),
      Phi_x[t] = 2 Q_t                          (diagonal),
      S = C Phi^-1 C'  block-banded with bandwidth 2 (VAR(2)); the ramp
      coupling makes the u-contribution dense in the stage index, still
      assembled blockwise.
    """
    U, X, nu = state
    T, m = U.shape
    n = X.shape[1]
    k = prob.barrier_k
    A1, A2, B = prob.A1, prob.A2, prob.B

    d_hi = 1.0 / (prob.u_max - U)
    d_lo = 1.0 / (U - prob.u_min)
    phi_u = 2.0 * prob.r_diag + k * (d_hi ** 2 + d_lo ** 2)   # (T, m)
    q_stack = jnp.concatenate(
        [jnp.broadcast_to(prob.q_diag, (T - 1, n)), prob.qf_diag[None]],
        axis=0) if T > 1 else prob.qf_diag[None]
    phi_x = 2.0 * q_stack                                      # (T, n)
    px = 1.0 / phi_x

    rd_u, rd_x, rp = residuals(prob, b, state, ramp=ramp)

    if ramp:
        # Per-coordinate (m independent) T x T tridiagonal Phi_uu: the
        # stage-t ramp rows contribute w_t (e_t - e_{t-1})(e_t - e_{t-1})'
        # with w_t = 1/hi_t^2 + 1/lo_t^2 (stage 0: e_0 e_0' only).
        r_hi, r_lo = _ramp_slacks(prob, U)
        w = 1.0 / r_hi ** 2 + 1.0 / r_lo ** 2                  # (T, m)
        w_next = _shift_up(w, 1)
        diag_c = (phi_u + k * (w + w_next)).T                  # (m, T)
        off_c = (-k * w[1:]).T                                 # (m, T-1)
        Phi_u = jnp.zeros((m, T, T), dtype=U.dtype)
        idx = jnp.arange(T)
        Phi_u = Phi_u.at[:, idx, idx].set(diag_c)
        if T > 1:
            i1 = jnp.arange(1, T)
            Phi_u = Phi_u.at[:, i1, i1 - 1].set(off_c)
            Phi_u = Phi_u.at[:, i1 - 1, i1].set(off_c)
        Ginv = jnp.linalg.inv(Phi_u)                           # (m, T, T)

        def u_solve(v):                                        # (T, m)
            return jnp.einsum("mts,sm->tm", Ginv, v)

        # u-contribution to S: M[i,j] = B diag(Ginv[:, i, j]) B'
        M = jnp.einsum("nm,mij,km->ijnk", B, Ginv, B)          # (T,T,n,n)
    else:
        pu = 1.0 / phi_u

        def u_solve(v):
            return v * pu

        W = jnp.einsum("nm,tm,km->tnk", B, pu, B)              # (T, n, n)

    # C Phi^-1 rd  (row i)  (see module docstring for C's stage pattern)
    ru = u_solve(rd_u)
    rx = rd_x * px
    c_phinv_rd = (-ru @ B.T + rx
                  - _shift_down(rx, 1) @ A1.T
                  - _shift_down(rx, 2) @ A2.T)
    beta = -rp + c_phinv_rd                                    # (T, n)

    # Block-banded x-part of S (diag + two sub-diagonals) + u-part, then
    # dense chol on the small (T n, T n) system.
    px1 = _shift_down(px, 1)                                   # px_{i-1}
    px2 = _shift_down(px, 2)
    diag_blocks = (jnp.eye(n, dtype=U.dtype) * px[:, None, :]
                   + jnp.einsum("nk,tk,mk->tnm", A1, px1, A1)
                   + jnp.einsum("nk,tk,mk->tnm", A2, px2, A2))
    if not ramp:
        diag_blocks = diag_blocks + W
    sub1_blocks = (-A1 * px1[:, None, :]
                   + jnp.einsum("nk,tk,mk->tnm", A2, px2, A1))  # S[i, i-1]
    sub2_blocks = -A2 * px2[:, None, :]                         # S[i, i-2]

    if not ramp and T >= CR_MIN_HORIZON:
        # long horizons: block cyclic reduction on the banded system
        dnu = -block_tridiag.banded_solve(diag_blocks, sub1_blocks,
                                          sub2_blocks, beta)
    else:
        S = jnp.zeros((T, n, T, n), dtype=U.dtype)
        for i in range(T):
            S = S.at[i, :, i, :].set(diag_blocks[i])
            if i >= 1:
                S = S.at[i, :, i - 1, :].set(sub1_blocks[i])
                S = S.at[i - 1, :, i, :].set(sub1_blocks[i].T)
            if i >= 2:
                S = S.at[i, :, i - 2, :].set(sub2_blocks[i])
                S = S.at[i - 2, :, i, :].set(sub2_blocks[i].T)
        if ramp:
            S = S + jnp.moveaxis(M, 1, 2)                       # (T,n,T,n)
        S = S.reshape(T * n, T * n)

        chol = jax.scipy.linalg.cho_factor(S, lower=True)
        dnu = -jax.scipy.linalg.cho_solve(
            chol, beta.reshape(-1)).reshape(T, n)

    # dz = Phi^-1 (-rd - C' dnu)
    dU = u_solve(-rd_u + dnu @ B)
    ct_dnu_x = dnu - _shift_up(dnu, 1) @ A1 - _shift_up(dnu, 2) @ A2
    dX = (-rd_x - ct_dnu_x) * px
    return dU, dX, dnu


def line_search_step(prob, b, state, direction, ramp: bool = False,
                     alpha=1e-4, beta=0.5, n_candidates=16):
    """Parallel-candidate norm-descent backtracking.

    Replaces the sequential while-loop (backtracking_inf_newton.m:3-9) with
    a fixed bank t in {1, beta, beta^2, ...}: accept the largest t whose
    residual norm satisfies the Armijo-style decrease AND keeps the control
    strictly inside its box (slack positivity; the reference omits this
    check).  Fixed shapes, no data-dependent control flow.
    """
    dU, dX, dnu = direction
    base = residual_norm(*residuals(prob, b, state, ramp=ramp))
    ts = beta ** jnp.arange(n_candidates, dtype=state.U.dtype)

    def eval_candidate(t):
        cand = SolverState(state.U + t * dU, state.X + t * dX,
                           state.nu + t * dnu)
        norm = residual_norm(*residuals(prob, b, cand, ramp=ramp))
        feasible = jnp.logical_and(
            jnp.all(cand.U < prob.u_max), jnp.all(cand.U > prob.u_min))
        if ramp:
            r_hi, r_lo = _ramp_slacks(prob, cand.U)
            feasible = jnp.logical_and(
                feasible, jnp.logical_and(jnp.all(r_hi > 0),
                                          jnp.all(r_lo > 0)))
        ok = jnp.logical_and(norm <= (1.0 - alpha * t) * base, feasible)
        return ok, norm

    oks, _ = jax.vmap(eval_candidate)(ts)
    # first accepted candidate; fall back to the smallest step
    idx = jnp.argmax(oks)
    t = jnp.where(jnp.any(oks), ts[idx], ts[-1])
    return SolverState(state.U + t * dU, state.X + t * dX,
                       state.nu + t * dnu)


class FixedNewtonOperator(NamedTuple):
    """Precomputed single-Newton-step solve operators.

    In the reference's real-time mode -- ONE Newton step from the midpoint
    init (Fast_MPC2.m:124-130, README.md:551-553) -- the barrier slacks at
    the initial iterate are constants (u=0 in a symmetric box), so the
    primal Hessian Phi and the dual Schur complement S are the SAME for
    every scenario and every control step.  The entire Newton direction
    collapses to precomputed linear maps of the equality rhs b:

        beta = b            (rd(z0, nu0=0) = 0 exactly: u=0 kills the
                             control gradient, d_hi=d_lo kills the barrier
                             gradient, X=0 kills the state gradient)
        dnu  = -S^-1 b
        dU_t = pu0 * (B' dnu_t),   dX_t = -px_t * (C' dnu)_x,t

    so the per-solve cost is two small matmuls -- no factorization at all.
    Only the (optional) line search still evaluates barrier residuals.
    """

    neg_s_inv: jnp.ndarray   # (T*n, T*n)
    pu0: jnp.ndarray         # (m,) 1/Phi_u at init
    px: jnp.ndarray          # (T, n) 1/Phi_x


def precompute_fixed_newton(prob: FastMPCProblem,
                            horizon: int) -> FixedNewtonOperator:
    """Build the constant operators (once per problem; host/jit)."""
    T = horizon
    n = prob.A1.shape[-1]
    m = prob.B.shape[-1]
    dt = prob.B.dtype
    A1, A2, B = prob.A1, prob.A2, prob.B
    k = prob.barrier_k

    u0 = (prob.u_min + prob.u_max) / 2.0
    d_hi = 1.0 / (prob.u_max - u0)
    d_lo = 1.0 / (u0 - prob.u_min)
    phi_u0 = 2.0 * prob.r_diag + k * (d_hi ** 2 + d_lo ** 2)
    pu0 = 1.0 / phi_u0
    q_stack = jnp.concatenate(
        [jnp.broadcast_to(prob.q_diag, (T - 1, n)), prob.qf_diag[None]],
        axis=0) if T > 1 else prob.qf_diag[None]
    px = 1.0 / (2.0 * q_stack)

    W0 = jnp.einsum("nm,m,km->nk", B, pu0, B)
    px1 = _shift_down(px, 1)
    px2 = _shift_down(px, 2)
    diag_blocks = (W0[None] + jnp.eye(n, dtype=dt) * px[:, None, :]
                   + jnp.einsum("nk,tk,mk->tnm", A1, px1, A1)
                   + jnp.einsum("nk,tk,mk->tnm", A2, px2, A2))
    sub1_blocks = (-A1 * px1[:, None, :]
                   + jnp.einsum("nk,tk,mk->tnm", A2, px2, A1))
    sub2_blocks = -A2 * px2[:, None, :]
    S = jnp.zeros((T, n, T, n), dtype=dt)
    for i in range(T):
        S = S.at[i, :, i, :].set(diag_blocks[i])
        if i >= 1:
            S = S.at[i, :, i - 1, :].set(sub1_blocks[i])
            S = S.at[i - 1, :, i, :].set(sub1_blocks[i].T)
        if i >= 2:
            S = S.at[i, :, i - 2, :].set(sub2_blocks[i])
            S = S.at[i - 2, :, i, :].set(sub2_blocks[i].T)
    S = S.reshape(T * n, T * n)
    neg_s_inv = -jnp.linalg.inv(S)
    return FixedNewtonOperator(neg_s_inv=neg_s_inv, pu0=pu0, px=px)


@partial(jax.jit, static_argnames=("horizon", "line_search"))
def solve_fixed(prob: FastMPCProblem, op: FixedNewtonOperator,
                x0, x0_pre, w, horizon: int,
                line_search: bool = True) -> SolverState:
    """Single-Newton-step solve via the precomputed operators.

    Bit-equivalent to solve(..., n_newton=1) for symmetric boxes and zero
    linear costs (tested); the hot path is two matmuls + the parallel
    line search.  Single scenario; vmap for batches.
    """
    T = horizon
    n = prob.A1.shape[-1]
    m = prob.B.shape[-1]
    b = equality_rhs(prob, x0, x0_pre, w, horizon)
    state = init_state(prob, horizon, 0.0)

    dnu = (op.neg_s_inv @ b.reshape(-1)).reshape(T, n)
    dU = (dnu @ prob.B) * op.pu0
    ct_dnu_x = dnu - _shift_up(dnu, 1) @ prob.A1 - _shift_up(dnu, 2) @ prob.A2
    dX = -ct_dnu_x * op.px

    if line_search:
        return line_search_step(prob, b, state, (dU, dX, dnu))
    return SolverState(state.U + dU, state.X + dX, state.nu + dnu)


@partial(jax.jit,
         static_argnames=("horizon", "n_newton", "line_search", "ramp"))
def solve(prob: FastMPCProblem, x0, x0_pre, w,
          horizon: int, n_newton: int = 1, x_box: float = 100.0,
          line_search: bool = True, ramp: bool = False) -> SolverState:
    """Fixed-barrier fixed-Newton solve (= mpc_fixed_log_newton,
    Fast_MPC2.m:124-130).  Single scenario; `vmap` for batches.

    ``ramp=True`` activates the VAR_1-style ramp-rate rows
    (VAR_1/fast_mpc_ineq_const.m:58-76) using prob.du_min/du_max/u_prev.
    """
    b = equality_rhs(prob, x0, x0_pre, w, horizon)
    state = init_state(prob, horizon, x_box, ramp=ramp)

    def body(_, st):
        direction = newton_direction(prob, b, st, ramp=ramp)
        if line_search:
            return line_search_step(prob, b, st, direction, ramp=ramp)
        dU, dX, dnu = direction
        return SolverState(st.U + dU, st.X + dX, st.nu + dnu)

    if n_newton <= 2:
        for i in range(n_newton):
            state = body(i, state)
    else:
        state = jax.lax.fori_loop(0, n_newton, body, state)
    return state


def solve_barrier_continuation(prob: FastMPCProblem, x0, x0_pre, w,
                               horizon: int, k_start: float = 1.0,
                               mu: float = 0.1, k_min_scaled: float = 1e-2,
                               n_newton_inner: int = 20) -> SolverState:
    """Barrier continuation k <- mu k until k*len(z) < k_min_scaled
    (= mpc_fixed_newton / mpc_solve_full, Fast_MPC2.m:100-115,131-144),
    with a *static* schedule so shapes stay fixed under jit."""
    m = prob.u_min.shape[-1]
    n = prob.A1.shape[-1]
    z_len = horizon * (n + m)
    ks = []
    k = k_start
    while k * z_len >= k_min_scaled:
        ks.append(k)
        k *= mu
    b = equality_rhs(prob, x0, x0_pre, w, horizon)
    state = init_state(prob, horizon, 100.0)
    for k in ks:
        p = prob._replace(barrier_k=jnp.asarray(k, dtype=state.U.dtype))

        def body(_, st):
            return line_search_step(p, b, st, newton_direction(p, b, st))

        state = jax.lax.fori_loop(0, n_newton_inner, body, state)
    return state
