"""Block-tridiagonal solves via odd-even cyclic reduction (O(log T) depth).

The fastMPC dual Schur complement S = C Phi^-1 C' is stage-block-banded:
bandwidth = VAR order (ops/newton_kkt.py).  The reference factorizes it
densely (inf_newton_solver.m:24-31) -- O(T^3 n^3) and strictly
sequential.  For long horizons the right parallel shape is block cyclic
reduction (the parallel-in-time Riccati family, cf. PAPERS.md): each
level eliminates the odd-indexed block rows with *batched* n x n
matmuls/factorizations (vmappable over scenarios), halving
the system; log2(T) levels of O(T n^3) total work and O(log T)
sequential depth, vs the dense factorization's O(T) depth and O(T^3 n^3)
work.

The VAR(2) pentadiagonal case packs stage pairs into 2n x 2n superblocks
first (`pack_pairs`), turning bandwidth 2 into block-tridiagonal.

All shapes are static (Python-level level loop under jit); boundary
blocks are zero-padded.  SPD systems only (Cholesky-based elimination).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cr_solve(diag, sub, rhs):
    """Solve the SPD block-tridiagonal system  S x = rhs.

    diag: (J, n, n) diagonal blocks D_j (symmetric);
    sub:  (J, n, n) sub-diagonal blocks L_j = S[j, j-1] (L_0 ignored);
    rhs:  (J, n) or (J, n, k).

    Returns x with rhs's shape.  Cyclic reduction: eliminate odd rows,
    recurse on the even half, back-substitute.
    """
    squeeze = rhs.ndim == 2
    if squeeze:
        rhs = rhs[..., None]
    x = _cr(diag, sub, rhs)
    return x[..., 0] if squeeze else x


def _cr(diag, sub, rhs):
    """One odd-even elimination level; recurses on the even half.

    Row j equation: L_j x_{j-1} + D_j x_j + L_{j+1}' x_{j+1} = b_j
    (L_0 / L_J absent).  Eliminating the odd rows gives, for y_k = x_{2k}:

      D'_k = D_{2k} - L_{2k} D_{2k-1}^-1 L_{2k}'
                    - L_{2k+1}' D_{2k+1}^-1 L_{2k+1}
      L'_k = -L_{2k} D_{2k-1}^-1 L_{2k-1}
      b'_k = b_{2k} - L_{2k} D_{2k-1}^-1 b_{2k-1}
                    - L_{2k+1}' D_{2k+1}^-1 b_{2k+1}
    """
    J0 = J = diag.shape[0]
    if J == 1:
        c = jax.scipy.linalg.cho_factor(diag[0], lower=True)
        return jax.scipy.linalg.cho_solve(c, rhs[0])[None]

    if J % 2 == 1:
        # pad a decoupled identity row so every odd row exists
        n = diag.shape[1]
        eye = jnp.broadcast_to(jnp.eye(n, dtype=diag.dtype), (1, n, n))
        diag = jnp.concatenate([diag, eye], axis=0)
        sub = jnp.concatenate([sub, jnp.zeros_like(sub[:1])], axis=0)
        rhs = jnp.concatenate([rhs, jnp.zeros_like(rhs[:1])], axis=0)
        J = J + 1
    half = J // 2

    d_even, d_odd = diag[0::2], diag[1::2]            # (half, n, n)
    L_eo = sub[0::2]       # L_{2k}: even row 2k <- odd row 2k-1 (k>=1)
    L_oe = sub[1::2]       # L_{2k+1}: odd row 2k+1 <- even row 2k
    b_even, b_odd = rhs[0::2], rhs[1::2]

    # factor the odd diagonals once, reuse for every solve at this level
    chol_odd = jax.vmap(
        lambda d: jax.scipy.linalg.cho_factor(d, lower=True)[0])(d_odd)
    solve_odd = jax.vmap(lambda c, b: jax.scipy.linalg.cho_solve(
        (c, True), b))

    iDLoe = solve_odd(chol_odd, L_oe)                 # D_{2k+1}^-1 L_{2k+1}
    iDb = solve_odd(chol_odd, b_odd)                  # D_{2k+1}^-1 b_{2k+1}
    # iDLeoT[m] = D_{2m+1}^-1 L_{2m+2}'  (used by even row 2(m+1) and in
    # odd-row back-substitution); defined for m = 0..half-2
    iDLeoT = solve_odd(chol_odd[:-1],
                       jnp.transpose(L_eo[1:], (0, 2, 1)))

    zero = jnp.zeros_like(d_even[:1])
    below = jnp.einsum("kij,kim->kjm", L_oe, iDLoe)   # L' D^-1 L (odd 2k+1)
    above = jnp.concatenate(
        [zero, jnp.einsum("kij,kjm->kim", L_eo[1:], iDLeoT)], axis=0)
    d_red = d_even - below - above

    sub_red = jnp.concatenate(
        [zero, -jnp.einsum("kij,kjm->kim", L_eo[1:], iDLoe[:-1])], axis=0)

    b_red = (b_even
             - jnp.concatenate(
                 [jnp.zeros_like(iDb[:1]),
                  jnp.einsum("kij,kjm->kim", L_eo[1:], iDb[:-1])], axis=0)
             - jnp.einsum("kij,kim->kjm", L_oe, iDb))

    y = _cr(d_red, sub_red, b_red)                    # x at even rows

    # x_odd[k] = iDb[k] - iDLoe[k] y_k - iDLeoT[k] y_{k+1}
    x_odd = iDb - jnp.einsum("kij,kjm->kim", iDLoe, y)
    x_odd = x_odd.at[:-1].add(
        -jnp.einsum("kij,kjm->kim", iDLeoT, y[1:]))

    out = jnp.zeros((J,) + y.shape[1:], dtype=y.dtype)
    out = out.at[0::2].set(y)
    out = out.at[1::2].set(x_odd)
    return out[:J0]


def pack_pairs(diag, sub1, sub2):
    """Pack a bandwidth-2 block-banded SPD system (T blocks of n) into a
    block-tridiagonal one (ceil(T/2) superblocks of 2n).

    diag: (T, n, n) S[i, i]; sub1: (T, n, n) S[i, i-1] (row i's coupling
    to i-1; entry 0 ignored); sub2: (T, n, n) S[i, i-2] (entries 0, 1
    ignored).  Returns (diag2, sub2x, pad) for cr_solve plus the original
    T (odd T pads one identity stage).
    """
    T, n, _ = diag.shape
    if T % 2 == 1:
        eye = jnp.broadcast_to(jnp.eye(n, dtype=diag.dtype), (1, n, n))
        diag = jnp.concatenate([diag, eye], axis=0)
        sub1 = jnp.concatenate([sub1, jnp.zeros_like(sub1[:1])], axis=0)
        sub2 = jnp.concatenate([sub2, jnp.zeros_like(sub2[:1])], axis=0)
        T = T + 1
    J = T // 2
    a = diag[0::2]       # stage 2j
    b = diag[1::2]       # stage 2j+1
    s1e = sub1[0::2]     # S[2j, 2j-1]
    s1o = sub1[1::2]     # S[2j+1, 2j]
    s2e = sub2[0::2]     # S[2j, 2j-2]
    s2o = sub2[1::2]     # S[2j+1, 2j-1]

    top = jnp.concatenate([a, jnp.transpose(s1o, (0, 2, 1))], axis=2)
    bot = jnp.concatenate([s1o, b], axis=2)
    D = jnp.concatenate([top, bot], axis=1)               # (J, 2n, 2n)

    # superblock sub-diagonal: rows (2j, 2j+1) x cols (2j-2, 2j-1)
    zb = jnp.zeros_like(a)
    Ltop = jnp.concatenate([s2e, s1e], axis=2)
    Lbot = jnp.concatenate([zb, s2o], axis=2)
    L = jnp.concatenate([Ltop, Lbot], axis=1)             # (J, 2n, 2n)
    return D, L, T


def banded_solve(diag, sub1, sub2, rhs):
    """Solve the SPD bandwidth-2 block-banded system via pair-packing +
    cyclic reduction.  rhs: (T, n).  Returns (T, n)."""
    T0 = diag.shape[0]
    n = diag.shape[1]
    D, L, T = pack_pairs(diag, sub1, sub2)
    r = rhs
    if T != T0:
        r = jnp.concatenate([rhs, jnp.zeros_like(rhs[:1])], axis=0)
    r2 = r.reshape(T // 2, 2 * n)
    x = cr_solve(D, L, r2)
    return x.reshape(T, n)[:T0]
