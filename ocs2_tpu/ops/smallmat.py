"""Small-matrix linear algebra unrolled into plain XLA ops.

XLA lowers `cholesky`/`triangular_solve` to library calls that are tuned for
large matrices.  For the tiny per-stage systems of optimal control (nu, nx
<= ~16) an UNROLLED factorization in ordinary multiply/add/sqrt ops fuses
into the surrounding computation instead of being a separate call.  Whether
that wins on a GPU, against the library batched Cholesky, is not measured
yet.

Used by the Riccati kernels (ops/riccati.py) — the analogue of the
reference's Eigen LLT solves inside the DDP/HPIPM backward passes
(ocs2_ddp riccati_equations, hpipm's internal Riccati).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array

# Above this size the library call is used (unrolling bloats the program).
UNROLL_LIMIT = 16


def cholesky_small(M: Array, eps: float = 1e-12):
    """Lower-Cholesky of a PSD matrix [..., n, n], unrolled over static n.

    Returns the list-of-columns representation used by the solves below
    (avoids materializing an [..., n, n] dense L through n^2 scatters).
    L[i][j] entries for j <= i, each [...]-shaped.
    """
    n = M.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = M[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = jnp.sqrt(jnp.maximum(s, eps))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = M[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    return L


def _fwd_subst(L, B: Array):
    """Solve L y = B with L from cholesky_small; B [..., n, m]."""
    n = len(L)
    ys = []
    for i in range(n):
        s = B[..., i, :]
        for k in range(i):
            s = s - L[i][k][..., None] * ys[k]
        ys.append(s / L[i][i][..., None])
    return ys


def _bwd_subst(L, ys):
    """Solve L^T z = y (y as list of rows [..., m])."""
    n = len(L)
    zs = [None] * n
    for i in reversed(range(n)):
        s = ys[i]
        for k in range(i + 1, n):
            s = s - L[k][i][..., None] * zs[k]
        zs[i] = s / L[i][i][..., None]
    return jnp.stack(zs, axis=-2)


def solve_psd_small(M: Array, rhs: Array) -> Array:
    """Solve M z = rhs for symmetric PD M [..., n, n], rhs [..., n, m] or
    [..., n] — unrolled Cholesky + substitution in fusable ops."""
    vec = rhs.ndim == M.ndim - 1
    if vec:
        rhs = rhs[..., None]
    L = cholesky_small(M)
    z = _bwd_subst(L, _fwd_subst(L, rhs))
    return z[..., 0] if vec else z


def solve_psd(M: Array, rhs: Array) -> Array:
    """Dispatch: unrolled path for small static n, Cholesky custom-call
    otherwise."""
    if M.shape[-1] <= UNROLL_LIMIT:
        return solve_psd_small(M, rhs)
    chol = jax.scipy.linalg.cho_factor(M, lower=True)
    return jax.scipy.linalg.cho_solve(chol, rhs)
