"""Time-varying LQR via Riccati recursion — sequential scan and parallel
associative scan.

This kernel subsumes three reference components:
* the DDP backward pass (ocs2_ddp/include/ocs2_ddp/riccati_equations/
  DiscreteTimeRiccatiEquations.h:71 and the partitioned parallel driver
  GaussNewtonDDP.cpp:516-552),
* HPIPM's structured equality-QP Riccati solve used by SQP
  (ocs2_sqp/hpipm_catkin/HpipmInterface.h:85,100,111), and
* value-function extraction (getRiccatiCostToGo / getRiccatiFeedback).

The sequential path is one ``lax.scan`` (exact).  The parallel path
reformulates the recursion as an associative operator over conditional
value functions and runs ``jax.lax.associative_scan`` — O(log N) depth over
the horizon, the analogue of the reference's partitioned parallel
Riccati (which used *stale* partition-boundary values; ours is exact).
Construction follows the parallel LQT elements of Särkkä & García-Fernández,
"Temporal Parallelization of Bayesian Smoothers" (arXiv:1905.13002) /
"Parallelization of Riccati Recursion" (PAPERS.md).

Problem (increments around the nominal trajectory):
    min  sum_k [ q_k + qx_k'dx + qu_k'du + 1/2 dx'Qxx dx + du'Qux dx
                 + 1/2 du'Quu du ]  +  terminal quadratic
    s.t. dx_{k+1} = A_k dx_k + B_k du_k + b_k
with b_k the dynamics defect (zero for single-shooting DDP).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.types import symmetrize

Array = jax.Array


class LqrSolution(NamedTuple):
    gains: Array  # K  [N, nu, nx]   du = kff + K dx
    kff: Array  # [N, nu]
    value_S: Array  # [N+1, nx, nx]  cost-to-go Hessian
    value_s: Array  # [N+1, nx]      cost-to-go gradient
    dv1: Array  # [] expected decrease, linear term  sum kff'Qu
    dv2: Array  # [] expected decrease, quadratic    sum 1/2 kff'Quu kff


class LqrCoeffs(NamedTuple):
    """Batched stage data [N, ...] + terminal [nx...]."""

    A: Array
    B: Array
    b: Array
    Qxx: Array
    qx: Array
    Quu: Array
    qu: Array
    Qux: Array
    Qf: Array
    qf: Array


def _solve_psd(M: Array, rhs: Array) -> Array:
    """Solve M z = rhs for symmetric positive-definite M via Cholesky.

    This is the single-instance path, on the library Cholesky.  Batched
    solves of at least _BATCH_MINOR_MIN_SIZE scenarios never reach this code:
    the custom_vmap rule on lqr_backward dispatches them to a batch-minor
    path whose entry-form Cholesky (_bm_cholesky) works on [B] vectors."""
    chol = jax.scipy.linalg.cho_factor(M, lower=True)
    return jax.scipy.linalg.cho_solve(chol, rhs)


def convexify_stage_hessians(
    Qxx: Array, Qux: Array, Quu: Array, Qf: Array,
    min_eig: float = 1e-5, method: str = "gershgorin",
):
    """PSD-project batched stage Hessians [[Qxx, Qux'], [Qux, Quu]] [N, ...]
    and the terminal Qf — shared by the discrete convexify() below and the
    continuous-time SLQ quadratization (ops/riccati_ct.py)."""
    nx = Qxx.shape[-1]

    if method == "gershgorin":

        def stage(qxx, qux, quu):
            z = jnp.block([[qxx, qux.T], [qux, quu]])
            z = 0.5 * (z + z.T)
            diag = jnp.diagonal(z)
            radius = jnp.sum(jnp.abs(z), axis=-1) - jnp.abs(diag)
            lb = jnp.min(diag - radius)
            shift = jnp.maximum(0.0, min_eig - lb)
            z = z + shift * jnp.eye(z.shape[-1], dtype=z.dtype)
            return z[:nx, :nx], z[nx:, :nx], z[nx:, nx:]

        def final(qf):
            z = 0.5 * (qf + qf.T)
            diag = jnp.diagonal(z)
            radius = jnp.sum(jnp.abs(z), axis=-1) - jnp.abs(diag)
            shift = jnp.maximum(0.0, min_eig - jnp.min(diag - radius))
            return z + shift * jnp.eye(nx, dtype=z.dtype)

    else:  # "eigh": exact eigenvalue clamping

        def stage(qxx, qux, quu):
            z = jnp.block([[qxx, qux.T], [qux, quu]])
            z = 0.5 * (z + z.T)
            w, v = jnp.linalg.eigh(z)
            z = (v * jnp.maximum(w, min_eig)) @ v.T
            return z[:nx, :nx], z[nx:, :nx], z[nx:, nx:]

        def final(qf):
            wf, vf = jnp.linalg.eigh(0.5 * (qf + qf.T))
            return (vf * jnp.maximum(wf, min_eig)) @ vf.T

    qxx, qux, quu = jax.vmap(stage)(Qxx, Qux, Quu)
    return qxx, qux, quu, final(Qf)


def convexify(
    coeffs: LqrCoeffs, min_eig: float = 1e-5, method: str = "gershgorin"
) -> LqrCoeffs:
    """Make every stage's joint Hessian [[Qxx, Qux'], [Qux, Quu]] (and the
    terminal Qf) positive semidefinite.

    Analogue of the reference's Hessian correction strategies
    (ocs2_ddp/include/ocs2_ddp/HessianCorrection.h:44 — DIAGONAL_SHIFT /
    EIGENVALUE_MODIFICATION / GERSHGORIN_MODIFICATION): exact Hessians of
    nonconvex terms can be indefinite, which breaks the Riccati Cholesky.

    method="gershgorin" (default): shift by the Gershgorin lower bound —
    pure elementwise/reduction work, with no eigendecomposition per node.
    A PSD matrix with dominant diagonal gets zero shift, so the common
    (convex-cost) case is untouched.  method="eigh": exact eigenvalue
    clamping.
    """
    qxx, qux, quu, qf = convexify_stage_hessians(
        coeffs.Qxx, coeffs.Qux, coeffs.Quu, coeffs.Qf, min_eig, method
    )
    return coeffs._replace(Qxx=qxx, Qux=qux, Quu=quu, Qf=qf)


def lqr_backward(coeffs: LqrCoeffs, reg: Array | float = 0.0) -> LqrSolution:
    """Sequential Riccati backward pass (reference DiscreteTimeRiccatiEquations
    recursion), one fused lax.scan.

    Under ``vmap`` the custom_vmap rule below picks the batched path from
    the batch size: plain ``vmap`` of the scan, or from
    ``_BATCH_MINOR_MIN_SIZE`` scenarios the BATCH-MINOR entry form
    (``_lqr_backward_batched``, every matrix entry a [B] vector, so
    per-scenario matrices as small as 3x3 still give dense elementwise work).
    """
    return _lqr_backward_cv(coeffs, jnp.asarray(reg))


def _lqr_backward_single(coeffs: LqrCoeffs, reg: Array) -> LqrSolution:
    nu = coeffs.B.shape[-1]
    eye_u = jnp.eye(nu, dtype=coeffs.B.dtype)

    def step(carry, stage):
        s_mat, s_vec = carry
        a, b_mat, b, qxx, qx, quu, qu, qux = stage
        sv = s_vec + s_mat @ b
        qu_hat = qu + b_mat.T @ sv
        qx_hat = qx + a.T @ sv
        quu_hat = quu + b_mat.T @ s_mat @ b_mat + reg * eye_u
        qux_hat = qux + b_mat.T @ s_mat @ a
        qxx_hat = qxx + a.T @ s_mat @ a
        kk = -_solve_psd(quu_hat, qux_hat)
        kf = -_solve_psd(quu_hat, qu_hat)
        s_next = symmetrize(qxx_hat + kk.T @ quu_hat @ kk + kk.T @ qux_hat + qux_hat.T @ kk)
        sv_next = qx_hat + kk.T @ quu_hat @ kf + kk.T @ qu_hat + qux_hat.T @ kf
        dv1 = kf @ qu_hat
        dv2 = 0.5 * kf @ quu_hat @ kf
        return (s_next, sv_next), (kk, kf, s_next, sv_next, dv1, dv2)

    stages = (
        coeffs.A,
        coeffs.B,
        coeffs.b,
        coeffs.Qxx,
        coeffs.qx,
        coeffs.Quu,
        coeffs.qu,
        coeffs.Qux,
    )
    init = (coeffs.Qf, coeffs.qf)
    _, (ks, kffs, s_mats, s_vecs, dv1s, dv2s) = jax.lax.scan(
        step, init, stages, reverse=True
    )
    value_S = jnp.concatenate([s_mats, coeffs.Qf[None]], axis=0)
    value_s = jnp.concatenate([s_vecs, coeffs.qf[None]], axis=0)
    return LqrSolution(
        gains=ks,
        kff=kffs,
        value_S=value_S,
        value_s=value_s,
        dv1=jnp.sum(dv1s),
        dv2=jnp.sum(dv2s),
    )


# -- batch-minor batched backward pass (vmap rule) ---------------------------
#
# Entry layout: matrices [n, m, B] / vectors [n, B] — the batch dim is the
# minor (contiguous) axis, matrix dims are unrolled loop indices.  Matmuls
# become broadcast-multiply-reduce fusions over [B] vectors instead of
# batched dots over 10x10 operands.


def _bm_mm(a, b):
    """[i, k, B] @ [k, j, B] -> [i, j, B]."""
    return jnp.sum(a[:, :, None, :] * b[None, :, :, :], axis=1)


def _bm_mTm(a, b):
    """[k, i, B]' @ [k, j, B] -> [i, j, B]."""
    return jnp.sum(a[:, :, None, :] * b[:, None, :, :], axis=0)


def _bm_mv(a, v):
    """[i, k, B] @ [k, B] -> [i, B]."""
    return jnp.sum(a * v[None, :, :], axis=1)


def _bm_mTv(a, v):
    """[k, i, B]' @ [k, B] -> [i, B]."""
    return jnp.sum(a * v[:, None, :], axis=0)


def _bm_cholesky(M, eps: float = 1e-12):
    """Entry-form Cholesky of [n, n, B]: L[i][j] are [B] lane vectors."""
    n = M.shape[0]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = M[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = jnp.sqrt(jnp.maximum(s, eps))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = M[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    return L


def _bm_solve_psd(M, rhs):
    """Solve M z = rhs, M [n, n, B] PD, rhs [n, m, B]."""
    n, m = rhs.shape[0], rhs.shape[1]
    L = _bm_cholesky(M)
    ys = []
    for i in range(n):
        s = rhs[i]
        for k in range(i):
            s = s - L[i][k] * ys[k]
        ys.append(s / L[i][i])
    zs = [None] * n
    for i in reversed(range(n)):
        s = ys[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * zs[k]
        zs[i] = s / L[i][i]
    return jnp.stack(zs, axis=0)


def _bm_sym(m):
    return 0.5 * (m + m.transpose(1, 0, 2))


def _lqr_backward_batched(coeffs: LqrCoeffs, reg: Array) -> LqrSolution:
    """Batch-minor backward pass: coeffs leaves carry a LEADING batch dim
    [B, N, ...]; reg is [B] (or scalar).  Same recursion as
    _lqr_backward_single, evaluated in entry form."""
    B = coeffs.A.shape[0]
    reg = jnp.broadcast_to(jnp.asarray(reg), (B,))

    # [B, N, n, m] -> [N, n, m, B] (time-leading for scan, batch-minor).
    A = jnp.transpose(coeffs.A, (1, 2, 3, 0))
    Bm = jnp.transpose(coeffs.B, (1, 2, 3, 0))
    bv = jnp.transpose(coeffs.b, (1, 2, 0))
    Qxx = jnp.transpose(coeffs.Qxx, (1, 2, 3, 0))
    qx = jnp.transpose(coeffs.qx, (1, 2, 0))
    Quu = jnp.transpose(coeffs.Quu, (1, 2, 3, 0))
    qu = jnp.transpose(coeffs.qu, (1, 2, 0))
    Qux = jnp.transpose(coeffs.Qux, (1, 2, 3, 0))
    Qf = jnp.transpose(coeffs.Qf, (1, 2, 0))
    qf = jnp.transpose(coeffs.qf, (1, 0))
    nu = Bm.shape[2]

    def step(carry, stage):
        s_mat, s_vec = carry  # [nx, nx, B], [nx, B]
        a, b_mat, b, qxx, qx_, quu, qu_, qux = stage
        sv = s_vec + _bm_mv(s_mat, b)
        qu_hat = qu_ + _bm_mTv(b_mat, sv)
        qx_hat = qx_ + _bm_mTv(a, sv)
        sB = _bm_mm(s_mat, b_mat)
        sA = _bm_mm(s_mat, a)
        quu_hat = quu + _bm_mTm(b_mat, sB)
        # + reg * I on the diagonal (reg is [B], lanes broadcast).
        quu_hat = quu_hat + reg * jnp.eye(nu, dtype=quu.dtype)[:, :, None]
        qux_hat = qux + _bm_mTm(b_mat, sA)
        qxx_hat = qxx + _bm_mTm(a, sA)
        kk = -_bm_solve_psd(quu_hat, qux_hat)  # [nu, nx, B]
        kf = -_bm_solve_psd(quu_hat, qu_hat[:, None, :])[:, 0, :]  # [nu, B]
        quuk = _bm_mm(quu_hat, kk)
        s_next = _bm_sym(
            qxx_hat + _bm_mTm(kk, quuk) + _bm_mTm(kk, qux_hat)
            + _bm_mTm(qux_hat, kk)
        )
        quukf = _bm_mv(quu_hat, kf)
        sv_next = (
            qx_hat + _bm_mTv(kk, quukf) + _bm_mTv(kk, qu_hat)
            + _bm_mTv(qux_hat, kf)
        )
        dv1 = jnp.sum(kf * qu_hat, axis=0)  # [B]
        dv2 = 0.5 * jnp.sum(kf * quukf, axis=0)
        return (s_next, sv_next), (kk, kf, s_next, sv_next, dv1, dv2)

    _, (ks, kffs, s_mats, s_vecs, dv1s, dv2s) = jax.lax.scan(
        step, (Qf, qf), (A, Bm, bv, Qxx, qx, Quu, qu, Qux), reverse=True
    )
    # Back to standard [B, N, ...] layout.
    gains = jnp.transpose(ks, (3, 0, 1, 2))
    kff = jnp.transpose(kffs, (2, 0, 1))
    value_S = jnp.concatenate(
        [jnp.transpose(s_mats, (3, 0, 1, 2)), coeffs.Qf[:, None]], axis=1
    )
    value_s = jnp.concatenate(
        [jnp.transpose(s_vecs, (2, 0, 1)), coeffs.qf[:, None]], axis=1
    )
    return LqrSolution(
        gains=gains,
        kff=kff,
        value_S=value_S,
        value_s=value_s,
        dv1=jnp.sum(dv1s, axis=0),
        dv2=jnp.sum(dv2s, axis=0),
    )


from jax import custom_batching as _custom_batching  # noqa: E402


@_custom_batching.custom_vmap
def _lqr_backward_cv(coeffs: LqrCoeffs, reg: Array) -> LqrSolution:
    return _lqr_backward_single(coeffs, reg)


# Batch size from which the entry-form batch-minor path replaces plain vmap
# (the crossover is not yet measured on the GPU).
_BATCH_MINOR_MIN_SIZE = 1024


@_lqr_backward_cv.def_vmap
def _lqr_backward_vmap_rule(axis_size, in_batched, coeffs, reg):
    cb, rb = in_batched

    def bcast(x, is_b):
        return x if is_b else jnp.broadcast_to(x[None], (axis_size,) + x.shape)

    coeffs = jax.tree.map(bcast, coeffs, cb)
    reg = reg if rb else jnp.broadcast_to(reg, (axis_size,) + jnp.shape(reg))
    if axis_size >= _BATCH_MINOR_MIN_SIZE:
        out = _lqr_backward_batched(coeffs, reg)
    else:
        out = jax.vmap(_lqr_backward_single)(coeffs, reg)
    return out, jax.tree.map(lambda _: True, out)


# ---------------------------------------------------------------------------
# Parallel (associative-scan) Riccati.
# ---------------------------------------------------------------------------


def _eliminate_cross_terms(coeffs: LqrCoeffs, reg):
    """Complete the square in u: du = dv - Quu^{-1}(Qux dx + qu).

    Removes the cross term and the linear-in-u term so stages fit the
    parallel-LQT element form; gains are mapped back afterwards.
    """
    nu = coeffs.B.shape[-1]
    eye_u = jnp.eye(nu, dtype=coeffs.B.dtype)

    def per_stage(a, b_mat, b, qxx, qx, quu, qu, qux):
        quu_r = quu + reg * eye_u
        w_ux = _solve_psd(quu_r, qux)  # Quu^{-1} Qux
        w_u = _solve_psd(quu_r, qu)  # Quu^{-1} qu
        a_t = a - b_mat @ w_ux
        b_t = b - b_mat @ w_u
        qxx_t = symmetrize(qxx - qux.T @ w_ux)
        qx_t = qx - qux.T @ w_u
        return a_t, b_t, qxx_t, qx_t, quu_r, w_ux, w_u

    return jax.vmap(per_stage)(
        coeffs.A,
        coeffs.B,
        coeffs.b,
        coeffs.Qxx,
        coeffs.qx,
        coeffs.Quu,
        coeffs.qu,
        coeffs.Qux,
    )


class _Element(NamedTuple):
    """Parallel-LQT conditional-value-function element (Särkkä et al.)."""

    F: Array  # [nx, nx]
    c: Array  # [nx]
    C: Array  # [nx, nx]
    eta: Array  # [nx]
    J: Array  # [nx, nx]


def _combine(later: _Element, earlier: _Element) -> _Element:
    """Associative combination of conditional value functions.

    Under ``associative_scan(..., reverse=True)`` the first argument is the
    already-combined suffix (the *later* span [k, j)) and the second is the
    new element (the *earlier* span [i, k)); the composition below is
    earlier-then-later.
    """
    e1, e2 = earlier, later
    nx = e1.F.shape[-1]
    eye = jnp.eye(nx, dtype=e1.F.dtype)

    def one(a: _Element, b: _Element) -> _Element:
        m = eye + a.C @ b.J  # I + C1 J2
        m_inv_f1 = jnp.linalg.solve(m, a.F)
        m_inv_rhs = jnp.linalg.solve(m, a.c + a.C @ b.eta)
        n = eye + b.J @ a.C  # I + J2 C1
        n_inv_eta = jnp.linalg.solve(n, b.eta - b.J @ a.c)
        n_inv_j2f1 = jnp.linalg.solve(n, b.J @ a.F)
        return _Element(
            F=b.F @ m_inv_f1,
            c=b.F @ m_inv_rhs + b.c,
            C=symmetrize(b.F @ jnp.linalg.solve(m, a.C) @ b.F.T + b.C),
            eta=a.F.T @ n_inv_eta + a.eta,
            J=symmetrize(a.F.T @ n_inv_j2f1 + a.J),
        )

    return jax.vmap(one)(e1, e2)


def lqr_backward_parallel(coeffs: LqrCoeffs, reg: Array | float = 0.0) -> LqrSolution:
    """Associative-scan Riccati: O(log N) depth, exact (validated against
    the sequential scan in tests/test_riccati.py)."""
    a_t, b_t, qxx_t, qx_t, quu_r, w_ux, w_u = _eliminate_cross_terms(coeffs, reg)
    n, nx = b_t.shape

    def inv_c(b_mat, quu):
        return b_mat @ _solve_psd(quu, b_mat.T)

    c_stage = jax.vmap(inv_c)(coeffs.B, quu_r)

    # Stage elements [0..N-1]: cost measured on the incoming state x_k.
    elems = _Element(F=a_t, c=b_t, C=c_stage, eta=-qx_t, J=qxx_t)
    # Terminal element: pins the value function to the terminal quadratic.
    term = _Element(
        F=jnp.zeros((1, nx, nx), a_t.dtype),
        c=jnp.zeros((1, nx), a_t.dtype),
        C=jnp.zeros((1, nx, nx), a_t.dtype),
        eta=-coeffs.qf[None],
        J=coeffs.Qf[None],
    )
    elems = jax.tree.map(lambda s, t: jnp.concatenate([s, t], axis=0), elems, term)

    scanned = jax.lax.associative_scan(_combine, elems, reverse=True)
    value_S = scanned.J  # [N+1, nx, nx]
    value_s = -scanned.eta

    # Per-node gain extraction from V_{k+1} (batched — no recursion left).
    def gains(a, b_mat, b, quu, qux, qu, s_next, sv_next):
        sv = sv_next + s_next @ b
        quu_hat = quu + b_mat.T @ s_next @ b_mat
        qux_hat = qux + b_mat.T @ s_next @ a
        qu_hat = qu + b_mat.T @ sv
        kk = -_solve_psd(quu_hat, qux_hat)
        kf = -_solve_psd(quu_hat, qu_hat)
        return kk, kf, kf @ qu_hat, 0.5 * kf @ quu_hat @ kf

    ks, kffs, dv1s, dv2s = jax.vmap(gains)(
        coeffs.A,
        coeffs.B,
        coeffs.b,
        quu_r,
        coeffs.Qux,
        coeffs.qu,
        value_S[1:],
        value_s[1:],
    )
    del w_ux, w_u
    return LqrSolution(
        gains=ks,
        kff=kffs,
        value_S=value_S,
        value_s=value_s,
        dv1=jnp.sum(dv1s),
        dv2=jnp.sum(dv2s),
    )


def lqr_forward(coeffs: LqrCoeffs, sol: LqrSolution, dx0: Array):
    """Roll the LQR policy through the linear dynamics (exact QP solution).

    Returns (dxs [N+1, nx], dus [N, nu]) — the Newton/SQP step.
    """

    def body(dx, stage):
        a, b_mat, b, kk, kf = stage
        du = kf + kk @ dx
        dx_next = a @ dx + b_mat @ du + b
        return dx_next, (dx_next, du)

    _, (dxs_tail, dus) = jax.lax.scan(
        body, dx0, (coeffs.A, coeffs.B, coeffs.b, sol.gains, sol.kff)
    )
    dxs = jnp.concatenate([dx0[None], dxs_tail], axis=0)
    return dxs, dus
