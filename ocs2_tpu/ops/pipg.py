"""PIPG: proportional-integral projected gradient OCP-QP solver.

JAX-native re-design of the reference's first-order QP solver
(ocs2_slp/include/ocs2_slp/pipg/PipgSolver.h:30-60, parallel update task
src/pipg/PipgSolver.cpp:49-231, single-thread reference pipg/SingleThreadPipg.h;
algorithm: Yu, Elango, Acikmese, "Proportional-Integral Projected Gradient
Method for Conic Optimization", arXiv:2009.06980).

The reference fans per-node primal/dual updates over a ThreadPool with
per-thread workload counters; here every update is a vmapped stage map — the
whole iteration is a handful of batched matmuls and elementwise ops, with
*no* sequential dependency over the horizon (unlike Riccati).
That makes PIPG the preferred kernel when the horizon is sharded across
devices: the only cross-node coupling is the one-step neighbor exchange in
G z and G' eta, which XLA lowers to cheap shifts (ppermute on a sharded
axis).

Also here: the Ruiz-style equilibration of the stacked OCP data
(ocs2_oc/precondition/Ruzi.h:92-173 ``ocpDataInPlaceInParallel`` /
``scaleOcpData``) and power-iteration estimates of the extreme eigenvalues
used for the PIPG step sizes (ocs2_slp/Helpers.h hessianAbsMaxEigenvalue /
GGTAbsMaxEigenvalue).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .riccati import LqrCoeffs

Array = jax.Array


class PipgSettings(NamedTuple):
    num_iterations: int = 3000
    relaxation: float = 1.5  # rho in (0, 2)
    # Extra multiple of the estimated ||G||^2 for robustness of step sizes.
    sigma_safety: float = 1.1
    power_iterations: int = 30
    check_every: int = 0  # 0: fixed iteration count (jit-friendliest)


class PipgSolution(NamedTuple):
    dxs: Array  # [N+1, nx]
    dus: Array  # [N, nu]
    eta: Array  # [N, nx] dynamics duals
    primal_residual: Array  # [] ||G z - g||_inf at exit


def _cost_matvec(coeffs: LqrCoeffs, dxs, dus):
    """(Q z)_k for the block-tridiagonal-free stage cost (block diagonal in
    stages with (x,u) cross terms)."""
    gx = (
        jnp.einsum("kxy,ky->kx", coeffs.Qxx, dxs[:-1])
        + jnp.einsum("kux,ku->kx", coeffs.Qux, dus)
    )
    gu = jnp.einsum("kuv,kv->ku", coeffs.Quu, dus) + jnp.einsum(
        "kux,kx->ku", coeffs.Qux, dxs[:-1]
    )
    gxN = coeffs.Qf @ dxs[-1]
    return jnp.concatenate([gx, gxN[None]], axis=0), gu


def _g_matvec(coeffs: LqrCoeffs, dxs, dus):
    """(G z)_k = A_k dx_k + B_k du_k - dx_{k+1}  (dynamics rows)."""
    return (
        jnp.einsum("kxy,ky->kx", coeffs.A, dxs[:-1])
        + jnp.einsum("kxu,ku->kx", coeffs.B, dus)
        - dxs[1:]
    )


def _gt_matvec(coeffs: LqrCoeffs, eta):
    """G' eta scattered to (dxs, dus).  dx_0 is pinned (not a variable) but we
    return its row anyway; callers zero it."""
    n = eta.shape[0]
    gx_from_a = jnp.einsum("kxy,kx->ky", coeffs.A, eta)  # to dx_k, k=0..N-1
    gx = jnp.zeros((n + 1, eta.shape[1]), eta.dtype)
    gx = gx.at[:-1].add(gx_from_a)
    gx = gx.at[1:].add(-eta)
    gu = jnp.einsum("kxu,kx->ku", coeffs.B, eta)
    return gx, gu


def estimate_sigma(coeffs: LqrCoeffs, iters: int = 30, key=None) -> Array:
    """lambda_max(G G') via power iteration (Helpers.h GGTAbsMaxEigenvalue)."""
    n, nx = coeffs.b.shape
    v = jnp.ones((n, nx), coeffs.b.dtype)
    v = v / jnp.linalg.norm(v)

    def body(_, v):
        gx, gu = _gt_matvec(coeffs, v)
        gx = gx.at[0].set(0.0)  # dx_0 is not a decision variable
        w = _g_matvec(coeffs, gx, gu)
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)

    v = jax.lax.fori_loop(0, iters, body, v)
    gx, gu = _gt_matvec(coeffs, v)
    gx = gx.at[0].set(0.0)
    w = _g_matvec(coeffs, gx, gu)
    return jnp.vdot(v, w)


def estimate_cost_eigs(coeffs: LqrCoeffs, iters: int = 30):
    """(mu, lambda) bounds on the stage-cost Hessian spectrum via power
    iteration on Q and on (lambda I - Q) (Helpers.h hessianAbsMaxEigenvalue)."""
    n, nx = coeffs.b.shape
    nu = coeffs.B.shape[-1]
    dt = coeffs.b.dtype

    def matvec(dxs, dus):
        gx, gu = _cost_matvec(coeffs, dxs, dus)
        return gx, gu

    def norm(gx, gu):
        return jnp.sqrt(jnp.sum(gx * gx) + jnp.sum(gu * gu))

    vx = jnp.ones((n + 1, nx), dt)
    vu = jnp.ones((n, nu), dt)
    nrm = norm(vx, vu)
    vx, vu = vx / nrm, vu / nrm

    def body(_, vv):
        vx, vu = vv
        gx, gu = matvec(vx, vu)
        nrm = jnp.maximum(norm(gx, gu), 1e-30)
        return gx / nrm, gu / nrm

    vx, vu = jax.lax.fori_loop(0, iters, body, (vx, vu))
    gx, gu = matvec(vx, vu)
    lam = jnp.sum(vx * gx) + jnp.sum(vu * gu)

    # Smallest eigenvalue via power iteration on (lam I - Q).
    def body_min(_, vv):
        vx, vu = vv
        gx, gu = matvec(vx, vu)
        gx, gu = lam * vx - gx, lam * vu - gu
        nrm = jnp.maximum(norm(gx, gu), 1e-30)
        return gx / nrm, gu / nrm

    wx = jnp.ones((n + 1, nx), dt) / jnp.sqrt((n + 1) * nx + n * nu)
    wu = jnp.ones((n, nu), dt) / jnp.sqrt((n + 1) * nx + n * nu)
    wx, wu = jax.lax.fori_loop(0, iters, body_min, (wx, wu))
    gx, gu = matvec(wx, wu)
    mu = lam - (jnp.sum(wx * (lam * wx - gx)) + jnp.sum(wu * (lam * wu - gu)))
    return jnp.maximum(mu, 0.0), lam


class RuizScaling(NamedTuple):
    """Diagonal equilibration: rows (dynamics duals) D_r [N, nx]; variable
    columns D_x [N+1, nx], D_u [N, nu]; cost scale c []."""

    d_row: Array
    d_x: Array
    d_u: Array
    c: Array


def ruiz_equilibrate(coeffs: LqrCoeffs, iterations: int = 5):
    """Ruiz-style row/column equilibration of the stacked (cost, dynamics)
    OCP data (reference precondition/Ruzi.h:92 ocpDataInPlaceInParallel).

    Operates stage-parallel: every row/column inf-norm is computed with
    vmapped reductions over the stage blocks that touch it, never forming the
    stacked matrix.  Returns scaled coefficients + the scaling (to unscale
    the solution: dx = D_x dx_s, du = D_u du_s, eta = c^-1 D_r eta_s).
    """
    n, nx = coeffs.b.shape
    nu = coeffs.B.shape[-1]
    dt = coeffs.b.dtype
    cur = coeffs

    def scale_once(cur, scal):
        d_row, d_x, d_u, c = scal
        # Column inf-norms over all blocks touching each variable.
        colx_a = jnp.max(jnp.abs(cur.A), axis=1)  # [N, nx] for dx_k
        colx_q = jnp.max(jnp.abs(cur.Qxx), axis=1)
        colx_qux = jnp.max(jnp.abs(cur.Qux), axis=1)  # [N, nx]
        # -I block contributes 1 to every column; scatter-free concat form
        # (a .at[].max scatter here miscompiles under the XLA CPU SPMD
        # partitioner when this feeds a shard_map in the same jit).
        colx = jnp.concatenate(
            [
                jnp.maximum(
                    1.0, jnp.maximum(colx_a, jnp.maximum(colx_q, colx_qux))
                ),
                jnp.maximum(1.0, jnp.max(jnp.abs(cur.Qf), axis=0))[None],
            ],
            axis=0,
        )
        colu = jnp.maximum(
            jnp.max(jnp.abs(cur.B), axis=1),
            jnp.maximum(
                jnp.max(jnp.abs(cur.Quu), axis=1),
                jnp.max(jnp.abs(cur.Qux), axis=2),
            ),
        )
        dx_s = 1.0 / jnp.sqrt(jnp.maximum(colx, 1e-6))
        du_s = 1.0 / jnp.sqrt(jnp.maximum(colu, 1e-6))
        # Row scaling of the dynamics constraints is tied to the next-state
        # column scaling so the -I block stays exactly -I (the stage-form
        # invariant _g_matvec relies on): D_r[k] = 1 / D_x[k+1].
        dr = 1.0 / dx_s[1:]

        def sc(mat, left, right):
            return left[..., :, None] * mat * right[..., None, :]

        new = LqrCoeffs(
            A=sc(cur.A, dr, dx_s[:-1]),
            B=sc(cur.B, dr, du_s),
            b=dr * cur.b,
            Qxx=sc(cur.Qxx, dx_s[:-1], dx_s[:-1]),
            qx=dx_s[:-1] * cur.qx,
            Quu=sc(cur.Quu, du_s, du_s),
            qu=du_s * cur.qu,
            Qux=sc(cur.Qux, du_s, dx_s[:-1]),
            Qf=sc(cur.Qf, dx_s[-1], dx_s[-1]),
            qf=dx_s[-1] * cur.qf,
        )
        return new, RuizScaling(d_row * dr, d_x * dx_s, d_u * du_s, c)

    scal = RuizScaling(
        d_row=jnp.ones((n, nx), dt),
        d_x=jnp.ones((n + 1, nx), dt),
        d_u=jnp.ones((n, nu), dt),
        c=jnp.ones((), dt),
    )
    for _ in range(iterations):
        cur, scal = scale_once(cur, scal)
    # Cost scale: normalize average stage-Hessian inf-norm toward 1.
    hnorm = (
        jnp.mean(jnp.max(jnp.abs(cur.Qxx), axis=(1, 2)))
        + jnp.mean(jnp.max(jnp.abs(cur.Quu), axis=(1, 2)))
    ) * 0.5
    c_new = 1.0 / jnp.maximum(hnorm, 1e-6)
    cur = cur._replace(
        Qxx=c_new * cur.Qxx, qx=c_new * cur.qx, Quu=c_new * cur.Quu,
        qu=c_new * cur.qu, Qux=c_new * cur.Qux, Qf=c_new * cur.Qf,
        qf=c_new * cur.qf,
    )
    return cur, scal._replace(c=c_new)


def _zero_row0(gx):
    return gx.at[0].set(0.0)


def pipg_solve(
    coeffs: LqrCoeffs,
    settings: PipgSettings = PipgSettings(),
    u_lower: Optional[Array] = None,
    u_upper: Optional[Array] = None,
    dxs0: Optional[Array] = None,
    dus0: Optional[Array] = None,
) -> PipgSolution:
    """Solve the LQ OCP-QP with the extrapolated PIPG iteration.

    min  sum_k 1/2 [dx;du]' H_k [dx;du] + q_k'[dx;du]  + terminal
    s.t. dx_{k+1} = A dx_k + B du_k + b_k,   dx_0 = 0,
         u_lower <= du_k <= u_upper          (optional box, handled by
                                              projection — the PIPG way of
                                              doing input constraints).

    Validated against the Riccati kernel in tests/test_pipg.py.
    """
    n, nx = coeffs.b.shape
    nu = coeffs.B.shape[-1]
    dt = coeffs.b.dtype

    mu, lam = estimate_cost_eigs(coeffs, settings.power_iterations)
    sigma = settings.sigma_safety * jnp.abs(
        estimate_sigma(coeffs, settings.power_iterations)
    )
    # Step sizes (arXiv:2009.06980): alpha = 2 / (sqrt(mu^2 + 4 omega sigma)
    # + mu), beta = omega * alpha, with omega ~ lam a robust default.
    omega = jnp.maximum(lam, 1e-6)
    alpha = 2.0 / (jnp.sqrt(mu * mu + 4.0 * omega * sigma) + mu)
    beta = omega * alpha
    rho = settings.relaxation

    def project(dus):
        if u_lower is not None:
            dus = jnp.maximum(dus, u_lower)
        if u_upper is not None:
            dus = jnp.minimum(dus, u_upper)
        return dus

    zx = jnp.zeros((n + 1, nx), dt) if dxs0 is None else dxs0
    zu = jnp.zeros((n, nu), dt) if dus0 is None else dus0
    w = jnp.zeros((n, nx), dt)  # integral dual state
    q_x = jnp.concatenate([coeffs.qx, coeffs.qf[None]], axis=0)

    def body(_, carry):
        """Canonical PIPG iteration (arXiv:2009.06980, Algorithm 1):

            v   = w + beta * (G z + b)           proportional + integral dual
            z+  = proj_D(z - alpha * (Q z + q + G' v))
            w+  = w + beta * (G z+ + b)          integral accumulation
        """
        zx, zu, w = carry
        v = w + beta * (_g_matvec(coeffs, zx, zu) + coeffs.b)
        gx, gu = _cost_matvec(coeffs, zx, zu)
        gtx, gtu = _gt_matvec(coeffs, v)
        zx_n = _zero_row0(zx - alpha * (gx + q_x + gtx))  # dx_0 = 0 pinned
        zu_n = project(zu - alpha * (gu + coeffs.qu + gtu))
        w_n = w + beta * (_g_matvec(coeffs, zx_n, zu_n) + coeffs.b)
        # Over-relaxation on the primal pair (rho in (0, 2)).
        zx_r = (1.0 - rho) * zx + rho * zx_n
        zu_r = (1.0 - rho) * zu + rho * zu_n
        return zx_r, zu_r, w_n

    zx, zu, w = jax.lax.fori_loop(
        0, settings.num_iterations, body, (zx, zu, w)
    )
    res = _g_matvec(coeffs, zx, zu) + coeffs.b
    return PipgSolution(
        dxs=zx, dus=zu, eta=w,
        primal_residual=jnp.max(jnp.abs(res)),
    )
