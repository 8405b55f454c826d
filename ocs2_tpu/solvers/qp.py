"""Dense KKT ground-truth solver for LQ optimal-control problems.

Analogue of the reference's independent test solver
`ocs2_test_tools/ocs2_qp_solver` (Ocs2QpSolver.h, QpSolver.h): assembles the
full dense KKT system of the equality-constrained LQ problem and solves it
directly.  Used in tests as ground truth for the scan/associative-scan Riccati
kernels (the same role it plays in the reference's CorrectnessTest.cpp).

Deliberately host-side numpy in float64: ground truth must be more precise
than the f32 device kernels it validates, and it never runs in the hot path.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..ops.riccati import LqrCoeffs


class DenseQpSolution(NamedTuple):
    dxs: np.ndarray  # [N+1, nx]
    dus: np.ndarray  # [N, nu]
    cost: float


def _kkt_system(coeffs: LqrCoeffs):
    """Dense KKT matrix of the LQ problem and its right-hand side for dx_0 = 0.

    Decision vector z = [dx_0, du_0, dx_1, du_1, ..., dx_N]; the first nx
    constraint rows pin dx_0, so the right-hand side for another initial
    state adds it at rows [nz, nz + nx).
    """
    c = LqrCoeffs(*(np.asarray(f, np.float64) for f in coeffs))
    n, nx = c.b.shape
    nu = c.B.shape[-1]
    nz = (n + 1) * nx + n * nu
    h = np.zeros((nz, nz))
    g = np.zeros((nz,))

    def xi(k):
        return k * (nx + nu)

    def ui(k):
        return k * (nx + nu) + nx

    for k in range(n):
        sx = slice(xi(k), xi(k) + nx)
        su = slice(ui(k), ui(k) + nu)
        h[sx, sx] += c.Qxx[k]
        h[su, su] += c.Quu[k]
        h[su, sx] += c.Qux[k]
        h[sx, su] += c.Qux[k].T
        g[sx] += c.qx[k]
        g[su] += c.qu[k]
    sxn = slice(xi(n), xi(n) + nx)
    h[sxn, sxn] += c.Qf
    g[sxn] += c.qf

    # Equality constraints: dx_0 = dx0; dx_{k+1} = A dx_k + B du_k + b.
    nc = (n + 1) * nx
    e = np.zeros((nc, nz))
    d = np.zeros((nc,))
    e[0:nx, 0:nx] = np.eye(nx)
    for k in range(n):
        row = slice((k + 1) * nx, (k + 2) * nx)
        e[row, xi(k) : xi(k) + nx] = c.A[k]
        e[row, ui(k) : ui(k) + nu] = c.B[k]
        e[row, xi(k + 1) : xi(k + 1) + nx] = -np.eye(nx)
        d[row] = -c.b[k]

    kkt = np.block([[h, e.T], [e, np.zeros((nc, nc))]])
    rhs = np.concatenate([-g, d])
    return kkt, rhs, h, g, (n, nx, nu, nz)


def solve_lq_dense(coeffs: LqrCoeffs, dx0) -> DenseQpSolution:
    """Solve min sum quadratic stage costs s.t. linear dynamics, dx_0 given."""
    kkt, rhs, h, g, (n, nx, nu, nz) = _kkt_system(coeffs)
    rhs[nz : nz + nx] = np.asarray(dx0, np.float64)
    z = np.linalg.solve(kkt, rhs)[:nz]

    step = nx + nu
    dxs = np.stack([z[k * step : k * step + nx] for k in range(n + 1)])
    dus = np.stack([z[k * step + nx : (k + 1) * step] for k in range(n)])
    cost = 0.5 * z @ h @ z + g @ z
    return DenseQpSolution(dxs=dxs, dus=dus, cost=float(cost))


class DenseStartSensitivity(NamedTuple):
    """The Riccati quantities at node 0, from the dense KKT system."""

    gains: np.ndarray  # [nu, nx]  d du_0 / d dx_0
    kff: np.ndarray  # [nu]      du_0 at dx_0 = 0
    value_S: np.ndarray  # [nx, nx]  Hessian of the optimal cost in dx_0
    value_s: np.ndarray  # [nx]      its gradient at dx_0 = 0


def dense_start_sensitivity(coeffs: LqrCoeffs) -> DenseStartSensitivity:
    """Float64 ground truth for a backward pass's gains[0], kff[0],
    value_S[0] and value_s[0].

    The KKT system is linear in dx_0, so one solve with nx + 1 right-hand
    sides (dx_0 = 0 and the unit vectors) gives du_0 and the multipliers
    lam_0 of the constraint dx_0 = d as affine functions of d.  With the
    Lagrangian 1/2 z'Hz + g'z + lam'(Ez - d), the optimal cost V(d) has
    dV/dd = -lam_0.
    """
    kkt, rhs, _, _, (_, nx, nu, nz) = _kkt_system(coeffs)
    rhs_all = np.tile(rhs[:, None], (1, nx + 1))
    rhs_all[nz : nz + nx, 1:] += np.eye(nx)
    sol = np.linalg.solve(kkt, rhs_all)
    du0 = sol[nx : nx + nu]
    lam0 = sol[nz : nz + nx]
    return DenseStartSensitivity(
        gains=du0[:, 1:] - du0[:, :1],
        kff=du0[:, 0],
        value_S=-(lam0[:, 1:] - lam0[:, :1]),
        value_s=-lam0[:, 0],
    )
