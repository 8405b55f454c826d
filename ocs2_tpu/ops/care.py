"""Continuous-time algebraic Riccati equation / infinite-horizon LQR.

JAX-native analogue of the reference's ContinuousTimeLqr utility
(ocs2_ddp/include/ocs2_ddp/ContinuousTimeLqr.h: computes the CARE solution
and the LQR gain for a linearized system).  The reference calls into a
Schur-decomposition CARE; Schur is not jittable, so we use the matrix
**sign-function iteration** on the Hamiltonian pencil — pure matmuls and
solves, fixed iteration count, batchable with vmap:

    H = [[A, -B R^-1 B'], [-Q, -A']]
    Z_{k+1} = (c Z_k + (c Z_k)^{-1}) / 2,  c = |det Z|^{-1/(2n)}  (scaling)
    sign(H) yields the stable invariant subspace; P solves
    [W12; W22 + I] P = -[W11 + I; W21]  in the least-squares sense.

Solves A'P + PA - P B R^-1 B' P + Q = 0; K = R^-1 B' P.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array


class CareSolution(NamedTuple):
    P: Array  # [nx, nx] value-function Hessian
    K: Array  # [nu, nx] LQR gain, u = -K x
    residual: Array  # [] CARE residual inf-norm


def solve_care(
    A: Array, B: Array, Q: Array, R: Array, iterations: int = 40
) -> CareSolution:
    nx = A.shape[0]
    Rinv = jnp.linalg.inv(R)
    G = B @ Rinv @ B.T
    H = jnp.block([[A, -G], [-Q, -A.T]])

    def body(_, Z):
        # Determinant scaling accelerates the sign iteration.
        sign, logdet = jnp.linalg.slogdet(Z)
        c = jnp.exp(-logdet / (2.0 * nx))
        Zs = c * Z
        return 0.5 * (Zs + jnp.linalg.inv(Zs))

    W = jax.lax.fori_loop(0, iterations, body, H)
    W11 = W[:nx, :nx]
    W12 = W[:nx, nx:]
    W21 = W[nx:, :nx]
    W22 = W[nx:, nx:]
    eye = jnp.eye(nx, dtype=A.dtype)
    lhs = jnp.concatenate([W12, W22 + eye], axis=0)
    rhs = -jnp.concatenate([W11 + eye, W21], axis=0)
    P = jnp.linalg.lstsq(lhs, rhs)[0]
    P = 0.5 * (P + P.T)
    K = Rinv @ B.T @ P
    res = A.T @ P + P @ A - P @ G @ P + Q
    return CareSolution(P=P, K=K, residual=jnp.max(jnp.abs(res)))


def solve_lqr(A: Array, B: Array, Q: Array, R: Array) -> CareSolution:
    """Infinite-horizon continuous-time LQR (ContinuousTimeLqr.h computeController)."""
    return solve_care(A, B, Q, R)
