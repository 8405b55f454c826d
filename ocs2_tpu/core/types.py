"""Core value types: Taylor-approximation containers and performance indices.

JAX-native re-expression of the reference's universal currency types
(reference: ocs2_core/include/ocs2_core/Types.h:44-341).  Where the reference
uses dynamically sized Eigen matrices held in per-node ``std::vector``s, we use
JAX pytrees of dense arrays with an optional leading time/batch axis — the
layout XLA wants for vmapped linearization and scanned Riccati recursions.

All containers are ``NamedTuple``s so they are pytrees for free: they can be
``vmap``-ped, ``scan``-ned, donated, and sharded without any registration.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

Array = jax.Array


class ScalarQuadraticApproximation(NamedTuple):
    """Second-order Taylor expansion of a scalar function (cost term).

    f(x+dx, u+du) ~= f + dfdx.dx + dfdu.du + 1/2 dx'dfdxx dx + du'dfdux dx
                     + 1/2 du'dfduu du

    Mirrors ScalarFunctionQuadraticApproximation (reference Types.h:145-232).
    Arrays may carry leading batch/time axes.
    """

    f: Array  # [] or [N]
    dfdx: Array  # [nx] or [N, nx]
    dfdu: Optional[Array]  # [nu]
    dfdxx: Array  # [nx, nx]
    dfdux: Optional[Array]  # [nu, nx]
    dfduu: Optional[Array]  # [nu, nu]

    def __add__(self, other: "ScalarQuadraticApproximation"):
        return jax.tree.map(
            lambda a, b: a + b, self, other, is_leaf=lambda x: x is None
        )

    @staticmethod
    def zeros(nx: int, nu: Optional[int] = None, dtype=jnp.float32):
        has_u = nu is not None
        return ScalarQuadraticApproximation(
            f=jnp.zeros((), dtype),
            dfdx=jnp.zeros((nx,), dtype),
            dfdu=jnp.zeros((nu,), dtype) if has_u else None,
            dfdxx=jnp.zeros((nx, nx), dtype),
            dfdux=jnp.zeros((nu, nx), dtype) if has_u else None,
            dfduu=jnp.zeros((nu, nu), dtype) if has_u else None,
        )


class VectorLinearApproximation(NamedTuple):
    """First-order Taylor expansion of a vector function (dynamics/constraint).

    Mirrors VectorFunctionLinearApproximation (reference Types.h:234-291).
    """

    f: Array  # [m] or [N, m]
    dfdx: Array  # [m, nx]
    dfdu: Optional[Array]  # [m, nu]

    @staticmethod
    def zeros(m: int, nx: int, nu: Optional[int] = None, dtype=jnp.float32):
        return VectorLinearApproximation(
            f=jnp.zeros((m,), dtype),
            dfdx=jnp.zeros((m, nx), dtype),
            dfdu=jnp.zeros((m, nu), dtype) if nu is not None else None,
        )


class PerformanceIndex(NamedTuple):
    """Per-iteration solution quality record.

    Mirrors the reference's PerformanceIndex (ocs2_oc/oc_data/
    PerformanceIndex.h:42-96): merit = cost + dynamics/constraint violation
    penalties + Lagrangian terms.  Kept as a flat pytree of scalars so a
    batched solve produces a batched PerformanceIndex for free.
    """

    merit: Array
    cost: Array
    dynamics_violation_sse: Array
    equality_constraints_sse: Array
    inequality_constraints_sse: Array
    equality_lagrangian: Array
    inequality_lagrangian: Array

    @staticmethod
    def zeros(dtype=jnp.float32):
        z = jnp.zeros((), dtype)
        return PerformanceIndex(z, z, z, z, z, z, z)

    def __add__(self, other: "PerformanceIndex"):
        return jax.tree.map(lambda a, b: a + b, self, other)


def make_psd(mat: Array, min_eigenvalue: float = 0.0) -> Array:
    """Shift the symmetric part of ``mat`` to have eigenvalues >= min_eigenvalue.

    Analogue of LinearAlgebra::makePsdEigenvalue (reference
    ocs2_core/misc/LinearAlgebra.h): symmetric eigendecomposition with clamped
    eigenvalues.  Batched via vmap by callers.
    """
    sym = 0.5 * (mat + mat.T)
    w, v = jnp.linalg.eigh(sym)
    w = jnp.maximum(w, min_eigenvalue)
    return (v * w) @ v.T


def symmetrize(mat: Array) -> Array:
    return 0.5 * (mat + jnp.swapaxes(mat, -1, -2))
