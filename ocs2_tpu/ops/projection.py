"""QR-based null-space projection of state-input equality constraints.

JAX-native analogue of the reference's constraint projection
(ocs2_oc/multiple_shooting/Transcription.h:87 ``projectTranscription``,
ocs2_core/misc/LinearAlgebra.h rank-revealing QR projection, and the remap
helpers multiple_shooting/Helpers.h ``remapProjectedInput/remapProjectedGain``).

Given g + C dx + D du = 0 with D [ne, nu] full row rank (ne < nu), every
feasible input increment is

    du = p0 + Px dx + Pu v,      v in R^{nu - ne}

with p0 = -D^+ g, Px = -D^+ C, Pu = null-space basis of D.  Substituting into
the node quadratic cost yields a *reduced, unconstrained* LQ stage — the
Riccati kernel then solves the equality-constrained QP exactly.  All maps are
batched over the horizon with vmap.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.types import symmetrize
from .riccati import LqrCoeffs

Array = jax.Array


class Projection(NamedTuple):
    p0: Array  # [nu]        feasibility offset
    Px: Array  # [nu, nx]    state-feedback part
    Pu: Array  # [nu, nv]    null-space basis (orthonormal columns)


def constraint_projection(g: Array, C: Array, D: Array) -> Projection:
    """Compute the projection for one node via full QR of D^T.

    D^T = Q [R; 0]; D^+ = Q1 R^{-T}; null(D) = Q2.
    """
    ne, nu = D.shape
    q_full, r_full = jnp.linalg.qr(D.T, mode="complete")  # [nu,nu], [nu,ne]
    q1 = q_full[:, :ne]
    q2 = q_full[:, ne:]
    r = r_full[:ne, :]
    # D^+ z = Q1 R^{-T} z  (solve R^T w = z).
    def dpinv(z):
        w = jax.scipy.linalg.solve_triangular(r.T, z, lower=True)
        return q1 @ w

    p0 = -dpinv(g)
    px = -jax.vmap(dpinv, in_axes=1, out_axes=1)(C)
    return Projection(p0=p0, Px=px, Pu=q2)


def project_lqr_coeffs(
    coeffs: LqrCoeffs, g: Array, C: Array, D: Array
) -> tuple[LqrCoeffs, Projection]:
    """Reduce batched stage coefficients onto the constraint null space.

    g [N, ne], C [N, ne, nx], D [N, ne, nu].  Returns coefficients in the
    reduced input v (dim nu - ne) plus the batched projection for remapping.
    """
    proj = jax.vmap(constraint_projection)(g, C, D)

    def stage(a, b_mat, b, qxx, qx, quu, qu, qux, p0, px, pu):
        a_t = a + b_mat @ px
        b_t = b_mat @ pu
        bb_t = b + b_mat @ p0
        qu_full = qu + quu @ p0
        qxx_t = symmetrize(qxx + px.T @ qux + qux.T @ px + px.T @ quu @ px)
        qx_t = qx + px.T @ qu + (qux.T + px.T @ quu) @ p0
        quu_t = pu.T @ quu @ pu
        qu_t = pu.T @ qu_full
        qux_t = pu.T @ (qux + quu @ px)
        return a_t, b_t, bb_t, qxx_t, qx_t, quu_t, qu_t, qux_t

    a_t, b_t, bb_t, qxx_t, qx_t, quu_t, qu_t, qux_t = jax.vmap(stage)(
        coeffs.A, coeffs.B, coeffs.b, coeffs.Qxx, coeffs.qx,
        coeffs.Quu, coeffs.qu, coeffs.Qux, proj.p0, proj.Px, proj.Pu,
    )
    reduced = LqrCoeffs(
        A=a_t, B=b_t, b=bb_t, Qxx=qxx_t, qx=qx_t, Quu=quu_t, qu=qu_t,
        Qux=qux_t, Qf=coeffs.Qf, qf=coeffs.qf,
    )
    return reduced, proj


def remap_projected_input(proj: Projection, dxs: Array, dvs: Array) -> Array:
    """du_k = p0 + Px dx_k + Pu dv_k (reference remapProjectedInput)."""

    def one(p0, px, pu, dx, dv):
        return p0 + px @ dx + pu @ dv

    return jax.vmap(one)(proj.p0, proj.Px, proj.Pu, dxs, dvs)


def remap_projected_gain(proj: Projection, gains_v: Array) -> Array:
    """K_u = Px + Pu K_v (reference remapProjectedGain)."""
    return proj.Px + jnp.einsum("kuv,kvx->kux", proj.Pu, gains_v)
