"""MPC-Net losses.

JAX-native analogues of the reference losses (ocs2_mpcnet_core/python/
ocs2_mpcnet_core/loss/hamiltonian.py, behavioral_cloning.py,
cross_entropy.py).  The Hamiltonian loss consumes the per-node quadratic
approximation of the control Hamiltonian that the solver computes anyway —
here the discrete-time Q-function expansion assembled from the LQ data and
the Riccati value function (the same byproduct the reference harvests in
MpcnetDataGeneration, rollout/MpcnetData.h).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array


class HamiltonianApprox(NamedTuple):
    """Quadratic expansion of the node Hamiltonian (Q-function) in du = u - u*:
    H(u) = h0 + hu'du + 1/2 du'Huu du   (reference MpcnetData hamiltonian
    entries; batched over samples)."""

    h0: Array  # [...,]
    hu: Array  # [..., nu]
    Huu: Array  # [..., nu, nu]

    def value(self, du: Array) -> Array:
        return (
            self.h0
            + jnp.einsum("...u,...u->...", self.hu, du)
            + 0.5 * jnp.einsum("...u,...uv,...v->...", du, self.Huu, du)
        )


def hamiltonian_loss(hammy: HamiltonianApprox, u_pred: Array, u_star: Array) -> Array:
    """Mean Hamiltonian of predicted inputs (reference loss/hamiltonian.py:
    the policy minimizes the MPC's Q-function rather than cloning u*)."""
    return jnp.mean(hammy.value(u_pred - u_star))


def behavioral_cloning_loss(u_pred: Array, u_star: Array, R: Array) -> Array:
    """Weighted L2 imitation (reference loss/behavioral_cloning.py)."""
    du = u_pred - u_star
    return jnp.mean(jnp.einsum("...u,uv,...v->...", du, R, du))


def cross_entropy_loss(gates: Array, mode_probs: Array, eps: float = 1e-8) -> Array:
    """Gating cross entropy vs. target mode distribution (reference
    loss/cross_entropy.py pairs expert gates with gait-mode labels)."""
    return -jnp.mean(jnp.sum(mode_probs * jnp.log(gates + eps), axis=-1))


def hamiltonian_from_lq(
    lq, value_S: Array, value_s: Array, xs: Array
) -> HamiltonianApprox:
    """Assemble per-node Hamiltonian expansions from the horizon LQ data and
    the value function of the Riccati pass.

    Discrete Q-function at node k:  Q(dx, du) = l_k + V_{k+1}(A dx + B du + b);
    its u-block at dx = 0 is exactly the Riccati intermediate
    (Qu_hat, Quu_hat) — the quantity the reference stores per sample
    (rollout/MpcnetData.h hamiltonian).  Shapes: [N, ...].

    value_S/value_s live in DELTA coordinates around the solution trajectory,
    so the affine term must be the multiple-shooting defect
    b = F(x_k,u_k) - x_{k+1} (what the solvers pass as LqrCoeffs.b), NOT the
    absolute predicted next state lq.dynamics.f — using f adds a spurious
    B'S_{k+1}x_{k+1} to hu and shifts the Q-function minimizer away from u*.
    ``xs`` is the solution state trajectory [N+1, nx] used to form the defect.
    """
    a, b_mat = lq.dynamics.dfdx, lq.dynamics.dfdu
    b = lq.dynamics.f - xs[1:]
    s_next = value_S[1:]
    sv_next = value_s[1:]

    def node(a_k, bm_k, b_k, quu, qu, s, sv):
        sv_b = sv + s @ b_k
        hu = qu + bm_k.T @ sv_b
        huu = quu + bm_k.T @ s @ bm_k
        return hu, huu

    hu, huu = jax.vmap(node)(
        a, b_mat, b, lq.cost.dfduu[:-1], lq.cost.dfdu[:-1], s_next, sv_next
    )
    h0 = lq.cost.f[:-1]
    return HamiltonianApprox(h0=h0, hu=hu, Huu=huu)
