"""MPC-Net policy architectures.

JAX-native re-design of the reference MPC-Net policies
(ocs2_mpcnet/ocs2_mpcnet_core/python/ocs2_mpcnet_core/policy/linear.py,
nonlinear.py, mixture_of_linear_experts.py, mixture_of_nonlinear_experts.py)
as flax modules.  The reference wraps PyTorch modules and deploys them via
ONNX into a C++ controller (MpcnetOnnxController.h:59); here the policy is a
jitted pure function, so "deployment" is calling it inside the same XLA
program as the rollout — no serialization boundary at all.

Each policy maps an observation (by default (t, x) features produced by an
``observation_fn``) to an input u, optionally through an action transform
u = A a + b (the reference's action transformation, e.g. gravity
compensation for the legged robot).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import flax.linen as nn
import jax
import jax.numpy as jnp

Array = jax.Array


class LinearPolicy(nn.Module):
    """u = W o + b (reference policy/linear.py)."""

    action_dim: int

    @nn.compact
    def __call__(self, obs: Array) -> Array:
        return nn.Dense(self.action_dim, name="linear")(obs)


class NonlinearPolicy(nn.Module):
    """MLP with tanh hidden activations (reference policy/nonlinear.py uses
    one hidden layer of dim (obs+action)/2 with tanh)."""

    action_dim: int
    hidden: Sequence[int] = ()

    @nn.compact
    def __call__(self, obs: Array) -> Array:
        h = obs
        hidden = self.hidden or ((obs.shape[-1] + self.action_dim) // 2,)
        for i, width in enumerate(hidden):
            h = jnp.tanh(nn.Dense(width, name=f"hidden_{i}")(h))
        return nn.Dense(self.action_dim, name="out")(h)


class MixtureOfNonlinearExpertsPolicy(nn.Module):
    """Gated mixture of nonlinear experts (reference
    policy/mixture_of_nonlinear_experts.py): u = sum_e p_e(o) * u_e(o) with
    a softmax gating network.  The gate probabilities are also returned by
    ``apply_with_gates`` for the cross-entropy gating loss (loss/cross_entropy
    .py pairs gates with mode labels)."""

    action_dim: int
    num_experts: int
    expert_hidden: Sequence[int] = ()

    def __call__(self, obs: Array) -> Array:
        u, _ = self.apply_with_gates(obs)
        return u

    @nn.compact
    def apply_with_gates(self, obs: Array):
        gate_h = jnp.tanh(
            nn.Dense((obs.shape[-1] + self.num_experts) // 2, name="gate_hidden")(obs)
        )
        gates = nn.softmax(nn.Dense(self.num_experts, name="gate_out")(gate_h))
        experts = []
        for e in range(self.num_experts):
            h = obs
            hidden = self.expert_hidden or (
                (obs.shape[-1] + self.action_dim) // 2,
            )
            for i, width in enumerate(hidden):
                h = jnp.tanh(nn.Dense(width, name=f"expert{e}_hidden{i}")(h))
            experts.append(nn.Dense(self.action_dim, name=f"expert{e}_out")(h))
        u = jnp.einsum("...e,...eu->...u", gates, jnp.stack(experts, axis=-2))
        return u, gates


class MixtureOfLinearExpertsPolicy(nn.Module):
    """Gated mixture of LINEAR experts (reference
    policy/mixture_of_linear_experts.py): u = sum_e p_e(o) * (W_e o + b_e)
    with a single-layer softmax gating network (gating_net = Linear +
    Softmax in the reference)."""

    action_dim: int
    num_experts: int

    def __call__(self, obs: Array) -> Array:
        u, _ = self.apply_with_gates(obs)
        return u

    @nn.compact
    def apply_with_gates(self, obs: Array):
        gates = nn.softmax(nn.Dense(self.num_experts, name="gate")(obs))
        experts = jnp.stack(
            [
                nn.Dense(self.action_dim, name=f"expert{e}")(obs)
                for e in range(self.num_experts)
            ],
            axis=-2,
        )
        u = jnp.einsum("...e,...eu->...u", gates, experts)
        return u, gates


def default_observation(t: Array, x: Array) -> Array:
    """Default observation features: the state itself (robot modules override
    with e.g. gait-phase-augmented features, cf. reference per-robot
    mpcnet helper observation/action transforms)."""
    del t
    return x


def make_policy_fn(
    module: nn.Module,
    observation_fn: Callable[[Array, Array], Array] = default_observation,
    action_transform: Optional[Callable[[Array, Array, Array], Array]] = None,
):
    """Bind a flax module into a (params, t, x) -> u policy function.

    action_transform(t, x, a) -> u maps raw network actions into inputs
    (reference MpcnetDefinitionBase::getActionTransformation).
    """

    def policy(params, t, x):
        a = module.apply(params, observation_fn(t, x))
        if action_transform is not None:
            return action_transform(t, x, a)
        return a

    return policy
