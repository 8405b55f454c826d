"""Forward rollout of the (possibly switched) system dynamics.

JAX-native analogue of the reference rollout machinery
(ocs2_oc/include/ocs2_oc/rollout/RolloutBase.h:46-130,
TimeTriggeredRollout.h:46).  One ``lax.scan`` over the horizon replaces the
per-segment ODE integration loop; jump transitions are masked blends on the
duplicated event nodes of the TimeGrid, so switched-system rollouts are a
single fused compiled program.  State-triggered rollouts (guard-surface
root-finding, StateTriggeredRollout.h:46) live in
:mod:`ocs2_tpu.oc.hybrid_rollout`.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.integrate import discretize
from .problem import OptimalControlProblem
from .time_discretization import TimeGrid
from .approx import node_params

Array = jax.Array
# policy(t, x, k) -> u ; k is the node index (lets array policies index directly).
Policy = Callable[[Array, Array, Array], Array]


def rollout(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    x0: Array,
    policy: Policy,
    params: Any,
    method: str = "rk4",
    substeps: int = 1,
):
    """Closed-loop rollout. Returns (xs [N+1, nx], us [N, nu])."""
    grid = grid.device()

    def transition(k, x):
        t = grid.times[k]
        dt = grid.times[k + 1] - grid.times[k]
        p = node_params(params, grid, k)
        p_next = node_params(params, grid, k + 1)
        u = policy(t, x, k)
        flow = discretize(
            lambda tt, xx, uu: problem.dynamics(tt, xx, uu, p), method, substeps
        )
        x_int = flow(t, x, u, dt)
        x_jmp = problem.apply_jump(t, x, p_next)
        m = grid.is_jump[k]
        return (1.0 - m) * x_int + m * x_jmp, u

    def body(x, k):
        xn, u = transition(k, x)
        return xn, (xn, u)

    _, (xs_tail, us) = jax.lax.scan(body, x0, jnp.arange(grid.num_intervals))
    xs = jnp.concatenate([x0[None], xs_tail], axis=0)
    return xs, us


def open_loop_policy(us: Array) -> Policy:
    return lambda t, x, k: us[k]


def linear_policy(us_ff: Array, gains: Array, xs_nom: Array) -> Policy:
    """u_k = uff_k + K_k (x - x_nom_k) (reference LinearController.h:42)."""

    def policy(t, x, k):
        return us_ff[k] + gains[k] @ (x - xs_nom[k])

    return policy


def ddp_search_policy(
    us_nom: Array, duff: Array, gains: Array, xs_nom: Array, alpha
) -> Policy:
    """u_k = u_nom_k + alpha * duff_k + K_k (x - x_nom_k)."""

    def policy(t, x, k):
        return us_nom[k] + alpha * duff[k] + gains[k] @ (x - xs_nom[k])

    return policy


class RolloutMetrics(NamedTuple):
    """Cost and constraint-violation accumulators of a rollout (analogue of
    ProblemMetrics / PerformanceIndicesRollout.h)."""

    cost: Array
    eq_sse: Array
    ineq_sse: Array  # sum of squared *violations* max(0, -h)


def evaluate_rollout(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    xs: Array,
    us: Array,
    params: Any,
) -> RolloutMetrics:
    """Total cost + constraint violation of a state/input trajectory."""
    n = grid.num_intervals

    def node(k):
        t = grid.times[k]
        dt = grid.times[k + 1] - grid.times[k]
        p = node_params(params, grid, k)
        x = xs[k]
        u = us[k]
        m = grid.is_jump[k]
        c = dt * problem.cost(t, x, u, p)
        if problem.pre_jump_cost_terms:
            c = c + m * problem.pre_jump_cost(t, x, p)
        eq = jnp.zeros(())
        if problem.equality_terms:
            eq = eq + jnp.sum(jnp.square(problem.equality(t, x, u, p)))
        if problem.state_equality_terms:
            eq = eq + jnp.sum(jnp.square(problem.state_equality(t, x, p)))
        ineq = jnp.zeros(())
        if problem.inequality_terms:
            h = problem.inequality(t, x, u, p)
            ineq = ineq + jnp.sum(jnp.square(jnp.minimum(h, 0.0)))
        if problem.state_inequality_terms:
            h = problem.state_inequality(t, x, p)
            ineq = ineq + jnp.sum(jnp.square(jnp.minimum(h, 0.0)))
        return c, eq, ineq

    cs, eqs, ineqs = jax.vmap(node)(jnp.arange(n))
    tN = grid.times[n]
    pN = node_params(params, grid, n)
    cost = jnp.sum(cs) + problem.final_cost(tN, xs[n], pN)
    eq_sse = jnp.sum(eqs)
    ineq_sse = jnp.sum(ineqs)
    if problem.state_equality_terms:
        eq_sse = eq_sse + jnp.sum(jnp.square(problem.state_equality(tN, xs[n], pN)))
    if problem.final_equality_terms:
        eq_sse = eq_sse + jnp.sum(jnp.square(problem.final_equality(tN, xs[n], pN)))
    if problem.state_inequality_terms:
        h = problem.state_inequality(tN, xs[n], pN)
        ineq_sse = ineq_sse + jnp.sum(jnp.square(jnp.minimum(h, 0.0)))
    return RolloutMetrics(cost=cost, eq_sse=eq_sse, ineq_sse=ineq_sse)
