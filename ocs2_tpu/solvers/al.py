"""Augmented-Lagrangian constraint handling.

JAX-native analogue of the reference's augmented-Lagrangian machinery
(ocs2_core/augmented_lagrangian/*.h + penalties/augmented/*.h and the DDP
penalty-update loop GaussNewtonDDP.cpp).  Constraints are folded into the
cost through AL terms whose per-node multipliers live in the *parameter*
pytree (key "al"), so the solver's LQ approximation differentiates them
exactly and multiplier updates are pure array ops — no Multiplier object
graph.

The node index is injected into params (key "node") by the LQ approximator /
rollout evaluator so AL terms can gather their node's multiplier row.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core import penalties as pen
from ..oc.problem import OptimalControlProblem
from ..oc.time_discretization import TimeGrid
from ..oc.approx import node_params

Array = jax.Array


class AlState(NamedTuple):
    """Per-node multipliers and the shared penalty scale.

    Shapes (padded with zero-size arrays when a constraint family is absent):
      lmbd_eq       [N,  ne]   state-input equality
      lmbd_state_eq [N+1, nse] state-only equality
      lmbd_ineq     [N,  ni]   state-input inequality (>= 0)
      lmbd_state_ineq [N+1, nsi]
      lmbd_final_eq [nfe]
      rho           []         penalty coefficient
    """

    lmbd_eq: Array
    lmbd_state_eq: Array
    lmbd_ineq: Array
    lmbd_state_ineq: Array
    lmbd_final_eq: Array
    rho: Array

    @staticmethod
    def init(dims: dict, num_intervals: int, rho: float = 10.0, dtype=jnp.float32):
        n = num_intervals
        return AlState(
            lmbd_eq=jnp.zeros((n, dims["ne"]), dtype),
            lmbd_state_eq=jnp.zeros((n + 1, dims["nse"]), dtype),
            lmbd_ineq=jnp.zeros((n, dims["ni"]), dtype),
            lmbd_state_ineq=jnp.zeros((n + 1, dims["nsi"]), dtype),
            lmbd_final_eq=jnp.zeros((dims["nfe"],), dtype),
            rho=jnp.asarray(rho, dtype),
        )


_EQ_PEN = pen.al_quadratic_equality()
_INEQ_PEN = pen.al_hinge_inequality()


def augment_problem(
    problem: OptimalControlProblem, project_equalities: bool = False
) -> OptimalControlProblem:
    """Return an unconstrained problem whose cost includes the AL terms.

    The augmented terms read AlState from params["al"] and the node index from
    params["node"].  If ``project_equalities`` the state-input equalities are
    left out (they are handled exactly by null-space projection instead,
    reference Transcription.h:87 / GaussNewtonDDP projection).
    """
    from ..oc.problem import GaussNewtonCost

    extra_cost = []
    extra_state_cost = []
    extra_final = []

    def pen_fn(apen, lmbd_of):
        def penalty_fn(h, p):
            al: AlState = p["al"]
            return apen.derivatives(lmbd_of(al, p), al.rho, h)

        return penalty_fn

    # Each AL term is a structured Gauss-Newton cost: the LQ approximator
    # consumes psi', psi'' and the constraint Jacobian directly (reference:
    # augmented-Lagrangian quadratic approximation in LinearQuadraticApproximator
    # uses the constraint linearization, not constraint Hessians).
    if problem.equality_terms and not project_equalities:
        extra_cost.append(GaussNewtonCost(
            problem.equality,
            pen_fn(_EQ_PEN, lambda al, p: al.lmbd_eq[p["node"]]),
        ))

    if problem.inequality_terms:
        extra_cost.append(GaussNewtonCost(
            problem.inequality,
            pen_fn(_INEQ_PEN, lambda al, p: al.lmbd_ineq[p["node"]]),
        ))

    if problem.state_equality_terms:
        extra_state_cost.append(GaussNewtonCost(
            problem.state_equality,
            pen_fn(_EQ_PEN, lambda al, p: al.lmbd_state_eq[p["node"]]),
            with_input=False,
        ))

    if problem.state_inequality_terms:
        extra_state_cost.append(GaussNewtonCost(
            problem.state_inequality,
            pen_fn(_INEQ_PEN, lambda al, p: al.lmbd_state_ineq[p["node"]]),
            with_input=False,
        ))

    if problem.final_equality_terms:
        extra_final.append(GaussNewtonCost(
            problem.final_equality,
            pen_fn(_EQ_PEN, lambda al, p: al.lmbd_final_eq),
            with_input=False,
        ))

    return dataclasses.replace(
        problem,
        cost_terms=problem.cost_terms + tuple(extra_cost),
        state_cost_terms=problem.state_cost_terms + tuple(extra_state_cost),
        final_cost_terms=problem.final_cost_terms + tuple(extra_final),
        equality_terms=() if not project_equalities else problem.equality_terms,
        state_equality_terms=(),
        inequality_terms=(),
        state_inequality_terms=(),
        final_equality_terms=(),
    )


def update_multipliers(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    xs: Array,
    us: Array,
    params: Any,
    al: AlState,
    rho_growth: float = 1.0,
    rho_max: float = 1e6,
) -> AlState:
    """Dual ascent on all multipliers at the accepted trajectory."""
    grid = grid.device()
    n = grid.num_intervals

    def with_node(k):
        return node_params(params, grid, k)

    lmbd_eq = al.lmbd_eq
    if problem.equality_terms:

        def g_eq(k):
            return problem.equality(grid.times[k], xs[k], us[k], with_node(k))

        g = jax.vmap(g_eq)(jnp.arange(n))
        lmbd_eq = _EQ_PEN.multiplier_update(al.lmbd_eq, al.rho, g)

    lmbd_seq = al.lmbd_state_eq
    if problem.state_equality_terms:

        def g_seq(k):
            return problem.state_equality(grid.times[k], xs[k], with_node(k))

        g = jax.vmap(g_seq)(jnp.arange(n + 1))
        lmbd_seq = _EQ_PEN.multiplier_update(al.lmbd_state_eq, al.rho, g)

    lmbd_ineq = al.lmbd_ineq
    if problem.inequality_terms:

        def h_ineq(k):
            return problem.inequality(grid.times[k], xs[k], us[k], with_node(k))

        h = jax.vmap(h_ineq)(jnp.arange(n))
        lmbd_ineq = _INEQ_PEN.multiplier_update(al.lmbd_ineq, al.rho, h)

    lmbd_sineq = al.lmbd_state_ineq
    if problem.state_inequality_terms:

        def h_sineq(k):
            return problem.state_inequality(grid.times[k], xs[k], with_node(k))

        h = jax.vmap(h_sineq)(jnp.arange(n + 1))
        lmbd_sineq = _INEQ_PEN.multiplier_update(al.lmbd_state_ineq, al.rho, h)

    lmbd_feq = al.lmbd_final_eq
    if problem.final_equality_terms:
        g = problem.final_equality(grid.times[n], xs[n], with_node(n))
        lmbd_feq = _EQ_PEN.multiplier_update(al.lmbd_final_eq, al.rho, g)

    rho = jnp.minimum(al.rho * rho_growth, rho_max)
    return AlState(
        lmbd_eq=lmbd_eq,
        lmbd_state_eq=lmbd_seq,
        lmbd_ineq=lmbd_ineq,
        lmbd_state_ineq=lmbd_sineq,
        lmbd_final_eq=lmbd_feq,
        rho=rho,
    )
