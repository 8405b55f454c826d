"""Switch-time optimization: gradients of the optimal cost w.r.t. event times.

JAX-native re-design of the reference's upper-level switching-time
optimization (ocs2_ocs2: GDDP computes d(cost)/d(event times) via LQ-based
sensitivity propagation, GDDP.h:68,167-195 and sensitivity_equations/*.h;
ocs2_frank_wolfe/OCS2.h:30-60 runs Frank-Wolfe over the event times with
GLPK LP subproblems).

The sensitivity does not need a sweeping BVP here: by the classical
switching-time optimality condition, at a converged solution

    dJ / d t_event = H^-(t_e) - H^+(t_e)

— the jump in the control Hamiltonian H = l(t,x,u) + lambda' f(t,x,u)
across the switch, with the costate lambda = V_x taken from the solver's
value-function byproduct (the same quantity GDDP propagates).  One batched
evaluation per event replaces the reference's per-event sensitivity LQ
solves.  The upper-level loop is projected gradient descent on the event
times with an isotonic (ordering) projection replacing the Frank-Wolfe LP
(whose feasible set is exactly these ordering constraints).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..oc.approx import node_params
from ..oc.problem import OptimalControlProblem
from ..oc.time_discretization import TimeGrid, make_time_grid

Array = jax.Array


def switch_time_gradients(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    xs: Array,
    us: Array,
    value_s: Array,
    params,
) -> Array:
    """Per-jump-node Hamiltonian jumps dJ/dt_e, shape [N] (zero at non-jump
    transitions).  ``value_s`` is the solver's cost-to-go gradient [N+1, nx]
    (SqpSolution.value_s / DdpSolution.value_s)."""
    grid = grid.device()
    n = grid.num_intervals

    def node_h(k, x, u):
        t = grid.times[k]
        p = node_params(params, grid, k)
        lam = value_s[k]
        return problem.cost(t, x, u, p) + lam @ problem.dynamics(t, x, u, p)

    def per_interval(k):
        # Jump transition k: pre state xs[k] (mode before), post state xs[k+1]
        # (mode after).  The input just before/after the event approximates
        # u^-/u^+ with the neighbouring interval inputs.
        u_pre = us[jnp.maximum(k - 1, 0)]
        u_post = us[jnp.minimum(k + 1, n - 1)]
        h_pre = node_h(k, xs[k], u_pre)
        h_post = node_h(jnp.minimum(k + 1, n), xs[k + 1], u_post)
        return grid.is_jump[k] * (h_pre - h_post)

    return jax.vmap(per_interval)(jnp.arange(n))


def _isotonic_project(theta: np.ndarray, lo: float, hi: float, min_gap: float):
    """Order-preserving projection onto {lo < t_1 <= ... <= t_K < hi}."""
    theta = np.sort(theta)
    theta = np.clip(theta, lo + min_gap, hi - min_gap)
    for i in range(1, len(theta)):
        theta[i] = max(theta[i], theta[i - 1] + min_gap)
    theta = np.clip(theta, lo + min_gap, hi - min_gap)
    for i in range(len(theta) - 2, -1, -1):
        theta[i] = min(theta[i], theta[i + 1])
    return theta


class SwitchTimeResult(NamedTuple):
    event_times: np.ndarray
    cost: float
    history: list


def optimize_switch_times(
    problem: OptimalControlProblem,
    solve_fn: Callable,  # (grid, x0, params) -> solution w/ .performance.cost,
    #                       .xs, .us, .value_s
    x0: Array,
    params,
    t0: float,
    tf: float,
    num_intervals: int,
    event_times0,
    mode_sequence,
    iterations: int = 20,
    step_size: float = 0.1,
    min_gap: float = 1e-2,
) -> SwitchTimeResult:
    """Upper-level loop (reference OCS2::run, ocs2_frank_wolfe/OCS2.h:30-60):
    alternate full lower-level solves with projected-gradient steps on the
    event times.  The lower-level solve is jitted once — every iteration has
    the same node count, so changing event times never retraces."""
    theta = np.asarray(event_times0, np.float64).copy()
    history = []
    best = (None, np.inf)
    for _ in range(iterations):
        grid = make_time_grid(
            t0, tf, num_intervals, event_times=theta, mode_sequence=mode_sequence
        )
        sol = solve_fn(grid, x0, params)
        cost = float(sol.performance.cost)
        grads_nodes = switch_time_gradients(
            problem, grid, sol.xs, sol.us, sol.value_s, params
        )
        # Gather per-event gradients in event order from the jump nodes.
        is_jump = np.asarray(grid.is_jump) > 0.5
        g = np.asarray(grads_nodes)[is_jump]
        history.append((theta.copy(), cost))
        if cost < best[1]:
            best = (theta.copy(), cost)
        theta = _isotonic_project(
            theta - step_size * g[: len(theta)], t0, tf, min_gap
        )
    return SwitchTimeResult(
        event_times=best[0], cost=best[1], history=history
    )
