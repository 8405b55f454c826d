"""Gauss-Newton DDP (SLQ / iLQR) — single-shooting trajectory optimization.

JAX-native re-design of the reference DDP engine
(ocs2_ddp/include/ocs2_ddp/GaussNewtonDDP.h:60-403, main loop
src/GaussNewtonDDP.cpp:980-1086; SLQ.h:43; ILQR.h:43).  The mapping:

* per-node LQ approximation over ThreadPool workers (GaussNewtonDDP.cpp:647-724)
  -> one vmapped fused linearization (ocs2_tpu.oc.approx.approximate_lq);
* partitioned parallel Riccati with stale partition boundaries
  (GaussNewtonDDP.cpp:516-552) -> exact associative-scan Riccati
  (ocs2_tpu.ops.riccati.lqr_backward_parallel) or sequential lax.scan;
* line search racing step sizes across threads
  (LineSearchStrategy.cpp:167-243) -> one vmapped rollout over the whole
  alpha grid, winner by merit (every candidate evaluated, none wasted);
* Levenberg-Marquardt strategy (LevenbergMarquardtStrategy.cpp) -> adaptive
  Riccati regularization in the iteration carry;
* constraint handling: augmented Lagrangian with per-node multipliers
  (solvers/al.py), penalties folded exactly into the LQ approximation.

"SLQ" integrates the CONTINUOUS-TIME Riccati ODE over the nominal grid
(ContinuousTimeRiccatiEquations.h:106) — fixed RK4 substeps of the matrix ODE
with linearly interpolated model data inside one reverse scan (ops/
riccati_ct.py), versus the reference's ODE45 over the same interpolated data;
"ilqr" uses the discrete recursion on the discretized transitions.  Parity
with the reference fixtures is established in tests (EXP0/EXP1 analogues).

The whole solve is a single jittable, vmappable function: batching thousands
of scenario solves per device is `jax.vmap(solve)` (which the reference
lacks).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.types import PerformanceIndex
from ..oc.approx import approximate_lq, approximate_lq_ct
from ..oc.problem import OptimalControlProblem
from ..oc.metrics import TrajectoryMetrics, al_dual_ascent, al_merit, evaluate_trajectory
from ..oc.rollout import ddp_search_policy, open_loop_policy, rollout
from ..oc.time_discretization import TimeGrid
from ..ops.riccati import (
    LqrCoeffs,
    LqrSolution,
    convexify,
    convexify_stage_hessians,
    lqr_backward,
    lqr_backward_parallel,
)
from ..ops.riccati_ct import slq_backward
from .al import AlState, augment_problem

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class DdpSettings:
    """Analogue of reference DDP_Settings.h:63-113."""

    algorithm: str = "ilqr"  # "ilqr" (discrete Riccati) | "slq" (continuous)
    max_iterations: int = 15
    min_rel_cost: float = 1e-3  # relative merit decrease convergence
    constraint_tolerance: float = 1e-3
    num_alphas: int = 8
    alpha_decay: float = 0.5
    armijo_coefficient: float = 1e-4
    integrator: str = "rk4"
    substeps: int = 1
    reg_init: float = 1e-6
    reg_increase: float = 10.0
    reg_decrease: float = 0.5
    reg_max: float = 1e8
    reg_min: float = 1e-9
    al_rho_init: float = 10.0
    al_rho_growth: float = 10.0
    al_rho_max: float = 1e6
    # AL outer-loop schedule: dual ascent / penalty growth fires when the
    # inner merit descent slows below inner_tol (a LOOSER threshold than the
    # min_rel_cost convergence test), and is forced every outer_update_every
    # inner iterations so a slowly-descending inner problem cannot starve the
    # multiplier updates (reference: penalty update between DDP iterations,
    # GaussNewtonDDP constraint penalty growth).
    inner_tol: float = 1e-3
    outer_update_every: int = 10
    parallel_riccati: bool = False
    use_feedback_policy: bool = True
    # PSD-project stage Hessians (HessianCorrection.h analogue).  "auto"
    # (default): skip when every cost term is PSD-by-construction
    # (problem.cost_structure_psd), else correct.
    convexify: Any = "auto"
    # Hessian correction strategy for convexify: "eigh" (exact eigenvalue
    # clamping, default) or "gershgorin" (cheap scalar diagonal shift; its
    # loose bound over-damps coupled Hessians — see solvers/sqp.py)
    # (reference HessianCorrection.h:44 strategies).
    hessian_correction: str = "eigh"
    # SLQ: RK4 substeps per interval for the continuous-time Riccati ODE
    # (the reference integrates it with ODE45; fixed substeps keep the
    # backward sweep one fused scan — ContinuousTimeRiccatiEquations.h:106).
    riccati_substeps: int = 4

    @property
    def _substeps(self) -> int:
        return max(self.substeps, 2) if self.algorithm == "slq" else self.substeps


class DdpIterationLog(NamedTuple):
    """Per-iteration record, [max_iterations] arrays NaN-padded beyond the
    executed iterations (reference per-iteration PerformanceIndex history,
    SolverBase.h:154-168)."""

    merit: Array
    cost: Array
    constraint_viol: Array
    step_accepted: Array  # 1.0 when the line search accepted a candidate
    reg: Array


class DdpSolution(NamedTuple):
    """Primal solution + value function (the reference's PrimalSolution +
    getValueFunction, SolverBase.h:54-273)."""

    xs: Array  # [N+1, nx]
    us: Array  # [N, nu]
    gains: Array  # [N, nu, nx]
    value_S: Array  # [N+1, nx, nx]
    value_s: Array  # [N+1, nx]
    performance: PerformanceIndex
    iterations: Array
    converged: Array
    al: AlState
    history: DdpIterationLog


class _Carry(NamedTuple):
    xs: Array
    us: Array
    al: AlState
    reg: Array
    merit: Array
    viol: Array
    best_viol: Array
    rel_decrease: Array
    since_outer: Array
    it: Array
    done: Array
    gains: Array
    value_S: Array
    value_s: Array
    history: DdpIterationLog


def _lq_to_coeffs(lq) -> LqrCoeffs:
    c = lq.cost
    return LqrCoeffs(
        A=lq.dynamics.dfdx,
        B=lq.dynamics.dfdu,
        b=jnp.zeros_like(lq.dynamics.f),  # single shooting: zero defects
        Qxx=c.dfdxx[:-1],
        qx=c.dfdx[:-1],
        Quu=c.dfduu[:-1],
        qu=c.dfdu[:-1],
        Qux=c.dfdux[:-1],
        Qf=c.dfdxx[-1],
        qf=c.dfdx[-1],
    )


def solve(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    x0: Array,
    params: Any,
    us_init: Optional[Array] = None,
    al_init: Optional[AlState] = None,
    settings: DdpSettings = DdpSettings(),
) -> DdpSolution:
    """Run DDP to convergence (jit/vmap-friendly: lax.while_loop over
    iterations, fixed shapes throughout)."""
    n = grid.num_intervals
    nx, nu = problem.nx, problem.nu
    aug = augment_problem(problem)
    do_convexify = (
        not aug.cost_structure_psd
        if settings.convexify == "auto"
        else bool(settings.convexify)
    )
    dims = problem.constraint_dims(_example_params(params))
    if al_init is None:
        al_init = AlState.init(dims, n, settings.al_rho_init, dtype=x0.dtype)
    if us_init is None:
        us_init = jnp.zeros((n, nu), x0.dtype)

    ro = partial(rollout, method=settings.integrator, substeps=settings._substeps)
    assert isinstance(params, dict), "params must be a dict pytree"

    def eval_traj(xs, us) -> TrajectoryMetrics:
        return evaluate_trajectory(problem, grid, xs, us, params)

    # Initial rollout (reference initializePrimalSolution / rolloutInitial...).
    xs0, us0 = ro(problem, grid, x0, open_loop_policy(us_init), params)
    metrics0 = eval_traj(xs0, us0)
    merit0 = al_merit(metrics0, al_init)
    viol0 = jnp.sqrt(metrics0.eq_sse + metrics0.ineq_sse)

    alphas = settings.alpha_decay ** jnp.arange(settings.num_alphas, dtype=x0.dtype)

    def backward_pass(xs, us, p_al, reg) -> LqrSolution:
        if settings.algorithm == "slq":
            # Continuous-time SLQ: Riccati ODE over the nominal grid
            # (ContinuousTimeRiccatiEquations.h:106; see ops/riccati_ct.py).
            ct = approximate_lq_ct(aug, grid, xs, us, p_al)
            if do_convexify:
                q_m, p_m, r_m, qf = convexify_stage_hessians(
                    ct.Q, ct.P, ct.R, ct.Qf, method=settings.hessian_correction
                )
                ct = ct._replace(Q=q_m, P=p_m, R=r_m, Qf=qf)
            return slq_backward(ct, reg=reg, substeps=settings.riccati_substeps)
        lq = approximate_lq(
            aug, grid, xs, us, p_al,
            method=settings.integrator, substeps=settings._substeps,
        )
        coeffs = _lq_to_coeffs(lq)
        if do_convexify:
            coeffs = convexify(coeffs, method=settings.hessian_correction)
        backward = lqr_backward_parallel if settings.parallel_riccati else lqr_backward
        return backward(coeffs, reg=reg)

    def iteration(c: _Carry) -> _Carry:
        p_al = dict(params, al=c.al)
        sol: LqrSolution = backward_pass(c.xs, c.us, p_al, c.reg)

        # Batched line search over the alpha grid (replaces the reference's
        # thread racing, LineSearchStrategy.cpp:167).  Each candidate rollout
        # also records its raw constraint values so merit under any
        # multipliers is an elementwise reduction afterwards.
        def try_alpha(alpha):
            policy = ddp_search_policy(c.us, sol.kff, sol.gains, c.xs, alpha)
            xs_a, us_a = ro(problem, grid, x0, policy, params)
            return xs_a, us_a, eval_traj(xs_a, us_a)

        xs_cand, us_cand, metrics_cand = jax.vmap(try_alpha)(alphas)
        merits = jax.vmap(lambda m: al_merit(m, c.al))(metrics_cand)
        # Armijo on the Riccati expected decrease (SearchStrategy accept rule).
        expected = alphas * sol.dv1 + alphas**2 * sol.dv2
        accept = merits <= c.merit + settings.armijo_coefficient * expected
        merits_ok = jnp.where(accept, merits, jnp.inf)
        best = jnp.argmin(merits_ok)
        any_ok = jnp.any(accept)

        xs_n = jnp.where(any_ok, xs_cand[best], c.xs)
        us_n = jnp.where(any_ok, us_cand[best], c.us)
        metrics_n = jax.tree.map(
            lambda a: None if a is None else a[best],
            metrics_cand,
            is_leaf=lambda v: v is None,
        )
        merit_n = jnp.where(any_ok, merits[best], c.merit)
        reg_n = jnp.where(
            any_ok,
            jnp.maximum(c.reg * settings.reg_decrease, settings.reg_min),
            jnp.minimum(c.reg * settings.reg_increase, settings.reg_max),
        )

        # LANCELOT-style AL outer loop: dual ascent / penalty growth when the
        # inner problem (AL merit at fixed multipliers) is near-stationary —
        # growing rho per DDP step explodes the merit before the inner solve
        # converges and stalls the line search (see solvers/sqp.py).  A
        # slowly-descending inner problem must not starve the outer loop, so
        # the update is also forced every outer_update_every iterations.
        rel = jnp.abs(c.merit - merit_n) / jnp.maximum(jnp.abs(c.merit), 1e-12)
        inner_stat = jnp.logical_or(
            jnp.logical_and(any_ok, rel < settings.inner_tol), ~any_ok
        )
        outer_due = jnp.logical_or(
            inner_stat, c.since_outer >= settings.outer_update_every
        )
        viol = jnp.sqrt(metrics_n.eq_sse + metrics_n.ineq_sse)
        feasible = viol < settings.constraint_tolerance
        improved = jnp.logical_or(viol <= 0.5 * c.best_viol, feasible)
        take_dual = jnp.logical_and(outer_due, improved)
        take_rho = jnp.logical_and(outer_due, ~improved)
        dual = al_dual_ascent(metrics_n, c.al)
        al_n = jax.tree.map(
            lambda new, old: jnp.where(take_dual, new, old), dual, c.al
        )
        al_n = al_n._replace(
            rho=jnp.where(
                take_rho,
                jnp.minimum(c.al.rho * settings.al_rho_growth, settings.al_rho_max),
                al_n.rho,
            )
        )
        best_viol = jnp.where(
            outer_due, jnp.minimum(c.best_viol, viol), c.best_viol
        )
        # Merit must be measured under the multipliers the next iteration
        # will use, else the line search chases a stale objective.  With the
        # constraint values stored this is an elementwise reduction.
        merit_carry = jnp.where(any_ok, al_merit(metrics_n, al_n), c.merit)

        stalled = jnp.logical_and(~any_ok, c.reg >= settings.reg_max * 0.99)
        # Converged = an ACCEPTED inner-stationary step AND constraints
        # satisfied (reference minRelCost + constraintTolerance).  A failed
        # line search alone is NOT convergence — the Levenberg regularization
        # just grew; keep iterating with the damped direction until it is
        # saturated (`stalled`), matching solvers/sqp.py's semantics (a
        # first-iteration full-Newton overshoot otherwise terminates the
        # solve at the initial point).
        inner_conv = jnp.logical_and(any_ok, rel < settings.min_rel_cost)
        done = jnp.logical_or(jnp.logical_and(inner_conv, feasible), stalled)
        hist = DdpIterationLog(
            merit=c.history.merit.at[c.it].set(merit_n),
            cost=c.history.cost.at[c.it].set(metrics_n.cost),
            constraint_viol=c.history.constraint_viol.at[c.it].set(viol),
            step_accepted=c.history.step_accepted.at[c.it].set(
                any_ok.astype(c.history.step_accepted.dtype)
            ),
            reg=c.history.reg.at[c.it].set(c.reg),
        )
        return _Carry(
            xs=xs_n, us=us_n, al=al_n, reg=reg_n, merit=merit_carry,
            viol=jnp.where(any_ok, viol, c.viol), best_viol=best_viol,
            rel_decrease=rel,
            since_outer=jnp.where(outer_due, 0, c.since_outer + 1),
            it=c.it + 1, done=done,
            gains=sol.gains, value_S=sol.value_S, value_s=sol.value_s,
            history=hist,
        )

    init = _Carry(
        xs=xs0, us=us0, al=al_init,
        reg=jnp.asarray(settings.reg_init, x0.dtype),
        merit=merit0,
        viol=viol0.astype(x0.dtype),
        best_viol=viol0.astype(x0.dtype),
        rel_decrease=jnp.asarray(jnp.inf, x0.dtype),
        since_outer=jnp.zeros((), jnp.int32),
        it=jnp.zeros((), jnp.int32),
        done=jnp.zeros((), bool),
        gains=jnp.zeros((n, nu, nx), x0.dtype),
        value_S=jnp.zeros((n + 1, nx, nx), x0.dtype),
        value_s=jnp.zeros((n + 1, nx), x0.dtype),
        history=DdpIterationLog(
            *([jnp.full((settings.max_iterations,), jnp.nan, x0.dtype)] * 5)
        ),
    )

    def cond(c: _Carry):
        return jnp.logical_and(c.it < settings.max_iterations, ~c.done)

    final = jax.lax.while_loop(cond, iteration, init)

    metrics_f = eval_traj(final.xs, final.us)
    merit_f = al_merit(metrics_f, final.al)
    performance = PerformanceIndex(
        merit=merit_f,
        cost=metrics_f.cost,
        dynamics_violation_sse=jnp.zeros(()),
        equality_constraints_sse=metrics_f.eq_sse,
        inequality_constraints_sse=metrics_f.ineq_sse,
        equality_lagrangian=merit_f - metrics_f.cost,
        inequality_lagrangian=jnp.zeros(()),
    )
    return DdpSolution(
        xs=final.xs,
        us=final.us,
        gains=final.gains if settings.use_feedback_policy else jnp.zeros_like(final.gains),
        value_S=final.value_S,
        value_s=final.value_s,
        performance=performance,
        iterations=final.it,
        converged=final.done,
        al=final.al,
        history=final.history,
    )


def _example_params(params):
    """Params example for constraint-dim probing (host-side, shapes only)."""
    if isinstance(params, dict):
        p = dict(params)
        p["mode"] = jnp.zeros((), jnp.int32)
        p["node"] = jnp.zeros((), jnp.int32)
        return p
    return params
