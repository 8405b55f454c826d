"""Multiple-shooting SQP solver.

JAX-native re-design of the reference SQP solver
(ocs2_sqp/ocs2_sqp/include/ocs2_sqp/SqpSolver.h:51, main loop
src/SqpSolver.cpp:183-274).  The mapping:

* parallel transcription over ThreadPool workers (SqpSolver.cpp:336-406,
  threads claim node indices :358) -> one vmapped linearization with defects
  (multiple shooting is parallel-in-time by construction — a perfect fit for
  vmap; no sequential rollout anywhere in the iteration);
* HPIPM structured QP (hpipm_catkin/HpipmInterface.h:85) -> the scan /
  associative-scan Riccati kernel on projection-reduced coefficients
  (ops/riccati.py + ops/projection.py) — exact for the equality-constrained
  QP, which is what the reference uses HPIPM for when
  projectStateInputEqualityConstraints=true;
* QR projection of state-input equalities (Transcription.h:87) ->
  batched QR null-space reduction (ops/projection.py);
* filter line search (ocs2_oc/search_strategy/FilterLinesearch.h:44) ->
  vmapped candidate evaluation over the alpha grid with the same
  accept rules expressed as masked selects;
* inequality constraints -> augmented Lagrangian terms in the cost
  (solvers/al.py), as in this framework's DDP; the interior-point treatment
  lives in solvers/ipm.py.

Everything is one jittable function of fixed shapes: `jax.vmap(solve)`
batches thousands of SQP solves per device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.integrate import discretize
from ..core.types import PerformanceIndex
from ..oc.approx import approximate_lq, node_params
from ..oc.metrics import (
    TrajectoryMetrics,
    al_dual_ascent,
    al_merit,
    evaluate_trajectory,
)
from ..oc.problem import OptimalControlProblem
from ..oc.time_discretization import TimeGrid
from ..ops.projection import (
    project_lqr_coeffs,
    remap_projected_gain,
    remap_projected_input,
)
from ..ops.riccati import (
    LqrCoeffs,
    convexify,
    lqr_backward,
    lqr_backward_parallel,
    lqr_forward,
)
from .al import AlState, augment_problem
from .ddp import _example_params

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class SqpSettings:
    """Analogue of reference SqpSettings.h."""

    max_iterations: int = 10
    integrator: str = "rk2"  # reference SQP default integratorType RK2
    substeps: int = 1
    num_alphas: int = 8
    alpha_decay: float = 0.5
    armijo_factor: float = 1e-4
    # FilterLinesearch thresholds (FilterLinesearch.h g_max/g_min).
    g_max: float = 1e6
    g_min: float = 1e-6
    cost_tol: float = 1e-4
    dynamics_tol: float = 1e-6  # convergence on step + defect size
    # Primal termination: RMS of the accepted (dx, du) step both below this
    # (reference SqpSettings.h:43 deltaTol / Convergence::PRIMAL).
    delta_tol: float = 1e-6
    # Total-violation feasibility threshold for convergence (reference
    # constraintTolerance, DDP_Settings.h:77 uses 1e-3; tighter here).
    constraint_tol: float = 1e-4
    project_equalities: bool = True
    hessian_reg: float = 1e-6
    # Adaptive Riccati input regularization (Levenberg-Marquardt effect):
    # grown on line-search failure, shrunk on success.
    reg_init: float = 1e-6
    reg_increase: float = 10.0
    reg_decrease: float = 0.5
    reg_max: float = 1e8
    reg_min: float = 0.0
    # PSD-project stage Hessians (HessianCorrection.h analogue); required
    # whenever exact Hessians of nonconvex terms can go indefinite.
    # "auto" (default): skip when every cost term is PSD-by-construction
    # (quadratic / Gauss-Newton — problem.cost_structure_psd), else correct.
    convexify: Any = "auto"
    # Hessian correction strategy for convexify: "eigh" (exact eigenvalue
    # clamping, default) or "gershgorin" (cheap scalar diagonal shift; its
    # loose bound over-damps coupled Hessians and can redirect the whole
    # solve — use only for diagonally dominant problems)
    # (reference HessianCorrection.h:44 strategies).
    hessian_correction: str = "eigh"
    al_rho_init: float = 10.0
    al_rho_growth: float = 10.0
    al_rho_max: float = 1e6
    # Force an AL outer update every K inner iterations so a slowly
    # descending inner problem cannot starve multiplier updates (see
    # solvers/ddp.py outer_update_every).
    outer_update_every: int = 10
    parallel_riccati: bool = False
    use_feedback_policy: bool = True
    # Inner QP backend: "riccati" (exact, scan — HPIPM-class), "pipg"
    # (first-order horizon-parallel, the SLP configuration; ocs2_slp), or
    # "pipg_sharded" (PIPG with the horizon sharded over `time_mesh` —
    # parallel/horizon.py; the multi-chip expression of PipgSolver.cpp's
    # ThreadPool fan-out).
    qp_solver: str = "riccati"
    pipg_iterations: int = 2000
    ruiz_iterations: int = 5
    # Mesh with a "time" axis for qp_solver="pipg_sharded" (the horizon
    # length must be divisible by the axis size).
    time_mesh: Any = None
    time_mesh_axis: str = "time"


class IterationLog(NamedTuple):
    """Per-iteration solver record, [max_iterations] arrays padded with NaN
    beyond the executed iterations — the analogue of the reference's
    per-iteration PerformanceIndex history (SolverBase.h:154-168) and the
    SqpLogging ring log (ocs2_sqp/SqpLogging.h)."""

    merit: Array
    cost: Array
    constraint_viol: Array  # sqrt(eq_sse + ineq_sse)
    total_viol: Array  # incl. dynamics defects
    step_size: Array  # accepted alpha (0 when rejected)
    reg: Array


class SqpSolution(NamedTuple):
    xs: Array
    us: Array
    gains: Array
    value_S: Array
    value_s: Array
    performance: PerformanceIndex
    iterations: Array
    converged: Array
    al: AlState
    history: IterationLog


class _Carry(NamedTuple):
    xs: Array
    us: Array
    al: AlState
    merit: Array
    viol: Array
    best_cviol: Array  # best constraint-only violation at last outer update
    since_outer: Array
    reg: Array
    it: Array
    done: Array
    gains: Array
    value_S: Array
    value_s: Array
    history: IterationLog


def _defects(problem, grid, xs, us, params, method, substeps):
    """Multiple-shooting gap b_k = F(t_k, x_k, u_k) - x_{k+1} (vmapped)."""
    grid = grid.device()

    def node(k):
        t = grid.times[k]
        dt = grid.times[k + 1] - grid.times[k]
        p = node_params(params, grid, k)
        p_next = node_params(params, grid, k + 1)
        flow = discretize(
            lambda tt, xx, uu: problem.dynamics(tt, xx, uu, p), method, substeps
        )
        x_int = flow(t, xs[k], us[k], dt)
        x_jmp = problem.apply_jump(t, xs[k], p_next)
        m = grid.is_jump[k]
        return (1.0 - m) * x_int + m * x_jmp - xs[k + 1]

    return jax.vmap(node)(jnp.arange(grid.num_intervals))


def solve(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    x0: Array,
    params: Any,
    xs_init: Optional[Array] = None,
    us_init: Optional[Array] = None,
    al_init: Optional[AlState] = None,
    settings: SqpSettings = SqpSettings(),
) -> SqpSolution:
    n = grid.num_intervals
    nx, nu = problem.nx, problem.nu
    assert isinstance(params, dict), "params must be a dict pytree"
    project = settings.project_equalities and bool(problem.equality_terms)
    aug = augment_problem(problem, project_equalities=project)
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
    if xs_init is None:
        # Constant-state initialization (multiple_shooting/Initialization.h).
        xs_init = jnp.tile(x0[None], (n + 1, 1))
    xs_init = xs_init.at[0].set(x0)

    # The problem used for merit evaluation keeps projected equalities as
    # *metrics* (they enter the filter violation, not the AL merit).
    def eval_traj(xs, us) -> TrajectoryMetrics:
        return evaluate_trajectory(problem, grid, xs, us, params)

    def total_viol(metrics: TrajectoryMetrics, defect_sse) -> Array:
        return jnp.sqrt(metrics.eq_sse + metrics.ineq_sse + defect_sse)

    def defect_sse(xs, us):
        d = _defects(
            problem, grid, xs, us, params, settings.integrator, settings.substeps
        )
        return jnp.sum(jnp.square(d))

    metrics0 = eval_traj(xs_init, us_init)
    merit0 = al_merit(metrics0, al_init)
    # Filter baseline = the initial trajectory's actual violation (reference
    # FilterLinesearch keeps the previous iterate's baseline; seeding with inf
    # would let the first accepted step trade any merit explosion for a
    # trivial violation decrease).
    viol0 = total_viol(metrics0, defect_sse(xs_init, us_init))
    cviol0 = jnp.sqrt(metrics0.eq_sse + metrics0.ineq_sse)
    alphas = settings.alpha_decay ** jnp.arange(settings.num_alphas, dtype=x0.dtype)

    def iteration(c: _Carry) -> _Carry:
        p_al = dict(params, al=c.al)
        # Transcription: vmapped LQ approximation with defects.
        lq = approximate_lq(
            aug, grid, c.xs, c.us, p_al,
            method=settings.integrator, substeps=settings.substeps,
        )
        defect = lq.dynamics.f - c.xs[1:]
        coeffs = LqrCoeffs(
            A=lq.dynamics.dfdx,
            B=lq.dynamics.dfdu,
            b=defect,
            Qxx=lq.cost.dfdxx[:-1],
            qx=lq.cost.dfdx[:-1],
            Quu=lq.cost.dfduu[:-1]
            + settings.hessian_reg * jnp.eye(nu, dtype=x0.dtype)[None],
            qu=lq.cost.dfdu[:-1],
            Qux=lq.cost.dfdux[:-1],
            Qf=lq.cost.dfdxx[-1],
            qf=lq.cost.dfdx[-1],
        )
        if do_convexify:
            coeffs = convexify(
                coeffs, settings.hessian_reg,
                method=settings.hessian_correction,
            )

        def solve_qp(qp_coeffs):
            """Inner QP: exact Riccati scan, or first-order PIPG (the SLP
            configuration — Ruiz equilibration + extrapolated PIPG,
            solvers/slp.py; reference SlpSolver.cpp:246-283)."""
            if settings.qp_solver in ("pipg", "pipg_sharded"):
                from ..ops.pipg import PipgSettings, pipg_solve, ruiz_equilibrate

                scaled, scal = ruiz_equilibrate(
                    qp_coeffs, settings.ruiz_iterations
                )
                if settings.qp_solver == "pipg_sharded":
                    from ..parallel.horizon import pipg_solve_horizon_sharded

                    assert settings.time_mesh is not None, (
                        "qp_solver='pipg_sharded' needs SqpSettings.time_mesh"
                    )
                    psol = pipg_solve_horizon_sharded(
                        scaled,
                        settings.time_mesh,
                        PipgSettings(num_iterations=settings.pipg_iterations),
                        axis=settings.time_mesh_axis,
                    )
                else:
                    psol = pipg_solve(
                        scaled,
                        PipgSettings(num_iterations=settings.pipg_iterations),
                    )
                dxs = scal.d_x * psol.dxs
                dus_r = scal.d_u * psol.dus
                nv = qp_coeffs.B.shape[-1]
                zero_gains = jnp.zeros((n, nv, nx), x0.dtype)
                # PIPG computes no value function (reference SlpSolver has
                # none either).  NaN-fill instead of zero so downstream
                # consumers (switch_time_gradients, hamiltonian_from_lq)
                # fail visibly rather than computing garbage silently.
                value = (
                    jnp.full((n + 1, nx, nx), jnp.nan, x0.dtype),
                    jnp.full((n + 1, nx), jnp.nan, x0.dtype),
                )
                return dxs, dus_r, zero_gains, value
            backward = (
                lqr_backward_parallel if settings.parallel_riccati else lqr_backward
            )
            sol = backward(qp_coeffs, reg=c.reg)
            dxs, dus_r = lqr_forward(qp_coeffs, sol, jnp.zeros((nx,), x0.dtype))
            return dxs, dus_r, sol.gains, (sol.value_S, sol.value_s)

        if project:
            reduced, proj = project_lqr_coeffs(coeffs, lq.eq.f, lq.eq.dfdx, lq.eq.dfdu)
            dxs, dvs, gains_r, (value_S, value_s) = solve_qp(reduced)
            dus = remap_projected_input(proj, dxs[:-1], dvs)
            gains = remap_projected_gain(proj, gains_r)
        else:
            dxs, dus, gains, (value_S, value_s) = solve_qp(coeffs)

        # Non-finite directions (ill-posed QP at wildly infeasible iterates)
        # must not poison the carry: zero the step so every candidate equals
        # the baseline, the line search rejects, and the Levenberg-style
        # regularization below grows until the QP is well-posed again
        # (reference: exceptions on ill-posed LQ, GaussNewtonDDP.cpp:683-719,
        # here expressed as masked recovery since jit cannot throw).
        step_finite = jnp.logical_and(
            jnp.all(jnp.isfinite(dxs)), jnp.all(jnp.isfinite(dus))
        )
        dxs = jnp.where(step_finite, dxs, 0.0)
        dus = jnp.where(step_finite, dus, 0.0)

        # Filter line search over the alpha grid (FilterLinesearch.h:44).
        def try_alpha(alpha):
            xs_a = c.xs + alpha * dxs
            us_a = c.us + alpha * dus
            m = eval_traj(xs_a, us_a)
            d_sse = defect_sse(xs_a, us_a)
            return xs_a, us_a, m, al_merit(m, c.al), total_viol(m, d_sse)

        xs_cand, us_cand, metrics_cand, merits, viols = jax.vmap(try_alpha)(alphas)

        # Armijo slope from the QP gradient: g'd = sum qx.dx + qu.du.
        slope = jnp.sum(coeffs.qx * dxs[:-1]) + jnp.sum(coeffs.qu * dus) + jnp.sum(
            coeffs.qf * dxs[-1]
        )
        armijo = merits <= c.merit + settings.armijo_factor * alphas * slope
        # acceptStep cases (reference FilterLinesearch::acceptStep):
        hi = c.viol > settings.g_max
        lo = jnp.logical_and(c.viol < settings.g_min, viols < settings.g_min)
        accept = jnp.where(
            hi,
            viols < (1.0 - 1e-3) * c.viol,
            jnp.where(
                lo,
                armijo,
                jnp.logical_or(merits < c.merit, viols < (1.0 - 1e-3) * c.viol),
            ),
        )
        accept = jnp.logical_and(accept, step_finite)
        first_ok = jnp.argmax(accept)  # largest accepted step (alphas descend)
        any_ok = jnp.any(accept)
        # Levenberg-style trust-region effect: shrink the Riccati input
        # regularization on success, grow it when the line search rejects
        # everything (reference LevenbergMarquardtStrategy.cpp; the reference
        # SQP instead terminates on stepSize < alpha_min — adaptive reg keeps
        # making progress where termination would strand an infeasible
        # iterate).
        reg_n = jnp.where(
            any_ok,
            jnp.maximum(c.reg * settings.reg_decrease, settings.reg_min),
            jnp.minimum(
                jnp.maximum(c.reg, settings.reg_init) * settings.reg_increase,
                settings.reg_max,
            ),
        )

        xs_n = jnp.where(any_ok, xs_cand[first_ok], c.xs)
        us_n = jnp.where(any_ok, us_cand[first_ok], c.us)
        metrics_n = jax.tree.map(
            lambda a: None if a is None else a[first_ok],
            metrics_cand,
            is_leaf=lambda v: v is None,
        )
        viol_n = jnp.where(any_ok, viols[first_ok], c.viol)
        merit_n = jnp.where(any_ok, merits[first_ok], c.merit)

        # -- AL outer loop (LANCELOT schedule) --------------------------------
        # Inner problem = minimize the AL merit at FIXED (lambda, rho); outer
        # updates fire only when the inner iteration is stationary (tiny
        # relative merit decrease, or a failed line search).  Growing rho per
        # SQP step — before the inner problem converges — explodes the merit
        # and stalls the line search (the reference instead updates penalties
        # between full solver iterations, GaussNewtonDDP penalty update).
        rel_cost = jnp.abs(c.merit - merit_n) / jnp.maximum(jnp.abs(c.merit), 1e-12)
        inner_conv = jnp.logical_or(
            jnp.logical_and(any_ok, rel_cost < settings.cost_tol), ~any_ok
        )
        outer_due = jnp.logical_or(
            inner_conv, c.since_outer >= settings.outer_update_every
        )
        # Constraint-only violation drives dual-vs-penalty choice (defects are
        # the QP's job, not the AL's).
        cviol_n = jnp.sqrt(metrics_n.eq_sse + metrics_n.ineq_sse)
        c_feasible = cviol_n < settings.constraint_tol
        improved = jnp.logical_or(cviol_n <= 0.5 * c.best_cviol, c_feasible)
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
        best_cviol = jnp.where(
            outer_due, jnp.minimum(c.best_cviol, cviol_n), c.best_cviol
        )
        merit_carry = jnp.where(any_ok, al_merit(metrics_n, al_n), c.merit)

        # Converged = inner stationary AND total violation (defects +
        # constraints) within tolerance (reference SqpSolver convergence),
        # OR the accepted primal step is negligible while feasible
        # (Convergence::PRIMAL, SqpSolver.cpp:574-577 — gated on feasibility
        # here so a stalled-but-infeasible AL outer loop keeps growing rho).
        alpha_acc = alphas[first_ok]
        dx_rms = alpha_acc * jnp.sqrt(jnp.mean(jnp.square(dxs)))
        du_rms = alpha_acc * jnp.sqrt(jnp.mean(jnp.square(dus)))
        primal_conv = jnp.logical_and(
            any_ok,
            jnp.logical_and(
                dx_rms < settings.delta_tol, du_rms < settings.delta_tol
            ),
        )
        # A FAILED line search alone is not convergence: the Levenberg-style
        # regularization above just grew — keep iterating with the damped
        # direction (reference LevenbergMarquardtStrategy), and only give up
        # once the damping is saturated (reg at reg_max: no further escape).
        ls_exhausted = jnp.logical_and(~any_ok, c.reg >= settings.reg_max)
        accepted_conv = jnp.logical_and(
            jnp.logical_and(inner_conv, any_ok),
            viol_n < settings.constraint_tol,
        )
        done = jnp.logical_or(
            jnp.logical_and(primal_conv, c_feasible),
            jnp.logical_or(accepted_conv, ls_exhausted),
        )
        hist = IterationLog(
            merit=c.history.merit.at[c.it].set(merit_n),
            cost=c.history.cost.at[c.it].set(metrics_n.cost),
            constraint_viol=c.history.constraint_viol.at[c.it].set(cviol_n),
            total_viol=c.history.total_viol.at[c.it].set(viol_n),
            step_size=c.history.step_size.at[c.it].set(
                jnp.where(any_ok, alphas[first_ok], 0.0)
            ),
            reg=c.history.reg.at[c.it].set(c.reg),
        )
        return _Carry(
            xs=xs_n, us=us_n, al=al_n, merit=merit_carry, viol=viol_n,
            best_cviol=best_cviol,
            since_outer=jnp.where(outer_due, 0, c.since_outer + 1),
            reg=reg_n,
            it=c.it + 1, done=done,
            gains=gains, value_S=value_S, value_s=value_s,
            history=hist,
        )

    empty_log = jnp.full((settings.max_iterations,), jnp.nan, x0.dtype)
    init = _Carry(
        xs=xs_init, us=us_init, al=al_init, merit=merit0,
        viol=viol0.astype(x0.dtype),
        best_cviol=cviol0.astype(x0.dtype),
        since_outer=jnp.zeros((), jnp.int32),
        reg=jnp.asarray(settings.reg_init, x0.dtype),
        it=jnp.zeros((), jnp.int32),
        done=jnp.zeros((), bool),
        gains=jnp.zeros((n, nu, nx), x0.dtype),
        value_S=jnp.zeros((n + 1, nx, nx), x0.dtype),
        value_s=jnp.zeros((n + 1, nx), x0.dtype),
        history=IterationLog(*([empty_log] * 6)),
    )

    def cond(c: _Carry):
        return jnp.logical_and(c.it < settings.max_iterations, ~c.done)

    final = jax.lax.while_loop(cond, iteration, init)

    metrics_f = eval_traj(final.xs, final.us)
    merit_f = al_merit(metrics_f, final.al)
    performance = PerformanceIndex(
        merit=merit_f,
        cost=metrics_f.cost,
        dynamics_violation_sse=defect_sse(final.xs, final.us),
        equality_constraints_sse=metrics_f.eq_sse,
        inequality_constraints_sse=metrics_f.ineq_sse,
        equality_lagrangian=merit_f - metrics_f.cost,
        inequality_lagrangian=jnp.zeros(()),
    )
    return SqpSolution(
        xs=final.xs,
        us=final.us,
        gains=final.gains
        if settings.use_feedback_policy
        else jnp.zeros_like(final.gains),
        value_S=final.value_S,
        value_s=final.value_s,
        performance=performance,
        iterations=final.it,
        converged=final.done,
        al=final.al,
        history=final.history,
    )
