"""Multiple-shooting nonlinear interior-point solver.

JAX-native re-design of the reference IPM solver (ocs2_ipm/include/ocs2_ipm/
IpmSolver.h:51, main loop src/IpmSolver.cpp:203-256, slack/dual condensing
IpmHelpers.h, slack/dual initialization IpmInitialization.h, barrier and
fraction-to-boundary settings IpmSettings.h:42-96).

Inequality constraints h(t, x, u) >= 0 get slack s > 0 and dual v > 0
variables with a log-barrier -mu*sum(log s).  Each Newton step condenses the
slack/dual blocks into the per-node LQ stage data (the reference does this
in IpmHelpers::condenseIneqConstraints before handing HPIPM the QP):

    Sigma = v / s                               (elementwise)
    Q    += H' diag(Sigma) H
    q    -= H' (mu / s - Sigma * (h - s))

after which the equality-constrained QP is solved exactly by the Riccati
scan (ops/riccati.py), with state-input equalities removed by null-space
projection (ops/projection.py) exactly as in the SQP solver.  The slack and
dual Newton directions are recovered per node,

    ds = H dz + (h - s),      dv = mu/s - v - Sigma * ds,

and steps are clipped by the fraction-to-boundary rule (IpmSolver.cpp:
fractionToBoundaryStepSize) with separate primal/dual step sizes.  The
primal step additionally passes the same filter line search as SQP, on the
barrier merit.  All of it is one jittable fixed-shape function: vmap it to
batch thousands of IPM solves per device.

State-only equality / final equality constraints are handled by augmented
Lagrangian (as in solvers/sqp.py); state-only inequalities get their own
slack/dual pairs over the N+1 state nodes (terminal node condenses into the
terminal cost).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.types import PerformanceIndex
from ..oc.approx import approximate_lq
from ..oc.metrics import TrajectoryMetrics, al_dual_ascent, al_merit, evaluate_trajectory
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
from .sqp import _defects

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class IpmSettings:
    """Analogue of reference IpmSettings.h:42-96."""

    max_iterations: int = 15
    integrator: str = "rk2"
    substeps: int = 1
    num_alphas: int = 8
    alpha_decay: float = 0.5
    armijo_factor: float = 1e-4
    g_max: float = 1e6
    g_min: float = 1e-6
    cost_tol: float = 1e-4
    dynamics_tol: float = 1e-6
    constraint_tol: float = 1e-4
    project_equalities: bool = True
    hessian_reg: float = 1e-6
    # "auto" (default): skip when every cost term is PSD-by-construction
    # (problem.cost_structure_psd), else correct.  NOTE the IPM barrier
    # condensation adds its own PSD contribution, so "auto" stays valid.
    convexify: Any = "auto"
    # Hessian correction strategy for convexify: "eigh" (exact eigenvalue
    # clamping, default) or "gershgorin" (cheap scalar diagonal shift; its
    # loose bound over-damps coupled Hessians — see solvers/sqp.py)
    # (reference HessianCorrection.h:44 strategies).
    hessian_correction: str = "eigh"
    # Barrier schedule (IpmSettings initialBarrierParameter /
    # targetBarrierParameter / barrierLinearDecreaseFactor /
    # barrierSuperlinearDecreasePower).
    mu_init: float = 1e-2
    mu_target: float = 1e-4
    mu_linear_decrease: float = 0.5
    mu_superlinear_power: float = 1.2
    # Fraction-to-boundary margin tau (IpmSettings fractionToBoundaryMargin).
    ftb_margin: float = 0.995
    slack_init_min: float = 1e-2
    al_rho_init: float = 10.0
    al_rho_growth: float = 10.0
    al_rho_max: float = 1e6
    parallel_riccati: bool = False
    use_feedback_policy: bool = True


class IpmVars(NamedTuple):
    """Slack/dual interior-point variables (zero-width when family absent)."""

    slack_ineq: Array  # [N, ni]
    dual_ineq: Array  # [N, ni]
    slack_state_ineq: Array  # [N+1, nsi]
    dual_state_ineq: Array  # [N+1, nsi]
    mu: Array  # [] barrier parameter


class IpmSolution(NamedTuple):
    xs: Array
    us: Array
    gains: Array
    value_S: Array
    value_s: Array
    performance: PerformanceIndex
    iterations: Array
    converged: Array
    al: AlState
    ipm: IpmVars


class _Carry(NamedTuple):
    xs: Array
    us: Array
    al: AlState
    ipm: IpmVars
    merit: Array
    viol: Array
    best_cviol: Array
    it: Array
    done: Array
    gains: Array
    value_S: Array
    value_s: Array


def _init_slack_dual(h: Optional[Array], mu, s_min: float, shape, dtype):
    """IpmInitialization.h analogue: s = max(h, s_min), v = mu / s."""
    if h is None:
        s = jnp.zeros(shape, dtype)
        return s, s
    s = jnp.maximum(h, s_min)
    return s, mu / s


def _condense(lq, ipm: IpmVars):
    """Condense slack/dual blocks into the stage LQ data (IpmHelpers.h).

    Returns additive updates (dQxx, dqx, dQuu, dqu, dQux) for intermediate
    nodes [N, ...] and (dQf, dqf) for the terminal node.
    """
    cost = lq.cost
    n = lq.dynamics.f.shape[0]
    nx = cost.dfdx.shape[-1]
    nu = cost.dfdu.shape[-1]
    dt = cost.dfdx.dtype
    dQxx = jnp.zeros((n, nx, nx), dt)
    dqx = jnp.zeros((n, nx), dt)
    dQuu = jnp.zeros((n, nu, nu), dt)
    dqu = jnp.zeros((n, nu), dt)
    dQux = jnp.zeros((n, nu, nx), dt)
    dQf = jnp.zeros((nx, nx), dt)
    dqf = jnp.zeros((nx,), dt)

    if lq.ineq is not None:
        h, hx, hu = lq.ineq.f, lq.ineq.dfdx, lq.ineq.dfdu
        s, v = ipm.slack_ineq, ipm.dual_ineq
        sig = v / s  # [N, ni]
        grad = ipm.mu / s - sig * (h - s)  # [N, ni]
        dQxx = dQxx + jnp.einsum("kix,ki,kiy->kxy", hx, sig, hx)
        dQuu = dQuu + jnp.einsum("kiu,ki,kiw->kuw", hu, sig, hu)
        dQux = dQux + jnp.einsum("kiu,ki,kix->kux", hu, sig, hx)
        dqx = dqx - jnp.einsum("kix,ki->kx", hx, grad)
        dqu = dqu - jnp.einsum("kiu,ki->ku", hu, grad)

    if lq.state_ineq is not None:
        h, hx = lq.state_ineq.f, lq.state_ineq.dfdx
        s, v = ipm.slack_state_ineq, ipm.dual_state_ineq
        sig = v / s
        grad = ipm.mu / s - sig * (h - s)
        dxx = jnp.einsum("kix,ki,kiy->kxy", hx, sig, hx)
        dx = -jnp.einsum("kix,ki->kx", hx, grad)
        dQxx = dQxx + dxx[:-1]
        dqx = dqx + dx[:-1]
        dQf = dQf + dxx[-1]
        dqf = dqf + dx[-1]

    return dQxx, dqx, dQuu, dqu, dQux, dQf, dqf


def _slack_dual_steps(lq, ipm: IpmVars, dxs, dus):
    """Recover Newton directions ds, dv per inequality family."""
    ds_i = dv_i = ds_s = dv_s = None
    if lq.ineq is not None:
        h, hx, hu = lq.ineq.f, lq.ineq.dfdx, lq.ineq.dfdu
        s, v = ipm.slack_ineq, ipm.dual_ineq
        hdz = jnp.einsum("kix,kx->ki", hx, dxs[:-1]) + jnp.einsum(
            "kiu,ku->ki", hu, dus
        )
        ds_i = hdz + (h - s)
        dv_i = ipm.mu / s - v - (v / s) * ds_i
    if lq.state_ineq is not None:
        h, hx = lq.state_ineq.f, lq.state_ineq.dfdx
        s, v = ipm.slack_state_ineq, ipm.dual_state_ineq
        hdz = jnp.einsum("kix,kx->ki", hx, dxs)
        ds_s = hdz + (h - s)
        dv_s = ipm.mu / s - v - (v / s) * ds_s
    return ds_i, dv_i, ds_s, dv_s


def _ftb_alpha(s: Optional[Array], ds: Optional[Array], tau) -> Array:
    """Fraction-to-boundary: max alpha with s + alpha*ds >= (1 - tau) s."""
    if s is None or s.size == 0:
        return jnp.ones(())
    ratio = jnp.where(ds < 0.0, -tau * s / jnp.where(ds < 0.0, ds, -1.0), 1.0)
    return jnp.minimum(jnp.min(ratio), 1.0)


def _barrier_term(ipm: IpmVars) -> Array:
    t = jnp.zeros(())
    if ipm.slack_ineq.size:
        t = t - ipm.mu * jnp.sum(jnp.log(ipm.slack_ineq))
    if ipm.slack_state_ineq.size:
        t = t - ipm.mu * jnp.sum(jnp.log(ipm.slack_state_ineq))
    return t


def _slack_gap_sse(metrics: TrajectoryMetrics, ipm: IpmVars) -> Array:
    """|| h - s ||^2 over both families (the IPM primal residual)."""
    sse = jnp.zeros(())
    if metrics.h_ineq is not None:
        sse = sse + jnp.sum(jnp.square(metrics.h_ineq - ipm.slack_ineq))
    if metrics.h_state_ineq is not None:
        sse = sse + jnp.sum(
            jnp.square(metrics.h_state_ineq - ipm.slack_state_ineq)
        )
    return sse


def solve(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    x0: Array,
    params: Any,
    xs_init: Optional[Array] = None,
    us_init: Optional[Array] = None,
    al_init: Optional[AlState] = None,
    settings: IpmSettings = IpmSettings(),
) -> IpmSolution:
    n = grid.num_intervals
    nx, nu = problem.nx, problem.nu
    assert isinstance(params, dict), "params must be a dict pytree"
    project = settings.project_equalities and bool(problem.equality_terms)
    # AL handles only the equality families here; inequalities are native IPM.
    eq_only = dataclasses.replace(
        problem, inequality_terms=(), state_inequality_terms=()
    )
    aug = augment_problem(eq_only, project_equalities=project)
    # Re-attach inequality terms so approximate_lq linearizes them for the
    # condensation (the AL augmentation must not consume them).
    aug = dataclasses.replace(
        aug,
        inequality_terms=problem.inequality_terms,
        state_inequality_terms=problem.state_inequality_terms,
    )
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
        xs_init = jnp.tile(x0[None], (n + 1, 1))
    xs_init = xs_init.at[0].set(x0)

    def eval_traj(xs, us) -> TrajectoryMetrics:
        return evaluate_trajectory(problem, grid, xs, us, params)

    def defect_sse(xs, us):
        d = _defects(
            problem, grid, xs, us, params, settings.integrator, settings.substeps
        )
        return jnp.sum(jnp.square(d))

    metrics0 = eval_traj(xs_init, us_init)
    mu0 = jnp.asarray(settings.mu_init, x0.dtype)
    s_i, v_i = _init_slack_dual(
        metrics0.h_ineq, mu0, settings.slack_init_min, (n, dims["ni"]), x0.dtype
    )
    s_s, v_s = _init_slack_dual(
        metrics0.h_state_ineq, mu0, settings.slack_init_min,
        (n + 1, dims["nsi"]), x0.dtype,
    )
    ipm0 = IpmVars(
        slack_ineq=s_i, dual_ineq=v_i,
        slack_state_ineq=s_s, dual_state_ineq=v_s, mu=mu0,
    )

    def merit_fn(metrics, al, ipm):
        # AL handles ONLY the equality families in IPM — inequalities enter
        # through the barrier/slack condensation.  Hiding h_ineq from
        # al_merit keeps the line-search merit consistent with the Newton
        # direction's model (no double penalty on inequality violation).
        m_eq = metrics._replace(h_ineq=None, h_state_ineq=None)
        return al_merit(m_eq, al) + _barrier_term(ipm)

    def total_viol(metrics, ipm, d_sse):
        return jnp.sqrt(metrics.eq_sse + _slack_gap_sse(metrics, ipm) + d_sse)

    merit0 = merit_fn(metrics0, al_init, ipm0)
    alphas = settings.alpha_decay ** jnp.arange(settings.num_alphas, dtype=x0.dtype)
    tau = settings.ftb_margin

    def iteration(c: _Carry) -> _Carry:
        p_al = dict(params, al=c.al)
        lq = approximate_lq(
            aug, grid, c.xs, c.us, p_al,
            method=settings.integrator, substeps=settings.substeps,
        )
        defect = lq.dynamics.f - c.xs[1:]
        dQxx, dqx, dQuu, dqu, dQux, dQf, dqf = _condense(lq, c.ipm)
        coeffs = LqrCoeffs(
            A=lq.dynamics.dfdx,
            B=lq.dynamics.dfdu,
            b=defect,
            Qxx=lq.cost.dfdxx[:-1] + dQxx,
            qx=lq.cost.dfdx[:-1] + dqx,
            Quu=lq.cost.dfduu[:-1] + dQuu
            + settings.hessian_reg * jnp.eye(nu, dtype=x0.dtype)[None],
            qu=lq.cost.dfdu[:-1] + dqu,
            Qux=lq.cost.dfdux[:-1] + dQux,
            Qf=lq.cost.dfdxx[-1] + dQf,
            qf=lq.cost.dfdx[-1] + dqf,
        )
        if do_convexify:
            coeffs = convexify(
                coeffs, settings.hessian_reg,
                method=settings.hessian_correction,
            )

        backward = (
            lqr_backward_parallel if settings.parallel_riccati else lqr_backward
        )
        if project:
            reduced, proj = project_lqr_coeffs(coeffs, lq.eq.f, lq.eq.dfdx, lq.eq.dfdu)
            sol = backward(reduced)
            dxs, dvs = lqr_forward(reduced, sol, jnp.zeros((nx,), x0.dtype))
            dus = remap_projected_input(proj, dxs[:-1], dvs)
            gains = remap_projected_gain(proj, sol.gains)
        else:
            sol = backward(coeffs)
            dxs, dus = lqr_forward(coeffs, sol, jnp.zeros((nx,), x0.dtype))
            gains = sol.gains

        ds_i, dv_i, ds_s, dv_s = _slack_dual_steps(lq, c.ipm, dxs, dus)

        # Fraction-to-boundary step-size limits (primal on slacks, dual on v).
        a_primal = jnp.minimum(
            _ftb_alpha(c.ipm.slack_ineq if ds_i is not None else None, ds_i, tau),
            _ftb_alpha(
                c.ipm.slack_state_ineq if ds_s is not None else None, ds_s, tau
            ),
        )
        a_dual = jnp.minimum(
            _ftb_alpha(c.ipm.dual_ineq if dv_i is not None else None, dv_i, tau),
            _ftb_alpha(
                c.ipm.dual_state_ineq if dv_s is not None else None, dv_s, tau
            ),
        )

        def step_slacks(alpha):
            s_i_n = (
                c.ipm.slack_ineq + alpha * ds_i
                if ds_i is not None
                else c.ipm.slack_ineq
            )
            s_s_n = (
                c.ipm.slack_state_ineq + alpha * ds_s
                if ds_s is not None
                else c.ipm.slack_state_ineq
            )
            return c.ipm._replace(slack_ineq=s_i_n, slack_state_ineq=s_s_n)

        # Filter line search on the barrier merit over the FTB-scaled grid.
        def try_alpha(alpha):
            a = alpha * a_primal
            xs_a = c.xs + a * dxs
            us_a = c.us + a * dus
            ipm_a = step_slacks(a)
            m = eval_traj(xs_a, us_a)
            d_sse = defect_sse(xs_a, us_a)
            return (
                a, xs_a, us_a, m,
                merit_fn(m, c.al, ipm_a),
                total_viol(m, ipm_a, d_sse),
            )

        a_eff, xs_cand, us_cand, metrics_cand, merits, viols = jax.vmap(try_alpha)(
            alphas
        )

        slope = (
            jnp.sum(coeffs.qx * dxs[:-1])
            + jnp.sum(coeffs.qu * dus)
            + jnp.sum(coeffs.qf * dxs[-1])
        )
        armijo = merits <= c.merit + settings.armijo_factor * a_eff * slope
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
        first_ok = jnp.argmax(accept)
        any_ok = jnp.any(accept)
        a_star = jnp.where(any_ok, a_eff[first_ok], 0.0)

        xs_n = jnp.where(any_ok, xs_cand[first_ok], c.xs)
        us_n = jnp.where(any_ok, us_cand[first_ok], c.us)
        metrics_n = jax.tree.map(
            lambda a: None if a is None else a[first_ok],
            metrics_cand,
            is_leaf=lambda vv: vv is None,
        )
        viol_n = jnp.where(any_ok, viols[first_ok], c.viol)

        # Accepted slack step + full FTB dual step (IpmSolver: separate
        # primal/dual step sizes).
        ipm_n = step_slacks(a_star)
        if dv_i is not None:
            ipm_n = ipm_n._replace(
                dual_ineq=jnp.where(
                    any_ok, c.ipm.dual_ineq + a_dual * dv_i, c.ipm.dual_ineq
                )
            )
        if dv_s is not None:
            ipm_n = ipm_n._replace(
                dual_state_ineq=jnp.where(
                    any_ok,
                    c.ipm.dual_state_ineq + a_dual * dv_s,
                    c.ipm.dual_state_ineq,
                )
            )

        # Barrier decrease (IpmSettings barrierLinearDecreaseFactor +
        # superlinear power, clipped at the target).
        mu_n = jnp.where(
            any_ok,
            jnp.maximum(
                settings.mu_target,
                jnp.minimum(
                    settings.mu_linear_decrease * c.ipm.mu,
                    c.ipm.mu ** settings.mu_superlinear_power,
                ),
            ),
            c.ipm.mu,
        )
        ipm_n = ipm_n._replace(mu=mu_n)

        # AL outer loop on the equality families (LANCELOT schedule — dual or
        # penalty updates only when the inner iteration is stationary; see
        # solvers/sqp.py for rationale).
        merit_same_al = jnp.where(any_ok, merit_fn(metrics_n, c.al, ipm_n), c.merit)
        rel_cost = jnp.abs(c.merit - merit_same_al) / jnp.maximum(
            jnp.abs(c.merit), 1e-12
        )
        inner_conv = jnp.logical_or(
            jnp.logical_and(any_ok, rel_cost < settings.cost_tol), ~any_ok
        )
        cviol_n = jnp.sqrt(metrics_n.eq_sse)
        c_feasible = cviol_n < settings.constraint_tol
        improved = jnp.logical_or(cviol_n <= 0.5 * c.best_cviol, c_feasible)
        take_dual = jnp.logical_and(inner_conv, improved)
        take_rho = jnp.logical_and(inner_conv, ~improved)
        # Equality families only — inequality multipliers stay frozen at
        # zero (inequalities are handled natively by the barrier, not AL).
        dual = al_dual_ascent(
            metrics_n._replace(h_ineq=None, h_state_ineq=None), c.al
        )
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
            inner_conv, jnp.minimum(c.best_cviol, cviol_n), c.best_cviol
        )
        merit_n = jnp.where(any_ok, merit_fn(metrics_n, al_n, ipm_n), c.merit)

        at_target_mu = c.ipm.mu <= settings.mu_target * (1.0 + 1e-9)
        done = jnp.logical_and(
            jnp.logical_and(inner_conv, viol_n < settings.constraint_tol),
            at_target_mu,
        )
        return _Carry(
            xs=xs_n, us=us_n, al=al_n, ipm=ipm_n, merit=merit_n, viol=viol_n,
            best_cviol=best_cviol, it=c.it + 1, done=done,
            gains=gains, value_S=sol.value_S, value_s=sol.value_s,
        )

    # Filter baseline from the initial trajectory's actual violation (not inf,
    # which would let the first accepted step trade any merit explosion for a
    # trivial violation decrease) — see solvers/sqp.py.
    viol0 = total_viol(metrics0, ipm0, defect_sse(xs_init, us_init))
    init = _Carry(
        xs=xs_init, us=us_init, al=al_init, ipm=ipm0, merit=merit0,
        viol=viol0.astype(x0.dtype),
        best_cviol=jnp.sqrt(metrics0.eq_sse).astype(x0.dtype),
        it=jnp.zeros((), jnp.int32),
        done=jnp.zeros((), bool),
        gains=jnp.zeros((n, nu, nx), x0.dtype),
        value_S=jnp.zeros((n + 1, nx, nx), x0.dtype),
        value_s=jnp.zeros((n + 1, nx), x0.dtype),
    )

    def cond(c: _Carry):
        return jnp.logical_and(c.it < settings.max_iterations, ~c.done)

    final = jax.lax.while_loop(cond, iteration, init)

    metrics_f = eval_traj(final.xs, final.us)
    merit_f = merit_fn(metrics_f, final.al, final.ipm)
    performance = PerformanceIndex(
        merit=merit_f,
        cost=metrics_f.cost,
        dynamics_violation_sse=defect_sse(final.xs, final.us),
        equality_constraints_sse=metrics_f.eq_sse,
        inequality_constraints_sse=metrics_f.ineq_sse,
        equality_lagrangian=al_merit(
            metrics_f._replace(h_ineq=None, h_state_ineq=None), final.al
        )
        - metrics_f.cost,
        inequality_lagrangian=_barrier_term(final.ipm),
    )
    return IpmSolution(
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
        ipm=final.ipm,
    )
