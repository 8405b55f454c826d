"""Linear-quadratic approximation of the optimal-control problem.

JAX-native analogue of the reference's LinearQuadraticApproximator
(ocs2_oc/include/ocs2_oc/approximate_model/LinearQuadraticApproximator.h:51:
approximateIntermediateLQ / approximatePreJumpLQ / approximateFinalLQ) and the
multiple-shooting transcription (ocs2_oc/multiple_shooting/Transcription.h:44).

Where the reference fans per-node work out over a ThreadPool
(GaussNewtonDDP.cpp:669, SqpSolver.cpp:358), we ``vmap`` one fused node
evaluation over the whole horizon: every Jacobian/Hessian of every node is one
batched XLA computation.  CppAD code generation
(ocs2_core/automatic_differentiation/CppAdInterface.h:48) is replaced by
``jax.jacfwd``/``jax.hessian`` under jit.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.integrate import DiscreteTransition, discretize
from ..core.types import ScalarQuadraticApproximation, VectorLinearApproximation
from .problem import OptimalControlProblem
from .time_discretization import TimeGrid

Array = jax.Array


class LQData(NamedTuple):
    """Per-node LQ approximation over the horizon (the reference's ModelData
    array, ocs2_core/model_data/ModelData.h — but batched, not a vector of
    structs).

    cost:      quadratic approx, batched [N+1, ...]; at the terminal node the
               input-derivative entries are zero.
    dynamics:  discrete transitions x_{k+1} ~ f + A dx + B du, batched [N, ...]
               (jump transitions hold the jump-map linearization, B = 0).
    eq:        state-input equality g(t,x,u) = 0, batched [N, ne] (projectable).
    state_eq:  state-only equality, batched [N+1, nse].
    ineq:      state-input inequality h >= 0, batched [N, ni].
    state_ineq: state-only inequality, batched [N+1, nsi].
    final_eq:  terminal equality at node N, [nfe].
    """

    cost: ScalarQuadraticApproximation
    dynamics: DiscreteTransition
    eq: Optional[VectorLinearApproximation]
    state_eq: Optional[VectorLinearApproximation]
    ineq: Optional[VectorLinearApproximation]
    state_ineq: Optional[VectorLinearApproximation]
    final_eq: Optional[VectorLinearApproximation]


def quadratize_scalar(fn, x: Array, u: Array) -> ScalarQuadraticApproximation:
    """Exact second-order expansion of fn(x, u) in (x, u) jointly."""
    nx = x.shape[0]
    z = jnp.concatenate([x, u])

    def fz(zz):
        return fn(zz[:nx], zz[nx:])

    f = fz(z)
    g = jax.grad(fz)(z)
    h = jax.jacfwd(jax.grad(fz))(z)
    return ScalarQuadraticApproximation(
        f=f,
        dfdx=g[:nx],
        dfdu=g[nx:],
        dfdxx=h[:nx, :nx],
        dfdux=h[nx:, :nx],
        dfduu=h[nx:, nx:],
    )


def quadratize_state_scalar(fn, x: Array, nu: int) -> ScalarQuadraticApproximation:
    f = fn(x)
    g = jax.grad(fn)(x)
    h = jax.jacfwd(jax.grad(fn))(x)
    nx = x.shape[0]
    dt = x.dtype
    return ScalarQuadraticApproximation(
        f=f,
        dfdx=g,
        dfdu=jnp.zeros((nu,), dt),
        dfdxx=h,
        dfdux=jnp.zeros((nu, nx), dt),
        dfduu=jnp.zeros((nu, nu), dt),
    )


def linearize_vector(fn, x: Array, u: Optional[Array]) -> VectorLinearApproximation:
    """Constraint linearization via one joint jacrev — one reverse pass per
    constraint row (constraints have few rows, states+inputs have many)."""
    if u is None:
        return VectorLinearApproximation(
            f=fn(x), dfdx=jax.jacrev(fn)(x), dfdu=None
        )
    nx = x.shape[0]
    z = jnp.concatenate([x, u])
    fz = lambda zz: fn(zz[:nx], zz[nx:])  # noqa: E731
    jac = jax.jacrev(fz)(z)
    return VectorLinearApproximation(f=fz(z), dfdx=jac[:, :nx], dfdu=jac[:, nx:])


def _split_terms(terms):
    structured = tuple(t for t in terms if hasattr(t, "quad_approx"))
    plain = tuple(t for t in terms if not hasattr(t, "quad_approx"))
    return structured, plain


def _scale_quad(q: ScalarQuadraticApproximation, s):
    return jax.tree.map(
        lambda a: None if a is None else s * a, q, is_leaf=lambda v: v is None
    )


def _pad_state_quad(q: ScalarQuadraticApproximation, nu: int):
    """Extend a state-only approximation with zero input blocks."""
    nx = q.dfdx.shape[-1]
    dt = q.dfdx.dtype
    return ScalarQuadraticApproximation(
        f=q.f,
        dfdx=q.dfdx,
        dfdu=jnp.zeros((nu,), dt),
        dfdxx=q.dfdxx,
        dfdux=jnp.zeros((nu, nx), dt),
        dfduu=jnp.zeros((nu, nu), dt),
    )


def quadratize_running_cost(problem, t, dt, x, u, p, jump_mask):
    """Term-structured quadratization of the node's running cost.

    Structured terms (quad_approx — closed-form quadratics, Gauss-Newton
    penalty terms) are summed analytically; only the remaining plain
    callables go through generic forward-over-reverse AD.  Mirrors the
    reference's per-term LQ assembly (LinearQuadraticApproximator.h:51 sums
    term approximations), which is Gauss-Newton — and avoids paying ~nz
    HVPs through kinematics-heavy terms.
    """
    nu = u.shape[0]
    s_xu, p_xu = _split_terms(problem.cost_terms)
    s_x, p_x = _split_terms(problem.state_cost_terms)

    parts = [_scale_quad(term.quad_approx(t, x, u, p), dt) for term in s_xu]
    parts += [
        _scale_quad(_pad_state_quad(term.quad_approx(t, x, p), nu), dt)
        for term in s_x
    ]

    if p_xu or p_x or problem.pre_jump_cost_terms:

        def plain_cost(xx, uu):
            run = jnp.zeros((), x.dtype)
            for term in p_xu:
                run = run + term(t, xx, uu, p)
            for term in p_x:
                run = run + term(t, xx, p)
            run = dt * run
            if problem.pre_jump_cost_terms:
                run = run + jump_mask * problem.pre_jump_cost(t, xx, p)
            return run

        parts.append(quadratize_scalar(plain_cost, x, u))

    if not parts:
        return ScalarQuadraticApproximation.zeros(x.shape[0], nu, x.dtype)
    total = parts[0]
    for q in parts[1:]:
        total = total + q
    return total


def quadratize_final_cost(problem, t, x, p, nu: int):
    """Term-structured quadratization of the terminal cost (zero u blocks)."""
    s_f, p_f = _split_terms(problem.final_cost_terms)
    parts = [_pad_state_quad(term.quad_approx(t, x, p), nu) for term in s_f]
    if p_f:

        def plain_cost(xx):
            run = jnp.zeros((), x.dtype)
            for term in p_f:
                run = run + term(t, xx, p)
            return run

        parts.append(quadratize_state_scalar(plain_cost, x, nu))
    if not parts:
        return ScalarQuadraticApproximation.zeros(x.shape[0], nu, x.dtype)
    total = parts[0]
    for q in parts[1:]:
        total = total + q
    return total


def device_params(params: Any):
    """jnp views of every numpy array leaf in the parameter pytree.

    Host-built reference data (swing plans, targets, grids) carries numpy
    leaves to avoid committed-device-array capture in user jit closures; but
    numpy arrays cannot be indexed by tracers (``p["swing_vz"][node]`` with a
    traced node).  Solvers call this once at entry: under jit-with-arguments
    it is a no-op on tracers, under closure capture it bakes the leaves into
    the program as XLA constants (still no host sync)."""
    return jax.tree.map(
        lambda v: jnp.asarray(v) if isinstance(v, (np.ndarray, np.generic)) else v,
        params,
    )


def node_params(params: Any, grid: TimeGrid, k):
    """Inject the per-node mode and node index into the (dict) parameter
    pytree — consumed by mode-switched dynamics (lax.switch) and by
    augmented-Lagrangian terms gathering their multiplier row."""
    if isinstance(params, dict):
        p = device_params(params)
        p["mode"] = grid.modes[k]
        p["node"] = k
        return p
    return params


def approximate_lq_ct(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    xs: Array,  # [N+1, nx]
    us: Array,  # [N, nu]
    params: Any,
):
    """CONTINUOUS-TIME LQ data for the SLQ backward pass: per-node
    linearization A = df/dx, B = df/du of the flow map (not its
    discretization) and the running-cost RATE quadratization, plus per-
    interval jump-map linearizations and pre-jump cost quadratics
    (reference approximateIntermediateLQ feeding
    ContinuousTimeRiccatiEquations.h:106).  Returns ops.riccati_ct.CtLqCoeffs
    WITHOUT the terminal quadratic PSD projection — callers convexify.
    """
    from ..ops.riccati_ct import CtLqCoeffs

    grid = grid.device()
    n = grid.num_intervals
    nu = problem.nu
    us_ext = jnp.concatenate([us, us[-1:]], axis=0)  # value at node N

    def node(k):
        t = grid.times[k]
        x = xs[k]
        u = us_ext[k]
        p = node_params(params, grid, k)
        a = jax.jacfwd(lambda xx: problem.dynamics(t, xx, u, p))(x)
        b = jax.jacfwd(lambda uu: problem.dynamics(t, x, uu, p))(u)
        # Cost RATE quadratization: dt = 1, no jump contribution.
        rate = quadratize_running_cost(problem, t, 1.0, x, u, p, 0.0)
        return a, b, rate

    a_n, b_n, rate = jax.vmap(node)(jnp.arange(n + 1))

    def jump(k):
        t = grid.times[k]
        x = xs[k]
        p_next = node_params(params, grid, k + 1)
        aj = jax.jacfwd(lambda xx: problem.apply_jump(t, xx, p_next))(x)
        # Pre-jump cost quadratic (state-only; dt = 0 kills the rate terms).
        pj = quadratize_running_cost(
            problem, t, 0.0, x, us_ext[k], node_params(params, grid, k), 1.0
        )
        return aj, pj.dfdxx, pj.dfdx

    a_jump, q_jump, qv_jump = jax.vmap(jump)(jnp.arange(n))

    tN = grid.times[n]
    pN = node_params(params, grid, n)
    cost_f = quadratize_final_cost(problem, tN, xs[n], pN, nu)

    return CtLqCoeffs(
        A=a_n, B=b_n,
        Q=rate.dfdxx, q=rate.dfdx, R=rate.dfduu, r=rate.dfdu, P=rate.dfdux,
        A_jump=a_jump, Q_jump=q_jump, q_jump=qv_jump,
        Qf=cost_f.dfdxx, qf=cost_f.dfdx,
        times=grid.times, is_jump=grid.is_jump,
    )


def approximate_lq(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    xs: Array,  # [N+1, nx]
    us: Array,  # [N, nu]
    params: Any,
    method: str = "rk4",
    substeps: int = 1,
) -> LQData:
    """Full-horizon LQ approximation in one vmapped evaluation."""
    grid = grid.device()
    n = grid.num_intervals
    nu = problem.nu

    def intermediate(k):
        t = grid.times[k]
        dt = grid.times[k + 1] - grid.times[k]
        x = xs[k]
        u = us[k]
        p = node_params(params, grid, k)
        p_next = node_params(params, grid, k + 1)

        # Discrete transition: integration step or jump map, selected by mask.
        # Both branches are evaluated (vmap-friendly); the jump branch is the
        # cheap one and XLA masks the blend — no divergent control flow.
        flow = discretize(lambda tt, xx, uu: problem.dynamics(tt, xx, uu, p),
                          method, substeps)
        x_int = flow(t, x, u, dt)
        a_int = jax.jacfwd(lambda xx: flow(t, xx, u, dt))(x)
        b_int = jax.jacfwd(lambda uu: flow(t, x, uu, dt))(u)
        x_jmp = problem.apply_jump(t, x, p_next)
        a_jmp = jax.jacfwd(lambda xx: problem.apply_jump(t, xx, p_next))(x)
        m = grid.is_jump[k]
        dyn = DiscreteTransition(
            f=(1.0 - m) * x_int + m * x_jmp,
            dfdx=(1.0 - m) * a_int + m * a_jmp,
            dfdu=(1.0 - m) * b_int,
        )

        # Running cost, dt-weighted; pre-jump cost on jump transitions
        # (reference approximatePreJumpLQ).  Term-structured: closed-form /
        # Gauss-Newton where terms provide it, AD fallback otherwise.
        cost = quadratize_running_cost(problem, t, dt, x, u, p, m)

        eq = (
            linearize_vector(lambda xx, uu: problem.equality(t, xx, uu, p), x, u)
            if problem.equality_terms
            else None
        )
        ineq = (
            linearize_vector(lambda xx, uu: problem.inequality(t, xx, uu, p), x, u)
            if problem.inequality_terms
            else None
        )
        seq = (
            linearize_vector(lambda xx: problem.state_equality(t, xx, p), x, None)
            if problem.state_equality_terms
            else None
        )
        sineq = (
            linearize_vector(lambda xx: problem.state_inequality(t, xx, p), x, None)
            if problem.state_inequality_terms
            else None
        )
        return cost, dyn, eq, seq, ineq, sineq

    cost_i, dyn, eq, seq_i, ineq, sineq_i = jax.vmap(intermediate)(jnp.arange(n))

    # Terminal node.
    tN = grid.times[n]
    xN = xs[n]
    pN = node_params(params, grid, n)
    cost_f = quadratize_final_cost(problem, tN, xN, pN, nu)
    seq_f = (
        linearize_vector(lambda xx: problem.state_equality(tN, xx, pN), xN, None)
        if problem.state_equality_terms
        else None
    )
    sineq_f = (
        linearize_vector(lambda xx: problem.state_inequality(tN, xx, pN), xN, None)
        if problem.state_inequality_terms
        else None
    )
    final_eq = (
        linearize_vector(lambda xx: problem.final_equality(tN, xx, pN), xN, None)
        if problem.final_equality_terms
        else None
    )

    def append_node(batched, last):
        if batched is None:
            return None
        return jax.tree.map(
            lambda b, l: None if b is None else jnp.concatenate(
                [b, l[None]], axis=0
            ),
            batched, last,
            is_leaf=lambda v: v is None,
        )

    cost = append_node(cost_i, cost_f)
    state_eq = append_node(seq_i, seq_f)
    state_ineq = append_node(sineq_i, sineq_f)

    return LQData(
        cost=cost,
        dynamics=dyn,
        eq=eq,
        state_eq=state_eq,
        ineq=ineq,
        state_ineq=state_ineq,
        final_eq=final_eq,
    )
