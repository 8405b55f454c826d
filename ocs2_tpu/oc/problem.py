"""Optimal-control problem definition as a pytree of pure functions.

JAX-native re-expression of the reference's OptimalControlProblem
(ocs2_oc/include/ocs2_oc/oc_problem/OptimalControlProblem.h:48-138).  The
reference holds ~20 term-collection slots of virtual-dispatch objects; here a
problem is a frozen dataclass of jittable callables over dense arrays.  The
reference's PreComputation cache (ocs2_core/PreComputation.h:48) is subsumed
by XLA common-subexpression elimination across the fused term evaluations.

Signatures (p is an arbitrary user parameter pytree — targets, gait, model
constants — traced, so updating it never recompiles):
    dynamics(t, x, u, p)            -> dx/dt               (continuous flow map)
    cost(t, x, u, p)                -> scalar cost *rate*  (integrated over dt)
    state_cost(t, x, p)             -> scalar cost rate
    final_cost(t, x, p)             -> scalar
    pre_jump_cost(t, x, p)          -> scalar              (at event nodes)
    jump_map(t, x, p)               -> x_post              (state at mode switch)
    equality(t, x, u, p)            -> [ne]   g(t,x,u) = 0 (projectable)
    state_equality(t, x, p)         -> [nse]  g(t,x)   = 0
    inequality(t, x, u, p)          -> [ni]   h(t,x,u) >= 0
    state_inequality(t, x, p)       -> [nsi]  h(t,x)   >= 0
    final_equality(t, x, p)         -> [nfe]
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import penalties as pen

Array = jax.Array
CostFn = Callable[..., Array]
ConstraintFn = Callable[..., Array]


def _sum_terms(terms: Tuple[CostFn, ...], *args) -> Array:
    if not terms:
        return jnp.zeros(())
    total = terms[0](*args)
    for t in terms[1:]:
        total = total + t(*args)
    return total


def _cat_terms(terms: Tuple[ConstraintFn, ...], *args) -> Optional[Array]:
    if not terms:
        return None
    return jnp.concatenate([jnp.atleast_1d(t(*args)) for t in terms], axis=0)


@dataclasses.dataclass(frozen=True)
class OptimalControlProblem:
    """Problem ingredients (term tuples sum / concatenate on evaluation)."""

    dynamics: Callable
    cost_terms: Tuple[CostFn, ...] = ()
    state_cost_terms: Tuple[CostFn, ...] = ()
    final_cost_terms: Tuple[CostFn, ...] = ()
    pre_jump_cost_terms: Tuple[CostFn, ...] = ()
    equality_terms: Tuple[ConstraintFn, ...] = ()
    state_equality_terms: Tuple[ConstraintFn, ...] = ()
    inequality_terms: Tuple[ConstraintFn, ...] = ()
    state_inequality_terms: Tuple[ConstraintFn, ...] = ()
    final_equality_terms: Tuple[ConstraintFn, ...] = ()
    jump_map: Optional[Callable] = None
    # Static model dimensions.
    nx: int = 0
    nu: int = 0

    # -- fused evaluators ---------------------------------------------------
    def cost(self, t, x, u, p) -> Array:
        return _sum_terms(self.cost_terms, t, x, u, p) + _sum_terms(
            self.state_cost_terms, t, x, p
        )

    def final_cost(self, t, x, p) -> Array:
        return _sum_terms(self.final_cost_terms, t, x, p)

    def pre_jump_cost(self, t, x, p) -> Array:
        return _sum_terms(self.pre_jump_cost_terms, t, x, p)

    def equality(self, t, x, u, p) -> Optional[Array]:
        return _cat_terms(self.equality_terms, t, x, u, p)

    def state_equality(self, t, x, p) -> Optional[Array]:
        return _cat_terms(self.state_equality_terms, t, x, p)

    def inequality(self, t, x, u, p) -> Optional[Array]:
        return _cat_terms(self.inequality_terms, t, x, u, p)

    def state_inequality(self, t, x, p) -> Optional[Array]:
        return _cat_terms(self.state_inequality_terms, t, x, p)

    def final_equality(self, t, x, p) -> Optional[Array]:
        return _cat_terms(self.final_equality_terms, t, x, p)

    def apply_jump(self, t, x, p) -> Array:
        if self.jump_map is None:
            return x
        return self.jump_map(t, x, p)

    # -- constraint dimensions (static, via abstract evaluation) ------------
    def constraint_dims(self, p_example: Any) -> dict:
        t = jnp.zeros(())
        x = jax.ShapeDtypeStruct((self.nx,), jnp.float32)
        u = jax.ShapeDtypeStruct((self.nu,), jnp.float32)

        def dim(fn, with_u):
            args = (t, x, u, p_example) if with_u else (t, x, p_example)
            out = jax.eval_shape(fn, *args)
            return 0 if out is None else out.shape[0]

        return {
            "ne": dim(self.equality, True),
            "nse": dim(self.state_equality, False),
            "ni": dim(self.inequality, True),
            "nsi": dim(self.state_inequality, False),
            "nfe": dim(self.final_equality, False),
        }

    # -- structure queries ----------------------------------------------------
    @property
    def cost_structure_psd(self) -> bool:
        """True when every cost term carries a PSD quadratization by
        construction (quadratic tracking terms, Gauss-Newton penalty terms
        with convex penalties) — then the LQ subproblem is convex without any
        Hessian correction and solvers can skip convexify entirely.  Plain
        callables go through exact AD and may produce indefinite Hessians,
        as may pre-jump cost terms (quadratized jointly via AD)."""
        if self.pre_jump_cost_terms:
            return False
        terms = self.cost_terms + self.state_cost_terms + self.final_cost_terms
        return all(getattr(t, "psd_quadratization", False) for t in terms)

    # -- builders -----------------------------------------------------------
    def add(self, **kwargs) -> "OptimalControlProblem":
        """Return a copy with term tuples extended.

        e.g. problem.add(cost_terms=(my_cost,), inequality_terms=(cone,)).
        """
        updates = {}
        for key, val in kwargs.items():
            cur = getattr(self, key)
            if isinstance(cur, tuple):
                updates[key] = cur + tuple(val)
            else:
                updates[key] = val
        return dataclasses.replace(self, **updates)


# --------------------------------------------------------------------------
# Structured cost terms (term-wise quadratization).
#
# A cost term may expose ``quad_approx(t, x, u, p)`` (or ``(t, x, p)`` for
# state-only terms) returning a ScalarQuadraticApproximation.  The LQ
# approximator (oc/approx.py) sums structured approximations in closed form
# and only runs generic forward-over-reverse AD on the remaining plain
# callables.  This is the reference's Gauss-Newton structure — analytic
# Hessians for quadratic costs (QuadraticStateInputCost.h) and
# penalty''·J'J for soft constraints — and it avoids full Hessians of
# kinematics-heavy terms, the most expensive AD in the approximation.
# --------------------------------------------------------------------------


class QuadraticTrackingCost:
    """Tracking cost 0.5 (x-x*)'Q(x-x*) + 0.5 (u-u*)'R(u-u*).

    The target is read from params[target_key] (a TargetTrajectories), matching
    the reference's QuadraticStateInputCost + TargetTrajectories pattern
    (ocs2_core/cost/QuadraticStateInputCost.h).  Closed-form quadratization.
    """

    psd_quadratization = True  # Q, R assumed PSD

    def __init__(self, Q, R, target_key: str = "target"):
        # Stored as NUMPY constants: they bake into the compiled program as
        # literals, and building the cost starts no device work.
        self.Q = np.asarray(Q, np.float32)
        self.R = np.asarray(R, np.float32)
        self.target_key = target_key

    def _deltas(self, t, x, u, p):
        tt = p[self.target_key]
        return x - tt.state_at(t), u - tt.input_at(t)

    def __call__(self, t, x, u, p):
        dx, du = self._deltas(t, x, u, p)
        return 0.5 * dx @ self.Q @ dx + 0.5 * du @ self.R @ du

    def quad_approx(self, t, x, u, p):
        from ..core.types import ScalarQuadraticApproximation

        dx, du = self._deltas(t, x, u, p)
        qx = self.Q @ dx
        ru = self.R @ du
        return ScalarQuadraticApproximation(
            f=0.5 * dx @ qx + 0.5 * du @ ru,
            dfdx=qx,
            dfdu=ru,
            dfdxx=self.Q,
            dfdux=jnp.zeros((u.shape[0], x.shape[0]), x.dtype),
            dfduu=self.R,
        )


def quadratic_cost(Q, R, target_key: str = "target"):
    return QuadraticTrackingCost(Q, R, target_key)


class QuadraticStateCost:
    """0.5 (x-x*)'Qf(x-x*) — state-only / final tracking, closed form."""

    psd_quadratization = True  # Qf assumed PSD

    def __init__(self, Qf, target_key: str = "target"):
        self.Qf = np.asarray(Qf, np.float32)  # numpy: see QuadraticTrackingCost
        self.target_key = target_key

    def __call__(self, t, x, p):
        dx = x - p[self.target_key].state_at(t)
        return 0.5 * dx @ self.Qf @ dx

    def quad_approx(self, t, x, p):
        from ..core.types import ScalarQuadraticApproximation

        dx = x - p[self.target_key].state_at(t)
        qx = self.Qf @ dx
        return ScalarQuadraticApproximation(
            f=0.5 * dx @ qx, dfdx=qx, dfdu=None,
            dfdxx=self.Qf, dfdux=None, dfduu=None,
        )


def quadratic_final_cost(Qf, target_key: str = "target"):
    return QuadraticStateCost(Qf, target_key)


class GaussNewtonCost:
    """Penalty-of-constraint cost  sum_i phi_i(g_i(t,x,u,p))  with
    Gauss-Newton quadratization:  grad = J'phi',  Hess = J' diag(phi'') J
    (constraint curvature dropped — exactly the reference's soft-constraint /
    penalty treatment, ocs2_core soft_constraint + Gauss-Newton DDP).

    ``penalty_fn(h, p) -> PenaltyValue`` may read parameters (e.g. AL
    multipliers) from p.  The constraint Jacobian is computed with jacrev —
    one reverse pass per constraint row, which for the typical few-row
    constraint beats differentiating a full Hessian by an order of magnitude.
    """

    # J' diag(phi'') J with phi'' >= 0 (all shipped penalties are convex).
    psd_quadratization = True

    def __init__(self, g_fn, penalty_fn, with_input: bool = True):
        self.g_fn = g_fn
        self.penalty_fn = penalty_fn
        self.with_input = with_input

    def __call__(self, *args):
        p = args[-1]
        h = jnp.atleast_1d(self.g_fn(*args))
        return jnp.sum(self.penalty_fn(h, p).value)

    def quad_approx(self, *args):
        from ..core.types import ScalarQuadraticApproximation

        p = args[-1]
        if self.with_input:
            t, x, u, _ = args
            nx = x.shape[0]
            z = jnp.concatenate([x, u])
            gz = lambda zz: jnp.atleast_1d(  # noqa: E731
                self.g_fn(t, zz[:nx], zz[nx:], p)
            )
        else:
            t, x, _ = args
            z = x
            gz = lambda zz: jnp.atleast_1d(self.g_fn(t, zz, p))  # noqa: E731
        g = gz(z)
        jac = jax.jacrev(gz)(z)  # [ng, nz]
        pv = self.penalty_fn(g, p)
        grad = jac.T @ pv.first
        hess = (jac * pv.second[:, None]).T @ jac
        f = jnp.sum(pv.value)
        if not self.with_input:
            return ScalarQuadraticApproximation(
                f=f, dfdx=grad, dfdu=None, dfdxx=hess, dfdux=None, dfduu=None
            )
        nx = args[1].shape[0]
        return ScalarQuadraticApproximation(
            f=f,
            dfdx=grad[:nx],
            dfdu=grad[nx:],
            dfdxx=hess[:nx, :nx],
            dfdux=hess[nx:, :nx],
            dfduu=hess[nx:, nx:],
        )


class ResidualGaussNewtonCost:
    """Weighted-residual cost  0.5 ||sqrt(w) * r(t,x,u,p)||^2  with the
    Gauss-Newton quadratization  grad = J'(w*r),  Hess = J' diag(w) J
    (residual curvature dropped) — the reference's StateInputGaussNewtonCostAd
    pattern (ocs2_core/cost/StateInputGaussNewtonCostAd.h), used by e.g.
    MotionTrackingCost (ocs2_switched_model_interface/cost/MotionTrackingCost.h:
    'cost = sum_i w_i (target_i - ref_i)^2')."""

    psd_quadratization = True  # J' diag(w) J with w >= 0

    def __init__(self, residual_fn, weights, with_input: bool = True):
        self.residual_fn = residual_fn
        self.weights = np.asarray(weights, np.float32)  # numpy: see above
        self.with_input = with_input

    def __call__(self, *args):
        r = jnp.atleast_1d(self.residual_fn(*args))
        return 0.5 * jnp.sum(self.weights * r * r)

    def quad_approx(self, *args):
        from ..core.types import ScalarQuadraticApproximation

        p = args[-1]
        if self.with_input:
            t, x, u, _ = args
            nx = x.shape[0]
            z = jnp.concatenate([x, u])
            rz = lambda zz: jnp.atleast_1d(  # noqa: E731
                self.residual_fn(t, zz[:nx], zz[nx:], p)
            )
        else:
            t, x, _ = args
            z = x
            rz = lambda zz: jnp.atleast_1d(self.residual_fn(t, zz, p))  # noqa: E731
        r = rz(z)
        jac = jax.jacrev(rz)(z)  # [nr, nz]
        grad = jac.T @ (self.weights * r)
        hess = (jac * self.weights[:, None]).T @ jac
        f = 0.5 * jnp.sum(self.weights * r * r)
        if not self.with_input:
            return ScalarQuadraticApproximation(
                f=f, dfdx=grad, dfdu=None, dfdxx=hess, dfdux=None, dfduu=None
            )
        nx = args[1].shape[0]
        return ScalarQuadraticApproximation(
            f=f,
            dfdx=grad[:nx],
            dfdu=grad[nx:],
            dfdxx=hess[:nx, :nx],
            dfdux=hess[nx:, :nx],
            dfduu=hess[nx:, nx:],
        )


# --------------------------------------------------------------------------
# Common term constructors.
# --------------------------------------------------------------------------


def soft_constraint(constraint_fn: ConstraintFn, penalty: pen.Penalty, with_input=True):
    """Fold an inequality constraint h>=0 into a cost term via a penalty —
    the reference's StateInputSoftConstraint (soft_constraint/
    StateInputSoftConstraint.h).  Returns a structured Gauss-Newton term."""
    return GaussNewtonCost(
        constraint_fn, lambda h, p: penalty(h), with_input=with_input
    )


def soft_box_input_constraint(lower, upper, penalty: pen.Penalty):
    """Soft input box bounds (reference StateInputSoftBoxConstraint.h)."""
    lower = np.asarray(lower, np.float32)  # numpy: see QuadraticTrackingCost
    upper = np.asarray(upper, np.float32)

    def cost(t, x, u, p):
        del t, x, p
        return jnp.sum(penalty(u - lower).value) + jnp.sum(penalty(upper - u).value)

    return cost
