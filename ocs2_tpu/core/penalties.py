"""Scalar penalty functions for soft constraints and augmented Lagrangians.

JAX-native re-expression of the reference's penalty family (reference:
ocs2_core/include/ocs2_core/penalties/penalties/*.h).  Each penalty is a pure
function h -> (value, dh, ddh) evaluated elementwise on constraint values; the
solver folds them into the cost quadratic via the chain rule.  All functions
are trivially vmappable and fuse into surrounding XLA computations.

Sign convention follows the reference: inequality constraints are written
``g(x, u) >= 0`` and the penalty pushes g up.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array


class PenaltyValue(NamedTuple):
    value: Array  # penalty value, same shape as h
    first: Array  # d penalty / dh
    second: Array  # d^2 penalty / dh^2


Penalty = Callable[[Array], PenaltyValue]


def _with_derivatives(fn: Callable[[Array], Array]) -> Penalty:
    """Lift a scalar penalty fn to (value, first, second) elementwise."""

    d1 = jax.grad(lambda h: fn(h))
    d2 = jax.grad(d1)

    def penalty(h: Array) -> PenaltyValue:
        flat = h.reshape(-1)
        v = jax.vmap(fn)(flat).reshape(h.shape)
        g = jax.vmap(d1)(flat).reshape(h.shape)
        gg = jax.vmap(d2)(flat).reshape(h.shape)
        return PenaltyValue(v, g, gg)

    return penalty


def relaxed_barrier(mu: float = 1.0, delta: float = 1e-3) -> Penalty:
    """Relaxed log barrier (reference penalties/RelaxedBarrierPenalty.h).

    -mu ln(h) for h > delta, quadratic extension below delta (C2 continuous).
    """

    def fn(h):
        log_branch = -mu * jnp.log(jnp.maximum(h, delta))
        quad_branch = mu * (
            0.5 * jnp.square((h - 2.0 * delta) / delta) - 0.5 - jnp.log(delta)
        )
        return jnp.where(h > delta, log_branch, quad_branch)

    return _with_derivatives(fn)


def squared_hinge(mu: float = 1.0, delta: float = 0.0) -> Penalty:
    """0.5*mu*max(0, delta - h)^2 (reference penalties/SquaredHingePenalty.h)."""

    def fn(h):
        return 0.5 * mu * jnp.square(jnp.maximum(delta - h, 0.0))

    return _with_derivatives(fn)


def quadratic(scale: float = 1.0) -> Penalty:
    """0.5*scale*h^2 — for equality-style soft constraints (QuadraticPenalty.h)."""

    def fn(h):
        return 0.5 * scale * jnp.square(h)

    return _with_derivatives(fn)


def smooth_absolute(scale: float = 1.0, relaxation: float = 1e-2) -> Penalty:
    """scale*(sqrt(h^2 + rel^2) - rel) (reference SmoothAbsolutePenalty.h)."""

    def fn(h):
        return scale * (jnp.sqrt(jnp.square(h) + relaxation**2) - relaxation)

    return _with_derivatives(fn)


def double_sided(lower: Array, upper: Array, inner: Penalty) -> Penalty:
    """Apply ``inner`` to both h-lower >= 0 and upper-h >= 0 (DoubleSidedPenalty.h)."""

    def penalty(h: Array) -> PenaltyValue:
        lo = inner(h - lower)
        hi = inner(upper - h)
        return PenaltyValue(
            lo.value + hi.value, lo.first - hi.first, lo.second + hi.second
        )

    return penalty


# --------------------------------------------------------------------------
# Augmented-Lagrangian penalties (reference penalties/augmented/*.h).
# These take (multiplier lambda, penalty scale rho, constraint value h) and
# produce the AL term; solvers also use them to update multipliers.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AugmentedPenalty:
    """Equality/inequality augmented-Lagrangian term.

    value(lmbd, rho, h): AL contribution added to the merit.
    derivatives(lmbd, rho, h): PenaltyValue (value, d/dh, d2/dh2) — consumed
      by the Gauss-Newton term quadratization (oc/problem.GaussNewtonCost).
    multiplier_update(lmbd, rho, h): next multiplier (dual ascent step).
    """

    value: Callable[[Array, Array, Array], Array]
    derivatives: Callable[[Array, Array, Array], PenaltyValue]
    multiplier_update: Callable[[Array, Array, Array], Array]


def al_quadratic_equality() -> AugmentedPenalty:
    """Standard AL for g(x,u)=0: -lmbd*h + 0.5*rho*h^2; lmbd <- lmbd - rho*h.

    Mirrors QuadraticPenalty-based augmented terms
    (reference penalties/augmented/QuadraticPenalty.h).
    """

    def value(lmbd, rho, h):
        return -lmbd * h + 0.5 * rho * jnp.square(h)

    def derivatives(lmbd, rho, h):
        return PenaltyValue(
            value(lmbd, rho, h), rho * h - lmbd, rho * jnp.ones_like(h)
        )

    return AugmentedPenalty(
        value=value,
        derivatives=derivatives,
        multiplier_update=lambda lmbd, rho, h: lmbd - rho * h,
    )


def al_hinge_inequality() -> AugmentedPenalty:
    """AL for g(x,u)>=0 via squared hinge on the shifted constraint.

    value = rho/2 * max(0, lmbd/rho - h)^2 - lmbd^2/(2 rho);
    lmbd <- max(0, lmbd - rho*h).  Mirrors SlacknessSquaredHingePenalty
    (reference penalties/augmented/SlacknessSquaredHingePenalty.h).
    """

    def value(lmbd, rho, h):
        return 0.5 * rho * jnp.square(jnp.maximum(lmbd / rho - h, 0.0)) - jnp.square(
            lmbd
        ) / (2.0 * rho)

    def derivatives(lmbd, rho, h):
        slack = jnp.maximum(lmbd / rho - h, 0.0)
        active = (slack > 0.0).astype(h.dtype)
        return PenaltyValue(
            0.5 * rho * jnp.square(slack) - jnp.square(lmbd) / (2.0 * rho),
            -rho * slack,
            rho * active,
        )

    def update(lmbd, rho, h):
        return jnp.maximum(lmbd - rho * h, 0.0)

    return AugmentedPenalty(value=value, derivatives=derivatives, multiplier_update=update)


def modified_relaxed_barrier(mu: float = 1.0, delta: float = 1e-3) -> AugmentedPenalty:
    """Relaxed-barrier AL variant (reference ModifiedRelaxedBarrierPenalty.h):

    barrier on h shifted by the multiplier estimate; multiplier follows the
    barrier gradient.
    """

    barrier = relaxed_barrier(mu, delta)

    def value(lmbd, rho, h):
        del rho
        return barrier(h).value - lmbd * h

    def derivatives(lmbd, rho, h):
        del rho
        b = barrier(h)
        return PenaltyValue(b.value - lmbd * h, b.first - lmbd, b.second)

    def update(lmbd, rho, h):
        del rho
        return jnp.maximum(lmbd - barrier(h).first, 0.0)

    return AugmentedPenalty(value=value, derivatives=derivatives, multiplier_update=update)
