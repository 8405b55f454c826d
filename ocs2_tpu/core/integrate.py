"""Fixed-step ODE integration and sensitivity discretization.

JAX-native analogue of the reference's integrator family
(ocs2_core/include/ocs2_core/integration/Integrator.h:43-52) and its
SensitivityIntegrator (integration/SensitivityIntegrator.h:64-88).

Design deltas vs the reference, on purpose:
* Adaptive-step ODE45 is replaced by fixed-step RK4 with substeps — adaptive
  step control is data-dependent control flow that XLA cannot tile; fixed-step
  with enough substeps reproduces the reference fixtures to tolerance (see
  tests/test_integrate.py).
* The "sensitivity discretizer" (discrete A = dx_{k+1}/dx_k, B = dx_{k+1}/du_k
  for Euler/RK2/RK4) is simply ``jax.jacfwd`` of the discrete step — JAX's AD
  replaces the hand-rolled chained Jacobians of SensitivityIntegrator.h.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array
# Continuous dynamics signature: f(t, x, u) -> dx/dt.
ContinuousDynamics = Callable[[Array, Array, Array], Array]
# Discrete step signature: step(t, x, u, dt) -> x_next.
DiscreteStep = Callable[[Array, Array, Array, Array], Array]


def euler_step(f: ContinuousDynamics, t, x, u, dt):
    return x + dt * f(t, x, u)


def rk2_step(f: ContinuousDynamics, t, x, u, dt):
    """Explicit midpoint rule — the reference SQP default (SqpSettings.h)."""
    k1 = f(t, x, u)
    k2 = f(t + 0.5 * dt, x + 0.5 * dt * k1, u)
    return x + dt * k2


def rk4_step(f: ContinuousDynamics, t, x, u, dt):
    k1 = f(t, x, u)
    k2 = f(t + 0.5 * dt, x + 0.5 * dt * k1, u)
    k3 = f(t + 0.5 * dt, x + 0.5 * dt * k2, u)
    k4 = f(t + dt, x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


_STEPPERS = {"euler": euler_step, "rk2": rk2_step, "rk4": rk4_step}


# Dormand-Prince 5(4) tableau (the reference's ODE45 / RungeKuttaDormandPrince5,
# ocs2_core/integration/RungeKuttaDormandPrince5.h).
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (
    5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100,
    1 / 40,
)


def _dp_stages(f, t, x, u, h):
    ks = []
    for i in range(7):
        xi = x
        for j, a in enumerate(_DP_A[i]):
            xi = xi + h * a * ks[j]
        ks.append(f(t + _DP_C[i] * h, xi, u))
    x5 = x
    x4 = x
    for i in range(7):
        x5 = x5 + h * _DP_B5[i] * ks[i]
        x4 = x4 + h * _DP_B4[i] * ks[i]
    return x5, x5 - x4  # 5th-order solution, embedded error estimate


def integrate_adaptive(
    f: ContinuousDynamics,
    t0,
    x0: Array,
    u: Array,
    dt,
    rtol: float = 1e-6,
    atol: float = 1e-8,
    max_steps: int = 64,
):
    """Adaptive Dormand-Prince 5(4) over one interval [t0, t0 + dt] with
    zero-order-hold input — the reference's ODE45 default integrator
    (Integrator.h:43 IntegratorType::ODE45, RungeKuttaDormandPrince5.h).

    jit-compatible: a bounded ``lax.while_loop`` advances an adaptive step
    with the standard PI-free step controller h <- h * clip(0.9 e^(-1/5)).
    Rejected steps shrink h and retry; the loop ends when the interval is
    covered or ``max_steps`` attempts are exhausted (the tail is then
    finished with the last h, conservative).  Returns x(t0 + dt).
    """
    dt = jnp.asarray(dt, x0.dtype)
    t_end = jnp.asarray(t0, x0.dtype) + dt

    def cond(carry):
        t, x, h, steps = carry
        return jnp.logical_and(t < t_end - 1e-12, steps < max_steps)

    def body(carry):
        t, x, h, steps = carry
        h_try = jnp.minimum(h, t_end - t)
        x_new, err = _dp_stages(f, t, x, u, h_try)
        tol = atol + rtol * jnp.maximum(
            jnp.max(jnp.abs(x)), jnp.max(jnp.abs(x_new))
        )
        e = jnp.max(jnp.abs(err)) / tol
        accept = e <= 1.0
        factor = jnp.clip(0.9 * (jnp.maximum(e, 1e-10) ** -0.2), 0.2, 5.0)
        h_next = jnp.clip(h_try * factor, dt / (8.0 * max_steps), dt)
        t_n = jnp.where(accept, t + h_try, t)
        x_n = jnp.where(accept, x_new, x)
        return (t_n, x_n, h_next, steps + 1)

    t_fin, x_fin, h_fin, _ = jax.lax.while_loop(
        cond, body, (jnp.asarray(t0, x0.dtype), x0, dt, 0)
    )
    # Conservative tail if max_steps exhausted before reaching t_end.
    x_tail, _ = _dp_stages(f, t_fin, x_fin, u, jnp.maximum(t_end - t_fin, 0.0))
    return jnp.where(t_fin < t_end - 1e-12, x_tail, x_fin)


def ode45_step(f: ContinuousDynamics, rtol=1e-6, atol=1e-8, max_steps=64):
    """DiscreteStep adapter: step(t, x, u, dt) via adaptive DP5(4)."""

    def step(t, x, u, dt):
        return integrate_adaptive(f, t, x, u, dt, rtol, atol, max_steps)

    return step


def discretize(
    f: ContinuousDynamics, method: str = "rk4", substeps: int = 1
) -> DiscreteStep:
    """Build a discrete step x_{k+1} = F(t_k, x_k, u_k, dt) from continuous f.

    ``substeps`` subdivides dt (zero-order-hold input).  method="ode45"
    selects the adaptive Dormand-Prince 5(4) stepper (Integrator.h:43
    IntegratorType::ODE45); the fixed-step methods remain the default for
    transcription where the sensitivity pass needs a cheap exact Jacobian.
    """
    if method.lower() == "ode45":
        return ode45_step(f)
    stepper = _STEPPERS[method.lower()]

    def step(t, x, u, dt):
        h = dt / substeps
        if substeps == 1:
            return stepper(f, t, x, u, h)

        def body(i, xc):
            return stepper(f, t + i * h, xc, u, h)

        return jax.lax.fori_loop(0, substeps, body, x)

    return step


class DiscreteTransition(NamedTuple):
    """One discretized transition with sensitivities:
    x_next ~= f + dfdx @ dx + dfdu @ du
    (analogue of VectorFunctionLinearApproximation produced by
    SensitivityIntegrator.h:82's DynamicsSensitivityDiscretizer).
    """

    f: Array  # x_{k+1}            [nx]
    dfdx: Array  # d x_{k+1} / d x_k  [nx, nx]
    dfdu: Array  # d x_{k+1} / d u_k  [nx, nu]


def sensitivity_step(step: DiscreteStep) -> Callable[..., DiscreteTransition]:
    """Discrete dynamics + exact Jacobians in one fused evaluation."""

    def run(t, x, u, dt):
        f = step(t, x, u, dt)
        dfdx = jax.jacfwd(lambda xx: step(t, xx, u, dt))(x)
        dfdu = jax.jacfwd(lambda uu: step(t, x, uu, dt))(u)
        return DiscreteTransition(f=f, dfdx=dfdx, dfdu=dfdu)

    return run


def integrate_trajectory(
    f: ContinuousDynamics,
    x0: Array,
    ts: Array,
    us: Array,
    method: str = "rk4",
    substeps: int = 1,
) -> Array:
    """Integrate x' = f(t,x,u) over grid ts [N+1] with ZOH inputs us [N, nu].

    Returns states [N+1, nx].  lax.scan replaces the reference's
    ODE_Base::integrateTimes loop (ocs2_core/integration).
    """
    step = discretize(f, method, substeps)

    def body(x, inp):
        t, u, dt = inp
        xn = step(t, x, u, dt)
        return xn, xn

    dts = ts[1:] - ts[:-1]
    _, xs = jax.lax.scan(body, x0, (ts[:-1], us, dts))
    return jnp.concatenate([x0[None], xs], axis=0)


def trapezoidal(values: Array, ts: Array) -> Array:
    """Trapezoidal quadrature of samples over grid ts
    (reference integration/TrapezoidalIntegration.h)."""
    dts = ts[1:] - ts[:-1]
    return jnp.sum(0.5 * dts * (values[1:] + values[:-1]), axis=0)
