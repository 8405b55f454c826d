"""State-triggered rollout: guard-surface event detection during simulation.

JAX-native re-design of the reference's StateTriggeredRollout
(ocs2_oc/include/ocs2_oc/rollout/StateTriggeredRollout.h:46-78) and its
RootFinder (rollout/RootFinder.h), plus the hybrid-system hooks of
SystemDynamicsBase (guard surfaces, jump maps;
ocs2_core/dynamics/SystemDynamicsBase.h:44 and
integration/StateTriggeredEventHandler.h).

The reference integrates with an adaptive ODE solver, watches the guard
sign, and refines the crossing time with anderson/bisection root-finding,
restarting integration after applying the jump map.  Inside jit we keep
static shapes: a ``lax.scan`` over fixed control steps where each step

  1. integrates dt with RK4,
  2. detects a guard sign change (guard > 0 inside a mode, crossing at 0),
  3. refines the crossing time with FIXED-iteration bisection
     (lax.fori_loop — the reference's RootFinder with a static budget),
  4. applies the jump map at the refined state and integrates the step
     remainder in the new mode.

At most one event per step is resolved (the reference's minEventTimeDifference
plays the same role); choose dt below the minimum inter-event spacing.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..core.integrate import discretize

Array = jax.Array


class HybridSystem(NamedTuple):
    """Mode-indexed hybrid system.

    dynamics(t, x, u, p, mode) -> dx/dt
    guard(t, x, p, mode) -> scalar, positive inside the mode, crossing at 0
    jump(t, x, p, mode) -> (x_post, next_mode)
    """

    dynamics: Callable
    guard: Callable
    jump: Callable


class HybridTrajectory(NamedTuple):
    times: Array  # [N+1]
    xs: Array  # [N+1, nx]
    modes: Array  # [N+1] int32
    event_mask: Array  # [N] 1.0 where an event fired inside the step
    event_times: Array  # [N] refined crossing times (t+dt where no event)


def rollout_state_triggered(
    system: HybridSystem,
    t0: Array,
    x0: Array,
    policy: Callable[[Array, Array, Array], Array],  # (t, x, k) -> u
    dt: float,
    num_steps: int,
    params,
    mode0: Array = 0,
    substeps: int = 4,
    bisection_iters: int = 24,
) -> HybridTrajectory:
    mode0 = jnp.asarray(mode0, jnp.int32)

    def flow(t, x, u, mode, h):
        f = discretize(
            lambda tt, xx, uu: system.dynamics(tt, xx, uu, params, mode),
            "rk4", substeps,
        )
        return f(t, x, u, h)

    def step(carry, k):
        t, x, mode = carry
        u = policy(t, x, k)
        x_end = flow(t, x, u, mode, dt)
        g0 = system.guard(t, x, params, mode)
        g1 = system.guard(t + dt, x_end, params, mode)
        crossed = jnp.logical_and(g0 > 0.0, g1 <= 0.0)

        def with_event(_):
            # Bisection on tau in [0, dt] for guard(flow(tau)) = 0
            # (RootFinder.h with a fixed budget).
            def bisect(_, ab):
                lo, hi = ab
                mid = 0.5 * (lo + hi)
                xm = flow(t, x, u, mode, mid)
                gm = system.guard(t + mid, xm, params, mode)
                return jnp.where(gm > 0.0, mid, lo), jnp.where(gm > 0.0, hi, mid)

            lo, hi = jax.lax.fori_loop(
                0, bisection_iters, bisect, (jnp.zeros_like(t) , jnp.full_like(t, dt))
            )
            tau = 0.5 * (lo + hi)
            x_event = flow(t, x, u, mode, tau)
            x_post, mode_next = system.jump(t + tau, x_event, params, mode)
            # Integrate the remainder of the step in the new mode.
            x_next = flow(t + tau, x_post, u, mode_next, dt - tau)
            return x_next, jnp.asarray(mode_next, jnp.int32), t + tau

        def without_event(_):
            return x_end, mode, t + dt

        x_next, mode_next, t_event = jax.lax.cond(
            crossed, with_event, without_event, None
        )
        out = (
            t + dt,
            x_next,
            mode_next,
            crossed.astype(x.dtype),
            t_event,
        )
        return (t + dt, x_next, mode_next), out

    (tf, xf, modef), (ts, xs, modes, mask, etimes) = jax.lax.scan(
        step, (jnp.asarray(t0, x0.dtype), x0, mode0), jnp.arange(num_steps)
    )
    return HybridTrajectory(
        times=jnp.concatenate([jnp.asarray(t0, x0.dtype)[None], ts]),
        xs=jnp.concatenate([x0[None], xs], axis=0),
        modes=jnp.concatenate([mode0[None], modes]),
        event_mask=mask,
        event_times=etimes,
    )
