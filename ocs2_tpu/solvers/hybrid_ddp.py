"""State-triggered hybrid DDP: optimize through guard-surface mode changes.

JAX-native analogue of the reference's hybrid SLQ pipeline — SLQ consuming a
StateTriggeredRollout so the mode schedule is DETECTED from the trajectory
rather than prescribed (ocs2_ddp/test/HybridSlqTest.cpp,
test/bouncingmass/BouncingMassTest.cpp; machinery:
ocs2_oc/rollout/StateTriggeredRollout.h:46 + SLQ.h:43).

The reference re-detects switching times inside every SLQ iteration by
integrating with an event-handling ODE solver.  The XLA re-design keeps the
whole solve ONE compiled program by splitting it into a small fixed number of
outer rounds; each round

  1. rolls the current policy through the guarded hybrid system
     (oc/hybrid_rollout.py — fixed-step scan + bisection root refinement),
  2. extracts up to ``max_events`` crossing times / post-modes,
  3. builds a TRACED TimeGrid with duplicated nodes at the detected times
     (oc/time_discretization.make_event_grid_traced — event times are data,
     shapes static, so moving events never retrace),
  4. runs the standard DDP/SLQ solve on that grid (time-triggered inner
     iterations at the detected times, exactly the reference's treatment).

Detected event times converge with the policy across rounds; the final
rollout is returned so tests can assert self-consistency (grid events ==
events the optimized policy actually triggers).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.controllers import LinearController
from ..core.interpolation import interpolate
from ..oc.hybrid_rollout import HybridSystem, HybridTrajectory, rollout_state_triggered
from ..oc.problem import OptimalControlProblem
from ..oc.time_discretization import TimeGrid, make_event_grid_traced
from . import ddp

Array = jax.Array


class HybridDdpSolution(NamedTuple):
    ddp: ddp.DdpSolution
    grid: TimeGrid
    event_times: Array  # [E] detected crossing times (inf where unused)
    mode_sequence: Array  # [E+1]
    rollout: HybridTrajectory  # final-policy state-triggered rollout
    # Per-outer-round max |event_time - previous round's event_time| over
    # active events (NaN for rounds not executed; drift[0] is vs the initial
    # open-loop detection).  The convergence measure of the outer loop — the
    # analogue of the reference's switching-time stationarity check in
    # HybridSlqTest.cpp (events must stop moving as the policy converges).
    event_drift: Array  # [outer_rounds]
    rounds_run: Array  # [] int32


def _detect_events(traj: HybridTrajectory, max_events: int, mode0):
    """First ``max_events`` guard crossings (sorted by time; inactive slots
    +inf) and the post-jump mode sequence."""
    masked = jnp.where(traj.event_mask > 0.0, traj.event_times, jnp.inf)
    order = jnp.argsort(masked)[:max_events]
    ev = masked[order]
    post_modes = traj.modes[1:][order]
    mode_seq = jnp.concatenate(
        [jnp.asarray(mode0, jnp.int32)[None], post_modes.astype(jnp.int32)]
    )
    return ev, mode_seq


def solve_state_triggered(
    system: HybridSystem,
    problem: OptimalControlProblem,
    t0,
    tf,
    x0: Array,
    params: dict,
    num_base_intervals: int = 60,
    max_events: int = 4,
    outer_rounds: int = 3,
    rollout_steps: Optional[int] = None,
    mode0: int = 0,
    settings: ddp.DdpSettings = ddp.DdpSettings(),
    event_tol: float = 0.0,
) -> HybridDdpSolution:
    """Jittable end-to-end state-triggered solve.

    ``problem`` must express the same dynamics/jump as ``system`` with the
    active mode read from ``params["mode"]`` (the per-node mode injected by
    the grid) — ``system`` drives detection, ``problem`` drives optimization.

    ``event_tol`` > 0 enables early termination of the outer loop once the
    detected event times move less than the tolerance between rounds (only
    effective when called OUTSIDE jit, where the drift is concrete; under
    jit all ``outer_rounds`` are traced and ``event_drift``/``rounds_run``
    report the convergence instead).
    """
    steps = rollout_steps or 2 * num_base_intervals
    dt_roll = (float(tf) - float(t0)) / steps
    n = num_base_intervals + 2 * max_events
    nu = problem.nu
    mode0_arr = jnp.asarray(mode0, jnp.int32)

    us = jnp.zeros((steps, nu), jnp.asarray(x0).dtype)

    def open_loop(t, x, k):
        del x
        return us[jnp.minimum(k, steps - 1)]

    policy = open_loop
    sol = None
    grid = None
    ev = None
    mode_seq = None
    drift = jnp.full((outer_rounds,), jnp.nan, jnp.asarray(x0).dtype)
    rounds_run = 0

    for round_i in range(outer_rounds):
        traj = rollout_state_triggered(
            system, t0, x0, policy, dt_roll, steps, params, mode0=mode0_arr
        )
        ev_prev = ev
        ev, mode_seq = _detect_events(traj, max_events, mode0_arr)
        rounds_run = round_i + 1
        if ev_prev is not None:
            # Drift over events active in BOTH rounds (inf slots excluded);
            # an event count change registers as +inf drift.
            both = jnp.logical_and(jnp.isfinite(ev), jnp.isfinite(ev_prev))
            moved = jnp.where(both, jnp.abs(ev - ev_prev), 0.0)
            count_changed = jnp.any(jnp.isfinite(ev) != jnp.isfinite(ev_prev))
            d = jnp.where(count_changed, jnp.inf, jnp.max(moved))
            drift = drift.at[round_i].set(d)
            if event_tol > 0.0:
                try:
                    if bool(d < event_tol):
                        # Events stationary: the previous round's solve is
                        # already consistent with these events.
                        ev, mode_seq = ev_prev, prev_mode_seq
                        grid = prev_grid
                        break
                except jax.errors.TracerBoolConversionError:
                    pass  # under jit: run all rounds, report drift instead
        prev_mode_seq = mode_seq
        grid = make_event_grid_traced(
            t0, tf, num_base_intervals, ev, mode_seq, dtype=jnp.asarray(x0).dtype
        )
        # Warm start: current policy evaluated along the detected trajectory
        # at the new grid nodes (trajectory-spreading-lite).
        if sol is None:
            us_init = jnp.zeros((n, nu), jnp.asarray(x0).dtype)
        else:
            ctrl = LinearController(
                times=prev_grid.times[:-1], uff=sol.us, gains=sol.gains,
                x_nom=sol.xs[:-1],
            )
            xs_at = jax.vmap(
                lambda t: interpolate(traj.times, traj.xs, t)
            )(grid.times[:-1])
            us_init = jax.vmap(ctrl)(grid.times[:-1], xs_at)
        sol = ddp.solve(
            problem, grid, x0, params, us_init=us_init, settings=settings
        )
        prev_grid = grid

        ctrl = LinearController(
            times=grid.times[:-1], uff=sol.us, gains=sol.gains, x_nom=sol.xs[:-1]
        )
        policy = lambda t, x, k, _c=ctrl: _c(t, x)  # noqa: E731

    final_traj = rollout_state_triggered(
        system, t0, x0, policy, dt_roll, steps, params, mode0=mode0_arr
    )
    return HybridDdpSolution(
        ddp=sol, grid=grid, event_times=ev, mode_sequence=mode_seq,
        rollout=final_traj,
        event_drift=drift,
        rounds_run=jnp.asarray(rounds_run, jnp.int32),
    )
