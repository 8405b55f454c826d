"""Trajectory spreading: mode-consistent warm-start remapping.

JAX-native analogue of the reference's TrajectorySpreading
(ocs2_oc/include/ocs2_oc/trajectory_adjustment/TrajectorySpreading.h:37-90:
``set`` matches the old and new mode schedules, ``adjustTrajectory`` warps
the stored trajectories onto the new event times; helpers
TrajectorySpreadingHelperFunctions.h).

When the reference manager shifts the mode schedule between MPC iterations
(e.g. the gait phase advanced), naively interpolating the previous solution
onto the new grid smears pre- and post-event samples across the *new* event
times — stance feet get swing inputs and vice versa.  Spreading instead
builds a **piecewise-linear time warp** anchored at matched event-time pairs
(old schedule <-> new schedule) and samples the old solution *through the
warp*, so every new node reads the old solution from the same gait phase.

Matching (host-side numpy — this runs between solves on the host, exactly
where the reference runs it in MRT_BASE::modifyActiveSolution): align the
two mode sequences by the shift with the longest common window, then pair
events index-wise under that shift.  Sampling is jittable (jnp.interp on
fixed-size anchor arrays).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.interpolation import interpolate_batch
from ..core.reference import ModeSchedule

Array = jax.Array


def match_event_times(
    old_ms: ModeSchedule,
    new_ms: ModeSchedule,
    t_lo: float,
    t_hi: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Matched (new_event_time, old_event_time) anchor pairs inside the window.

    Mirrors TrajectorySpreading::set's mode-sequence matching: find the shift
    of the old mode sequence that maximizes the leading common run with the
    new sequence, then pair event j of the new schedule with event (shift+j)
    of the old one.  Returns two equal-length ascending arrays (possibly
    empty when the schedules share no modes in the window).
    """
    old_e = np.asarray(old_ms.event_times, np.float64)
    new_e = np.asarray(new_ms.event_times, np.float64)
    old_m = np.asarray(old_ms.mode_sequence, np.int64)
    new_m = np.asarray(new_ms.mode_sequence, np.int64)
    old_k = int(old_ms.num_events)
    new_k = int(new_ms.num_events)
    old_m = old_m[: old_k + 1]
    new_m = new_m[: new_k + 1]

    best_shift, best_len = 0, 0
    for s in range(len(old_m)):
        run = 0
        while (
            run < len(new_m)
            and s + run < len(old_m)
            and old_m[s + run] == new_m[run]
        ):
            run += 1
        if run > best_len:
            best_shift, best_len = s, run
    if best_len == 0:
        return np.zeros((0,)), np.zeros((0,))

    anchors_new, anchors_old = [], []
    # Event j sits between modes j and j+1 of the new sequence; under the
    # shift it corresponds to old event best_shift + j.
    for j in range(min(best_len - 1, new_k)):
        oi = best_shift + j
        if oi >= old_k:
            break
        tn, to = new_e[j], old_e[oi]
        if t_lo < tn < t_hi and np.isfinite(to):
            anchors_new.append(tn)
            anchors_old.append(to)
    return np.asarray(anchors_new), np.asarray(anchors_old)


def warp_times(
    query: Array, anchors_new: Array, anchors_old: Array
) -> Array:
    """Piecewise-linear map new-timeline -> old-timeline.

    The start of the query window is "now": the present state is at the
    present time under both schedules, so the warp is pinned to identity
    there (the reference likewise only spreads *between* matched events,
    TrajectorySpreading::adjustTrajectory).  Between anchors: linear
    interpolation; beyond the last anchor: rigid shift by its offset.
    Identity when there are no anchors.
    """
    anchors_new = jnp.asarray(anchors_new)
    anchors_old = jnp.asarray(anchors_old)
    if anchors_new.shape[0] == 0:
        return query
    q0 = jnp.minimum(jnp.min(query), anchors_new[0] - 1e-6)
    xp = jnp.concatenate([q0[None], anchors_new])
    fp = jnp.concatenate([q0[None], anchors_old])
    inside = jnp.interp(query, xp, fp)
    hi_shift = anchors_old[-1] - anchors_new[-1]
    return jnp.where(query > anchors_new[-1], query + hi_shift, inside)


def spread_trajectories(
    prev_times: Array,  # [M+1] node times of the stored solution
    prev_xs: Array,  # [M+1, nx]
    prev_us: Array,  # [M, nu]
    old_ms: ModeSchedule,
    new_ms: ModeSchedule,
    new_times: Array,  # [N+1] target node times
):
    """adjustTrajectory analogue: sample (xs, us) at new_times through the
    event-anchored warp.  Returns (xs [N+1, nx], us [N, nu])."""
    t_lo = float(new_times[0])
    t_hi = float(new_times[-1])
    a_new, a_old = match_event_times(old_ms, new_ms, t_lo, t_hi)
    tq_x = warp_times(jnp.asarray(new_times), a_new, a_old)
    xs = interpolate_batch(prev_times, prev_xs, tq_x)
    us = interpolate_batch(prev_times[:-1], prev_us, tq_x[:-1])
    return xs, us


def mode_schedules_differ(old_ms: ModeSchedule, new_ms: ModeSchedule) -> bool:
    """Host-side check whether spreading is needed at all."""
    if int(old_ms.num_events) != int(new_ms.num_events):
        return True
    k = int(old_ms.num_events)
    return bool(
        np.any(
            np.asarray(old_ms.event_times[:k]) != np.asarray(new_ms.event_times[:k])
        )
        or np.any(
            np.asarray(old_ms.mode_sequence[: k + 1])
            != np.asarray(new_ms.mode_sequence[: k + 1])
        )
    )
