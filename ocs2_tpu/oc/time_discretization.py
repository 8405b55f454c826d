"""Horizon time grid with event alignment — static node count.

JAX-native analogue of the reference's TimeDiscretization
(ocs2_oc/include/ocs2_oc/oc_data/TimeDiscretization.h:40-104,
``timeDiscretizationWithEvents`` :75, ``AnnotatedTime{None,PreEvent,PostEvent}``).

The reference builds a variable-length grid inserting pre/post event node
pairs.  XLA needs static shapes, so we fix the node count N at compile time
and build the grid *data* on the host per solve (cheap: O(N) numpy on ~100
floats).  Event times inside the horizon appear as duplicated grid times;
the transition out of a pre-event node is the jump map (dt = 0) instead of
integration.  The jitted solve consumes only fixed-shape arrays, so grids
with different event placements never retrace.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp

Array = jax.Array


class TimeGrid(NamedTuple):
    """Fixed-size discretization of [t0, tf].

    times: [N+1] node times, non-decreasing; event nodes are duplicated times.
    is_jump: [N] float mask — 1.0 where transition k -> k+1 is a state jump.
    modes: [N+1] int32 active mode per node (post-jump mode at event nodes).
    """

    times: Array
    is_jump: Array
    modes: Array

    @property
    def num_intervals(self) -> int:
        return self.is_jump.shape[0]

    @property
    def dts(self) -> Array:
        return self.times[1:] - self.times[:-1]

    def device(self) -> "TimeGrid":
        """jnp view of the grid for traced indexing inside jit.  Host grids
        carry NUMPY leaves (so closures capturing them stay free of committed
        device arrays — see make_time_grid); solver entry points call this
        once, turning the leaves into baked constants (captured) or no-ops
        (when the grid is a jit argument)."""
        return TimeGrid(
            times=jnp.asarray(self.times),
            is_jump=jnp.asarray(self.is_jump),
            modes=jnp.asarray(self.modes),
        )


def make_time_grid(
    t0: float,
    tf: float,
    num_intervals: int,
    event_times=(),
    mode_sequence=None,
) -> TimeGrid:
    """Host-side grid construction (analogue of timeDiscretizationWithEvents).

    Events strictly inside (t0, tf) are snapped onto the grid as duplicated
    node pairs; remaining nodes are spread uniformly across the sub-intervals
    proportionally to their length (the reference instead adapts dt per
    segment — same effect).
    """
    t0 = float(t0)
    tf = float(tf)
    events = [float(e) for e in event_times if t0 < float(e) < tf and np.isfinite(e)]
    events = sorted(events)
    n_jump = len(events)
    n_integrate = num_intervals - n_jump
    if n_integrate < len(events) + 1:
        raise ValueError(
            f"num_intervals={num_intervals} too small for {n_jump} events"
        )

    # Segment boundaries between consecutive events.
    bounds = [t0] + events + [tf]
    seg_lens = np.diff(bounds)
    # Allocate integration intervals proportionally (>= 1 per segment).
    alloc = np.maximum(1, np.floor(n_integrate * seg_lens / seg_lens.sum()).astype(int))
    while alloc.sum() > n_integrate:
        alloc[np.argmax(alloc)] -= 1
    while alloc.sum() < n_integrate:
        alloc[np.argmax(seg_lens / alloc)] += 1

    times = [t0]
    is_jump = []
    for seg, n_seg in enumerate(alloc):
        seg_grid = np.linspace(bounds[seg], bounds[seg + 1], n_seg + 1)[1:]
        times.extend(seg_grid.tolist())
        is_jump.extend([0.0] * n_seg)
        if seg < len(events):  # duplicate the event node: jump transition
            times.append(bounds[seg + 1])
            is_jump.append(1.0)

    times = np.asarray(times, np.float32)
    is_jump = np.asarray(is_jump, np.float32)
    assert times.shape[0] == num_intervals + 1, (times.shape, num_intervals)

    # Mode per node: mode_sequence[i] is active between events i-1 and i.
    modes = np.zeros((num_intervals + 1,), np.int32)
    if mode_sequence is not None:
        mode_sequence = np.asarray(mode_sequence, np.int32)
        # Count events at-or-before each node; duplicated pre-event node keeps
        # the previous mode, the post-event node takes the next.
        jump_count = np.concatenate([[0], np.cumsum(is_jump.astype(int))])
        modes = mode_sequence[np.minimum(jump_count, len(mode_sequence) - 1)]

    # NUMPY leaves: a TimeGrid is host-built per solve and routinely captured
    # by user jit closures; numpy bakes into the compiled program as
    # literals (and works identically as a jit argument).
    return TimeGrid(
        times=times,
        is_jump=is_jump,
        modes=np.asarray(modes, np.int32),
    )


def uniform_grid(t0: float, tf: float, num_intervals: int) -> TimeGrid:
    return make_time_grid(t0, tf, num_intervals)


def make_event_grid_traced(
    t0,
    tf,
    num_base_intervals: int,
    event_times: Array,  # [E] detected event times; inactive slots >= tf (or inf)
    mode_sequence: Array,  # [E+1] int32 mode between consecutive events
    dtype=jnp.float32,
) -> TimeGrid:
    """TRACED grid construction: event *values* are data, shapes are static.

    The jit-compatible counterpart of make_time_grid for STATE-TRIGGERED
    solving (reference StateTriggeredRollout feeding SLQ,
    ocs2_ddp/test/HybridSlqTest.cpp): detected crossing times land in the
    grid as duplicated node pairs without leaving the compiled program.

    Fixed budget of E = event_times.shape[0] event slots; inactive slots
    (>= tf) park their node pair at tf as zero-length NON-jump intervals (a
    no-op for integration, cost and Riccati).  Total intervals
    N = num_base_intervals + 2 E regardless of how many events fired.
    """
    e = event_times.shape[0]
    t0 = jnp.asarray(t0, dtype)
    tf = jnp.asarray(tf, dtype)
    base = jnp.linspace(0.0, 1.0, num_base_intervals + 1).astype(dtype)
    base = t0 + (tf - t0) * base
    eps = 1e-6 * (tf - t0)
    active = jnp.logical_and(event_times > t0 + eps, event_times < tf - eps)
    ev = jnp.where(active, jnp.asarray(event_times, dtype), tf)
    # Nudge events off base nodes so duplicated times identify event pairs
    # uniquely (a triplicate would mark two jump intervals for one event).
    snap = jnp.round((ev - t0) / jnp.maximum((tf - t0) / num_base_intervals, 1e-12))
    on_node = jnp.abs(ev - (t0 + snap * (tf - t0) / num_base_intervals)) < eps
    ev = jnp.where(jnp.logical_and(active, on_node), ev + 2 * eps, ev)

    times = jnp.sort(jnp.concatenate([base, ev, ev]))
    dts = times[1:] - times[:-1]
    dup = dts <= 0.0
    interior = times[:-1] < tf - eps
    first_of_run = jnp.concatenate(
        [dup[:1], jnp.logical_and(dup[1:], ~dup[:-1])]
    )
    is_jump = jnp.logical_and(jnp.logical_and(dup, interior), first_of_run)
    is_jump = is_jump.astype(dtype)

    jump_count = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(is_jump.astype(jnp.int32))]
    )
    mode_sequence = jnp.asarray(mode_sequence, jnp.int32)
    modes = mode_sequence[jnp.minimum(jump_count, e)]
    return TimeGrid(times=times, is_jump=is_jump, modes=modes)
