"""Reference containers: mode schedules and target trajectories.

JAX-native re-expression of the reference's reference containers
(ocs2_core/include/ocs2_core/reference/ModeSchedule.h:42-80 and
TargetTrajectories.h:41-96).  Both are fixed-size padded pytrees so a solve
never re-traces when the gait or the target changes — only when the *padding
capacity* changes.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .interpolation import interpolate

Array = jax.Array

# Padding sentinel for unused event slots: +inf keeps searchsorted semantics
# correct (an unused event never triggers).
_INF = np.inf


class ModeSchedule(NamedTuple):
    """Padded mode schedule.

    event_times: [K] ascending, padded with +inf.
    mode_sequence: [K+1] int32 modes, entry i active on
        (event_times[i-1], event_times[i]).  Padded tail repeats the last mode.
    num_events: [] int32 — number of valid entries in event_times.

    Mirrors reference ModeSchedule (ModeSchedule.h:42; modeAtTime :67).

    HOST DATA (numpy leaves): the MPC host loop consumes mode schedules every
    tick to build time grids; device-array leaves would force a device->host
    readback per tick, which blocks the host loop until the queued device
    work has finished.  Passed into jit, numpy leaves convert at the
    boundary exactly like device arrays.
    """

    event_times: np.ndarray
    mode_sequence: np.ndarray
    num_events: np.ndarray

    @staticmethod
    def create(event_times, mode_sequence, capacity: int | None = None):
        event_times = np.asarray(event_times, np.float32).reshape(-1)
        mode_sequence = np.asarray(mode_sequence, np.int32).reshape(-1)
        k = event_times.shape[0]
        if capacity is None:
            capacity = k
        assert mode_sequence.shape[0] == k + 1, "need one more mode than events"
        pad_t = np.full((capacity - k,), _INF, event_times.dtype)
        pad_m = np.full((capacity - k,), mode_sequence[-1], np.int32)
        return ModeSchedule(
            event_times=np.concatenate([event_times, pad_t]),
            mode_sequence=np.concatenate([mode_sequence, pad_m]),
            num_events=np.asarray(k, np.int32),
        )

    @staticmethod
    def single_mode(mode: int = 0, capacity: int = 0):
        return ModeSchedule(
            event_times=np.full((capacity,), _INF, np.float32),
            mode_sequence=np.full((capacity + 1,), mode, np.int32),
            num_events=np.asarray(0, np.int32),
        )

    def mode_at_time(self, t: Array) -> Array:
        """Active mode at time t (reference ModeSchedule.h:67).  Works both
        host-side (numpy t) and in-jit (traced t; leaves coerce to jnp)."""
        idx = jnp.searchsorted(jnp.asarray(self.event_times), t, side="right")
        return jnp.asarray(self.mode_sequence)[idx]

    @property
    def capacity(self) -> int:
        return self.event_times.shape[0]


class TargetTrajectories(NamedTuple):
    """Time-stamped desired state/input trajectories
    (reference TargetTrajectories.h:41).

    times: [M]; states: [M, nx]; inputs: [M, nu].
    """

    times: Array
    states: Array
    inputs: Array

    @staticmethod
    def create(times, states, inputs):
        return TargetTrajectories(
            jnp.asarray(times, jnp.float32),
            jnp.atleast_2d(jnp.asarray(states, jnp.float32)),
            jnp.atleast_2d(jnp.asarray(inputs, jnp.float32)),
        )

    @staticmethod
    def constant(state, input, t0: float = 0.0):
        state = jnp.asarray(state, jnp.float32)
        input = jnp.asarray(input, jnp.float32)
        return TargetTrajectories(
            times=jnp.asarray([t0], jnp.float32),
            states=state[None, :],
            inputs=input[None, :],
        )

    def state_at(self, t: Array) -> Array:
        return interpolate(self.times, self.states, t)

    def input_at(self, t: Array) -> Array:
        return interpolate(self.times, self.inputs, t)
