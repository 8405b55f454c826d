"""Linear interpolation over time-stamped trajectories.

JAX-native analogue of the reference's LinearInterpolation
(ocs2_core/include/ocs2_core/misc/LinearInterpolation.h) and Lookup
(misc/Lookup.h).  Implemented with ``jnp.searchsorted`` + gather so it is
jittable, vmappable, and free of data-dependent control flow.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def lookup_index(times: Array, t: Array) -> Array:
    """Index i such that times[i] <= t < times[i+1], clamped to [0, len-2].

    Matches the reference's Lookup::findIndexInTimeArray clamping semantics so
    queries outside the trajectory extrapolate from the boundary segment.
    """
    idx = jnp.searchsorted(times, t, side="right") - 1
    return jnp.clip(idx, 0, jnp.maximum(times.shape[0] - 2, 0))


def interpolate(times: Array, values: Array, t: Array) -> Array:
    """Linearly interpolate values [N, ...] stamped at times [N] at query t.

    Boundary behavior matches the reference LinearInterpolation::interpolate:
    clamp to the first/last sample (alpha clipped to [0, 1]).
    """
    times = jnp.asarray(times)
    values = jnp.asarray(values)
    if times.shape[0] == 1:
        return values[0]
    i = lookup_index(times, t)
    t0 = times[i]
    t1 = times[i + 1]
    alpha = jnp.clip((t - t0) / jnp.maximum(t1 - t0, 1e-12), 0.0, 1.0)
    v0 = values[i]
    v1 = values[i + 1]
    return v0 + alpha * (v1 - v0)


def interpolate_batch(times: Array, values: Array, ts: Array) -> Array:
    """Vectorized interpolation at many query times ts [M]."""
    return jax.vmap(lambda t: interpolate(times, values, t))(ts)
