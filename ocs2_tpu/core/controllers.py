"""Policy representations.

JAX-native analogue of the reference controller classes
(ocs2_core/include/ocs2_core/control/LinearController.h:42,
FeedforwardController.h:44).  Controllers are pytrees of dense time-stamped
arrays evaluated by interpolation — directly usable inside jitted rollouts and
trivially serializable (the analogue of the reference's flatten/unflatten ROS
transport, mpc_flattened_controller.msg).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .interpolation import interpolate

Array = jax.Array


class LinearController(NamedTuple):
    """u(t, x) = uff(t) + K(t) (x - x_nom(t))  — reference LinearController.h:42.

    times: [N]; uff: [N, nu]; gains: [N, nu, nx]; x_nom: [N, nx].
    The reference stores bias = uff - K x_nom; we keep x_nom explicit because it
    also serves MRT evaluation and trajectory spreading.
    """

    times: Array
    uff: Array
    gains: Array
    x_nom: Array

    def __call__(self, t: Array, x: Array) -> Array:
        uff = interpolate(self.times, self.uff, t)
        k = interpolate(self.times, self.gains, t)
        xn = interpolate(self.times, self.x_nom, t)
        return uff + k @ (x - xn)


class FeedforwardController(NamedTuple):
    """u(t) ignoring state — reference FeedforwardController.h:44."""

    times: Array
    uff: Array

    def __call__(self, t: Array, x: Array) -> Array:
        del x
        return interpolate(self.times, self.uff, t)


def zero_controller(times: Array, nu: int, nx: int) -> LinearController:
    n = times.shape[0]
    dtype = times.dtype
    return LinearController(
        times=times,
        uff=jnp.zeros((n, nu), dtype),
        gains=jnp.zeros((n, nu, nx), dtype),
        x_nom=jnp.zeros((n, nx), dtype),
    )
