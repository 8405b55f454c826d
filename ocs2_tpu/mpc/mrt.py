"""MRT — model reference tracking (the consumer side of the MPC split).

JAX-native analogue of the reference MRT layer (ocs2_mpc/MRT_BASE.h:58-180:
updatePolicy/evaluatePolicy/rolloutPolicy double-buffered policy manager,
MPC_MRT_Interface.h:50 in-process pairing, and the closed-loop simulator
MRT_ROS_Dummy_Loop, ros_interfaces/src/mrt/MRT_ROS_Dummy_Loop.cpp:58-180).

The reference's ROS-topic pipeline parallelism (planner at 50-100 Hz, tracker
at 400 Hz+ on separate processes) becomes: policies are device-resident
pytrees swapped by reference on the host; `evaluate_policy` / `rollout_policy`
are tiny jitted device functions.  A real robot deployment would move only
(t, x) -> u across the host boundary per control tick.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import jax
import jax.numpy as jnp

from ..core.controllers import LinearController
from ..core.integrate import discretize
from ..oc.problem import OptimalControlProblem
from .mpc import Mpc, MpcPolicy

Array = jax.Array


class SystemObservation:
    """(mode, time, state, input) plant sample (reference
    SystemObservation.h:41)."""

    def __init__(self, time: float, state: Array, input: Optional[Array] = None,
                 mode: int = 0):
        self.time = time
        self.state = state
        self.input = input
        self.mode = mode


class RolloutBackend:
    """Pluggable plant simulator for the MRT side — the seam the reference
    proves with RaisimRollout (ocs2_raisim_core/RaisimRollout.h:46-165:
    RolloutBase is swapped for a contact-physics engine, with state
    conversion callbacks).  Closed-loop results then see MODEL MISMATCH —
    the entire point of testing an MPC runtime.

    Implement `step(t, x, u, dt, params) -> x_next` (jit-compatible)."""

    def step(self, t, x, u, dt, params):
        raise NotImplementedError


class FlowMapRollout(RolloutBackend):
    """Default backend: integrate the problem's own flow map (the
    reference's TimeTriggeredRollout inside MRT_BASE::rolloutPolicy)."""

    def __init__(self, problem: OptimalControlProblem, method="rk4", substeps=2):
        def _step(t, x, u, dt, params):
            flow = discretize(
                lambda tt, xx, uu: problem.dynamics(tt, xx, uu, params),
                method, substeps,
            )
            return flow(t, x, u, dt)

        self._step = jax.jit(_step)

    def step(self, t, x, u, dt, params):
        return self._step(t, x, u, dt, params)


class ExternalSimRollout(RolloutBackend):
    """Backend wrapping ANY external simulator dynamics — a different flow
    map (model mismatch), a contact model, or a learned/physics simulator —
    with optional state conversions in/out of the MPC state space
    (reference RaisimRollout's stateToRaisimGenCoordGenVel /
    raisimGenCoordGenVelToState callbacks)."""

    def __init__(
        self,
        sim_dynamics: Callable,  # (t, x_sim, u, params) -> dx_sim
        method: str = "rk4",
        substeps: int = 2,
        state_to_sim: Optional[Callable] = None,
        sim_to_state: Optional[Callable] = None,
    ):
        to_sim = state_to_sim or (lambda x: x)
        to_state = sim_to_state or (lambda x: x)

        def _step(t, x, u, dt, params):
            xs = to_sim(x)
            flow = discretize(
                lambda tt, xx, uu: sim_dynamics(tt, xx, uu, params),
                method, substeps,
            )
            return to_state(flow(t, xs, u, dt))

        self._step = jax.jit(_step)

    def step(self, t, x, u, dt, params):
        return self._step(t, x, u, dt, params)


class Mrt:
    """Policy consumer with buffer-swap semantics (MRT_BASE.h:126-148)."""

    def __init__(
        self,
        problem: OptimalControlProblem,
        rollout_backend: Optional[RolloutBackend] = None,
    ):
        self.problem = problem
        self.rollout_backend = rollout_backend or FlowMapRollout(problem)
        self._active: Optional[MpcPolicy] = None
        self._buffer: Optional[MpcPolicy] = None
        self._eval = jax.jit(
            lambda ctrl, t, x: ctrl(t, x)
        )

    # -- policy transport ---------------------------------------------------
    def move_to_buffer(self, policy: MpcPolicy) -> None:
        """Receive a new policy (the reference's mpcPolicyCallback)."""
        self._buffer = policy

    def update_policy(self) -> bool:
        """Swap in the newest buffered policy (MRT_BASE::updatePolicy)."""
        if self._buffer is None:
            return False
        self._active = self._buffer
        self._buffer = None
        return True

    @property
    def initialized(self) -> bool:
        return self._active is not None

    @property
    def policy(self) -> MpcPolicy:
        assert self._active is not None, "no policy received yet (MRT gating)"
        return self._active

    # -- policy queries -----------------------------------------------------
    def evaluate_policy(self, t: float, x: Array) -> Array:
        """u = uff + K (x - x_nom) interpolated at t (MRT_BASE.h:126)."""
        return self._eval(self.policy.controller, jnp.asarray(t, jnp.float32), x)

    def rollout_policy(self, t: float, x: Array, dt: float, params: dict,
                       substeps: int = 1) -> Array:
        """Integrate the plant under the policy for one control period
        (MRT_BASE::rolloutPolicy, MRT_BASE.h:138)."""
        x = jnp.asarray(x)
        h = dt / substeps
        for i in range(substeps):
            ti = t + i * h
            u = self.evaluate_policy(ti, x)
            x = self.rollout_backend.step(
                jnp.asarray(ti, jnp.float32), x, u, jnp.asarray(h, jnp.float32),
                params,
            )
        return x


class MpcMrtInterface:
    """In-process MPC+MRT pairing for tests, python users, and MPC-Net
    (reference MPC_MRT_Interface.h:50)."""

    def __init__(self, mpc: Mpc, mrt: Optional[Mrt] = None):
        self.mpc = mpc
        self.mrt = mrt or Mrt(mpc.problem)
        self._observation: Optional[SystemObservation] = None

    def set_current_observation(self, obs: SystemObservation) -> None:
        self._observation = obs

    def advance_mpc(self) -> MpcPolicy:
        assert self._observation is not None, "no observation set"
        policy = self.mpc.run(self._observation.time, self._observation.state)
        self.mrt.move_to_buffer(policy)
        return policy

    def evaluate_policy(self, t: float, x: Array) -> Array:
        return self.mrt.evaluate_policy(t, x)


def dummy_loop(
    interface: MpcMrtInterface,
    x0: Array,
    duration: float,
    mrt_frequency: float = 400.0,
    mpc_frequency: float = 50.0,
    params: Optional[dict] = None,
    observers: Optional[List[Callable]] = None,
    use_rollout: bool = True,
):
    """Closed-loop simulation at synthetic rates (reference
    MRT_ROS_Dummy_Loop::run, MRT_ROS_Dummy_Loop.cpp:58-180, synchronized
    mode: MPC runs every mrt/mpc-ratio control ticks).

    Returns (times [M], states [M, nx], inputs [M-1, nu]).
    """
    params = params or interface.mpc.base_params
    dt = 1.0 / mrt_frequency
    ratio = max(1, int(round(mrt_frequency / mpc_frequency)))
    steps = int(round(duration * mrt_frequency))

    t, x = 0.0, jnp.asarray(x0)
    times, states, inputs = [t], [x], []
    for k in range(steps):
        if k % ratio == 0:
            interface.set_current_observation(SystemObservation(t, x))
            interface.advance_mpc()
            interface.mrt.update_policy()
        u = interface.mrt.evaluate_policy(t, x)
        if use_rollout:
            x = interface.mrt.rollout_policy(t, x, dt, params)
        else:
            # Pure tracking debug: teleport to the planner's nominal state at
            # the next tick (interpolated — x_nom is a [N, nx] trajectory).
            ctrl = interface.mrt.policy.controller
            from ..core.interpolation import interpolate
            x = interpolate(ctrl.times, ctrl.x_nom, jnp.asarray(t + dt, jnp.float32))
        t += dt
        times.append(t)
        states.append(x)
        inputs.append(u)
        for obs in observers or ():
            obs(t, x, u)
    return (
        jnp.asarray(times),
        jnp.stack(states),
        jnp.stack(inputs),
    )
