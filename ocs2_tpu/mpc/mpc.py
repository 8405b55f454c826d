"""Receding-horizon MPC runtime.

JAX-native re-design of the reference MPC layer (ocs2_mpc/MPC_BASE.h:44-100,
MPC_BASE.cpp:53-91 and the solver adapters GaussNewtonDDP_MPC.h:43 /
SqpMpc.h:38).  Architecture:

* ONE compiled device function per (problem, horizon-shape): the full solve —
  warm-start consumption, iteration loop, policy extraction — runs on device;
  the host loop only builds the (fixed-shape) time grid, shifts the warm
  start, and feeds buffers.  This is the XLA answer to the reference's
  "keep the solver hot, swap data through buffers" runtime.
* Warm starting: the previous primal solution is interpolated onto the new
  horizon's node times (the reference's warm-start + solution-window logic,
  MPC_BASE.cpp:70-88); across gait/mode-schedule shifts the interpolation is
  performed mode-consistently by trajectory spreading (oc/spreading.py).
* The produced policy is a LinearController pytree (device arrays) consumed
  by the MRT side (mrt.py) without host round-trips.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.controllers import LinearController
from ..core.reference import ModeSchedule, TargetTrajectories
from ..oc.problem import OptimalControlProblem
from ..oc.time_discretization import TimeGrid, make_time_grid
from ..solvers import ddp as ddp_mod
from ..solvers import sqp as sqp_mod
from ..utils.timers import RepeatedTimer

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class MpcSettings:
    """Analogue of reference MPC_Settings.h:43-71."""

    time_horizon: float = 1.0
    num_intervals: int = 64
    solver: str = "sqp"  # "sqp" | "ddp" | "ipm" | "slp"
    cold_start: bool = False
    # Warm-start carry of AL multipliers across solves.
    carry_multipliers: bool = True
    debug_print: bool = False


class ReferenceManager:
    """Holds TargetTrajectories + ModeSchedule with swap-on-solve semantics.

    Analogue of the reference ReferenceManager (ocs2_oc/synchronized_module/
    ReferenceManager.h:41-81).  The reference needs BufferedValue double
    buffering because MPC runs on another thread; here the host loop is
    single-threaded (the *device* provides the concurrency), so plain
    buffered assignment preserves the pre-solver-run swap semantics.
    """

    def __init__(
        self,
        target: TargetTrajectories,
        mode_schedule: Optional[ModeSchedule] = None,
    ):
        self._target = target
        self._mode_schedule = mode_schedule or ModeSchedule.single_mode(0)
        self._target_buffer: Optional[TargetTrajectories] = None
        self._mode_buffer: Optional[ModeSchedule] = None

    def set_target(self, target: TargetTrajectories) -> None:
        self._target_buffer = target

    def set_mode_schedule(self, mode_schedule: ModeSchedule) -> None:
        self._mode_buffer = mode_schedule

    def pre_solver_run(self, t0: float, tf: float, x0: Array) -> None:
        if self._target_buffer is not None:
            self._target = self._target_buffer
            self._target_buffer = None
        if self._mode_buffer is not None:
            self._mode_schedule = self._mode_buffer
            self._mode_buffer = None

    @property
    def target(self) -> TargetTrajectories:
        return self._target

    @property
    def mode_schedule(self) -> ModeSchedule:
        return self._mode_schedule

    def augment_params(self, grid: TimeGrid, params: dict) -> dict:
        """Hook for grid-dependent reference data (e.g. swing trajectories
        planned on the concrete node times); identity by default."""
        return params


class MpcPolicy:
    """Solved policy handed to the MRT side (the reference's PrimalSolution +
    flattened-controller transport, PrimalSolution.h:43)."""

    def __init__(self, controller: LinearController, xs, us, times, performance,
                 mode_schedule: ModeSchedule):
        self.controller = controller
        self.xs = xs
        self.us = us
        self.times = times
        self.performance = performance
        self.mode_schedule = mode_schedule


class Mpc:
    """MPC_BASE analogue: `run(t, x)` solves the horizon [t, t+T]."""

    def __init__(
        self,
        problem: OptimalControlProblem,
        params: dict,
        settings: MpcSettings = MpcSettings(),
        solver_settings=None,
        reference_manager: Optional[ReferenceManager] = None,
    ):
        self.problem = problem
        self.base_params = dict(params)
        self.settings = settings
        self.reference_manager = reference_manager or ReferenceManager(
            params.get("target")
        )
        from ..solvers import ipm as ipm_mod
        from ..solvers import slp as slp_mod

        solver_registry = {
            "sqp": (sqp_mod, sqp_mod.SqpSettings),
            "ddp": (ddp_mod, ddp_mod.DdpSettings),
            "ipm": (ipm_mod, ipm_mod.IpmSettings),
            "slp": (slp_mod, slp_mod.SlpSettings),
        }
        self._solver, default_settings = solver_registry[settings.solver]
        if solver_settings is None:
            solver_settings = default_settings()
        self.solver_settings = solver_settings
        self._prev: Optional[MpcPolicy] = None
        self._prev_al = None
        self.solve_timer = RepeatedTimer()
        self._jitted = jax.jit(self._device_solve)
        # AL shape probe so every tick (including the first) passes identical
        # pytree structures to the compiled solve — one compile, not two.
        from ..solvers.al import AlState
        from ..solvers.ddp import _example_params

        dims = problem.constraint_dims(_example_params(dict(params)))
        rho0 = getattr(self.solver_settings, "al_rho_init", 10.0)
        self._al_zero = AlState.init(dims, settings.num_intervals, rho0)

    # -- device function ----------------------------------------------------
    def _device_solve(self, grid: TimeGrid, x0, warm_xs, warm_us, al, params):
        if self.settings.solver == "ddp":
            sol = ddp_mod.solve(
                self.problem, grid, x0, params,
                us_init=warm_us, al_init=al, settings=self.solver_settings,
            )
        else:  # multiple-shooting family: sqp / ipm / slp
            sol = self._solver.solve(
                self.problem, grid, x0, params,
                xs_init=warm_xs, us_init=warm_us, al_init=al,
                settings=self.solver_settings,
            )
        controller = LinearController(
            times=grid.times[:-1], uff=sol.us, gains=sol.gains, x_nom=sol.xs[:-1]
        )
        return sol, controller

    # -- host loop ----------------------------------------------------------
    def run(self, t: float, x: Array) -> MpcPolicy:
        """One MPC tick (reference MPC_BASE::run, MPC_BASE.cpp:53)."""
        t = float(t)
        tf = t + self.settings.time_horizon
        self.reference_manager.pre_solver_run(t, tf, x)
        ms = self.reference_manager.mode_schedule
        grid = make_time_grid(
            t, tf, self.settings.num_intervals,
            event_times=np.asarray(ms.event_times),
            mode_sequence=np.asarray(ms.mode_sequence),
        )
        warm_xs, warm_us = self._warm_start(grid, x)
        al = (
            self._prev_al
            if (self.settings.carry_multipliers and self._prev_al is not None)
            else self._al_zero
        )
        params = dict(self.base_params, target=self.reference_manager.target)
        params = self.reference_manager.augment_params(grid, params)

        tic = time.perf_counter()
        sol, controller = self._jitted(grid, x, warm_xs, warm_us, al, params)
        jax.block_until_ready(sol.xs)
        self.solve_timer.record(time.perf_counter() - tic)

        policy = MpcPolicy(
            controller=controller, xs=sol.xs, us=sol.us, times=grid.times,
            performance=sol.performance, mode_schedule=ms,
        )
        self._prev = policy
        self._prev_al = sol.al
        return policy

    def _warm_start(self, grid: TimeGrid, x: Array):
        """Shift the previous solution onto the new grid (MPC warm start;
        cold start or first call falls back to the initializer).  When the
        mode schedule moved between ticks the interpolation goes through the
        trajectory-spreading time warp so warm starts stay mode-consistent
        (reference TrajectorySpreading via MRT_BASE::modifyActiveSolution)."""
        n = grid.num_intervals
        if self.settings.cold_start or self._prev is None:
            # Constant-state / zero-input initialization (Initializer.h:40).
            xs = jnp.tile(jnp.asarray(x)[None], (n + 1, 1))
            us = jnp.zeros((n, self.problem.nu), xs.dtype)
            return xs, us
        from ..core.interpolation import interpolate_batch
        from ..oc.spreading import mode_schedules_differ, spread_trajectories

        prev = self._prev
        new_ms = self.reference_manager.mode_schedule
        if mode_schedules_differ(prev.mode_schedule, new_ms):
            return spread_trajectories(
                prev.times, prev.xs, prev.us,
                prev.mode_schedule, new_ms, grid.times,
            )
        xs = interpolate_batch(prev.times, prev.xs, grid.times)
        us = interpolate_batch(prev.times[:-1], prev.us, grid.times[:-1])
        return xs, us

    @property
    def last_policy(self) -> Optional[MpcPolicy]:
        """The most recent MpcPolicy produced by run(), or None before the
        first tick — the public accessor for operator tooling (analogue of
        MRT_BASE's buffered policy getter)."""
        return self._prev

    def reset(self) -> None:
        """Analogue of the MPC reset service (MPC_ROS_Interface reset.srv)."""
        self._prev = None
        self._prev_al = None
        self.solve_timer = RepeatedTimer()
