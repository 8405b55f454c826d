"""Operator surface: closed-loop trajectory recording, headless artifact
export, and target commands.

JAX-native analogue of the reference's command/visualization tooling
(ocs2_ros_interfaces/command/TargetTrajectoriesKeyboardPublisher.h,
visualization/VisualizationHelpers.h, multiplot configs): with no ROS/RViz,
the operator-facing products are structured dumps (.npz) and headless plot
exports (.png via matplotlib) of closed-loop runs, plus a converter from
operator pose/velocity commands to TargetTrajectories.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..core.reference import TargetTrajectories


@dataclasses.dataclass
class TrajectoryRecorder:
    """Closed-loop recorder — pass ``recorder`` into dummy_loop's observers
    (it is callable as (t, x, u)); per-solve stats attach via
    ``record_solve``.

    Export: ``save_npz`` (structured dump) and ``save_plots`` (headless
    multiplot analogue).
    """

    times: List[float] = dataclasses.field(default_factory=list)
    states: List[np.ndarray] = dataclasses.field(default_factory=list)
    inputs: List[np.ndarray] = dataclasses.field(default_factory=list)
    solve_times: List[float] = dataclasses.field(default_factory=list)
    performance: List[dict] = dataclasses.field(default_factory=list)
    term_traces: Dict[str, list] = dataclasses.field(default_factory=dict)

    # -- dummy_loop observer protocol ---------------------------------------
    def __call__(self, t: float, x, u) -> None:
        self.times.append(float(t))
        self.states.append(np.asarray(x))
        self.inputs.append(np.asarray(u))

    def record_solve(self, t: float, performance) -> None:
        """Per-MPC-tick performance record (mpc_performance_indices
        analogue in the published policy message)."""
        self.solve_times.append(float(t))
        entry = {
            f: float(np.asarray(getattr(performance, f)))
            for f in performance._fields
        }
        self.performance.append(entry)

    def record_term(self, name: str, times, values) -> None:
        """Attach a TermObserver trace (observers.TermObserver callback:
        ``lambda ts, vs: recorder.record_term('cone', ts, vs)``)."""
        self.term_traces.setdefault(name, []).append(
            (np.asarray(times), np.asarray(values))
        )

    # -- exports -------------------------------------------------------------
    def arrays(self) -> Dict[str, np.ndarray]:
        out = {
            "t": np.asarray(self.times),
            "x": np.stack(self.states) if self.states else np.zeros((0, 0)),
            "u": np.stack(self.inputs) if self.inputs else np.zeros((0, 0)),
        }
        if self.performance:
            out["solve_t"] = np.asarray(self.solve_times)
            for key in self.performance[0]:
                out[f"perf_{key}"] = np.asarray(
                    [e[key] for e in self.performance]
                )
        return out

    def save_npz(self, path: str) -> None:
        arrays = self.arrays()
        for name, traces in self.term_traces.items():
            # Last observation of each term (full per-node trace).
            ts, vs = traces[-1]
            arrays[f"term_{name}_t"] = ts
            arrays[f"term_{name}_v"] = vs
        np.savez(path, **arrays)

    def save_plots(self, path: str, state_labels=None, input_labels=None):
        """Headless PNG: states / inputs / per-solve merit+violations (the
        rqt_multiplot analogue)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        arrays = self.arrays()
        n_rows = 2 + (1 if self.performance else 0)
        fig, axes = plt.subplots(
            n_rows, 1, figsize=(10, 3.2 * n_rows), sharex=True
        )
        axes = np.atleast_1d(axes)
        t = arrays["t"]
        x, u = arrays["x"], arrays["u"]
        nx_plot = min(x.shape[1], 12) if x.size else 0
        for i in range(nx_plot):
            lbl = state_labels[i] if state_labels else f"x{i}"
            axes[0].plot(t[: x.shape[0]], x[:, i], lw=0.9, label=lbl)
        axes[0].set_ylabel("states")
        axes[0].legend(ncol=4, fontsize=6)
        nu_plot = min(u.shape[1], 12) if u.size else 0
        for i in range(nu_plot):
            lbl = input_labels[i] if input_labels else f"u{i}"
            axes[1].plot(t[: u.shape[0]], u[:, i], lw=0.9, label=lbl)
        axes[1].set_ylabel("inputs")
        axes[1].legend(ncol=4, fontsize=6)
        if self.performance:
            st = arrays["solve_t"]
            for key in ("merit", "cost", "equality_constraints_sse"):
                k = f"perf_{key}"
                if k in arrays:
                    axes[2].plot(st, arrays[k], marker=".", lw=0.9, label=key)
            axes[2].set_yscale("symlog", linthresh=1e-8)
            axes[2].set_ylabel("per-solve")
            axes[2].legend(fontsize=7)
        axes[-1].set_xlabel("t [s]")
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)


# --------------------------------------------------------------------------
# Target commands (TargetTrajectoriesKeyboardPublisher semantics: an operator
# types a desired displacement/pose; it becomes a TargetTrajectories reaching
# the goal at a velocity-scaled arrival time).
# --------------------------------------------------------------------------


def pose_command_to_target(
    x0,
    displacement,
    t0: float = 0.0,
    target_velocity: float = 0.5,
    u_target=None,
    position_idx: Optional[slice] = None,
    yaw_idx: Optional[int] = None,
) -> TargetTrajectories:
    """Relative pose command -> TargetTrajectories (the reference's
    commandLineToTargetTrajectories: arrival time = displacement /
    targetDisplacementVelocity, linear interpolation from the current
    state, TargetTrajectoriesKeyboardPublisher.h).

    displacement: [dx, dy, dz, dyaw] relative goal in world frame.  By
    default the position lives at x[6:9] with yaw at x[9] (the legged/
    centroidal layout) when the state is large enough, else at the leading
    state entries (small point-mass models).
    """
    import jax.numpy as jnp

    x0 = jnp.asarray(x0)
    nx = x0.shape[0]
    if position_idx is None:
        position_idx = slice(6, 9) if nx >= 10 else slice(0, min(3, nx))
    if yaw_idx is None and nx >= 10:
        yaw_idx = 9
    d = np.asarray(displacement, np.float32)
    n_pos = position_idx.stop - position_idx.start
    x_goal = x0.at[position_idx].set(
        x0[position_idx] + jnp.asarray(d[:n_pos])
    )
    if yaw_idx is not None and len(d) > 3:
        x_goal = x_goal.at[yaw_idx].set(x0[yaw_idx] + float(d[3]))
    dist = float(np.linalg.norm(d[:3]))
    t_arrival = t0 + max(dist / max(target_velocity, 1e-3), 1e-2)
    nu = 0 if u_target is None else np.asarray(u_target).shape[0]
    u_tt = (
        jnp.zeros((2, nu))
        if u_target is None
        else jnp.tile(jnp.asarray(u_target)[None], (2, 1))
    )
    return TargetTrajectories.create(
        times=[t0, t_arrival],
        states=jnp.stack([x0, x_goal]),
        inputs=u_tt,
    )


def keyboard_command_loop(mpc, u_target=None, stream=None, out=None) -> None:
    """Minimal interactive command shell (keyboard-publisher analogue):
    reads lines 'dx dy dz dyaw' and retargets the running MPC.  Testable by
    passing ``stream`` (an iterable of lines) and ``out`` (a list collecting
    responses)."""
    import sys

    stream = stream if stream is not None else sys.stdin
    emit = (out.append if out is not None else print)
    if u_target is None:
        u_target = np.zeros((mpc.problem.nu,), np.float32)
    emit("target command: 'dx dy dz [dyaw]' per line, 'q' quits")
    for line in stream:
        line = line.strip()
        if line in ("q", "quit", "exit"):
            break
        try:
            d = [float(v) for v in line.split()]
            assert 3 <= len(d) <= 4
        except (ValueError, AssertionError):
            emit(f"cannot parse '{line}'")
            continue
        policy = mpc.last_policy
        if policy is None:
            emit("no policy yet")
            continue
        x_now = policy.xs[0]
        t_now = float(policy.times[0])
        tt = pose_command_to_target(x_now, d, t0=t_now, u_target=u_target)
        mpc.reference_manager.set_target(tt)
        emit(f"target set: {d} arriving at t={float(tt.times[-1]):.2f}")
