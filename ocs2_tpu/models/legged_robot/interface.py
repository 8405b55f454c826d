"""Legged-robot problem assembly + gait-synchronized reference management.

Analogue of the reference LeggedRobotInterface
(ocs2_legged_robot/LeggedRobotInterface.h:56-130: assembles base-tracking
cost, friction cone, zero-force, zero/normal-velocity constraints) and
SwitchedModelReferenceManager (reference_manager/
SwitchedModelReferenceManager.h:45: injects the gait-derived ModeSchedule and
swing references before every solve).
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from ...core.reference import ModeSchedule, TargetTrajectories
from ...mpc.mpc import ReferenceManager
from ...oc.problem import (
    OptimalControlProblem,
    quadratic_cost,
    quadratic_final_cost,
)
from ...oc.time_discretization import TimeGrid
from . import constraints as con
from . import model
from .gait import GAIT_MAP, GaitSchedule, ModeSequenceTemplate, stance_gait
from .swing import plan_swing_references

# Base-tracking weights matching the reference task.info Q/R
# (ocs2_legged_robot/config/mpc/task.info:179-246).  Module constants are
# NUMPY so they bake into jitted programs as literals.
Q_DIAG = np.concatenate(
    [
        np.array([15.0, 15.0, 30.0]),  # com velocity
        np.array([5.0, 10.0, 10.0]),  # normalized angular momentum
        np.array([500.0, 500.0, 500.0]),  # base position
        np.array([100.0, 200.0, 200.0]),  # base orientation (z, y, x)
        np.full((12,), 20.0),  # joint angles
    ]
).astype(np.float32)


# The reference's R(12:24) = 5000*1e-3 weights FOOT velocity relative to the
# base, mapped to joint velocities through the base-to-feet Jacobian at the
# nominal configuration: R_qdot = J^T R_task J (LeggedRobotInterface.cpp:
# 238-269 initializeInputCostWeight).  A direct 5.0 on joint velocities
# over-penalizes leg swing ~25x and freezes the gait.
def _foot_jacobian_np(leg: int, q_leg: np.ndarray) -> np.ndarray:
    """d foot_position_base / d (haa, hfe, kfe) in PURE numpy.

    Pure numpy, so importing the module starts no device work and no
    device->host readback.  Mirrors model.foot_position_base
    analytically."""
    haa, hfe, kfe = float(q_leg[0]), float(q_leg[1]), float(q_leg[2])
    lt, ls = model.THIGH_LENGTH, model.SHANK_LENGTH
    side = model.leg_side_sign(leg)
    # Sagittal-plane position and its derivatives wrt hfe/kfe.
    x_p = -lt * np.sin(hfe) - ls * np.sin(hfe + kfe)
    z_p = -lt * np.cos(hfe) - ls * np.cos(hfe + kfe)
    dx_dhfe = -lt * np.cos(hfe) - ls * np.cos(hfe + kfe)
    dx_dkfe = -ls * np.cos(hfe + kfe)
    dz_dhfe = lt * np.sin(hfe) + ls * np.sin(hfe + kfe)
    dz_dkfe = ls * np.sin(hfe + kfe)
    p = np.array([x_p, side * model.HIP_LATERAL, z_p])
    dp_dhfe = np.array([dx_dhfe, 0.0, dz_dhfe])
    dp_dkfe = np.array([dx_dkfe, 0.0, dz_dkfe])
    c, s = np.cos(haa), np.sin(haa)
    rx = np.array([[1.0, 0, 0], [0, c, -s], [0, s, c]])
    drx = np.array([[0.0, 0, 0], [0, -s, -c], [0, c, -s]])
    jac = np.stack([drx @ p, rx @ dp_dhfe, rx @ dp_dkfe], axis=1)
    return jac.astype(np.float32)


def _input_cost_weight() -> np.ndarray:
    q_nom = model.DEFAULT_JOINTS.reshape(model.NUM_LEGS, 3)
    r = np.zeros((model.NU, model.NU), np.float32)
    r[:12, :12] = np.diag(np.full((12,), 1e-3, np.float32))  # contact forces
    r_task = 5000.0 * 1e-3  # foot-velocity weight (task.info R scaling)
    for leg in range(model.NUM_LEGS):
        jac = _foot_jacobian_np(leg, q_nom.reshape(model.NUM_LEGS, 3)[leg])
        block = r_task * (jac.T @ jac)
        s = slice(12 + 3 * leg, 12 + 3 * (leg + 1))
        r[s, s] = block
    return r


R_MAT = _input_cost_weight()


def make_problem(
    friction_cone: str = "soft",  # "soft" (relaxed barrier) | "hard" (AL)
    project_foot_constraint: bool = True,
    model_type: str = "srbd",  # "srbd" | "full" | "comkino"
) -> OptimalControlProblem:
    if model_type == "full":
        from .centroidal import dynamics_full as _dynamics
    elif model_type == "comkino":
        # Full kinodynamic model (perceptive-anymal ComKinoSystemDynamicsAd).
        from .comkino import dynamics as _dynamics
    else:
        _dynamics = model.dynamics
    problem = OptimalControlProblem(
        dynamics=_dynamics,
        cost_terms=(quadratic_cost(np.diag(Q_DIAG), R_MAT),),
        final_cost_terms=(quadratic_final_cost(10.0 * np.diag(Q_DIAG[:24])),),
        equality_terms=(con.foot_constraint, con.swing_normal_velocity)
        if not project_foot_constraint
        else (con.foot_constraint,),
        state_cost_terms=(con.swing_height_tracking,),
        nx=model.NX,
        nu=model.NU,
    )
    if not project_foot_constraint:
        pass  # both handled by AL
    else:
        # Swing vertical-velocity tracking via AL would put a rank-deficient
        # row into the projection; keep it as a soft cost companion to the
        # height tracking (documented delta from the reference's hard form).
        problem = problem.add(cost_terms=(_swing_velocity_soft,))
    if friction_cone == "soft":
        problem = problem.add(cost_terms=(con.make_friction_cone_soft(),))
    else:
        problem = problem.add(inequality_terms=(con.friction_cone,))
    return problem


# 50*sum(g^2) as a structured Gauss-Newton quadratic-penalty term.
from ...core import penalties as _pen  # noqa: E402
from ...oc.problem import soft_constraint as _soft  # noqa: E402

_swing_velocity_soft = _soft(con.swing_normal_velocity, _pen.quadratic(100.0))


def default_target(x0=None) -> TargetTrajectories:
    x_target = model.default_state() if x0 is None else x0
    u_target = model.weight_compensating_input(jnp.ones(4))
    return TargetTrajectories.constant(x_target, u_target)


def make_params(
    grid: TimeGrid,
    target: Optional[TargetTrajectories] = None,
    swing_height: float = 0.08,
) -> dict:
    """Build the params pytree for a given discretization (swing references
    are per-node arrays aligned with the grid)."""
    swing = plan_swing_references(
        np.asarray(grid.times), np.asarray(grid.modes), swing_height
    )
    return {
        "target": target or default_target(),
        "swing_vz": swing.vz,
        "swing_z": swing.z,
        "fz_max": np.float32(500.0),
    }


class SwitchedModelReferenceManager(ReferenceManager):
    """Injects the gait's ModeSchedule + swing references pre-solve
    (reference SwitchedModelReferenceManager.h:45)."""

    def __init__(
        self,
        gait_schedule: GaitSchedule,
        target: Optional[TargetTrajectories] = None,
        swing_height: float = 0.08,
    ):
        super().__init__(target or default_target())
        self.gait_schedule = gait_schedule
        self.swing_height = swing_height

    def set_gait(self, name_or_template) -> None:
        tpl = (
            GAIT_MAP[name_or_template]()
            if isinstance(name_or_template, str)
            else name_or_template
        )
        self.gait_schedule.set_template(tpl)

    def pre_solver_run(self, t0: float, tf: float, x0) -> None:
        super().pre_solver_run(t0, tf, x0)
        self._mode_schedule = self.gait_schedule.mode_schedule(t0, tf)

    def augment_params(self, grid: TimeGrid, params: dict) -> dict:
        swing = plan_swing_references(
            np.asarray(grid.times), np.asarray(grid.modes), self.swing_height
        )
        return dict(params, swing_vz=swing.vz, swing_z=swing.z)
