"""Soft-contact quadruped plant: spring-damper ground + Coulomb friction +
joint-servo force transmission.

The JAX-native analogue of the reference's RaiSim rollout backend
(ocs2_raisim/ocs2_raisim_core/include/ocs2_raisim_core/RaisimRollout.h:46-165):
a CONTACT-physics plant behind the MRT rollout seam whose ground reactions
come from foot penetration and slip, not from the MPC's commanded input.
Closing the MPC loop against it exercises exactly the model mismatch the
reference demonstrates with RaiSim.

Model: the same SRBD base + velocity-controlled legs as ``model.dynamics``,
with two plant-side effects the MPC model does not have:

1. **Ground**: per-foot Kelvin-Voigt normal contact and viscous tangential
   friction inside a Coulomb cone,

      f_n = kp * d - kd * v_z   (d = penetration, clamped >= 0, gated d > 0)
      f_t = -kt * v_t           (|f_t| <= mu * f_n)

2. **Joint-servo admittance**: the leg drive realizes the COMMANDED contact
   force ``u[:12]`` by pressing the foot against the ground with finite
   admittance — the analogue of the reference raisim conversions' joint PD
   controller transmitting the MPC's intent to the contact
   (ocs2_legged_robot_raisim LeggedRobotRaisimConversions).  Foot-velocity
   contribution: v_extra = -M (f_cmd - f_plant) with the PSD servo map
   M = R J J^T R^T / b_servo.  Without it, a perfect velocity servo + the
   MPC's zero-foot-velocity stance constraint freeze penetration at
   touchdown depth and the commanded-force channel is severed (the robot
   falls through its own stance).

The contact force and the servo velocity are algebraically coupled (the
damper sees the servo motion).  The force is solved IMPLICITLY per foot,

    f = (I + K M)^{-1} (f_raw(v_cmd) + K M f_cmd),  K = diag(kt, kt, kd),

which keeps the coupled plant passive — resolving it explicitly with the
commanded velocity feeds the damper a wrong sign and pumps energy into the
gait (observed: growing roll/pitch oscillation until the robot trips).
Clamps (gate, f_z >= 0, Coulomb cap) are applied after the solve.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from . import model

Array = jax.Array


class ContactParams(NamedTuple):
    """Ground + servo constants (RaiSim-like for a 30 kg quadruped)."""

    kp: float = 4.0e4  # normal stiffness [N/m] -> ~2 mm static penetration
    kd: float = 2.0e3  # normal damping [N s/m]
    kt: float = 2.0e3  # tangential viscous friction [N s/m]
    mu: float = 0.7  # Coulomb friction coefficient
    b_servo: float = 25.0  # joint-servo viscous coefficient [N m s / rad]


def _leg_jacobians(x: Array) -> Array:
    """[4, 3, 3] world-frame foot Jacobians d p_foot_world / d q_leg."""
    r_wb = model.euler_zyx_rotation(model.base_euler(x))
    q = model.joint_angles(x).reshape(model.NUM_LEGS, 3)
    return jnp.stack(
        [
            r_wb
            @ jax.jacfwd(lambda qq, leg=leg: model.foot_position_base(leg, qq))(
                q[leg]
            )
            for leg in range(model.NUM_LEGS)
        ]
    )


def plant_forces(
    x: Array,
    u: Array,
    height_at: Callable[[Array], Array],
    cp: ContactParams = ContactParams(),
):
    """Implicit ground-reaction solve.

    Returns (forces [4, 3] world, dq_extra [12] servo joint velocities).
    """
    feet = model.foot_positions_world(x)  # [4, 3]
    v_cmd = model.foot_velocities_world(x, u)  # [4, 3] commanded kinematics
    jacs = _leg_jacobians(x)  # [4, 3, 3]
    f_cmd = model.contact_forces(u)  # [4, 3]
    h = jax.vmap(height_at)(feet[:, :2])
    pen = h - feet[:, 2]
    in_contact = pen > 0.0

    k_diag = jnp.array([cp.kt, cp.kt, cp.kd])
    eye = jnp.eye(3)

    def per_leg(jac, vc, fc, d):
        m = (jac @ jac.T) / cp.b_servo  # PSD servo admittance (world)
        f_raw = jnp.array(
            [-cp.kt * vc[0], -cp.kt * vc[1], cp.kp * d - cp.kd * vc[2]]
        )
        a = eye + k_diag[:, None] * m
        f = jnp.linalg.solve(a, f_raw + k_diag[:, None] * m @ fc)
        # Clamps: normal force nonnegative, Coulomb cone.
        f_n = jnp.maximum(f[2], 0.0)
        f_t = f[:2]
        f_t_norm = jnp.linalg.norm(f_t)
        cap = cp.mu * f_n
        f_t = f_t * jnp.minimum(1.0, cap / jnp.maximum(f_t_norm, 1e-9))
        return jnp.concatenate([f_t, f_n[None]])

    forces = jax.vmap(per_leg)(jacs, v_cmd, f_cmd, pen)
    forces = jnp.where(in_contact[:, None], forces, 0.0)

    # Servo joint motion realizing the force error (joint-space form of
    # v_extra = -M (f_cmd - f)).
    df = f_cmd - forces  # [4, 3] world

    def leg_dq(jac, dfl):
        return -(jac.T @ dfl) / cp.b_servo

    dq_extra = jax.vmap(leg_dq)(jacs, df).reshape(-1)
    return forces, dq_extra


def contact_forces_from_state(
    x: Array,
    u: Array,
    height_at: Callable[[Array], Array],
    cp: ContactParams = ContactParams(),
) -> Array:
    """[4, 3] world-frame ground-reaction forces (diagnostic surface)."""
    return plant_forces(x, u, height_at, cp)[0]


def make_soft_contact_dynamics(
    height_at: Optional[Callable[[Array], Array]] = None,
    cp: ContactParams = ContactParams(),
) -> Callable:
    """Plant flow map ``(t, x, u, params) -> dx`` for ExternalSimRollout.

    `height_at(xy) -> z` defines the ground (default: flat z=0; pass
    ``ElevationMap.height_at`` for terrain).
    """
    h_fn = height_at or (lambda xy: jnp.zeros(()))

    def dynamics(t, x, u, p):
        del t, p
        forces, dq_extra = plant_forces(x, u, h_fn, cp)
        dq = model.joint_velocities(u) + dq_extra
        # Same SRBD bookkeeping as model.dynamics, with plant forces.
        u_plant = jnp.concatenate([forces.reshape(-1), dq])
        return model.dynamics(0.0, x, u_plant, None)

    return dynamics


def make_contact_rollout(
    height_at: Optional[Callable[[Array], Array]] = None,
    cp: ContactParams = ContactParams(),
    substeps: int = 8,
):
    """ExternalSimRollout over the soft-contact plant (the stiff ground needs
    small RK4 steps: substeps=8 at a 100 Hz control period -> dt=1.25 ms;
    tangential damping 4 kt / m and normal damping must stay inside the RK4
    stability region, 4 * kt/m * dt < 2.78)."""
    from ...mpc.mrt import ExternalSimRollout

    return ExternalSimRollout(
        make_soft_contact_dynamics(height_at, cp),
        method="rk4",
        substeps=substeps,
    )
