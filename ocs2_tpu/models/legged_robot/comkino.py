"""ComKino full kinodynamic quadruped model.

Analogue of the reference perceptive-anymal dynamics stack:
* ocs2_switched_model_interface/dynamics/ComKinoSystemDynamicsAd.h (flow map:
  base dynamics from the top-6 rows of the full rigid-body dynamics with the
  zero-joint-acceleration assumption, joint kinematics integrated from the
  commanded joint velocities, contact wrench J^T·lambda on the base),
* ocs2_anymal_models/src/QuadrupedCom.cpp:64-115
  (calculateBaseLocalAccelerations: CRBA base inertia block M_b(q),
  nonLinearEffects bias h(q, v), solve M_b a = J^T·lambda - h_6).

JAX-native re-expression: instead of porting CRBA/RNEA recursions, the same
equations are DERIVED from the Lagrangian by autodiff.  With generalized
coordinates z = [p_base, euler_zyx, q_joints] (18) and velocities zdot:

    KE(z, zdot) = 1/2 sum_i m_i |v_i(z, zdot)|^2              (link CoMs)
                + 1/2 w_body' I_base w_body                   (base rotation)
    M(z)        = d^2 KE / d zdot^2          (exact: KE is quadratic in zdot)
    bias(z,zdot)= (d p_mom/d z) zdot - dKE/dz + dPE/dz,  p_mom = dKE/d zdot
    Q_contact   = d( sum_f p_foot(z)·f_f )/d z               (J^T lambda)

and the ComKino assumption ddq = 0 closes the top-6 system
    M[:6,:6] zdd_base = Q[:6] - bias[:6].

This is numerically identical to the reference's Pinocchio crba +
nonLinearEffects route (same Euler-Lagrange equations, coordinates chosen as
euler rates instead of body twist) while every term is one fused XLA program
— no per-link recursion at runtime, vmap/vjp-friendly for batched solves.

State/input layout matches model.py's 24/24 centroidal layout exactly, so
every constraint, cost, gait, swing and foothold component composes with this
dynamics unchanged (x[3:6] stores INERTIA*w_body/MASS — a fixed diagonal
rescaling of the body angular velocity, bijective with the reference's base
twist coordinates).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import model
from .centroidal import (
    DEFAULT_MASSES,
    MassModel,
    _leg_link_coms_base,
)
from .model import (
    GRAVITY,
    INERTIA,
    MASS,
    NUM_LEGS,
    NX,
    NU,
    base_euler,
    base_position,
    contact_forces,
    euler_zyx_rate_matrix,
    euler_zyx_rotation,
    joint_angles,
    joint_velocities,
)

Array = jax.Array

NZ = 18  # generalized coordinates: base position (3) + euler zyx (3) + q (12)

# Base rotational inertia consistent with the SRBD model: model.INERTIA is
# the inertia of the WHOLE robot in the nominal configuration; the base body
# carries what the leg links (as point masses at their CoMs) do not.
# Pure numpy (NOT jnp): computed at trace time, so the results bake into
# the compiled program as constants with no device round trip
# (see the QuadraticTrackingCost numpy note).
def _leg_link_coms_np(leg: int, q_leg: np.ndarray):
    haa, hfe, kfe = q_leg
    side = model.leg_side_sign(leg)
    c, s = np.cos(haa), np.sin(haa)
    rx = np.array([[1.0, 0, 0], [0, c, -s], [0, s, c]])
    hip_mount = np.asarray(model.HIP_OFFSETS[leg], np.float64)

    def sagittal(r_thigh, r_shank):
        x_p = -r_thigh * np.sin(hfe) - r_shank * np.sin(hfe + kfe)
        z_p = -r_thigh * np.cos(hfe) - r_shank * np.cos(hfe + kfe)
        return np.array([x_p, side * model.HIP_LATERAL, z_p])

    p_hip = hip_mount
    p_thigh = hip_mount + rx @ sagittal(0.5 * model.THIGH_LENGTH, 0.0)
    p_shank = hip_mount + rx @ sagittal(model.THIGH_LENGTH, 0.5 * model.SHANK_LENGTH)
    return p_hip, p_thigh, p_shank


def _base_inertia(masses: MassModel) -> np.ndarray:
    q_nom = np.asarray(model.DEFAULT_JOINTS, np.float64).reshape(NUM_LEGS, 3)
    leg_inertia = np.zeros(3)
    for leg in range(NUM_LEGS):
        coms = _leg_link_coms_np(leg, q_nom[leg])
        for m_i, c in zip((masses.hip, masses.thigh, masses.shank), coms):
            # Point-mass inertia about the base origin (diagonal part).
            leg_inertia += m_i * (np.sum(c * c) - c * c)
    return np.maximum(np.asarray(INERTIA, np.float64) - leg_inertia, 1e-3).astype(
        np.float32
    )


def _omega_body(euler: Array, deuler: Array) -> Array:
    """ZYX euler rates -> body angular velocity (inverse of
    euler_zyx_rate_matrix)."""
    return jnp.linalg.solve(euler_zyx_rate_matrix(euler), deuler)


def _link_points(z: Array, masses: MassModel):
    """World positions and masses of all point-mass links (base CoM at the
    base origin + 12 leg-link CoMs), as a function of z."""
    p_base, euler, q = z[0:3], z[3:6], z[6:18].reshape(NUM_LEGS, 3)
    r_wb = euler_zyx_rotation(euler)
    ps = [p_base]
    ms = [masses.base]
    for leg in range(NUM_LEGS):
        for m_i, c in zip(
            (masses.hip, masses.thigh, masses.shank),
            _leg_link_coms_base(leg, q[leg]),
        ):
            ps.append(p_base + r_wb @ c)
            ms.append(m_i)
    return jnp.stack(ps), jnp.asarray(ms, z.dtype)


def _kinetic_energy(z: Array, zdot: Array, masses: MassModel, ib: Array) -> Array:
    # Translational KE of the point-mass links: v_i = (d p_i/d z) zdot.
    _, vs = jax.jvp(lambda zz: _link_points(zz, masses)[0], (z,), (zdot,))
    _, m_arr = _link_points(z, masses)
    ke_lin = 0.5 * jnp.sum(m_arr * jnp.sum(vs * vs, axis=-1))
    # Rotational KE of the base body.
    w = _omega_body(z[3:6], zdot[3:6])
    return ke_lin + 0.5 * jnp.dot(w, ib * w)


def _potential_energy(z: Array, masses: MassModel) -> Array:
    ps, m_arr = _link_points(z, masses)
    return GRAVITY * jnp.sum(m_arr * ps[:, 2])


def _contact_generalized_force(z: Array, forces: Array) -> Array:
    """Q = sum_f J_foot(z)' f_f via the virtual-work gradient
    (reference computeExternalForcesInBaseFrame, ComKinoSystemDynamicsAd.cpp;
    forces in the WORLD frame as everywhere in this repo)."""

    def work(zz):
        p_base, euler, q = zz[0:3], zz[3:6], zz[6:18].reshape(NUM_LEGS, 3)
        r_wb = euler_zyx_rotation(euler)
        feet = jnp.stack(
            [
                p_base + r_wb @ model.foot_position_base(leg, q[leg])
                for leg in range(NUM_LEGS)
            ]
        )
        return jnp.sum(feet * forces)

    return jax.grad(work)(z)


def base_acceleration(
    z: Array,
    zdot: Array,
    forces: Array,
    masses: MassModel = DEFAULT_MASSES,
    external_force_world=None,
    external_torque_base=None,
) -> Array:
    """zdd_base (6): [p_base_dd (world), euler_dd] from the top-6 rows of the
    full rigid-body dynamics with ddq = 0 (QuadrupedCom.cpp:64-115)."""
    ib = jnp.asarray(_base_inertia(masses))
    ke = lambda zz, zd: _kinetic_energy(zz, zd, masses, ib)  # noqa: E731

    momentum = jax.grad(ke, argnums=1)  # p_mom(z, zdot), linear in zdot
    m_full = jax.jacfwd(momentum, argnums=1)(z, zdot)  # [18, 18]
    # bias = (d p_mom / d z) zdot - dKE/dz + dPE/dz.
    _, dp_dz_zdot = jax.jvp(lambda zz: momentum(zz, zdot), (z,), (zdot,))
    bias = (
        dp_dz_zdot
        - jax.grad(ke, argnums=0)(z, zdot)
        + jax.grad(lambda zz: _potential_energy(zz, masses))(z)
    )
    rhs = _contact_generalized_force(z, forces) - bias
    if external_force_world is not None:
        # Generalized force of a world wrench at the base origin: the
        # position rows take it directly (computeExternalForcesInBaseFrame).
        rhs = rhs.at[0:3].add(jnp.asarray(external_force_world))
    if external_torque_base is not None:
        # Base torque -> euler-rate generalized coordinates: Q_euler =
        # E(euler)^{-T} tau_body (virtual work through w_body = W deuler).
        w_of_deuler = jax.jacfwd(lambda de: _omega_body(z[3:6], de))(
            jnp.zeros(3, z.dtype)
        )
        rhs = rhs.at[3:6].add(w_of_deuler.T @ jnp.asarray(external_torque_base))
    # ddq = 0: the joint columns drop out of the top-6 equations.
    m66 = m_full[:6, :6]
    return jnp.linalg.solve(
        m66 + 1e-9 * jnp.eye(6, dtype=z.dtype), rhs[:6]
    )


def _state_to_z(x: Array):
    """State -> (z, zdot).  x[3:6] stores INERTIA*w_body/MASS (see module
    docstring); euler rates follow from the rate matrix."""
    euler = base_euler(x)
    w_body = MASS * x[3:6] / jnp.asarray(INERTIA)
    deuler = euler_zyx_rate_matrix(euler) @ w_body
    z = jnp.concatenate([base_position(x), euler, joint_angles(x)])
    return z, w_body, deuler


def dynamics(t, x, u, p, masses: MassModel = DEFAULT_MASSES):
    """ComKino flow map on the 24/24 centroidal layout
    (ComKinoSystemDynamicsAd::systemFlowMap).

    Optional disturbance parameters (the reference's
    ComKinoDynamicsParameters / DynamicsParametersSynchronizedModule:
    externalForceInOrigin + externalTorqueInBase):
      p["external_force_world"]  [3] N   applied at the base origin,
      p["external_torque_base"]  [3] Nm  in the base frame.
    """
    del t
    z, w_body, deuler = _state_to_z(x)
    dq = joint_velocities(u)
    zdot = jnp.concatenate([x[0:3], deuler, dq])
    zdd_base = base_acceleration(
        z, zdot, contact_forces(u), masses,
        external_force_world=(
            p.get("external_force_world") if isinstance(p, dict) else None
        ),
        external_torque_base=(
            p.get("external_torque_base") if isinstance(p, dict) else None
        ),
    )
    # d/dt (I w_body / m): w_body = W(euler) deuler; chain rule via jvp.
    _, dw_body = jax.jvp(
        lambda e, de: _omega_body(e, de),
        (z[3:6], zdot[3:6]),
        (zdot[3:6], zdd_base[3:6]),
    )
    dh_n = jnp.asarray(INERTIA) * dw_body / MASS
    return jnp.concatenate([zdd_base[0:3], dh_n, x[0:3], deuler, dq])


def mass_matrix(x: Array, masses: MassModel = DEFAULT_MASSES) -> Array:
    """Full 18x18 generalized mass matrix M(z) (CRBA analogue) — exposed for
    tests and torque approximation."""
    z, _, _ = _state_to_z(x)
    ib = jnp.asarray(_base_inertia(masses))
    return jax.hessian(lambda zd: _kinetic_energy(z, zd, masses, ib))(
        jnp.zeros(NZ, x.dtype)
    )
