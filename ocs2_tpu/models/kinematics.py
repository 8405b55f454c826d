"""Differentiable rigid-body kinematics: serial chains and trees in JAX.

JAX-native replacement for the reference's Pinocchio layer
(ocs2_pinocchio/ocs2_pinocchio_interface/PinocchioInterface.h:60,
PinocchioEndEffectorKinematics.h) for the kinematic queries the MPC stack
needs: forward kinematics of end-effector frames and their Jacobians.  A
chain is a static description (pytree of constants); FK is a pure jittable
function; Jacobians come from ``jax.jacfwd`` (replacing both Pinocchio's
analytic derivatives and the CppAd codegen variants).

Revolute/prismatic joints about arbitrary axes with full URDF-style origins
(xyz translation + rpy rotation) are supported; principal-axis joints take a
cheaper closed-form rotation.  Chains are extracted from URDF trees by
models/urdf.py (the reference's urdf.h front door).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

_AXES = {"x": 0, "y": 1, "z": 2}


def rot_axis(axis: int, angle):
    """Rotation matrix about principal axis (0=x, 1=y, 2=z)."""
    c, s = jnp.cos(angle), jnp.sin(angle)
    if axis == 0:
        return jnp.array([[1.0, 0, 0], [0, c, -s], [0, s, c]])
    if axis == 1:
        return jnp.array([[c, 0, s], [0, 1.0, 0], [-s, 0, c]])
    return jnp.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def rot_any_axis(axis_vec, angle):
    """Rodrigues rotation about a constant unit axis (URDF <axis xyz>)."""
    a = jnp.asarray(axis_vec)
    kx, ky, kz = a[0], a[1], a[2]
    K = jnp.array([[0.0, -kz, ky], [kz, 0.0, -kx], [-ky, kx, 0.0]])
    c, s = jnp.cos(angle), jnp.sin(angle)
    return jnp.eye(3) + s * K + (1.0 - c) * (K @ K)


def rpy_matrix(rpy) -> np.ndarray:
    """URDF origin rpy (fixed-axis XYZ: R = Rz(y) Ry(p) Rx(r)) — host-side."""
    r, p, y = float(rpy[0]), float(rpy[1]), float(rpy[2])
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    ry = np.array([[cp, 0, sp], [0, 1.0, 0], [-sp, 0, cp]])
    rx = np.array([[1.0, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return rz @ ry @ rx


def _axis_spec(axis) -> tuple:
    """Normalize an axis spec: 'x'|'y'|'z' or a 3-vector (possibly negated
    principal).  Returns ("principal", idx, sign) or ("free", unit_vec)."""
    if isinstance(axis, str):
        return ("principal", _AXES[axis], 1.0)
    v = np.asarray(axis, np.float64)
    n = np.linalg.norm(v)
    v = v / (n if n > 0 else 1.0)
    for i in range(3):
        e = np.zeros(3)
        e[i] = 1.0
        if np.allclose(v, e, atol=1e-9):
            return ("principal", i, 1.0)
        if np.allclose(v, -e, atol=1e-9):
            return ("principal", i, -1.0)
    return ("free", tuple(v.tolist()))


@dataclasses.dataclass(frozen=True)
class Joint:
    """One joint: fixed origin (translation + rotation), then motion about
    an axis (URDF joint semantics)."""

    offset: Tuple[float, float, float]  # parent->joint translation (parent frame)
    axis: object = "z"  # "x"|"y"|"z" or a 3-tuple axis vector
    kind: str = "revolute"  # revolute | prismatic | fixed
    # Fixed origin rotation (URDF rpy), row-major 9-tuple; None = identity.
    origin_rot: Optional[Tuple[float, ...]] = None
    name: str = ""

    def _motion_rot(self, angle):
        mode = _axis_spec(self.axis)
        if mode[0] == "principal":
            return rot_axis(mode[1], mode[2] * angle)
        return rot_any_axis(mode[1], angle)

    def _motion_step(self, disp):
        mode = _axis_spec(self.axis)
        if mode[0] == "principal":
            return jnp.zeros(3).at[mode[1]].set(mode[2] * disp)
        return disp * jnp.asarray(mode[1])


@dataclasses.dataclass(frozen=True)
class Chain:
    """Serial kinematic chain ending at an end-effector frame."""

    joints: Tuple[Joint, ...]
    ee_offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ee_rot: Optional[Tuple[float, ...]] = None  # row-major 9-tuple or None

    @property
    def num_dof(self) -> int:
        return sum(1 for j in self.joints if j.kind != "fixed")

    def _advance(self, joint: Joint, rot, pos, q, qi):
        pos = pos + rot @ jnp.asarray(joint.offset)
        if joint.origin_rot is not None:
            rot = rot @ jnp.asarray(joint.origin_rot).reshape(3, 3)
        if joint.kind == "revolute":
            rot = rot @ joint._motion_rot(q[qi])
            qi += 1
        elif joint.kind == "prismatic":
            pos = pos + rot @ joint._motion_step(q[qi])
            qi += 1
        return rot, pos, qi

    def forward(self, q: Array, base_rot=None, base_pos=None):
        """FK: returns (ee position [3], ee rotation [3,3]) in base frame."""
        rot = jnp.eye(3) if base_rot is None else base_rot
        pos = jnp.zeros(3) if base_pos is None else base_pos
        qi = 0
        for joint in self.joints:
            rot, pos, qi = self._advance(joint, rot, pos, q, qi)
        pos = pos + rot @ jnp.asarray(self.ee_offset)
        if self.ee_rot is not None:
            rot = rot @ jnp.asarray(self.ee_rot).reshape(3, 3)
        return pos, rot

    def ee_position(self, q: Array, base_rot=None, base_pos=None) -> Array:
        return self.forward(q, base_rot, base_pos)[0]

    def frame_poses(self, q: Array, base_rot=None, base_pos=None):
        """Poses of every frame along the chain: ([F,3,3], [F,3]) with
        F = num joints + 2 (base frame first, EE frame last) — the FK query
        sphere-approximation collision models consume (reference
        PinocchioSphereKinematics computes sphere centers from frame
        placements)."""
        rot = jnp.eye(3) if base_rot is None else base_rot
        pos = jnp.zeros(3) if base_pos is None else base_pos
        rots, poss = [rot], [pos]
        qi = 0
        for joint in self.joints:
            rot, pos, qi = self._advance(joint, rot, pos, q, qi)
            rots.append(rot)
            poss.append(pos)
        ee_pos = pos + rot @ jnp.asarray(self.ee_offset)
        ee_rot = (
            rot @ jnp.asarray(self.ee_rot).reshape(3, 3)
            if self.ee_rot is not None
            else rot
        )
        rots.append(ee_rot)
        poss.append(ee_pos)
        return jnp.stack(rots), jnp.stack(poss)

    def position_jacobian(self, q: Array) -> Array:
        """d ee_position / d q  [3, ndof] via forward-mode AD (replaces
        Pinocchio computeFrameJacobian / CppAd codegen)."""
        return jax.jacfwd(self.ee_position)(q)


def matrix_to_quaternion(r: Array) -> Array:
    """Rotation matrix -> unit quaternion [x, y, z, w], branch-robust.

    Shepperd's method evaluated on all four branches with the largest pivot
    selected by masking — jit/vmap friendly and AD-safe (every sqrt argument
    is clamped so unselected branches never produce NaN cotangents)."""
    m00, m01, m02 = r[0, 0], r[0, 1], r[0, 2]
    m10, m11, m12 = r[1, 0], r[1, 1], r[1, 2]
    m20, m21, m22 = r[2, 0], r[2, 1], r[2, 2]
    tw = 1.0 + m00 + m11 + m22  # 4 w^2
    tx = 1.0 + m00 - m11 - m22  # 4 x^2
    ty = 1.0 - m00 + m11 - m22  # 4 y^2
    tz = 1.0 - m00 - m11 + m22  # 4 z^2

    def safe_sqrt(v):
        return jnp.sqrt(jnp.maximum(v, 1e-12))

    sw, sx, sy, sz = safe_sqrt(tw), safe_sqrt(tx), safe_sqrt(ty), safe_sqrt(tz)
    # Candidate quaternions (x, y, z, w), one per pivot.
    q_w = jnp.stack([(m21 - m12) / (2 * sw), (m02 - m20) / (2 * sw),
                     (m10 - m01) / (2 * sw), 0.5 * sw])
    q_x = jnp.stack([0.5 * sx, (m01 + m10) / (2 * sx),
                     (m02 + m20) / (2 * sx), (m21 - m12) / (2 * sx)])
    q_y = jnp.stack([(m01 + m10) / (2 * sy), 0.5 * sy,
                     (m12 + m21) / (2 * sy), (m02 - m20) / (2 * sy)])
    q_z = jnp.stack([(m02 + m20) / (2 * sz), (m12 + m21) / (2 * sz),
                     0.5 * sz, (m10 - m01) / (2 * sz)])
    ts = jnp.stack([tw, tx, ty, tz])
    qs = jnp.stack([q_w, q_x, q_y, q_z])
    pick = jnp.argmax(ts)
    q = qs[pick]
    return q / jnp.linalg.norm(q)


def quaternion_distance(q: Array, q_ref: Array) -> Array:
    """Reference quaternionDistance (RotationTransforms.h:51):
    e = q.w * qRef.vec - qRef.w * q.vec + q.vec x qRef.vec — zero iff the
    frames align, magnitude sin(theta/2): well-conditioned at every relative
    angle including pi (where the so(3)-log vee degenerates)."""
    qv, qw = q[:3], q[3]
    rv, rw = q_ref[:3], q_ref[3]
    return qw * rv - rw * qv + jnp.cross(qv, rv)


def rotation_error(r: Array, r_des: Array) -> Array:
    """Orientation error between rotation matrices via the reference's
    quaternion distance (ocs2_robotic_tools RotationTransforms.h:51, used by
    EndEffectorKinematics getOrientationError).  Sign-fixed to the hemisphere
    nearest the target so the error is continuous around identity."""
    q = matrix_to_quaternion(r)
    q_ref = matrix_to_quaternion(r_des)
    q = jnp.where(jnp.dot(q, q_ref) < 0.0, -q, q)
    return quaternion_distance(q, q_ref)
