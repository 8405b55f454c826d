"""Self-collision avoidance via sphere approximation.

JAX-native re-design of the reference's collision stack: the sphere
decomposition of link geometry (ocs2_pinocchio/ocs2_sphere_approximation/
PinocchioSphereInterface.h, SphereApproximation.h, PinocchioSphereKinematics.h)
and the distance-based self-collision constraint (ocs2_self_collision/
SelfCollision.h, SelfCollisionConstraint.h:44).  The reference's hpp-fcl
mesh-distance path has no analogue here by design — sphere sets are the
batched, differentiable representation that maps onto vectorized device
code: all pairwise distances are one [P] gather + norm, vmapped over
horizon nodes.

A ``SphereModel`` attaches spheres to kinematic frames; given batched frame
poses the pairwise signed distances are

    d_ij = ||c_i - c_j|| - (r_i + r_j)   >= min_distance.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


class SphereModel(NamedTuple):
    """Sphere decomposition attached to frames.

    frame_idx: [S] int32 — owning frame of each sphere.
    offsets:   [S, 3]    — sphere center in the frame.
    radii:     [S]
    pairs:     [P, 2] int32 — sphere index pairs to check (collision pairs
               between different links; same-link pairs are excluded, like the
               reference's geometry collision-pair list).
    """

    frame_idx: Array
    offsets: Array
    radii: Array
    pairs: Array

    @staticmethod
    def create(spheres: Sequence[Tuple[int, Sequence[float], float]],
               pair_frames: Sequence[Tuple[int, int]]):
        """spheres: list of (frame, offset, radius); pair_frames: frame pairs
        to monitor (expanded to all sphere pairs across those frames)."""
        frame_idx = np.asarray([s[0] for s in spheres], np.int32)
        offsets = np.asarray([s[1] for s in spheres], np.float32)
        radii = np.asarray([s[2] for s in spheres], np.float32)
        pairs = []
        for fa, fb in pair_frames:
            ia = np.nonzero(frame_idx == fa)[0]
            ib = np.nonzero(frame_idx == fb)[0]
            for a in ia:
                for b in ib:
                    pairs.append((a, b))
        # NUMPY leaves: SphereModels live at module level and are captured
        # by jitted constraint closures; numpy constants bake into the
        # compiled program as literals.
        return SphereModel(
            frame_idx=frame_idx,
            offsets=offsets,
            radii=radii,
            pairs=np.asarray(pairs, np.int32).reshape(-1, 2),
        )

    def centers(self, frame_rots: Array, frame_pos: Array) -> Array:
        """World sphere centers given frame poses ([F,3,3], [F,3]) -> [S,3]."""
        rot = frame_rots[self.frame_idx]
        pos = frame_pos[self.frame_idx]
        return pos + jnp.einsum("sij,sj->si", rot, self.offsets)

    def distances(self, frame_rots: Array, frame_pos: Array) -> Array:
        """Pairwise signed distances [P] (SelfCollision::getValue analogue)."""
        c = self.centers(frame_rots, frame_pos)
        ca = c[self.pairs[:, 0]]
        cb = c[self.pairs[:, 1]]
        ra = self.radii[self.pairs[:, 0]]
        rb = self.radii[self.pairs[:, 1]]
        # Smooth-safe norm: keeps gradients finite at coincident centers.
        gap = ca - cb
        dist = jnp.sqrt(jnp.sum(gap * gap, axis=-1) + 1e-12)
        return dist - (ra + rb)


def self_collision_constraint(
    model: SphereModel,
    forward_kinematics: Callable[[Array], Tuple[Array, Array]],
    min_distance: float = 0.0,
):
    """State inequality term h(t,x,p) = d(x) - min_distance >= 0
    (reference SelfCollisionConstraint.h:44).  ``forward_kinematics(x)``
    returns ([F,3,3], [F,3]) frame poses — typically models/kinematics.Chain
    or the legged-robot FK."""

    def constraint(t, x, p):
        rots, pos = forward_kinematics(x)
        return model.distances(rots, pos) - min_distance

    return constraint
