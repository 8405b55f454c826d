"""Perceptive locomotion: terrain models and terrain-aware foot constraints.

JAX-native re-design of the reference perceptive-anymal terrain stack
(ocs2_robotic_examples/ocs2_perceptive_anymal/ocs2_switched_model_interface/
include/ocs2_switched_model_interface/terrain/TerrainModel.h — TerrainPlane,
getLocalTerrainAtPositionInWorldAlongGravity, getSignedDistanceField — and
segmented_planes_terrain_model/SegmentedPlanesTerrainModel.h:15, which fits
local planes to elevation-map segments for foothold constraints).

Design: the terrain is a dense elevation grid (exactly what an onboard
elevation-mapping pipeline produces).  Local terrain planes come from a
least-squares plane fit over a fixed window around the query — the
plane-segmentation analogue, but computed as a closed-form 3x3 solve per
query, jittable and vmappable over feet x nodes x scenarios.  All queries
are gathers + small dense math.

The constraint set it feeds (stance-on-terrain, terrain-normal friction
cone, swing clearance over terrain) mirrors the reference's foot placement
and friction cone costs (FootPlacementCost / FrictionConeCost of
ocs2_switched_model_interface).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ...ops.smallmat import solve_psd_small
from ..perceptive import SignedDistanceField, bilinear_interpolate, signed_distance_field
from . import model
from .gait import contact_flags
from .model import NUM_LEGS, contact_forces, foot_positions_world

Array = jax.Array


class TerrainPlane(NamedTuple):
    """Local terrain plane (reference TerrainPlane): a point on the plane
    and the (unit, upward) surface normal, world frame."""

    point: Array  # [3]
    normal: Array  # [3]


class ElevationMap(NamedTuple):
    """Dense elevation grid: heights [H, W] with world xy origin of cell
    (0, 0) and square cell resolution (the elevation-mapping product the
    reference's SegmentedPlanesTerrainModel consumes)."""

    heights: Array
    origin_xy: Array  # [2]
    resolution: Array  # []

    @staticmethod
    def create(heights, origin_xy=(0.0, 0.0), resolution=0.05):
        return ElevationMap(
            heights=jnp.asarray(heights, jnp.float32),
            origin_xy=jnp.asarray(origin_xy, jnp.float32),
            resolution=jnp.asarray(resolution, jnp.float32),
        )

    @staticmethod
    def flat(height=0.0, extent=4.0, resolution=0.05):
        n = int(extent / resolution)
        return ElevationMap.create(
            np.full((n, n), height, np.float32),
            origin_xy=(-extent / 2, -extent / 2),
            resolution=resolution,
        )

    def height_at(self, xy: Array) -> Array:
        """Bilinear terrain height at world xy."""
        idx = (xy - self.origin_xy) / self.resolution
        return bilinear_interpolate(self.heights, idx)

    def plane_at(self, xy: Array, window: int = 5) -> TerrainPlane:
        """Local terrain plane via least-squares fit over a window x window
        patch centered at xy (the reference's segmented-plane fit,
        SegmentedPlanesTerrainModel::getLocalTerrainAtPositionInWorld)."""
        res = self.resolution
        h, w = self.heights.shape
        half = window // 2
        idx = (xy - self.origin_xy) / res
        c = jnp.clip(
            jnp.floor(idx).astype(jnp.int32) - half,
            0,
            jnp.asarray([h - window, w - window], jnp.int32),
        )
        patch = jax.lax.dynamic_slice(self.heights, (c[0], c[1]), (window, window))
        # Cell-center world coordinates of the patch.
        ii = (c[0] + jnp.arange(window, dtype=jnp.float32)) * res + self.origin_xy[0]
        jj = (c[1] + jnp.arange(window, dtype=jnp.float32)) * res + self.origin_xy[1]
        xs = jnp.broadcast_to(ii[:, None], (window, window)).ravel()
        ys = jnp.broadcast_to(jj[None, :], (window, window)).ravel()
        zs = patch.ravel()
        # Fit z = a x + b y + c: 3x3 SPD normal equations (closed form).
        one = jnp.ones_like(xs)
        basis = jnp.stack([xs, ys, one])  # [3, M]
        ata = basis @ basis.T + 1e-6 * jnp.eye(3)
        atz = basis @ zs
        coef = solve_psd_small(ata, atz[:, None])[:, 0]
        a, b, cc = coef[0], coef[1], coef[2]
        normal = jnp.array([-a, -b, 1.0])
        normal = normal / jnp.linalg.norm(normal)
        z_fit = a * xy[0] + b * xy[1] + cc
        return TerrainPlane(
            point=jnp.array([xy[0], xy[1], z_fit]), normal=normal
        )

    def sdf(
        self, z_min: float, z_max: float, z_resolution: Optional[float] = None
    ) -> SignedDistanceField:
        """3-D SDF of the solid below the surface (reference
        SegmentedPlanesTerrainModel::getSignedDistanceField /
        PlanarSignedDistanceField): occupancy = cells under the elevation,
        then an exact Euclidean distance transform."""
        zres = self.resolution if z_resolution is None else jnp.asarray(z_resolution)
        nz = int(np.ceil((z_max - z_min) / float(zres)))
        z_centers = z_min + (jnp.arange(nz) + 0.5) * zres
        occ = self.heights[:, :, None] > z_centers[None, None, :]
        return signed_distance_field(
            occ,
            jnp.concatenate([self.origin_xy, jnp.asarray([z_min + 0.5 * float(zres)])]),
            float(self.resolution),
        )


# -- terrain-aware legged constraints ----------------------------------------


def stance_on_terrain(terrain: ElevationMap):
    """[4] state equality: stance feet lie ON the terrain surface,
    c * (z_foot - h(xy_foot)) = 0 (reference FootPlacementCost /
    foothold constraint along the local plane)."""

    def g(t, x, p):
        del t
        c = contact_flags(p["mode"])
        feet = foot_positions_world(x)
        h = jax.vmap(terrain.height_at)(feet[:, :2])
        return c * (feet[:, 2] - h)

    return g


def swing_clearance_over_terrain(terrain: ElevationMap, swing_tracking: bool = True):
    """[4] state term: swing feet track the planned height profile RELATIVE
    to the terrain under the foot, (1-c) * ((z_foot - h(xy)) - z_ref)
    (reference swing trajectory over local terrain)."""

    def g(t, x, p):
        del t
        c = contact_flags(p["mode"])
        feet = foot_positions_world(x)
        h = jax.vmap(terrain.height_at)(feet[:, :2])
        z_ref = p["swing_z"][p["node"]] if swing_tracking else 0.0
        return (1.0 - c) * (feet[:, 2] - h - z_ref)

    return g


def terrain_friction_cone(
    terrain: ElevationMap, mu: float = 0.7, cone_eps: float = 5.0
):
    """[4] inequality: friction cone about the LOCAL terrain normal from the
    plane fit (reference FrictionConeCost with the rotated cone,
    ocs2_switched_model_interface friction cone on TerrainPlane)."""

    def h(t, x, u, p):
        del t
        c = contact_flags(p["mode"])
        feet = foot_positions_world(x)
        f = contact_forces(u)

        def per_leg(xy, fi):
            plane = terrain.plane_at(xy)
            fn = jnp.dot(plane.normal, fi)
            ft = fi - fn * plane.normal
            return mu * fn - jnp.sqrt(jnp.dot(ft, ft) + cone_eps)

        cone = jax.vmap(per_leg)(feet[:, :2], f)
        return c * cone + (1.0 - c) * 1.0

    return h


def make_perceptive_problem(
    terrain: ElevationMap,
    friction_mu: float = 0.7,
    stance_weight: float = 4000.0,
    swing_weight: float = 100.0,
):
    """Assemble the perceptive legged OCP: the flagship problem's base
    tracking + merged foot constraint, with the flat-ground swing/cone terms
    replaced by their terrain-aware forms (reference perceptive-anymal
    problem assembly, QuadrupedInterface.h:27)."""
    import numpy as onp

    from ...core import penalties as pen
    from ...oc.problem import (
        OptimalControlProblem,
        quadratic_cost,
        quadratic_final_cost,
        soft_constraint,
    )
    from . import constraints as con
    from .interface import Q_DIAG, R_MAT

    problem = OptimalControlProblem(
        dynamics=model.dynamics,
        cost_terms=(
            quadratic_cost(onp.diag(Q_DIAG), R_MAT),
            con.make_friction_cone_soft(),  # flat-cone fallback kept active
            soft_constraint(
                terrain_friction_cone(terrain, friction_mu),
                pen.relaxed_barrier(mu=1e-2, delta=1.0),
            ),
        ),
        final_cost_terms=(quadratic_final_cost(10.0 * onp.diag(Q_DIAG[:24])),),
        equality_terms=(con.foot_constraint,),
        state_cost_terms=(
            soft_constraint(
                stance_on_terrain(terrain),
                pen.quadratic(scale=2.0 * stance_weight),
                with_input=False,
            ),
            soft_constraint(
                swing_clearance_over_terrain(terrain),
                pen.quadratic(scale=2.0 * swing_weight),
                with_input=False,
            ),
        ),
        nx=24,
        nu=24,
    )
    return problem
