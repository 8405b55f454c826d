"""Segmented-planes terrain model: convex planar decomposition of the
elevation map, foothold-to-segment projection, and the tangential/normal
foothold constraints.

JAX-native re-design of the reference perceptive-anymal production terrain
pipeline:
* plane decomposition + per-segment planes:
  segmented_planes_terrain_model/SegmentedPlanesTerrainModel.h:15 (consumes
  convex_plane_decomposition::PlanarTerrain — regions with a plane and a
  convex boundary polygon),
* convex polygon projection: ocs2_switched_model_interface/terrain/
  ConvexTerrain.h (projectToConvex2dPolygonBoundary / projectToConvex3dPolygon),
* tangential foothold constraint: foot_planner/FootPhase.h
  tangentialConstraintsFromConvexTerrain (A_p * p_world + b >= 0),
* normal constraint: constraint/FootNormalConstraint.h (hybrid
  A_p*position + A_v*velocity + b = 0 along the local surface normal).

Architecture split (mirrors the reference): the DECOMPOSITION runs on the
host once per elevation-map update (the reference runs an external CPU
library for this), producing FIXED-SHAPE arrays — K segments with padded
V-vertex convex boundaries.  All QUERIES (closest segment, polygon
projection, signed tangential distance) are jittable gather + small dense
math over those arrays: vmappable over feet x nodes x scenarios.  Padding is inert: invalid segments carry +inf distance,
padded vertices repeat the last real vertex (zero-length edges contribute
no new candidates).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .terrain import ElevationMap, TerrainPlane

Array = jax.Array

_BIG = 1e6


class SegmentedPlanesTerrain(NamedTuple):
    """K fitted planes with convex boundary polygons (fixed shapes).

    plane_point:  [K, 3] a point on each plane (world).
    plane_normal: [K, 3] unit upward normal (world).
    tangent1/2:   [K, 3] plane-frame tangent basis (world).
    boundary:     [K, V, 2] convex polygon vertices CCW in the plane's
                  tangent frame, padded by repeating the last vertex.
    num_vertices: [K] int32 true vertex counts.
    valid:        [K] bool, segment slot in use.
    """

    plane_point: Array
    plane_normal: Array
    tangent1: Array
    tangent2: Array
    boundary: Array
    num_vertices: Array
    valid: Array

    @property
    def num_segments(self) -> int:
        return self.plane_point.shape[0]

    def plane(self, k) -> TerrainPlane:
        return TerrainPlane(point=self.plane_point[k], normal=self.plane_normal[k])


# ---------------------------------------------------------------------------
# Host-side decomposition (per elevation-map update).
# ---------------------------------------------------------------------------


def _plane_basis_np(normal: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Orthonormal tangents for a unit normal (world frame)."""
    ref = np.array([1.0, 0.0, 0.0]) if abs(normal[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    t1 = np.cross(normal, ref)
    t1 /= np.linalg.norm(t1)
    t2 = np.cross(normal, t1)
    return t1, t2


def _fit_plane_np(pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """LS plane through [M, 3] points -> (point, unit upward normal)."""
    c = pts.mean(axis=0)
    q = pts - c
    # Smallest singular vector of the centered cloud = normal.
    _, _, vt = np.linalg.svd(q, full_matrices=False)
    n = vt[-1]
    if n[2] < 0:
        n = -n
    return c, n / np.linalg.norm(n)


def _cross2(a: np.ndarray, b: np.ndarray) -> float:
    """2D scalar cross product (np.cross on 2D vectors is removed in
    NumPy >= 2.0)."""
    return a[0] * b[1] - a[1] * b[0]


def _convex_hull_2d(pts: np.ndarray) -> np.ndarray:
    """Andrew monotone chain, CCW [M, 2] -> hull [H, 2]."""
    pts = np.unique(np.round(pts, 9), axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(points):
        out = []
        for p in points:
            while len(out) >= 2 and _cross2(out[-1] - out[-2], p - out[-2]) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def _simplify_hull(hull: np.ndarray, max_vertices: int) -> np.ndarray:
    """Reduce a CCW hull to <= max_vertices by iteratively dropping the
    vertex whose removal loses the least area (keeps the polygon convex and
    inscribed — conservative for a containment constraint)."""
    hull = hull.copy()
    while len(hull) > max_vertices:
        n = len(hull)
        losses = np.empty(n)
        for i in range(n):
            a, b, c = hull[i - 1], hull[i], hull[(i + 1) % n]
            losses[i] = abs(_cross2(b - a, c - a)) * 0.5
        hull = np.delete(hull, int(np.argmin(losses)), axis=0)
    return hull


def _shrink_polygon(hull: np.ndarray, margin: float) -> np.ndarray:
    """Pull each vertex toward the centroid by `margin` (the reference's
    terrainMargin shrink of the convex constraint region — approximate but
    conservative for near-regular cells)."""
    if margin <= 0.0 or len(hull) < 3:
        return hull
    c = hull.mean(axis=0)
    d = hull - c
    norms = np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
    return c + d * np.maximum(1.0 - margin / norms, 0.1)


def decompose_planes(
    em: ElevationMap,
    max_segments: int = 16,
    max_vertices: int = 12,
    max_slope_deg: float = 35.0,
    inlier_tol: float = 0.02,
    min_cells: int = 9,
    margin: float = 0.0,
) -> SegmentedPlanesTerrain:
    """Convex planar decomposition of the elevation map (host, numpy; run
    once per map update like the reference's convex_plane_decomposition).

    Steps: cell normals by central differences -> slope + roughness gate ->
    connected components (4-neighborhood) -> per-component LS plane fit with
    one inlier re-fit -> convex hull of inlier cells in the plane tangent
    frame, simplified to <= max_vertices.  Components ranked by area; the
    top max_segments fill the fixed slots.
    """
    from scipy import ndimage

    h = np.asarray(em.heights, np.float64)
    res = float(em.resolution)
    origin = np.asarray(em.origin_xy, np.float64)
    H, W = h.shape

    # Cell-centered gradients -> normals; edge cells use one-sided diffs.
    gx, gy = np.gradient(h, res)
    slope_ok = np.hypot(gx, gy) < np.tan(np.deg2rad(max_slope_deg))
    # Roughness gate: local curvature (Laplacian) must be small — removes
    # step edges that have locally small gradient but are not planar.
    lap = np.abs(ndimage.laplace(h)) / res
    rough_ok = lap < 4.0 * inlier_tol / res
    mask = slope_ok & rough_ok

    labels, n_comp = ndimage.label(mask, structure=np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]]))
    # World xy of cell centers: heights[i, j] lives at origin + (i, j)*res.
    ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    xs = origin[0] + ii * res
    ys = origin[1] + jj * res

    comps = []
    for c in range(1, n_comp + 1):
        sel = labels == c
        if sel.sum() < min_cells:
            continue
        pts = np.stack([xs[sel], ys[sel], h[sel]], axis=1)
        point, normal = _fit_plane_np(pts)
        # One inlier re-fit (the reference library's region refinement).
        d = np.abs((pts - point) @ normal)
        inl = d < max(inlier_tol, 1.5 * np.median(d) + 1e-9)
        if inl.sum() >= min_cells:
            point, normal = _fit_plane_np(pts[inl])
            pts = pts[inl]
        t1, t2 = _plane_basis_np(normal)
        uv = np.stack([(pts - point) @ t1, (pts - point) @ t2], axis=1)
        hull = _convex_hull_2d(uv)
        if len(hull) < 3:
            continue
        hull = _shrink_polygon(_simplify_hull(hull, max_vertices), margin)
        comps.append((sel.sum(), point, normal, t1, t2, hull))

    comps.sort(key=lambda t: -t[0])
    comps = comps[:max_segments]

    K, V = max_segments, max_vertices
    plane_point = np.zeros((K, 3), np.float32)
    plane_normal = np.tile(np.array([0, 0, 1.0], np.float32), (K, 1))
    tangent1 = np.tile(np.array([1.0, 0, 0], np.float32), (K, 1))
    tangent2 = np.tile(np.array([0, 1.0, 0], np.float32), (K, 1))
    boundary = np.zeros((K, V, 2), np.float32)
    num_vertices = np.zeros((K,), np.int32)
    valid = np.zeros((K,), bool)
    for k, (_, point, normal, t1, t2, hull) in enumerate(comps):
        nv = len(hull)
        plane_point[k] = point
        plane_normal[k] = normal
        tangent1[k] = t1
        tangent2[k] = t2
        boundary[k, :nv] = hull
        boundary[k, nv:] = hull[-1]  # pad: repeated vertex = zero-length edges
        num_vertices[k] = nv
        valid[k] = True

    return SegmentedPlanesTerrain(
        plane_point=jnp.asarray(plane_point),
        plane_normal=jnp.asarray(plane_normal),
        tangent1=jnp.asarray(tangent1),
        tangent2=jnp.asarray(tangent2),
        boundary=jnp.asarray(boundary),
        num_vertices=jnp.asarray(num_vertices),
        valid=jnp.asarray(valid),
    )


# ---------------------------------------------------------------------------
# Jittable queries (device; vmapped over feet x nodes x scenarios).
# ---------------------------------------------------------------------------


def project_to_polygon_2d(boundary: Array, num_vertices: Array, p: Array):
    """Project a 2D point onto a CCW convex polygon boundary (reference
    ConvexTerrain.h projectToConvex2dPolygonBoundary) with padded vertices.

    Returns (signed_sq_dist, image): negative inside, positive outside;
    image = closest boundary point.
    """
    v = boundary  # [V, 2]
    nv = num_vertices
    V = v.shape[0]
    idx = jnp.arange(V)
    nxt = jnp.where(idx + 1 >= nv, 0, idx + 1)
    p1 = v
    p2 = v[nxt]
    edge_real = idx < nv

    p12 = p2 - p1  # [V, 2]
    len2 = jnp.sum(p12 * p12, axis=1)
    r = jnp.sum(p12 * (p[None, :] - p1), axis=1) / jnp.maximum(len2, 1e-12)
    rc = jnp.clip(r, 0.0, 1.0)
    q = p1 + rc[:, None] * p12  # closest point per edge
    d2 = jnp.sum((p[None, :] - q) ** 2, axis=1)
    d2 = jnp.where(edge_real, d2, _BIG)
    best = jnp.argmin(d2)
    # Inside test: CCW polygon, point is inside iff left of every real edge.
    cross = p12[:, 0] * (p[1] - p1[:, 1]) - p12[:, 1] * (p[0] - p1[:, 0])
    inside = jnp.all(jnp.where(edge_real, cross >= 0.0, True))
    sq = jnp.where(inside, -d2[best], d2[best])
    return sq, q[best]


def project_to_segment(terr: SegmentedPlanesTerrain, k: Array, p_world: Array) -> Array:
    """Project a world point onto segment k's convex polygon in 3D
    (reference projectToConvex3dPolygon): plane projection, then polygon
    clamp in the tangent frame."""
    point = terr.plane_point[k]
    n = terr.plane_normal[k]
    t1 = terr.tangent1[k]
    t2 = terr.tangent2[k]
    rel = p_world - point
    uv = jnp.array([jnp.dot(rel, t1), jnp.dot(rel, t2)])
    sq, img = project_to_polygon_2d(terr.boundary[k], terr.num_vertices[k], uv)
    uv_in = jnp.where(sq <= 0.0, uv, img)
    return point + uv_in[0] * t1 + uv_in[1] * t2


def segment_distances(terr: SegmentedPlanesTerrain, p_world: Array) -> Array:
    """[K] squared distance from a world point to each segment's polygon
    (projected 3D point), +BIG for invalid slots."""

    def per_seg(k):
        proj = project_to_segment(terr, k, p_world)
        return jnp.sum((p_world - proj) ** 2)

    d2 = jax.vmap(per_seg)(jnp.arange(terr.num_segments))
    return jnp.where(terr.valid, d2, _BIG)


def closest_segment(
    terr: SegmentedPlanesTerrain, p_world: Array, penalty: Optional[Array] = None
):
    """(segment id, projected point) minimizing distance^2 + penalty[k]
    (reference getConvexTerrainAtPositionInWorld with its penaltyFunction —
    e.g. leg over-extension scoring, SwingTrajectoryPlanner
    selectNominalFootholdTerrain)."""
    score = segment_distances(terr, p_world)
    if penalty is not None:
        score = score + jnp.where(terr.valid, penalty, 0.0)
    k = jnp.argmin(score)
    return k, project_to_segment(terr, k, p_world)


def tangential_constraint(
    terr: SegmentedPlanesTerrain, k: Array, margin: float = 0.0
):
    """Linear world-frame inequalities A @ p_world + b >= 0 keeping the foot
    inside segment k's polygon (reference
    tangentialConstraintsFromConvexTerrain, FootPhase.h): one row per
    boundary edge; padded edges yield inert rows (0 @ p + BIG >= 0).
    ``margin`` shrinks the feasible region by a normal offset per edge
    (reference terrainMargin) — same semantics as the host mirror
    ``foothold_planner._tangential_rows_np``.

    Returns (A [V, 3], b [V]).
    """
    point = terr.plane_point[k]
    t1 = terr.tangent1[k]
    t2 = terr.tangent2[k]
    v = terr.boundary[k]
    nv = terr.num_vertices[k]
    V = v.shape[0]
    idx = jnp.arange(V)
    nxt = jnp.where(idx + 1 >= nv, 0, idx + 1)
    p1, p2 = v, v[nxt]
    e = p2 - p1  # [V, 2] CCW edges
    # Inward normal of a CCW edge in 2D: (-e_y, e_x), normalized.
    en = jnp.stack([-e[:, 1], e[:, 0]], axis=1)
    en = en / jnp.maximum(jnp.linalg.norm(en, axis=1, keepdims=True), 1e-9)
    # World-frame row: n_world = en_u * t1 + en_v * t2 (constraint is
    # invariant along the plane normal).
    A = en[:, 0:1] * t1[None, :] + en[:, 1:2] * t2[None, :]  # [V, 3]
    b = (
        -jnp.sum(A * (point[None, :] + p1[:, 0:1] * t1 + p1[:, 1:2] * t2), axis=1)
        - margin
    )
    real = idx < nv
    A = jnp.where(real[:, None], A, 0.0)
    b = jnp.where(real, b, _BIG)
    return A, b
