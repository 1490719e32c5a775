"""Procedural geometry + canonical scenes (port of
pathtrace_tpu/models/procedural.py).

The numpy builders are copied, not imported: importing pathtrace_tpu
imports jax. Conventions: room ~40 units, y up, triangle geometric
normals (cross(E1, E2)) face into the room; the integrator backface-culls
(CudaPrimitive.cuh:99), which lets the camera outside see through the
closed box's front wall.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pathtrace_tpu_torch.core.camera import Camera
from pathtrace_tpu_torch.models.scene import Material, Scene, Spheres, Triangles


def quad(p00, p10, p11, p01, normal) -> np.ndarray:
    """Two triangles covering the quad p00-p10-p11-p01, wound so
    cross(E1, E2) points along `normal`."""
    p00, p10, p11, p01 = [np.asarray(p, np.float32) for p in (p00, p10, p11, p01)]
    tris = np.stack([
        np.stack([p00, p10, p11]),
        np.stack([p00, p11, p01]),
    ])
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    gn = np.cross(e1, e2)
    flip = (gn @ np.asarray(normal, np.float32)) < 0
    tris[flip] = tris[flip][:, ::-1, :]
    return tris


def box(center, half_extents, outward=True) -> np.ndarray:
    """(12,3,3) triangle positions for an axis-aligned box."""
    c = np.asarray(center, np.float32)
    h = np.asarray(half_extents, np.float32)
    lo, hi = c - h, c + h
    sgn = 1.0 if outward else -1.0
    quads = []

    def corners(axis, val, n):
        a, b = [i for i in range(3) if i != axis]
        pts = []
        for (u, v) in [(0, 0), (1, 0), (1, 1), (0, 1)]:
            p = np.empty(3, np.float32)
            p[axis] = val
            p[a] = lo[a] if u == 0 else hi[a]
            p[b] = lo[b] if v == 0 else hi[b]
            pts.append(p)
        quads.append(quad(*pts, normal=sgn * np.asarray(n, np.float32)))

    corners(0, lo[0], (-1, 0, 0))
    corners(0, hi[0], (1, 0, 0))
    corners(1, lo[1], (0, -1, 0))
    corners(1, hi[1], (0, 1, 0))
    corners(2, lo[2], (0, 0, -1))
    corners(2, hi[2], (0, 0, 1))
    return np.concatenate(quads, axis=0)


def icosphere(radius=1.0, center=(0, 0, 0), subdivisions=3) -> np.ndarray:
    """(T,3,3) triangle positions for a geodesic sphere: 20 * 4**subdivisions
    triangles (6 -> 81,920)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdivisions):
        cache: dict = {}
        verts_list = list(verts)

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = verts_list[i] + verts_list[j]
                m /= np.linalg.norm(m)
                cache[key] = len(verts_list)
                verts_list.append(m)
            return cache[key]

        new_faces = []
        for (a, b, c) in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)
    pos = verts[faces] * radius + np.asarray(center, np.float64)
    return pos.astype(np.float32)


def smooth_sphere_normals(tri_positions, center) -> np.ndarray:
    """Per-vertex normals pointing radially out of `center`."""
    d = tri_positions - np.asarray(center, np.float32)
    return (d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
            ).astype(np.float32)


def flat_normals(tri_positions) -> np.ndarray:
    e1 = tri_positions[:, 1] - tri_positions[:, 0]
    e2 = tri_positions[:, 2] - tri_positions[:, 0]
    gn = np.cross(e1, e2)
    gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-12)
    return np.broadcast_to(gn[:, None, :], tri_positions.shape).astype(np.float32).copy()


# Room geometry mirroring the reference demo: Cornell OBJ at scale 20 with
# the camera at (0,20,60) looking down -z (renderer.cpp:19,102-106).
ROOM_HALF = 20.0
ROOM_LO = np.array([-ROOM_HALF, 0.0, -ROOM_HALF], np.float32)
ROOM_HI = np.array([ROOM_HALF, 2 * ROOM_HALF, ROOM_HALF], np.float32)

WHITE = (0.73, 0.73, 0.73)
RED = (0.65, 0.05, 0.05)
GREEN = (0.12, 0.45, 0.15)
LIGHT_EMIT = (15.0, 11.0, 5.0)


def cornell_walls(light_half=8.0, light_emit=LIGHT_EMIT):
    """Closed Cornell room (inward normals) + ceiling light quad.

    Returns (positions (K,3,3), normals, per-triangle Material)."""
    lo, hi = ROOM_LO, ROOM_HI
    parts, mats = [], []

    def wall(pts, normal, albedo):
        q = quad(*pts, normal=normal)
        parts.append(q)
        mats.append(Material.make(q.shape[0], albedo=albedo, roughness=1.0))

    # floor (y=lo), normal +y
    wall([(lo[0], lo[1], lo[2]), (hi[0], lo[1], lo[2]),
          (hi[0], lo[1], hi[2]), (lo[0], lo[1], hi[2])], (0, 1, 0), WHITE)
    # ceiling (y=hi), normal -y
    wall([(lo[0], hi[1], lo[2]), (hi[0], hi[1], lo[2]),
          (hi[0], hi[1], hi[2]), (lo[0], hi[1], hi[2])], (0, -1, 0), WHITE)
    # back wall (z=lo), normal +z
    wall([(lo[0], lo[1], lo[2]), (hi[0], lo[1], lo[2]),
          (hi[0], hi[1], lo[2]), (lo[0], hi[1], lo[2])], (0, 0, 1), WHITE)
    # front wall (z=hi), normal -z; the camera outside sees through it
    wall([(lo[0], lo[1], hi[2]), (hi[0], lo[1], hi[2]),
          (hi[0], hi[1], hi[2]), (lo[0], hi[1], hi[2])], (0, 0, -1), WHITE)
    # left wall (x=lo) red, normal +x
    wall([(lo[0], lo[1], lo[2]), (lo[0], hi[1], lo[2]),
          (lo[0], hi[1], hi[2]), (lo[0], lo[1], hi[2])], (1, 0, 0), RED)
    # right wall (x=hi) green, normal -x
    wall([(hi[0], lo[1], lo[2]), (hi[0], hi[1], lo[2]),
          (hi[0], hi[1], hi[2]), (hi[0], lo[1], hi[2])], (-1, 0, 0), GREEN)
    # area light just below the ceiling, normal -y
    ly = hi[1] - 0.05
    lh = light_half
    lq = quad((-lh, ly, -lh), (lh, ly, -lh), (lh, ly, lh), (-lh, ly, lh),
              normal=(0, -1, 0))
    parts.append(lq)
    mats.append(Material.make(lq.shape[0], albedo=WHITE, roughness=1.0,
                              emittance=light_emit))

    positions = np.concatenate(parts, axis=0)
    normals = np.concatenate([flat_normals(p) for p in parts], axis=0)
    return positions, normals, Material.stack(mats)


def cornell_box_scene(include_spheres: bool = False,
                      include_boxes: bool = True,
                      light_emit=LIGHT_EMIT) -> Scene:
    """The canonical Cornell box: two diffuse boxes (include_boxes) and/or
    the reference demo's analytic spheres (include_spheres)."""
    positions, normals, mat = cornell_walls(light_emit=light_emit)
    parts_p, parts_n, mats = [positions], [normals], [mat]

    if include_boxes:
        b1 = box((-7.0, 6.0, -6.0), (5.0, 6.0, 5.0))
        b2 = box((7.5, 3.5, 5.0), (4.5, 3.5, 4.5))
        for b in (b1, b2):
            parts_p.append(b)
            parts_n.append(flat_normals(b))
            mats.append(Material.make(b.shape[0], albedo=WHITE, roughness=1.0))

    tris = Triangles.from_vertices(np.concatenate(parts_p, axis=0),
                                   np.concatenate(parts_n, axis=0))
    spheres = reference_demo_spheres() if include_spheres else Spheres.empty()
    return Scene.build(tris, Material.stack(mats), spheres)


def reference_demo_spheres() -> Spheres:
    """The two analytic spheres of renderer.cpp:125-144: r=13 metallic
    (roughness 0.2) at the origin and r=13 transparent (roughness 0.05,
    opacity 0) at (0,39,0)."""
    m1 = Material.make(1, albedo=(1, 1, 1), specular=(0.04, 0.04, 0.04),
                       metallic=1.0, opacity=1.0, roughness=0.2)
    m2 = Material.make(1, albedo=(1, 1, 1), specular=(0.04, 0.04, 0.04),
                       metallic=1.0, opacity=0.0, roughness=0.05)
    return Spheres(
        center=torch.tensor([[0.0, 0.0, 0.0], [0.0, 39.0, 0.0]]),
        radius=torch.tensor([13.0, 13.0]),
        mat=Material.stack([m1, m2]),
    )


def sphere_mesh_scene(subdivisions=4, sphere_material=None,
                      light_emit=LIGHT_EMIT) -> Scene:
    """Cornell room containing one dense triangulated sphere
    (subdivisions=6: ~82k triangles, the multihost1024 preset)."""
    positions, normals, mat = cornell_walls(light_emit=light_emit)
    sph = icosphere(radius=9.0, center=(0.0, 9.0, 0.0), subdivisions=subdivisions)
    sph_n = smooth_sphere_normals(sph, (0.0, 9.0, 0.0))
    if sphere_material is None:
        sphere_material = Material.make(
            sph.shape[0], albedo=(0.9, 0.75, 0.4), roughness=0.4,
            specular=(0.04, 0.04, 0.04), metallic=0.6)
    positions = np.concatenate([positions, sph], axis=0)
    normals = np.concatenate([normals, sph_n], axis=0)
    mat = Material.stack([mat, sphere_material])
    return Scene.build(Triangles.from_vertices(positions, normals), mat)


ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "assets")


def blob_mesh_scene(light_emit=LIGHT_EMIT) -> Scene:
    """Cornell room + the repo's 82k-triangle OBJ asset (assets/blob82k.obj)
    through the OBJ/MTL loader, as the JAX package builds it (no BVH)."""
    from pathtrace_tpu_torch.models.obj import load_obj_scene

    room = cornell_walls(light_emit=light_emit)
    return load_obj_scene(os.path.join(ASSET_DIR, "blob82k.obj"),
                          translation=(0.0, 10.0, 0.0), scale=6.0, extra=room,
                          build_bvh=False)


def glass_scene(light_emit=LIGHT_EMIT) -> Scene:
    """Reflection/refraction scene: metal sphere + glass sphere (analytic)
    in the Cornell room."""
    positions, normals, mat = cornell_walls(light_emit=light_emit)
    tris = Triangles.from_vertices(positions, normals)
    metal = Material.make(1, albedo=(1.0, 1.0, 1.0), specular=(0.04,) * 3,
                          metallic=1.0, opacity=1.0, roughness=0.15)
    glass = Material.make(1, albedo=(1.0, 1.0, 1.0), specular=(0.04,) * 3,
                          metallic=0.0, opacity=0.0, roughness=0.0)
    spheres = Spheres(
        center=torch.tensor([[-8.0, 8.0, -4.0], [8.0, 8.0, 5.0]]),
        radius=torch.tensor([8.0, 8.0]),
        mat=Material.stack([metal, glass]),
    )
    return Scene.build(tris, mat, spheres)


def sphere_only_scene() -> Scene:
    """A scene without triangles, as the JSON loader builds a document of
    spheres alone (JAX json_io.py:105-107): an emissive sphere and a diffuse
    one in front of default_camera. No triangle is emissive, so the scene
    has no lights and NEE is skipped; light arrives by BSDF sampling."""
    tris = Triangles.from_vertices(np.zeros((0, 3, 3), np.float32),
                                   np.zeros((0, 3, 3), np.float32))
    lamp = Material.make(1, emittance=(4.0, 4.0, 4.0))
    diffuse = Material.make(1, albedo=(0.8, 0.3, 0.3), roughness=1.0)
    spheres = Spheres(center=torch.tensor([[0.0, 20.0, 0.0], [14.0, 10.0, 8.0]]),
                      radius=torch.tensor([10.0, 7.0]), mat=Material.stack([lamp, diffuse]))
    return Scene.build(tris, Material.make(0), spheres)


def default_camera(width=512, height=512) -> Camera:
    """Viewer startup pose: pos (0,20,60), rotation (0,90,0), fovy 45
    (renderer.cpp:19, camera.cpp:7-14)."""
    return Camera.from_rotation((0.0, 20.0, 60.0), (0.0, 90.0, 0.0),
                                fovy_deg=45.0, width=width, height=height)
