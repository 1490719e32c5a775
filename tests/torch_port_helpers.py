"""Carry JAX-package objects across to the PyTorch port in tests.

Both packages run on the CPU in one process; data crosses as numpy arrays.
"""

import dataclasses

import numpy as np

from pathtrace_tpu_torch.models.scene import CLUSTER_FIELDS

MAT_FIELDS = ("emittance", "albedo", "specular", "opacity", "roughness", "metallic")


def scene_to_numpy(scene) -> dict:
    """Flatten a Scene of either package into the dict Scene.from_numpy
    takes (every leaf as a numpy array)."""
    d = {f"tris.{f.name}": np.asarray(getattr(scene.tris, f.name))
         for f in dataclasses.fields(scene.tris)}
    for f in MAT_FIELDS:
        d[f"mat.{f}"] = np.asarray(getattr(scene.mat, f))
        d[f"spheres.mat.{f}"] = np.asarray(getattr(scene.spheres.mat, f))
    d["spheres.center"] = np.asarray(scene.spheres.center)
    d["spheres.radius"] = np.asarray(scene.spheres.radius)
    d["lights"] = np.asarray(scene.lights)
    d["light_pack"] = np.asarray(scene.light_pack)
    d["num_lights"] = scene.num_lights
    clusters = getattr(scene, "clusters", None)
    if clusters is not None and clusters.dup_map is not None:
        # KD cells (both packages name their leaves alike)
        for f in CLUSTER_FIELDS:
            d[f"clusters.{f}"] = np.asarray(getattr(clusters, f))
    return d


def port_scene(scene):
    from pathtrace_tpu_torch.models.scene import Scene
    return Scene.from_numpy(scene_to_numpy(scene))


def port_camera(camera):
    from pathtrace_tpu_torch.core.camera import Camera
    return Camera(pos=np.asarray(camera.pos), forward=np.asarray(camera.forward),
                  up=np.asarray(camera.up), right=np.asarray(camera.right),
                  fovy=np.float32(camera.fovy), fovx=np.float32(camera.fovx),
                  width=camera.width, height=camera.height)


def two_cell_tie_scene():
    """Two copies of one triangle, ids 0 and 1, in two same-box KD cells
    that list id 1 first: a ray through both sees equal t in two cells."""
    import torch

    from pathtrace_tpu_torch.accel.binned import ClusterArrays
    from pathtrace_tpu_torch.models.scene import Material, Scene, Triangles

    tri = np.float32([[[-1, -1, 0], [1, -1, 0], [0, 1, 0]]])
    pos = np.concatenate([tri, tri])
    cells = ClusterArrays.from_cells(pos, bmin=[[-1, -1, -0.1]] * 2, bmax=[[1, 1, 0.1]] * 2,
                                     prim_start=[0, 1], prim_count=[1, 1], dup_map=[1, 0])
    normals = np.broadcast_to(np.float32([0, 0, 1]), pos.shape)
    scene = Scene.build(Triangles.from_vertices(pos, normals), Material.make(2))
    rays = (torch.tensor([[0.1, -0.2, 5.0], [0.0, 0.0, -5.0], [0.3, 0.1, 5.0]]),
            torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]]),
            torch.zeros(3), torch.full((3,), 100.0))
    return dataclasses.replace(scene, clusters=cells), rays


def cell_row_scene(n: int = 80):
    """n KD cells in a row along x, each a box around the ray band y in
    [-1, 1], z in [-1, 1] at x = 1..n, listed farthest first. Each holds one
    triangle facing -x, off the band except the last (x = n), so a ray
    along +x through the band crosses all n cells, more than the kernel's
    list holds, and hits only at the end. Returns (scene, rays)."""
    import torch

    from pathtrace_tpu_torch.accel.binned import ClusterArrays
    from pathtrace_tpu_torch.models.scene import Material, Scene, Triangles

    xs = np.arange(n, 0, -1, dtype=np.float32)  # cell c at x = n - c
    tris = []
    for c, x in enumerate(xs):
        # the last one across the band, the rest beside it
        y0, z0, size = (-2.0, -2.0, 5.0) if x == n else (3.0, -0.5, 1.0)
        v0, v1, v2 = [x, y0, z0], [x, y0 + size, z0], [x, y0, z0 + size]
        e1, e2 = np.subtract(v1, v0), np.subtract(v2, v0)
        if np.cross(e2, e1)[0] <= 0:  # front face toward -x: det > 0 for dir +x
            v1, v2 = v2, v1
        tris.append([v0, v1, v2])
    pos = np.float32(tris)
    cells = ClusterArrays.from_cells(
        pos, bmin=[[x - 0.1, -1.0, -1.0] for x in xs], bmax=[[x + 0.1, 4.5, 1.0] for x in xs],
        prim_start=np.arange(n), prim_count=np.ones(n, np.int64), dup_map=np.arange(n))
    normals = np.broadcast_to(np.float32([-1, 0, 0]), pos.shape)
    scene = Scene.build(Triangles.from_vertices(pos, normals), Material.make(n))
    g = np.random.default_rng(0)
    m = 64
    org = np.stack([np.zeros(m), g.uniform(-0.3, 0.3, m), g.uniform(-0.3, 0.3, m)], 1)
    d = np.stack([np.ones(m), g.uniform(-1e-3, 1e-3, m), np.zeros(m)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f32 = lambda a: torch.from_numpy(np.float32(a))
    return (dataclasses.replace(scene, clusters=cells),
            (f32(org), f32(d), torch.zeros(m), torch.full((m,), 1000.0)))
