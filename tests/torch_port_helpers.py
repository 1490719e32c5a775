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
