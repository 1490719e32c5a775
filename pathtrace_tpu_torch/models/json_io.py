"""JSON scene descriptions (port of pathtrace_tpu/models/json_io.py:37-141).

The reference hardcodes its scene (renderer.cpp:102-144) and lists a scene
file as a TODO (README.md:33). The format is the JAX package's:

{
  "camera": {"pos": [..], "rotation": [..] | "look_at": [..],
             "fovy_deg": 45, "width": 512, "height": 512},
  "objects": [
     {"type": "cornell_walls", "light_emit": [15,11,5]},
     {"type": "box", "center": [..], "half_extents": [..], "material": {...}},
     {"type": "icosphere", "radius": 9, "center": [..], "subdivisions": 4,
      "smooth": true, "material": {...}},
     {"type": "obj", "path": "mesh.obj", "scale": 1.0, "translation": [0,0,0]},
     {"type": "sphere", "center": [..], "radius": 13, "material": {...}}
  ]
}

Material keys, all optional: albedo, emittance, specular, opacity,
roughness, metallic (the reference's Material, CudaPrimitive.cuh:15-23).

With build_accel the scene gets the SAH BVH and leaf order (with_bvh), as
in JAX; JAX then adds MT-matmul coefficients (with_mt, a TPU formulation
the port does not build), and the port instead takes the presets' rule: KD
cells above 4,096 triangles (models/presets.py), the all-triangles search
below.
"""

from __future__ import annotations

import json
import os

import numpy as np

from pathtrace_tpu_torch.core.camera import Camera
from pathtrace_tpu_torch.models import procedural
from pathtrace_tpu_torch.models.presets import KD_MIN_TRIS
from pathtrace_tpu_torch.models.scene import Material, Scene, Spheres, Triangles, _t


def _material(spec: dict, n: int) -> Material:
    return Material.make(
        n,
        emittance=tuple(spec.get("emittance", (0.0, 0.0, 0.0))),
        albedo=tuple(spec.get("albedo", (0.8, 0.8, 0.8))),
        specular=tuple(spec.get("specular", (0.04, 0.04, 0.04))),
        opacity=float(spec.get("opacity", 1.0)),
        roughness=float(spec.get("roughness", 1.0)),
        metallic=float(spec.get("metallic", 0.0)),
    )


def load_scene_dict(doc: dict, base_dir: str = ".", build_accel: bool = True):
    """(Scene, Camera) from a parsed JSON document; OBJ paths are relative
    to base_dir. The scene lies on the host (move it with Scene.to)."""
    parts_p, parts_n, mats = [], [], []
    sphere_centers, sphere_radii, sphere_mats = [], [], []

    for obj in doc.get("objects", []):
        kind = obj["type"]
        if kind == "cornell_walls":
            p, n, m = procedural.cornell_walls(
                light_half=float(obj.get("light_half", 8.0)),
                light_emit=tuple(obj.get("light_emit", procedural.LIGHT_EMIT)))
        elif kind == "box":
            p = procedural.box(obj["center"], obj["half_extents"],
                               outward=bool(obj.get("outward", True)))
            n = procedural.flat_normals(p)
            m = _material(obj.get("material", {}), p.shape[0])
        elif kind == "icosphere":
            center = obj.get("center", (0, 0, 0))
            p = procedural.icosphere(radius=float(obj.get("radius", 1.0)), center=center,
                                     subdivisions=int(obj.get("subdivisions", 3)))
            n = (procedural.smooth_sphere_normals(p, center) if obj.get("smooth", True)
                 else procedural.flat_normals(p))
            m = _material(obj.get("material", {}), p.shape[0])
        elif kind == "obj":
            from pathtrace_tpu_torch.models.obj import load_obj, obj_to_arrays

            mesh = load_obj(os.path.join(base_dir, obj["path"]))
            p, n, _, m = obj_to_arrays(mesh, translation=obj.get("translation", (0, 0, 0)),
                                       scale=float(obj.get("scale", 1.0)))
            if "material" in obj:  # a per-object override
                m = _material(obj["material"], p.shape[0])
        elif kind == "sphere":
            sphere_centers.append(obj["center"])
            sphere_radii.append(float(obj["radius"]))
            sphere_mats.append(_material(obj.get("material", {}), 1))
            continue
        else:
            raise ValueError(f"unknown object type {kind!r}")
        parts_p.append(p)
        parts_n.append(n)
        mats.append(m)

    if parts_p:
        tris = Triangles.from_vertices(np.concatenate(parts_p, axis=0),
                                       np.concatenate(parts_n, axis=0))
        mat = Material.stack(mats)
    else:
        tris = Triangles.from_vertices(np.zeros((0, 3, 3), np.float32),
                                       np.zeros((0, 3, 3), np.float32))
        mat = Material.make(0)
    spheres = Spheres.empty()
    if sphere_centers:
        spheres = Spheres(center=_t(sphere_centers), radius=_t(sphere_radii),
                          mat=Material.stack(sphere_mats))

    scene = Scene.build(tris, mat, spheres)
    if build_accel and scene.num_tris > 0:
        scene = scene.with_bvh()
        if scene.num_tris > KD_MIN_TRIS:
            scene = scene.with_kd_binned()

    cam_spec = doc.get("camera", {})
    width = int(cam_spec.get("width", 512))
    height = int(cam_spec.get("height", 512))
    fovy = float(cam_spec.get("fovy_deg", 45.0))
    pos = cam_spec.get("pos", (0.0, 20.0, 60.0))
    if "look_at" in cam_spec:
        camera = Camera.look_at(pos, cam_spec["look_at"], fovy_deg=fovy, width=width,
                                height=height)
    else:
        camera = Camera.from_rotation(pos, tuple(cam_spec.get("rotation", (0.0, 90.0, 0.0))),
                                      fovy_deg=fovy, width=width, height=height)
    return scene, camera


def load_scene(path: str, build_accel: bool = True):
    """(Scene, Camera) from a JSON file."""
    with open(path) as f:
        doc = json.load(f)
    return load_scene_dict(doc, base_dir=os.path.dirname(path) or ".", build_accel=build_accel)
