"""What the benchmark takes from the program (pathtrace_tpu_torch): its
scene, camera and integrator types, built from the benchmark's raw arrays
and configuration. The entries (benchmark/entries/) drive its entry points
with them."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.scenes import MAT_FIELDS


def port_scene(arrays: dict, kd_max_tris=None):
    """The port's Scene from the raw arrays, built on the host as its
    presets are; with kd_max_tris, its KD cells (Scene.with_kd_binned)."""
    from pathtrace_tpu_torch.models.scene import Material, Scene, Spheres, Triangles

    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    mat = lambda pre: Material(*[t(arrays[f"{pre}.{f}"]) for f in MAT_FIELDS])
    spheres = Spheres(center=t(arrays["sph.center"]).reshape(-1, 3),
                      radius=t(arrays["sph.radius"]).reshape(-1), mat=mat("sph.mat"))
    scene = Scene.build(Triangles.from_vertices(arrays["positions"], arrays["normals"]),
                        mat("mat"), spheres)
    return scene.with_kd_binned(max_tris=kd_max_tris) if kd_max_tris else scene


def port_camera(config: dict, width: int, height: int):
    from pathtrace_tpu_torch.core.camera import Camera

    c = config["camera"]
    return Camera.from_rotation(tuple(c["pos"]), tuple(c["rotation_deg"]),
                                fovy_deg=c["fovy_deg"], width=width, height=height)


def port_config(config: dict):
    from pathtrace_tpu_torch.integrator.config import IntegratorConfig

    i = config["integrator"]
    return IntegratorConfig(max_bounce=i["max_bounce"], rr_bounce=i["rr_bounce"],
                            rr_stop_prob=i["rr_stop_prob"], refract_cap=i["refract_cap"],
                            miss_radiance=tuple(i["miss_radiance"]), pdf_clamp=i["pdf_clamp"],
                            nee=i["nee"])


def port_key(key: tuple):
    """The port's Philox key array of a (word, word) key."""
    return np.asarray(key, np.uint32)
