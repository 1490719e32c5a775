"""Shipped scene/config presets (port of pathtrace_tpu/models/presets.py).

build_preset_scene applies the JAX package's size rule
(presets.py:94-106): a `use_bvh` preset with more than 4096 triangles gets
KD cells (Scene.with_kd_binned), the mesh path; `mesh512` (the blob82k
OBJ asset) and `multihost1024` (an 82k-triangle icosphere) take it, and
`--engine fused` renders them through the fused kernel's KD variant. A
smaller `use_bvh` preset gets the SAH BVH (Scene.with_bvh), which reorders
its triangles into leaf order as JAX's does, and is searched by the
all-triangles route: JAX adds MT-matmul coefficients (with_mt, a TPU
formulation) that win its route, and the all-triangles search finds the
same winners, exact ties included, over the same leaf-ordered table.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from pathtrace_tpu_torch.integrator.config import IntegratorConfig
from pathtrace_tpu_torch.models import procedural

# Above this many triangles a preset scene gets KD cells (JAX presets.py:100).
KD_MIN_TRIS = 4096


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    description: str
    build_scene: Callable
    width: int
    height: int
    spp: int
    cfg: IntegratorConfig = IntegratorConfig()
    use_bvh: bool = True


PRESETS = {
    "cornell64": Preset(
        name="cornell64",
        description="Cornell box (diffuse walls + area light), 64x64 @ "
                    "16spp, NEE on",
        build_scene=lambda: procedural.cornell_box_scene(),
        width=64, height=64, spp=16, use_bvh=False,
    ),
    "diffuse256": Preset(
        name="diffuse256",
        description="Diffuse room 256x256 @ 256spp (NEE vs no-NEE A/B)",
        build_scene=lambda: procedural.cornell_box_scene(),
        width=256, height=256, spp=256,
    ),
    "diffuse256_nonee": Preset(
        name="diffuse256_nonee",
        description="Diffuse room 256x256 @ 256spp without NEE",
        build_scene=lambda: procedural.cornell_box_scene(),
        width=256, height=256, spp=256,
        cfg=IntegratorConfig(nee=False),
    ),
    "mesh512": Preset(
        name="mesh512",
        description="82k-tri OBJ asset (assets/blob82k.obj) via the "
                    "OBJ/MTL loader + SAH BVH, 512x512 @ 256spp",
        build_scene=lambda: procedural.blob_mesh_scene(),
        width=512, height=512, spp=256,
    ),
    "glass512": Preset(
        name="glass512",
        description="Reflection/refraction scene (specular + dielectric), "
                    "512x512 @ 1024spp",
        build_scene=lambda: procedural.glass_scene(),
        width=512, height=512, spp=1024,
    ),
    "multihost1024": Preset(
        name="multihost1024",
        description="Bunny-in-box 1024x1024 @ 2048spp, tiles sharded over "
                    "hosts with grad allreduce",
        build_scene=lambda: procedural.sphere_mesh_scene(subdivisions=6),
        width=1024, height=1024, spp=2048,
    ),
    "reference_demo": Preset(
        name="reference_demo",
        description="Cornell room + the reference's two analytic spheres "
                    "(metallic rough 0.2, transparent rough 0.05)",
        build_scene=lambda: procedural.cornell_box_scene(include_spheres=True,
                                                        include_boxes=False),
        width=240, height=540, spp=64,
    ),
}


def get_preset(name: str) -> Preset:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]


def build_preset_scene(preset: Preset):
    """The preset's scene on the host (move it with Scene.to): with KD cells
    when it has more than KD_MIN_TRIS triangles, else with the SAH BVH in
    leaf order, if the preset uses acceleration."""
    scene = preset.build_scene()
    if preset.use_bvh:
        scene = scene.with_kd_binned() if scene.num_tris > KD_MIN_TRIS else scene.with_bvh()
    return scene
