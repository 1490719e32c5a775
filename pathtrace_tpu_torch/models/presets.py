"""Shipped scene/config presets (port of pathtrace_tpu/models/presets.py).

The small-scene presets are carried. `mesh512` and `multihost1024` need
the OBJ loader and the mesh acceleration, which the port does not have
yet (ROADMAP A7): building them raises NotImplementedError.

`use_bvh` has no effect yet: every scene takes the brute raycast. The JAX
build reorders triangles into BVH leaf order (presets.py:96-103), so exact
ties between triangles may break differently; images agree to golden
tolerance.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from pathtrace_tpu_torch.integrator.config import IntegratorConfig
from pathtrace_tpu_torch.models import procedural


def _not_ported(name: str) -> Callable:
    def build():
        raise NotImplementedError(
            f"preset {name!r} needs OBJ/mesh ingestion and its acceleration, "
            "not yet ported (ROADMAP A7)")
    return build


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
        build_scene=_not_ported("mesh512"),
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
        build_scene=_not_ported("multihost1024"),
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
    """The preset's scene, on the host (move it with Scene.to)."""
    return preset.build_scene()
