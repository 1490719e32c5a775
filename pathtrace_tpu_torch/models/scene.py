"""SoA scene representation (port of pathtrace_tpu/models/scene.py).

Every attribute is a flat (N, ...) float32 tensor; one material per
triangle (the reference copies the mesh material to all three vertices
and shades with mat0 only, CudaPrimitive.cuh:149-154). Scenes are built on
the host and moved with `Scene.to(device)`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from pathtrace_tpu_torch.accel.binned import ClusterArrays
from pathtrace_tpu_torch.utils import math3

# The KD cell leaves a scene carries across (Scene.from_numpy).
CLUSTER_FIELDS = ("bmin", "bmax", "prim_start", "prim_count", "dup_map")

_MAT_FIELDS = ("emittance", "albedo", "specular", "opacity", "roughness",
               "metallic")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))  # a writable copy


def _to(obj, device):
    """Copy of a (nested) dataclass of tensors on `device`."""
    moved = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(device)
        elif dataclasses.is_dataclass(v):
            v = _to(v, device)
        moved[f.name] = v
    return dataclasses.replace(obj, **moved)


@dataclasses.dataclass(frozen=True)
class Material:
    """Per-primitive material (CudaPrimitive.cuh:15-23): opacity < 1-EPS
    selects the refractive lobes, roughness < 1e-2 the delta variants."""

    emittance: torch.Tensor  # (N, 3)
    albedo: torch.Tensor     # (N, 3)
    specular: torch.Tensor   # (N, 3)
    opacity: torch.Tensor    # (N,)
    roughness: torch.Tensor  # (N,)
    metallic: torch.Tensor   # (N,)

    @staticmethod
    def stack(mats: list["Material"]) -> "Material":
        return Material(*[torch.cat([getattr(m, f) for m in mats], dim=0)
                          for f in _MAT_FIELDS])

    @staticmethod
    def make(n: int, emittance=(0.0, 0.0, 0.0), albedo=(1.0, 1.0, 1.0),
             specular=(0.04, 0.04, 0.04), opacity=1.0, roughness=1.0,
             metallic=0.0) -> "Material":
        f = np.float32
        rgb = lambda c: _t(np.broadcast_to(np.asarray(c, f), (n, 3)))
        return Material(
            emittance=rgb(emittance), albedo=rgb(albedo), specular=rgb(specular),
            opacity=_t(np.full((n,), opacity, f)),
            roughness=_t(np.full((n,), roughness, f)),
            metallic=_t(np.full((n,), metallic, f)),
        )

    def gather(self, idx: torch.Tensor) -> "Material":
        idx = idx.long()
        return Material(*[getattr(self, f)[idx] for f in _MAT_FIELDS])


@dataclasses.dataclass(frozen=True)
class Triangles:
    """World-space triangle soup with per-vertex shading attributes
    (Triangle::Copy, CudaPrimitive.cuh:171-215)."""

    v0: torch.Tensor   # (T, 3) positions
    v1: torch.Tensor
    v2: torch.Tensor
    n0: torch.Tensor   # (T, 3) shading normals
    n1: torch.Tensor
    n2: torch.Tensor
    t0: torch.Tensor   # (T, 3) tangents
    t1: torch.Tensor
    t2: torch.Tensor
    b0: torch.Tensor   # (T, 3) bitangents
    b1: torch.Tensor
    b2: torch.Tensor
    uv0: torch.Tensor  # (T, 2)
    uv1: torch.Tensor
    uv2: torch.Tensor

    @property
    def e1(self) -> torch.Tensor:
        return self.v1 - self.v0

    @property
    def e2(self) -> torch.Tensor:
        return self.v2 - self.v0

    @functools.cached_property
    def search_table(self) -> torch.Tensor:
        """(T, 9) rows [v0 | e1 | e2], the all-triangles search's table
        (ops/mt_closest.py), built once per Triangles."""
        return torch.cat([self.v0, self.e1, self.e2], dim=1).contiguous()

    @property
    def geometric_normal(self) -> torch.Tensor:
        """normalize(cross(E1, E2)) (CudaPrimitive.cuh:203)."""
        return math3.normalize(math3.cross(self.e1, self.e2))

    @property
    def area(self) -> torch.Tensor:
        """|cross(E1, E2)| / 2 (CudaPrimitive.cuh:205)."""
        return math3.length(math3.cross(self.e1, self.e2)) * 0.5

    @property
    def count(self) -> int:
        return self.v0.shape[0]

    @staticmethod
    def from_vertices(positions: np.ndarray, normals: np.ndarray,
                      tangents: Optional[np.ndarray] = None,
                      bitangents: Optional[np.ndarray] = None,
                      uvs: Optional[np.ndarray] = None) -> "Triangles":
        """Build from (T,3,3) position/normal arrays (+ optional T/B/uv);
        missing tangents fall back to a normal-derived frame (model.h:159-171)."""
        positions = np.asarray(positions, np.float32)
        normals = np.asarray(normals, np.float32)
        t = positions.shape[0]
        if tangents is None or bitangents is None:
            tangents, bitangents = tangent_frame_from_normals(normals)
        if uvs is None:
            uvs = np.zeros((t, 3, 2), np.float32)
        fields = {}
        for name, arr in (("v", positions), ("n", normals), ("t", tangents),
                          ("b", bitangents), ("uv", uvs)):
            for k in range(3):
                fields[f"{name}{k}"] = _t(arr[:, k])
        return Triangles(**fields)


def tangent_frame_from_normals(normals: np.ndarray):
    """Stable tangent frame per vertex from normals (numpy): cross with the
    axis least aligned with n (model.h:159-171 fallback)."""
    n = np.asarray(normals, np.float32)
    flat = n.reshape(-1, 3)
    helper = np.where(
        (np.abs(flat[:, 1:2]) < 0.99), np.array([[0.0, 1.0, 0.0]], np.float32),
        np.array([[1.0, 0.0, 0.0]], np.float32))
    t = np.cross(helper, flat)
    t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
    b = np.cross(flat, t)
    return t.reshape(n.shape), b.reshape(n.shape)


@dataclasses.dataclass(frozen=True)
class Spheres:
    """Analytic spheres, scanned linearly after the triangles
    (CudaUtil.cuh:137-145)."""

    center: torch.Tensor  # (S, 3)
    radius: torch.Tensor  # (S,)
    mat: Material         # (S, ...) fields

    @property
    def count(self) -> int:
        return self.center.shape[0]

    @staticmethod
    def empty() -> "Spheres":
        return Spheres(center=torch.zeros((0, 3)), radius=torch.zeros((0,)),
                       mat=Material.make(0))


@dataclasses.dataclass(frozen=True)
class Scene:
    """Triangle soup + materials + spheres + light table.

    `lights` indexes emissive triangles found by scanning emittance
    (pathtracer.cu:164-174). `light_pack` is the (L, 13) per-light row
    [v0 v1 v2 area geometric_normal] that NEE samples from. `clusters`
    (optional) holds the KD cells of the mesh raycast
    (Scene.with_kd_binned); the engines then route every closest-hit and
    shadow ray through them (integrator/megakernel.default_raycast).
    """

    tris: Triangles
    mat: Material         # per-triangle
    spheres: Spheres
    lights: torch.Tensor  # (L,) int32 indices into tris
    num_lights: int
    light_pack: torch.Tensor  # (L, 13) float32
    clusters: Optional[ClusterArrays] = None

    @property
    def num_tris(self) -> int:
        return self.tris.count

    @property
    def num_spheres(self) -> int:
        return self.spheres.count

    @property
    def device(self) -> torch.device:
        return self.tris.v0.device

    def to(self, device) -> "Scene":
        return _to(self, torch.device(device))

    def positions(self) -> np.ndarray:
        """(T, 3, 3) float32 triangle vertices on the host."""
        tr = self.tris
        return np.stack([tr.v0.cpu().numpy(), tr.v1.cpu().numpy(),
                         tr.v2.cpu().numpy()], axis=1)

    def with_kd_binned(self, max_tris: int = 1024) -> "Scene":
        """The scene with KD cells over its triangles (accel/kdgrid.py,
        hybrid split rule as the JAX package's scene.py:335-359). The JAX
        version's MT coefficients and packed shading rows are TPU
        formulations and are not built."""
        from pathtrace_tpu_torch.accel.kdgrid import build_kd_clusters

        clusters = build_kd_clusters(self.positions(), max_tris=max_tris, rule="hybrid")
        return dataclasses.replace(self, clusters=_to(clusters, self.device))

    @staticmethod
    def build(tris: Triangles, mat: Material,
              spheres: Optional[Spheres] = None) -> "Scene":
        if spheres is None:
            spheres = Spheres.empty()
        # light scan (pathtracer.cu:164-174): any emissive channel -> light
        emit = mat.emittance.cpu().numpy()
        lights = np.nonzero(np.linalg.norm(emit, axis=-1) > math3.EPS)[0]
        lights = lights.astype(np.int32)
        # keep shapes nonzero; with num_lights == 0 NEE is skipped
        lights_arr = lights if lights.size else np.zeros((1,), np.int32)
        if tris.count:
            li = torch.from_numpy(lights_arr.astype(np.int64))
            pack = torch.cat([tris.v0[li], tris.v1[li], tris.v2[li],
                              tris.area[li][:, None],
                              tris.geometric_normal[li]], dim=1)
        else:
            pack = torch.zeros((1, 13))
        return Scene(tris=tris, mat=mat, spheres=spheres,
                     lights=torch.from_numpy(lights_arr),
                     num_lights=int(lights.size), light_pack=pack)

    @staticmethod
    def from_numpy(d: dict) -> "Scene":
        """Scene from a flat dict of numpy arrays, keyed "tris.<field>",
        "mat.<field>", "spheres.center", "spheres.radius",
        "spheres.mat.<field>", "lights", "light_pack" and "num_lights",
        plus, for a KD scene, "clusters.<bmin|bmax|prim_start|prim_count|
        dup_map>" (how the tests carry a JAX scene across; the member
        table is gathered from the triangles)."""
        mat = lambda prefix: Material(
            **{f: _t(d[f"{prefix}.{f}"]) for f in _MAT_FIELDS})
        tris = Triangles(**{f.name: _t(d[f"tris.{f.name}"])
                            for f in dataclasses.fields(Triangles)})
        spheres = Spheres(center=_t(d["spheres.center"]),
                          radius=_t(d["spheres.radius"]),
                          mat=mat("spheres.mat"))
        scene = Scene(tris=tris, mat=mat("mat"), spheres=spheres,
                      lights=torch.from_numpy(np.asarray(d["lights"], np.int32)),
                      num_lights=int(d["num_lights"]),
                      light_pack=_t(d["light_pack"]))
        if "clusters.bmin" not in d:
            return scene
        cells = {f: d[f"clusters.{f}"] for f in CLUSTER_FIELDS}
        return dataclasses.replace(
            scene, clusters=ClusterArrays.from_cells(scene.positions(), **cells))
