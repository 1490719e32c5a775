"""Minimal OBJ/MTL loader -> SoA arrays (port of pathtrace_tpu/models/obj.py).

The numpy parser is copied, not imported: importing pathtrace_tpu imports
jax. It stands in for the reference's assimp import (Model::loadModel,
model.h:77-93, with Triangulate | GenSmoothNormals | FlipUVs):

- polygons are fan-triangulated;
- missing normals become area-weighted smooth vertex normals;
- the v texture coordinate is flipped (v -> 1-v);
- tangents come from the normal-derived fallback frame (model.h:159-171).

Materials follow the reference's aiMaterial fetch (model.h:173-207): Kd ->
albedo, Ke -> emittance, Ks -> specular, Pm metallic, Pr (or Ns converted)
roughness, d / Tr opacity.

load_obj_scene builds the SAH BVH by default (Scene.with_bvh), as the JAX
package does: the triangles come in BVH leaf order.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from pathtrace_tpu_torch.models.scene import Material, Scene, Triangles, _t


@dataclass
class MtlDef:
    albedo: tuple = (0.8, 0.8, 0.8)
    emittance: tuple = (0.0, 0.0, 0.0)
    specular: tuple = (0.04, 0.04, 0.04)
    opacity: float = 1.0
    roughness: float = 1.0
    metallic: float = 0.0


def parse_mtl(path: str) -> dict:
    """{name: MtlDef} of an MTL file; a missing file gives no materials."""
    mats: dict = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = MtlDef()
                mats[parts[1]] = cur
            elif cur is None:
                continue
            elif key == "Kd":
                cur.albedo = tuple(map(float, parts[1:4]))
            elif key == "Ke":
                cur.emittance = tuple(map(float, parts[1:4]))
            elif key == "Ks":
                cur.specular = tuple(map(float, parts[1:4]))
            elif key == "d":
                cur.opacity = float(parts[1])
            elif key == "Tr":
                cur.opacity = 1.0 - float(parts[1])
            elif key == "Pr":
                cur.roughness = float(parts[1])
            elif key == "Pm":
                cur.metallic = float(parts[1])
            elif key == "Ns":
                # Blinn-Phong exponent -> roughness (standard conversion)
                ns = float(parts[1])
                cur.roughness = float(np.sqrt(2.0 / (ns + 2.0)))
    return mats


@dataclass
class ObjMesh:
    """Host-side mesh: faces as index triples + per-face material names."""

    vertices: np.ndarray          # (V, 3)
    normals: np.ndarray           # (T, 3, 3) per-corner shading normals
    uvs: np.ndarray               # (T, 3, 2)
    faces: np.ndarray             # (T, 3) vertex indices
    face_mtl: list = field(default_factory=list)  # (T,) material names
    materials: dict = field(default_factory=dict)


def load_obj(path: str) -> ObjMesh:
    vs, vns, vts = [], [], []
    faces = []            # list of (vidx3, vtidx3, vnidx3)
    face_mtl = []
    materials: dict = {}
    cur_mtl = ""

    def resolve(idx: str, n: int) -> int:
        i = int(idx)
        return i - 1 if i > 0 else n + i

    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                vs.append(tuple(map(float, parts[1:4])))
            elif key == "vn":
                vns.append(tuple(map(float, parts[1:4])))
            elif key == "vt":
                vts.append(tuple(map(float, parts[1:3])))
            elif key == "mtllib":
                mtl_path = os.path.join(os.path.dirname(path), parts[1])
                materials.update(parse_mtl(mtl_path))
            elif key == "usemtl":
                cur_mtl = parts[1]
            elif key == "f":
                corners = []
                for p in parts[1:]:
                    toks = p.split("/")
                    vi = resolve(toks[0], len(vs))
                    ti = resolve(toks[1], len(vts)) if len(toks) > 1 and toks[1] else -1
                    ni = resolve(toks[2], len(vns)) if len(toks) > 2 and toks[2] else -1
                    corners.append((vi, ti, ni))
                for k in range(1, len(corners) - 1):  # fan triangulation
                    faces.append((corners[0], corners[k], corners[k + 1]))
                    face_mtl.append(cur_mtl)

    v = np.asarray(vs, np.float32).reshape(-1, 3)
    vn = np.asarray(vns, np.float32).reshape(-1, 3) if vns else np.zeros((0, 3), np.float32)
    vt = np.asarray(vts, np.float32).reshape(-1, 2) if vts else np.zeros((0, 2), np.float32)

    t = len(faces)
    fv = np.asarray([[c[0] for c in f] for f in faces], np.int64).reshape(t, 3)
    ft = np.asarray([[c[1] for c in f] for f in faces], np.int64).reshape(t, 3)
    fn = np.asarray([[c[2] for c in f] for f in faces], np.int64).reshape(t, 3)

    # smooth normals (GenSmoothNormals): area-weighted accumulation
    if vn.shape[0] == 0 or (fn < 0).any():
        acc = np.zeros_like(v)
        e1 = v[fv[:, 1]] - v[fv[:, 0]]
        e2 = v[fv[:, 2]] - v[fv[:, 0]]
        fnorm = np.cross(e1, e2)  # area-weighted
        for k in range(3):
            np.add.at(acc, fv[:, k], fnorm)
        acc /= np.maximum(np.linalg.norm(acc, axis=-1, keepdims=True), 1e-12)
        tri_normals = acc[fv]
    else:
        tri_normals = vn[fn]
        tri_normals /= np.maximum(
            np.linalg.norm(tri_normals, axis=-1, keepdims=True), 1e-12)

    # uvs with FlipUVs (v -> 1-v), zeros if absent
    if vt.shape[0] > 0 and (ft >= 0).all():
        tri_uvs = vt[ft]
        tri_uvs[..., 1] = 1.0 - tri_uvs[..., 1]
    else:
        tri_uvs = np.zeros((t, 3, 2), np.float32)

    return ObjMesh(vertices=v, normals=tri_normals.astype(np.float32),
                   uvs=tri_uvs.astype(np.float32), faces=fv,
                   face_mtl=face_mtl, materials=materials)


def compose_model_matrix(translation=(0, 0, 0), scale=1.0, rotation=None):
    """4x4 model matrix M = T @ R @ S (column-vector convention).

    `rotation`: optional (3, 3) rotation (or any linear) matrix. `scale`
    may be a scalar or per-axis (3,) vector.
    """
    m = np.eye(4, dtype=np.float64)
    s = np.asarray(scale, np.float64) * np.ones(3)
    m[:3, :3] = np.diag(s)
    if rotation is not None:
        m[:3, :3] = np.asarray(rotation, np.float64) @ m[:3, :3]
    m[:3, 3] = np.asarray(translation, np.float64)
    return m


def rotation_matrix(axis, angle_rad: float) -> np.ndarray:
    """(3, 3) rotation about `axis` by `angle_rad` (Rodrigues)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return (np.eye(3) + np.sin(angle_rad) * k
            + (1.0 - np.cos(angle_rad)) * (k @ k))


def obj_to_arrays(mesh: ObjMesh, translation=(0, 0, 0), scale=1.0,
                  model_matrix=None, normal_mode: str = "reference"):
    """World-space (T,3,3) positions/normals/uvs + per-tri Material, applying
    the reference's model transform (BVH::AddModel, bvh.cpp:153-189).

    `model_matrix` (4x4) overrides translation/scale. Positions go through
    the full affine map. normal_mode="reference" transforms shading
    normals by the plain linear part, as the reference does (bvh.cpp:173-184;
    skewed under non-uniform scale); "inverse_transpose" uses the normal
    matrix. Both renormalize per vertex.
    """
    if model_matrix is None:
        model_matrix = compose_model_matrix(translation, scale)
    m = np.asarray(model_matrix, np.float64)
    if m.shape != (4, 4):
        raise ValueError(f"model_matrix must be 4x4, got {m.shape}")
    lin, trans = m[:3, :3], m[:3, 3]
    pos = (mesh.vertices[mesh.faces] @ lin.T + trans).astype(np.float32)
    if normal_mode == "reference":
        nmat = lin
    elif normal_mode == "inverse_transpose":
        nmat = np.linalg.inv(lin).T
    else:
        raise ValueError(normal_mode)
    normals = mesh.normals @ nmat.T
    normals = (normals / np.maximum(
        np.linalg.norm(normals, axis=-1, keepdims=True), 1e-12)).astype(np.float32)
    t = pos.shape[0]
    mats = [mesh.materials.get(name, MtlDef())
            for name in (mesh.face_mtl if mesh.face_mtl else [""] * t)]
    mat = Material(
        emittance=_t(np.asarray([m.emittance for m in mats], np.float32).reshape(t, 3)),
        albedo=_t(np.asarray([m.albedo for m in mats], np.float32).reshape(t, 3)),
        specular=_t(np.asarray([m.specular for m in mats], np.float32).reshape(t, 3)),
        opacity=_t(np.asarray([m.opacity for m in mats], np.float32)),
        roughness=_t(np.asarray([m.roughness for m in mats], np.float32)),
        metallic=_t(np.asarray([m.metallic for m in mats], np.float32)),
    )
    return pos, normals, mesh.uvs, mat


def load_obj_scene(path: str, translation=(0, 0, 0), scale=1.0,
                   extra=None, build_bvh: bool = True,
                   model_matrix=None, normal_mode: str = "reference") -> Scene:
    """Load an OBJ file as a Scene, optionally merged with `extra`
    (positions, normals, Material) parts such as a procedural room; with
    build_bvh the scene has its SAH BVH and leaf-ordered triangles
    (Scene.with_bvh)."""
    mesh = load_obj(path)
    pos, normals, _, mat = obj_to_arrays(
        mesh, translation, scale, model_matrix=model_matrix,
        normal_mode=normal_mode)
    parts_p, parts_n, mats = [pos], [normals], [mat]
    if extra is not None:
        ep, en, em = extra
        parts_p.append(ep)
        parts_n.append(en)
        mats.append(em)
    tris = Triangles.from_vertices(np.concatenate(parts_p, axis=0),
                                   np.concatenate(parts_n, axis=0))
    scene = Scene.build(tris, Material.stack(mats))
    return scene.with_bvh() if build_bvh else scene
