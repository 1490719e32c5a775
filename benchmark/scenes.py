"""The raw scene arrays of a configuration, built by the benchmark's own
frozen code (a copy of the port's procedural Cornell room and OBJ/MTL
parser) and handed alike to the program and to the plain reference.

`scene_arrays(config)` returns a dict of float32 numpy arrays:
positions, normals (T, 3, 3); per-triangle "mat.<field>"; spheres
"sph.center" (S, 3), "sph.radius" (S,), "sph.mat.<field>". What either
side derives from them (tangent frames, the light table, KD cells, packed
tables) it works out for itself.
"""

from __future__ import annotations

import os

import numpy as np

MAT_FIELDS = ("emittance", "albedo", "specular", "opacity", "roughness", "metallic")
DEFAULT_MAT = dict(emittance=(0.0, 0.0, 0.0), albedo=(1.0, 1.0, 1.0), specular=(0.04, 0.04, 0.04),
                   opacity=1.0, roughness=1.0, metallic=0.0)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mat(n: int, **kw) -> dict:
    m = {**DEFAULT_MAT, **kw}
    out = {}
    for f in MAT_FIELDS:
        v = np.asarray(m[f], np.float32)
        out[f] = np.array(np.broadcast_to(v, (n, 3) if v.ndim else (n,)), np.float32)
    return out


def quad(p00, p10, p11, p01, normal) -> np.ndarray:
    """Two triangles over the quad, wound so cross(E1, E2) is along normal."""
    p00, p10, p11, p01 = [np.asarray(p, np.float32) for p in (p00, p10, p11, p01)]
    tris = np.stack([np.stack([p00, p10, p11]), np.stack([p00, p11, p01])])
    gn = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    flip = (gn @ np.asarray(normal, np.float32)) < 0
    tris[flip] = tris[flip][:, ::-1, :]
    return tris


def box(center, half) -> np.ndarray:
    """(12, 3, 3) outward-wound triangles of an axis-aligned box."""
    c, h = np.asarray(center, np.float32), np.asarray(half, np.float32)
    lo, hi = c - h, c + h
    quads = []
    for axis, val, n in ((0, lo[0], (-1, 0, 0)), (0, hi[0], (1, 0, 0)), (1, lo[1], (0, -1, 0)),
                         (1, hi[1], (0, 1, 0)), (2, lo[2], (0, 0, -1)), (2, hi[2], (0, 0, 1))):
        a, b = [i for i in range(3) if i != axis]
        pts = []
        for u, v in ((0, 0), (1, 0), (1, 1), (0, 1)):
            p = np.empty(3, np.float32)
            p[axis] = val
            p[a] = lo[a] if u == 0 else hi[a]
            p[b] = lo[b] if v == 0 else hi[b]
            pts.append(p)
        quads.append(quad(*pts, normal=np.asarray(n, np.float32)))
    return np.concatenate(quads, axis=0)


def flat_normals(pos) -> np.ndarray:
    gn = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-12)
    return np.broadcast_to(gn[:, None, :], pos.shape).astype(np.float32).copy()


def room_parts(room: dict) -> list:
    """[(positions, normals, material)] of the closed Cornell room: floor,
    ceiling, back, front, left (red), right (green), then the ceiling light."""
    lo, hi = np.asarray(room["lo"], np.float32), np.asarray(room["hi"], np.float32)
    walls = (
        ([(lo[0], lo[1], lo[2]), (hi[0], lo[1], lo[2]), (hi[0], lo[1], hi[2]),
          (lo[0], lo[1], hi[2])], (0, 1, 0), room["white"]),
        ([(lo[0], hi[1], lo[2]), (hi[0], hi[1], lo[2]), (hi[0], hi[1], hi[2]),
          (lo[0], hi[1], hi[2])], (0, -1, 0), room["white"]),
        ([(lo[0], lo[1], lo[2]), (hi[0], lo[1], lo[2]), (hi[0], hi[1], lo[2]),
          (lo[0], hi[1], lo[2])], (0, 0, 1), room["white"]),
        ([(lo[0], lo[1], hi[2]), (hi[0], lo[1], hi[2]), (hi[0], hi[1], hi[2]),
          (lo[0], hi[1], hi[2])], (0, 0, -1), room["white"]),
        ([(lo[0], lo[1], lo[2]), (lo[0], hi[1], lo[2]), (lo[0], hi[1], hi[2]),
          (lo[0], lo[1], hi[2])], (1, 0, 0), room["red"]),
        ([(hi[0], lo[1], lo[2]), (hi[0], hi[1], lo[2]), (hi[0], hi[1], hi[2]),
          (hi[0], lo[1], hi[2])], (-1, 0, 0), room["green"]),
    )
    parts = []
    for pts, normal, albedo in walls:
        q = quad(*pts, normal=normal)
        parts.append((q, flat_normals(q), _mat(2, albedo=albedo, roughness=1.0)))
    ly, lh = hi[1] - room["light_inset"], room["light_half"]
    q = quad((-lh, ly, -lh), (lh, ly, -lh), (lh, ly, lh), (-lh, ly, lh), normal=(0, -1, 0))
    parts.append((q, flat_normals(q), _mat(2, albedo=room["white"], roughness=1.0,
                                          emittance=room["light_emit"])))
    return parts


def parse_mtl(path: str) -> dict:
    mats, cur = {}, None
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = mats.setdefault(parts[1], dict(DEFAULT_MAT, albedo=(0.8, 0.8, 0.8)))
            elif cur is None:
                continue
            elif key in ("Kd", "Ke", "Ks"):
                cur[{"Kd": "albedo", "Ke": "emittance", "Ks": "specular"}[key]] = tuple(
                    map(float, parts[1:4]))
            elif key == "d":
                cur["opacity"] = float(parts[1])
            elif key == "Tr":
                cur["opacity"] = 1.0 - float(parts[1])
            elif key == "Pr":
                cur["roughness"] = float(parts[1])
            elif key == "Pm":
                cur["metallic"] = float(parts[1])
            elif key == "Ns":
                cur["roughness"] = float(np.sqrt(2.0 / (float(parts[1]) + 2.0)))
    return mats


def mesh_part(mesh: dict):
    """(positions, normals, material) of an OBJ file: fan-triangulated,
    area-weighted smooth normals where the file gives none, MTL materials,
    the model transform T @ S with normals through its linear part."""
    path = os.path.join(REPO, mesh["obj"])
    vs, vns, faces, face_mtl, mats, cur = [], [], [], [], {}, ""
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v":
                vs.append(tuple(map(float, parts[1:4])))
            elif parts[0] == "vn":
                vns.append(tuple(map(float, parts[1:4])))
            elif parts[0] == "mtllib":
                mats.update(parse_mtl(os.path.join(os.path.dirname(path), parts[1])))
            elif parts[0] == "usemtl":
                cur = parts[1]
            elif parts[0] == "f":
                corners = []
                for p in parts[1:]:
                    toks = p.split("/")
                    vi = int(toks[0])
                    ni = int(toks[2]) if len(toks) > 2 and toks[2] else 0
                    corners.append((vi - 1 if vi > 0 else len(vs) + vi,
                                    ni - 1 if ni > 0 else (len(vns) + ni if ni else -1)))
                for k in range(1, len(corners) - 1):
                    faces.append((corners[0], corners[k], corners[k + 1]))
                    face_mtl.append(cur)
    v = np.asarray(vs, np.float32).reshape(-1, 3)
    fv = np.asarray([[c[0] for c in f] for f in faces], np.int64).reshape(-1, 3)
    fn = np.asarray([[c[1] for c in f] for f in faces], np.int64).reshape(-1, 3)
    if not vns or (fn < 0).any():
        acc = np.zeros_like(v)
        fnorm = np.cross(v[fv[:, 1]] - v[fv[:, 0]], v[fv[:, 2]] - v[fv[:, 0]])
        for k in range(3):
            np.add.at(acc, fv[:, k], fnorm)
        acc /= np.maximum(np.linalg.norm(acc, axis=-1, keepdims=True), 1e-12)
        normals = acc[fv]
    else:
        normals = np.asarray(vns, np.float32)[fn]
        normals /= np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-12)
    lin = np.diag(np.asarray(mesh["scale"], np.float64) * np.ones(3))
    pos = (v[fv] @ lin.T + np.asarray(mesh["translation"], np.float64)).astype(np.float32)
    normals = normals.astype(np.float32) @ lin.T
    normals = (normals / np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-12)
               ).astype(np.float32)
    defs = [mats.get(name, dict(DEFAULT_MAT, albedo=(0.8, 0.8, 0.8))) for name in face_mtl]
    mat = {f: np.asarray([d[f] for d in defs], np.float32) for f in MAT_FIELDS}
    return pos, normals, mat


def scene_arrays(config: dict) -> dict:
    """The raw arrays of a configuration's "scene": an optional OBJ "mesh"
    first, then the "room", then its "boxes"; "spheres" apart."""
    sc = config["scene"]
    parts = [mesh_part(sc["mesh"])] if sc.get("mesh") else []
    parts += room_parts(sc["room"])
    for b in sc.get("boxes", []):
        p = box(b["center"], b["half"])
        parts.append((p, flat_normals(p), _mat(p.shape[0], albedo=b["albedo"],
                                               roughness=b["roughness"])))
    out = {"positions": np.concatenate([p[0] for p in parts]).astype(np.float32),
           "normals": np.concatenate([p[1] for p in parts]).astype(np.float32)}
    for f in MAT_FIELDS:
        out[f"mat.{f}"] = np.concatenate([p[2][f] for p in parts]).astype(np.float32)
    spheres = sc.get("spheres", [])
    out["sph.center"] = np.asarray([s["center"] for s in spheres], np.float32).reshape(-1, 3)
    out["sph.radius"] = np.asarray([s["radius"] for s in spheres], np.float32).reshape(-1)
    sm = [_mat(1, **{k: s[k] for k in MAT_FIELDS if k in s}) for s in spheres]
    for f in MAT_FIELDS:
        out[f"sph.mat.{f}"] = (np.concatenate([m[f] for m in sm]) if sm
                               else np.zeros((0, 3) if f in ("emittance", "albedo", "specular")
                                             else (0,), np.float32))
    return out
