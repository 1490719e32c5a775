"""The plain reference's arithmetic, RNG, camera and scene tables.

A frozen, trimmed copy of the port's plain path tracer (its math3, rng,
camera and scene modules), written out in plain PyTorch and imported from
nowhere else: the benchmark's yardstick must not move when the program
does. Every op is plain elementwise torch with no fused multiply-add, so
in float32 it rounds as the port's kernels do (built with -fmad=false).

Floating tensors take torch's default dtype, so the same code computed
under `torch.set_default_dtype(torch.bfloat16)` is the control that a
lower precision must fail (benchmark/control.py).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

EPS = 1e-4
TINY = 1e-20
BIG_T = 999999.0

# --------------------------------------------------------------------------
# 3-vector arithmetic on (..., 3) tensors
# --------------------------------------------------------------------------


def dot(a, b, keepdim: bool = False):
    p = a * b
    out = p[..., 0] + p[..., 1] + p[..., 2]
    return out.unsqueeze(-1) if keepdim else out


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def squared_length(v, keepdim: bool = False):
    return dot(v, v, keepdim)


def length(v, keepdim: bool = False):
    return torch.sqrt(torch.clamp(squared_length(v, keepdim), min=TINY))


def normalize(v):
    """0 for (near-)zero vectors: the zero vector is the dead-sample sentinel."""
    sq = squared_length(v, keepdim=True)
    inv = 1.0 / torch.sqrt(torch.clamp(sq, min=TINY))
    return v * torch.where(sq > TINY, inv, torch.zeros_like(inv))


def reflect(w, n):
    return -w + 2.0 * dot(n, w, keepdim=True) * n


def refract(w, n, inv_eta):
    """Refraction of w through n; total internal reflection gives 0."""
    inv_eta = inv_eta.unsqueeze(-1)
    cosine = dot(n, w, keepdim=True)
    k = 1.0 + inv_eta * inv_eta * (cosine * cosine - 1.0)
    k_pos = k > 0.0
    k_safe = torch.where(k_pos, k, torch.ones_like(k))
    out = -w * inv_eta + (inv_eta * cosine - torch.sqrt(k_safe)) * n
    return torch.where(k_pos, out, torch.zeros_like(out))


def lerp(x, y, alpha):
    return x * (1.0 - alpha) + y * alpha


def mean3(v):
    return (v[..., 0] + v[..., 1] + v[..., 2]) * 0.333333


def max3(v):
    return torch.amax(v, dim=-1)


def safe_div(a, b, eps: float = TINY):
    floor = torch.where(b >= 0, torch.full_like(b, eps), torch.full_like(b, -eps))
    return a / torch.where(torch.abs(b) > eps, b, floor)


def div_scalar(x, s: float):
    """x / s as one IEEE division (torch on CUDA multiplies by 1/s)."""
    return x / torch.full_like(x, s)


def safe_sqrt(x):
    positive = x > 1e-12
    root = torch.sqrt(torch.where(positive, x, torch.ones_like(x)))
    return torch.where(positive, root, torch.zeros_like(root))


# --------------------------------------------------------------------------
# Philox4x32-10, keyed by (key, path id, path-local iteration, column)
# --------------------------------------------------------------------------

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
STREAM_PATH = 0x50415448
STREAM_JITTER = 0x4A495454
COL_LIGHT_PICK, COL_NEE_R1, COL_NEE_R2, COL_LOBE, COL_PHI, COL_RY, COL_RR = range(7)


def _mulhilo(a: int, b):
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    lo_lo, mid1, mid2, hi_hi = a0 * b0, a1 * b0, a0 * b1, a1 * b1
    carry = ((lo_lo >> 16) + (mid1 & 0xFFFF) + (mid2 & 0xFFFF)) >> 16
    hi = hi_hi + (mid1 >> 16) + (mid2 >> 16) + carry
    lo = (lo_lo + ((mid1 + mid2) << 16)) & _MASK
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Ten Philox rounds over int64 tensors (or ints) holding uint32 words."""
    dev = next((c.device for c in (c0, c1, c2, c3) if torch.is_tensor(c)), None)
    c0, c1, c2, c3 = torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=torch.int64, device=dev) for c in (c0, c1, c2, c3)))
    k0, k1 = int(k0) & _MASK, int(k1) & _MASK
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK
        k1 = (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def _unit(u):
    """uint32 word -> [0, 1) from its top 24 bits (exact in float32)."""
    return (u >> 8).to(torch.float32).to(torch.get_default_dtype()) * (1.0 / (1 << 24))


def make_key(seed: int) -> tuple:
    """The Philox key (two uint32 words) of an integer seed of any size."""
    return (seed & _MASK, ((seed >> 32) & _MASK) ^ 0xA5A5A5A5)


def iter_key(key: tuple, tag: int) -> tuple:
    """Independent subkey; unit p of a run is keyed iter_key(key, 1000 + p)."""
    c0, c1, _, _ = philox4x32(int(tag) & _MASK, 0x5EEDF01D, 0, 1, *key)
    return (int(c0), int(c1))


def uniforms(key: tuple, ray_ids, iteration):
    """(R, 8) uniforms of (key, path id, iteration)."""
    rid = ray_ids.to(torch.int64) & _MASK
    it = torch.as_tensor(iteration, dtype=torch.int64, device=rid.device).expand_as(rid) & _MASK
    outs = []
    for block in range(2):
        outs.extend(philox4x32(rid, it, block, STREAM_PATH, *key))
    return _unit(torch.stack(outs, dim=-1))


def pixel_jitter(key: tuple, ray_ids):
    rid = ray_ids.to(torch.int64) & _MASK
    c0, c1, _, _ = philox4x32(rid, 0, 0, STREAM_JITTER, *key)
    return _unit(torch.stack([c0, c1], dim=-1))


def randint_from_uniform(u, n: int):
    return torch.clamp((u * n).to(torch.int32), max=n - 1)


# --------------------------------------------------------------------------
# Pinhole camera
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Camera:
    pos: np.ndarray
    forward: np.ndarray
    up: np.ndarray
    right: np.ndarray
    tan_x: float
    tan_y: float
    width: int
    height: int

    @staticmethod
    def from_rotation(pos, rotation_deg, fovy_deg: float, width: int, height: int):
        """The reference viewer's (roll, pitch, yaw) pose, pitch in [0, 180];
        tan(fov / 2) taken once in float32 on the host."""
        _, pitch, yaw = rotation_deg
        pitch = min(max(pitch, 0.0), 180.0)
        p, y = math.radians(pitch), math.radians(yaw)
        f32 = np.float32
        forward = np.array([-math.sin(p) * math.sin(y), math.cos(p),
                            -math.sin(p) * math.cos(y)], f32)
        up = np.array([math.cos(p) * math.sin(y), math.sin(p), math.cos(p) * math.cos(y)], f32)
        forward /= np.linalg.norm(forward)
        up = up - forward * np.dot(forward, up)
        up /= np.linalg.norm(up)
        right = np.cross(forward, up)
        right /= np.linalg.norm(right)
        fovy = math.radians(fovy_deg)
        fovx = 2.0 * math.atan2(math.tan(fovy * 0.5) * (width / height), 1.0)
        tan = torch.tan(torch.tensor([f32(fovx), f32(fovy)], dtype=torch.float32) * 0.5)
        return Camera(np.asarray(pos, f32), forward.astype(f32), up.astype(f32),
                      right.astype(f32), float(tan[0]), float(tan[1]), int(width), int(height))

    @property
    def num_pix(self) -> int:
        return self.width * self.height

    def rays(self, key: tuple, path_ids):
        """(org, dir) of the jittered camera rays of global path ids
        sample * num_pix + pixel."""
        pixel = path_ids % self.num_pix
        dt = torch.get_default_dtype()
        px = (pixel % self.width).to(dt)
        py = (pixel // self.width).to(dt)
        ju = pixel_jitter(key, path_ids)
        vec = lambda a: torch.as_tensor(a, dtype=dt, device=path_ids.device)
        sx = 2.0 * (div_scalar(px + ju[:, 0], self.width - 1) - 0.5)
        sy = 2.0 * (div_scalar(py + ju[:, 1], self.height - 1) - 0.5)
        d = (vec(self.forward)[None, :] + (sx * self.tan_x)[:, None] * vec(self.right)[None, :]
             - (sy * self.tan_y)[:, None] * vec(self.up)[None, :])
        d = normalize(d)
        return vec(self.pos).expand_as(d), d


# --------------------------------------------------------------------------
# Scene tables, worked out from the benchmark's raw arrays
# --------------------------------------------------------------------------

MAT_FIELDS = ("emittance", "albedo", "specular", "opacity", "roughness", "metallic")


@dataclasses.dataclass(frozen=True)
class Material:
    emittance: torch.Tensor  # (N, 3)
    albedo: torch.Tensor     # (N, 3)
    specular: torch.Tensor   # (N, 3)
    opacity: torch.Tensor    # (N,)
    roughness: torch.Tensor  # (N,)
    metallic: torch.Tensor   # (N,)

    def gather(self, idx) -> "Material":
        idx = idx.long()
        return Material(*[torch.index_select(getattr(self, f), 0, idx) for f in MAT_FIELDS])


def tangent_frame(normals: np.ndarray):
    """Per-vertex tangent and bitangent from the normal: cross with the
    axis least aligned with it."""
    flat = np.asarray(normals, np.float32).reshape(-1, 3)
    helper = np.where(np.abs(flat[:, 1:2]) < 0.99, np.array([[0.0, 1.0, 0.0]], np.float32),
                      np.array([[1.0, 0.0, 0.0]], np.float32))
    t = np.cross(helper, flat)
    t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
    b = np.cross(flat, t)
    return t.reshape(normals.shape), b.reshape(normals.shape)


@dataclasses.dataclass(frozen=True)
class Scene:
    """Triangles (per-vertex fields (T, 3) each), per-triangle materials,
    spheres and the light table, on one device in the default dtype."""

    v0: torch.Tensor
    v1: torch.Tensor
    v2: torch.Tensor
    n: tuple          # three (T, 3) vertex normals
    t: tuple          # tangents
    b: tuple          # bitangents
    mat: Material
    sph_center: torch.Tensor
    sph_radius: torch.Tensor
    sph_mat: Material
    lights: torch.Tensor      # (L,) int64 emissive triangle ids
    light_pack: torch.Tensor  # (L, 13) v0 v1 v2 area geometric normal

    @property
    def num_tris(self) -> int:
        return self.v0.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def num_lights(self) -> int:
        return self.lights.shape[0]

    @property
    def search_table(self):
        return torch.cat([self.v0, self.v1 - self.v0, self.v2 - self.v0], dim=1)

    def with_materials(self, mat: Material, sph_mat: Material) -> "Scene":
        return dataclasses.replace(self, mat=mat, sph_mat=sph_mat)

    @staticmethod
    def from_arrays(arrays: dict, device) -> "Scene":
        """From the benchmark's raw arrays (benchmark/scenes.py): positions
        and normals (T, 3, 3), per-triangle material fields "mat.<field>",
        spheres "sph.center", "sph.radius", "sph.mat.<field>". The tables
        are worked out on the host, as the port builds its scene, and moved."""
        dt = torch.get_default_dtype()
        f = lambda a: torch.from_numpy(np.array(a, np.float32)).to(dt)
        pos = np.asarray(arrays["positions"], np.float32)
        nrm = np.asarray(arrays["normals"], np.float32)
        tan, bit = tangent_frame(nrm)
        mat = lambda pre: Material(*[f(arrays[f"{pre}.{k}"]) for k in MAT_FIELDS])
        v0, v1, v2 = (f(pos[:, k]) for k in range(3))
        emit = np.asarray(arrays["mat.emittance"], np.float32)
        li = torch.from_numpy(np.nonzero(np.linalg.norm(emit, axis=-1) > EPS)[0].astype(np.int64))
        e1, e2 = v1 - v0, v2 - v0
        cr = cross(e1, e2)
        pack = torch.cat([v0[li], v1[li], v2[li], (length(cr) * 0.5)[li][:, None],
                          normalize(cr)[li]], dim=1)
        host = Scene(v0=v0, v1=v1, v2=v2, n=tuple(f(nrm[:, k]) for k in range(3)),
                     t=tuple(f(tan[:, k]) for k in range(3)),
                     b=tuple(f(bit[:, k]) for k in range(3)), mat=mat("mat"),
                     sph_center=f(arrays["sph.center"]).reshape(-1, 3),
                     sph_radius=f(arrays["sph.radius"]).reshape(-1), sph_mat=mat("sph.mat"),
                     lights=li, light_pack=pack)
        return host.to(device)

    def to(self, device) -> "Scene":
        def move(v):
            if torch.is_tensor(v):
                return v.to(device)
            if isinstance(v, tuple):
                return tuple(move(x) for x in v)
            return Material(*[move(getattr(v, k)) for k in MAT_FIELDS])
        return Scene(**{f.name: move(getattr(self, f.name)) for f in dataclasses.fields(self)})
