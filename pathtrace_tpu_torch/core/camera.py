"""Pinhole camera + ray generation (port of pathtrace_tpu/core/camera.py).

Camera fields are host numpy float32 values, exactly the JAX camera's
leaves. Primary directions use one formula in both the plain wavefront and
the CUDA kernel: tan(fov/2) is taken ONCE, in float32 on the host
(`tan_half_fov`), and both sides compute
    normalize(F + (sx * tan_x) R - (sy * tan_y) U).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pathtrace_tpu_torch.utils import math3


@dataclasses.dataclass(frozen=True)
class Camera:
    pos: np.ndarray       # (3,) float32
    forward: np.ndarray   # (3,)
    up: np.ndarray        # (3,)
    right: np.ndarray     # (3,)
    fovy: np.float32      # radians
    fovx: np.float32      # radians
    width: int
    height: int

    @staticmethod
    def from_rotation(pos, rotation_deg=(0.0, 90.0, 0.0), fovy_deg=45.0,
                      width=512, height=512) -> "Camera":
        """Reference (roll, pitch, yaw) convention (camera.cpp:42-66),
        pitch clamped to [0, 180]."""
        _, pitch, yaw = rotation_deg
        pitch = min(max(pitch, 0.0), 180.0)
        p, y = math.radians(pitch), math.radians(yaw)
        forward = np.array(
            [-math.sin(p) * math.sin(y), math.cos(p), -math.sin(p) * math.cos(y)],
            np.float32)
        up = np.array(
            [math.cos(p) * math.sin(y), math.sin(p), math.cos(p) * math.cos(y)],
            np.float32)
        forward /= np.linalg.norm(forward)
        up = up - forward * np.dot(forward, up)
        up /= np.linalg.norm(up)
        return Camera._finish(pos, forward, up, fovy_deg, width, height)

    @staticmethod
    def look_at(pos, target, up=(0.0, 1.0, 0.0), fovy_deg=45.0,
                width=512, height=512) -> "Camera":
        pos = np.asarray(pos, np.float32)
        forward = np.asarray(target, np.float32) - pos
        forward /= np.linalg.norm(forward)
        up = np.asarray(up, np.float32)
        up = up - forward * np.dot(forward, up)
        up /= np.linalg.norm(up)
        return Camera._finish(pos, forward, up, fovy_deg, width, height)

    @staticmethod
    def _finish(pos, forward, up, fovy_deg, width, height) -> "Camera":
        right = np.cross(forward, up)
        right /= np.linalg.norm(right)
        fovy = math.radians(fovy_deg)
        aspect = width / height
        # fovx from fovy and aspect (pathtracer.cu:198)
        fovx = 2.0 * math.atan2(math.tan(fovy * 0.5) * aspect, 1.0)
        f = np.float32
        return Camera(
            pos=np.asarray(pos, f), forward=np.asarray(forward, f),
            up=np.asarray(up, f), right=np.asarray(right, f),
            fovy=f(fovy), fovx=f(fovx),
            width=int(width), height=int(height),
        )

    def tan_half_fov(self):
        """(tan(fovx/2), tan(fovy/2)) as float32 values taken on the host."""
        t = torch.tan(torch.tensor([self.fovx, self.fovy], dtype=torch.float32)
                      * 0.5)
        return float(t[0]), float(t[1])

    def ray_directions(self, px: torch.Tensor, py: torch.Tensor,
                       jitter_x: torch.Tensor, jitter_y: torch.Tensor) -> torch.Tensor:
        """Jittered primary directions, (R, 3) (pathtracer.cu:33-40):
          dir = normalize(F + 2((px+u)/(W-1) - .5) tan(fovx/2) R
                            - 2((py+v)/(H-1) - .5) tan(fovy/2) U)."""
        dev = px.device
        tx, ty = self.tan_half_fov()
        vec = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        sx = 2.0 * (math3.div_scalar(px + jitter_x, self.width - 1) - 0.5)
        sy = 2.0 * (math3.div_scalar(py + jitter_y, self.height - 1) - 0.5)
        d = (vec(self.forward)[None, :]
             + (sx * tx)[:, None] * vec(self.right)[None, :]
             - (sy * ty)[:, None] * vec(self.up)[None, :])
        return math3.normalize(d)

    def pixel_grid(self, device="cpu"):
        """(R,) float32 px, py in row-major order (R = W*H)."""
        py, px = torch.meshgrid(
            torch.arange(self.height, dtype=torch.float32, device=device),
            torch.arange(self.width, dtype=torch.float32, device=device),
            indexing="ij")
        return px.reshape(-1), py.reshape(-1)
