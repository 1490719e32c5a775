"""SoA 3-vector math on (..., 3) float32 tensors.

Port of pathtrace_tpu/utils/math3.py. Every op is written out as plain
elementwise torch (no fused multiply-add helpers such as addcmul or
lerp), so it rounds like the CUDA kernel built with -fmad=false.
"""

from __future__ import annotations

import torch

# Matches the reference's EPS (CudaPrimitive.cuh:11).
EPS = 1e-4

# Tiny guard for safe division/normalization (not a semantic tolerance).
TINY = 1e-20


def dot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    p = a * b
    out = p[..., 0] + p[..., 1] + p[..., 2]
    return out.unsqueeze(-1) if keepdim else out


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def squared_length(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return dot(v, v, keepdim)


def length(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.clamp(squared_length(v, keepdim), min=TINY))


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Safe normalize: 0 for (near-)zero vectors instead of NaN.

    The zero vector doubles as the reference's "dead sample" sentinel
    (CudaUtil.cuh:335-338), so 0 -> 0 is load-bearing. 1/sqrt, not rsqrt,
    as math3.normalize does (math3.py:48).
    """
    sq = squared_length(v, keepdim=True)
    inv = 1.0 / torch.sqrt(torch.clamp(sq, min=TINY))
    return v * torch.where(sq > TINY, inv, torch.zeros_like(inv))


def reflect(w: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """reflect(w, n) = -w + 2 (n.w) n, both pointing away from the surface."""
    return -w + 2.0 * dot(n, w, keepdim=True) * n


def refract(w: torch.Tensor, n: torch.Tensor, inv_eta: torch.Tensor) -> torch.Tensor:
    """Refraction of w through n; inv_eta is (...,) per lane. Total
    internal reflection returns the zero vector (CudaVector.cuh refract)."""
    inv_eta = inv_eta.unsqueeze(-1)
    cosine = dot(n, w, keepdim=True)
    k = 1.0 + inv_eta * inv_eta * (cosine * cosine - 1.0)
    k_pos = k > 0.0
    k_safe = torch.where(k_pos, k, torch.ones_like(k))
    out = -w * inv_eta + (inv_eta * cosine - torch.sqrt(k_safe)) * n
    return torch.where(k_pos, out, torch.zeros_like(out))


def lerp(x: torch.Tensor, y: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x*(1-alpha) + y*alpha (Bxdf.cuh:13-16)."""
    return x * (1.0 - alpha) + y * alpha


def mean3(v: torch.Tensor) -> torch.Tensor:
    """Channel mean with the reference's 0.333333 constant (Bxdf.cuh:18-21)."""
    return (v[..., 0] + v[..., 1] + v[..., 2]) * 0.333333


def max3(v: torch.Tensor) -> torch.Tensor:
    return torch.amax(v, dim=-1)


def safe_div(a: torch.Tensor, b: torch.Tensor, eps: float = TINY) -> torch.Tensor:
    """a/b with the sign of b preserved and |b| clamped away from 0."""
    floor = torch.where(b >= 0, torch.full_like(b, eps), torch.full_like(b, -eps))
    return a / torch.where(torch.abs(b) > eps, b, floor)


def div_scalar(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s, rounded as one IEEE division on every device. torch on CUDA
    divides by a Python scalar as x * (1/s), which differs in the last bit
    for divisors that are not powers of two; the kernel divides."""
    return x / torch.full_like(x, s)


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt clamped at 0 (x <= 1e-12 -> 0)."""
    positive = x > 1e-12
    root = torch.sqrt(torch.where(positive, x, torch.ones_like(x)))
    return torch.where(positive, root, torch.zeros_like(root))
