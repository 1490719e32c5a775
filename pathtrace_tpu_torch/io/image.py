"""Film output: ACES tonemap, quantization, PNG/npy export (port of
pathtrace_tpu/io/image.py).

The PNG writer uses only zlib and struct from the standard library, so
nothing on the render path needs an imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from pathtrace_tpu_torch.utils.profiling import span


def aces_film(x: torch.Tensor) -> torch.Tensor:
    """ACES filmic fit, exact reference constants (CudaUtil.cuh:383-391)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def to_uint8(x) -> np.ndarray:
    """uint8(v * 255.99) (image.h:6-8)."""
    x = np.asarray(x)
    return (np.clip(x, 0.0, 1.0) * 255.99).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> 8-bit RGB PNG bytes (filter 0 on every row)."""
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, linear_image, tonemap: bool = True) -> None:
    """The image to the host, tonemapped, encoded and written (span
    io.png)."""
    with span("io.png"):
        img = torch.as_tensor(linear_image, dtype=torch.float32).cpu()
        if tonemap:
            img = aces_film(img)
        with open(path, "wb") as f:
            f.write(encode_png(to_uint8(img.numpy())))


def write_npy(path: str, linear_image) -> None:
    np.save(path, torch.as_tensor(linear_image, dtype=torch.float32).cpu().numpy())


def read_npy(path: str) -> np.ndarray:
    return np.load(path)
