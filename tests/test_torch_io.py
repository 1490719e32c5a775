"""Film output of the port vs the JAX package's io/image.py: the ACES
constants and the uint8 quantization are exact (elementwise float32 ops in
the same order; tolerance 0), and the standard-library PNG encoder writes
a valid file that decodes back to the quantized pixels."""

import struct
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pathtrace_tpu.io import image as jimage  # noqa: E402
from pathtrace_tpu_torch.io import image  # noqa: E402


def _linear(seed, shape=(17, 23, 3)):
    x = np.random.default_rng(seed).gamma(1.0, 1.5, shape).astype(np.float32)
    x.flat[:4] = [0.0, 1e-6, 30.0, 1.0]
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_aces_and_uint8_exact(seed):
    x = _linear(seed)
    a = np.asarray(jimage.aces_film(jnp.asarray(x)))
    b = image.aces_film(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jimage.to_uint8(a), image.to_uint8(b))


def _decode_png(data: bytes) -> np.ndarray:
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, dims = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(tag + body)
        if tag == b"IHDR":
            dims = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = dims[:4]
    assert (depth, color) == (8, 2)
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_write_png_round_trip(tmp_path):
    x = _linear(2)
    path = tmp_path / "img.png"
    image.write_png(str(path), torch.from_numpy(x))
    want = jimage.to_uint8(np.asarray(jimage.aces_film(jnp.asarray(x))))
    np.testing.assert_array_equal(_decode_png(path.read_bytes()), want)


def test_write_npy_round_trip(tmp_path):
    x = _linear(3)
    path = tmp_path / "img.npy"
    image.write_npy(str(path), torch.from_numpy(x))
    np.testing.assert_array_equal(np.load(path), x)
