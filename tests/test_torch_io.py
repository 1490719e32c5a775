"""Film output of the port vs the JAX package's io/image.py: the ACES
constants and the uint8 quantization are exact (elementwise float32 ops in
the same order; tolerance 0), and the standard-library PNG encoder writes
a valid file that decodes back to the quantized pixels. read_npy reads what
write_npy wrote.

Checkpoints (io/checkpoint.py against the JAX package's): a state written
by either package loads in either, with the same .npz keys, the image, the
counters and both material tables equal; without materials the tables
load as None; an unknown format version raises; the write leaves no
temporary file."""

import os
import struct
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pathtrace_tpu.io import checkpoint as jcheckpoint  # noqa: E402
from pathtrace_tpu.io import image as jimage  # noqa: E402
from pathtrace_tpu.models.scene import Material as JMaterial  # noqa: E402
from pathtrace_tpu_torch.io import checkpoint, image  # noqa: E402
from pathtrace_tpu_torch.models.scene import Material  # noqa: E402
from torch_port_helpers import MAT_FIELDS  # noqa: E402


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


def test_read_npy(tmp_path):
    x = _linear(4)
    path = str(tmp_path / "img.npy")
    image.write_npy(path, torch.from_numpy(x))
    np.testing.assert_array_equal(image.read_npy(path), x)
    np.testing.assert_array_equal(image.read_npy(path), jimage.read_npy(path))


def _materials(seed):
    """(tri, sphere) tables as numpy dicts: 5 triangles, 2 spheres."""
    g = np.random.default_rng(seed)
    return [{f: g.random((n, 3) if f in ("emittance", "albedo", "specular") else (n,))
             .astype(np.float32) for f in MAT_FIELDS} for n in (5, 2)]


WRITERS = {
    "port": lambda path, accum, mats: checkpoint.save_state(
        path, torch.from_numpy(accum), 3, 11, 16,
        *(Material(**{f: torch.from_numpy(a) for f, a in m.items()}) for m in mats)),
    "jax": lambda path, accum, mats: jcheckpoint.save_state(
        path, accum, 3, 11, 16, *(JMaterial(**m) for m in mats)),
}
READERS = {"port": checkpoint.load_state, "jax": jcheckpoint.load_state}


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"),
                                           ("port", "jax")])
def test_checkpoint_cross_loads(tmp_path, writer, reader):
    accum = _linear(5, (6, 7, 3))
    mats = _materials(6)
    path = str(tmp_path / "state.npz")
    WRITERS[writer](path, accum, mats)
    assert os.listdir(tmp_path) == ["state.npz"]
    state = READERS[reader](path)
    np.testing.assert_array_equal(state["accum_image"], accum)
    assert (state["passes_done"], state["seed"], state["spp_per_pass"]) == (3, 11, 16)
    for got, want in zip((state["tri_mat"], state["sph_mat"]), mats):
        for f in MAT_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(got, f)), want[f])
    if reader == "port":
        assert isinstance(state["tri_mat"].albedo, torch.Tensor)
    other = str(tmp_path / "other.npz")
    WRITERS["jax" if writer == "port" else "port"](other, accum, mats)
    assert sorted(np.load(path).files) == sorted(np.load(other).files)


def test_checkpoint_without_materials_and_version(tmp_path):
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, torch.zeros((2, 2, 3)), 1, 0, 4)
    state = checkpoint.load_state(path)
    assert state["tri_mat"] is None and state["sph_mat"] is None
    assert jcheckpoint.load_state(path)["passes_done"] == 1
    z = dict(np.load(path))
    z["meta"] = np.frombuffer(b'{"version": 2, "passes_done": 1, "seed": 0, '
                              b'"spp_per_pass": 4}', np.uint8)
    np.savez(path, **z)
    with pytest.raises(ValueError, match="format 2"):
        checkpoint.load_state(path)
