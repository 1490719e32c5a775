"""The fused entry point of the port on the CPU, where it runs the CUDA
kernel's plain version (the static strided wavefront).

- Against the JAX fused engine in interpret mode with spheres, at the
  statistical bars of tests/test_fused.py:50-75: curved transport amplifies
  float rounding differences per bounce, so means within 2%, > 50% of
  pixels within 1e-3, ray counts within 2%.
- Chunked launches equal a single launch (same path ids; 1e-5).
"""

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from pathtrace_tpu.integrator.config import IntegratorConfig as JConfig  # noqa: E402
from pathtrace_tpu.models import procedural as jproc  # noqa: E402
from pathtrace_tpu.ops.pallas.bounce_kernel import (  # noqa: E402
    render_wavefront_fused as jax_fused)
from pathtrace_tpu.utils import rng as jrng  # noqa: E402
from pathtrace_tpu_torch.models import procedural  # noqa: E402
from pathtrace_tpu_torch.ops.cuda.bounce_kernel import render_wavefront_fused  # noqa: E402
from pathtrace_tpu_torch.utils import rng  # noqa: E402
from torch_port_helpers import port_scene  # noqa: E402

# Test workers share the CPU; one intra-op thread each is as fast here
# and avoids oversubscription.
torch.set_num_threads(1)


def test_fused_plain_matches_jax_fused_spheres_statistical():
    js = jproc.cornell_box_scene(include_spheres=True).with_mt()
    spp, lanes = 16, 256
    a, rays_a = jax_fused(js, jproc.default_camera(16, 16), spp, jrng.make_key(5),
                          JConfig(), lanes=lanes, chunk_spp=spp, block_r=lanes,
                          interpret=True)
    b, rays_b = render_wavefront_fused(port_scene(js), procedural.default_camera(16, 16),
                                       spp, rng.make_key(5), lanes=lanes, chunk_spp=spp,
                                       device="cpu")
    a, b = np.asarray(a), b.numpy()
    assert abs(a.mean() - b.mean()) / a.mean() < 0.02
    close = np.isclose(a, b, rtol=1e-3, atol=1e-3)
    assert close.mean() > 0.5, f"pixel agreement {close.mean()}"
    assert rays_b == pytest.approx(rays_a, rel=0.02)


def test_fused_chunked_equals_single():
    scene = procedural.cornell_box_scene(include_spheres=True)
    cam = procedural.default_camera(8, 8)
    key = rng.make_key(9)
    a, ra = render_wavefront_fused(scene, cam, 8, key, lanes=64, chunk_spp=8, device="cpu")
    b, rb = render_wavefront_fused(scene, cam, 8, key, lanes=64, chunk_spp=2, device="cpu")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    assert ra == rb
