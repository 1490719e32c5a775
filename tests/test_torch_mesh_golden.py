"""The mesh path against the committed blob82k golden.

The port's wavefront renders blob82k (the 82k-triangle OBJ asset in the
Cornell room, KD cells of 1024, the plain KD raycast on the CPU) at
48x48 @ 4 spp with make_key(11) and 2304 lanes, the shape and key of
tools/tpu_cpu_agreement.py's mesh row, and is held to that row's bar
(tpu_cpu_agreement.py:88-92): > 99.5% of pixels within rtol = atol = 5e-3
and the mean within 1e-3. The golden is a CPU render of the JAX package
through a KD-free backend; the KD winner equals brute's, so agreement is
near exact (measured: every pixel, mean difference 0).
"""

import os

import numpy as np
import torch

from pathtrace_tpu_torch.integrator.wavefront import render_wavefront_stats
from pathtrace_tpu_torch.models import procedural
from pathtrace_tpu_torch.utils import rng

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "blob82k_48x48_4spp_seed11.npy")

torch.set_num_threads(1)


def test_blob82k_wavefront_kd_matches_golden():
    scene = procedural.blob_mesh_scene().with_kd_binned(max_tris=1024)
    assert scene.clusters.num_clusters == 157
    ref = np.load(GOLDEN)
    img, rays = render_wavefront_stats(scene, procedural.default_camera(48, 48), 4,
                                       rng.make_key(11), lanes=2304, device="cpu")
    img = img.numpy()
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.isclose(img, ref, rtol=5e-3, atol=5e-3)
    assert close.mean() > 0.995, f"pixel agreement {close.mean()}"
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3
    assert 48 * 48 * 4 <= rays <= 48 * 48 * 4 * 2 * 18
