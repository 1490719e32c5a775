"""The port's lockstep megakernel against the JAX megakernel run op by op.

Under jax.disable_jit every JAX primitive runs on its own, rounding as IEEE
float32 op-by-op arithmetic does, which is what eager torch computes: the
same Philox streams then trace the same paths, and even chaotic glass
transport agrees pixel for pixel. (Against the jit-compiled JAX render,
whose fused code rounds differently, glass agrees only statistically; see
test_torch_render.py.) Bars: >= 99.5% of pixels within rtol=atol=1e-4
(measured 99.83% at 2 spp: a rare path still meets a last-ulp fork), image
mean within 1e-5 relative (measured 5.8e-7).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from pathtrace_tpu import render as jax_render  # noqa: E402
from pathtrace_tpu.models import procedural as jproc  # noqa: E402
from pathtrace_tpu.utils import rng as jrng  # noqa: E402
from pathtrace_tpu_torch.integrator.render import render  # noqa: E402
from pathtrace_tpu_torch.models import procedural  # noqa: E402
from pathtrace_tpu_torch.utils import rng  # noqa: E402

# Test workers share the CPU; one intra-op thread each is as fast here
# and avoids oversubscription.
torch.set_num_threads(1)


def test_glass_paths_match_jax_op_by_op():
    with jax.disable_jit():
        a = np.asarray(jax_render(jproc.glass_scene(), jproc.default_camera(24, 24), 2,
                                  jrng.make_key(7)))
    b = render(procedural.glass_scene(), procedural.default_camera(24, 24), 2,
               rng.make_key(7), device="cpu").numpy()
    close = np.isclose(a, b, rtol=1e-4, atol=1e-4)
    assert close.mean() >= 0.995, f"pixel agreement {close.mean()}"
    assert abs(a.mean() - b.mean()) / a.mean() < 1e-5
