"""Why the port's glass golden bar is 97% of pixels (test_torch_render.py).

The glass golden (tests/golden/glass_24x24_8spp_seed7.npy) is a
jit-compiled JAX render, and glass transport is chaotic: a program that
rounds differently forks a few paths. The JAX package's own render run op
by op (jax.disable_jit), which rounds as eager torch does, agrees with the
golden on 97.57% of pixels within 5e-3 (measured): above the port's 97%
bar, and below the 98% wavefront bar of tests/test_golden.py:78-80, which
no program rounding op by op meets. The port's render equals the op-by-op
JAX render path for path (test_torch_megakernel.py). If the op-by-op
agreement ever reaches 98%, the port's bar should go back to 98%.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from pathtrace_tpu import render as jax_render  # noqa: E402
from pathtrace_tpu.models import procedural as jproc  # noqa: E402
from pathtrace_tpu.utils import rng as jrng  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "glass_24x24_8spp_seed7.npy")


def test_glass_golden_bar_is_what_jax_op_by_op_meets():
    ref = np.load(GOLDEN)
    with jax.disable_jit():
        img = np.asarray(jax_render(jproc.glass_scene(), jproc.default_camera(24, 24), 8,
                                    jrng.make_key(7)))
    agree = np.isclose(img, ref, rtol=5e-3, atol=5e-3).mean()
    assert 0.97 < agree < 0.98, f"op-by-op JAX agrees with the golden on {agree}"
    assert abs(img.mean() - ref.mean()) / ref.mean() < 5e-3
