"""The port's 3-vector math (utils/math3.py) against the JAX package's.

Elementwise on random float32 vectors from a numpy seed, with the edge
cases the renderer leans on: the zero vector normalizes to zero (the dead
sample sentinel), total internal reflection refracts to zero, safe_div
keeps the divisor's sign, safe_sqrt clamps at 1e-12. Tolerance rtol 1e-6,
atol 1e-6: both sides run op by op in float32, but XLA may round an
intermediate (a dot's sum, a reciprocal square root) one ulp apart, and the
inputs reach magnitude 4, whose ulp is 4.8e-7; where a result cancels to
near zero (reflect) it keeps that absolute error.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pathtrace_tpu.utils import math3 as jm  # noqa: E402
from pathtrace_tpu_torch.utils import math3 as tm  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _vecs(seed, n=4096):
    r = np.random.default_rng(seed)
    v = r.normal(size=(n, 3)).astype(np.float32)
    v[:4] = [[0, 0, 0], [1e-12, 0, 0], [3, 4, 0], [-1e-3, 2e-3, 5e-4]]
    return v


def _close(j, t):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), **TOL)


def test_constants():
    assert (tm.EPS, tm.TINY) == (jm.EPS, jm.TINY)


@pytest.mark.parametrize("fn", ["dot", "cross", "squared_length", "length", "normalize",
                                "reflect", "lerp", "mean3", "max3", "safe_div",
                                "safe_sqrt"])
def test_elementwise_matches(fn):
    a, b, c = _vecs(1), _vecs(2), np.random.default_rng(3).random((4096, 3), np.float32)
    ja, jb, jc = jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)
    ta, tb, tc = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)
    if fn in ("dot", "cross"):
        _close(getattr(jm, fn)(ja, jb), getattr(tm, fn)(ta, tb))
    elif fn in ("squared_length", "length", "normalize", "mean3", "max3"):
        _close(getattr(jm, fn)(ja), getattr(tm, fn)(ta))
    elif fn == "reflect":
        _close(jm.reflect(ja, jm.normalize(jb)), tm.reflect(ta, tm.normalize(tb)))
    elif fn == "lerp":
        _close(jm.lerp(ja, jb, jc), tm.lerp(ta, tb, tc))
    elif fn == "safe_div":
        d = b.copy()
        d[:8, 0] = [0.0, -0.0, 1e-21, -1e-21, 1e-19, -1e-19, 2.0, -2.0]
        _close(jm.safe_div(ja, jnp.asarray(d)), tm.safe_div(ta, torch.from_numpy(d)))
    else:
        x = a[:, 0] * 1e-6
        x[:4] = [0.0, 1e-12, 2e-12, -1.0]
        _close(jm.safe_sqrt(jnp.asarray(x)), tm.safe_sqrt(torch.from_numpy(x)))


def test_normalize_zero_is_zero():
    z = torch.zeros((2, 3))
    z[1, 0] = 1e-11  # squared length 1e-22 <= TINY
    assert torch.equal(tm.normalize(z), torch.zeros((2, 3)))


def test_refract_matches_with_total_internal_reflection():
    w, n = _vecs(4), np.random.default_rng(5).normal(size=(4096, 3)).astype(np.float32)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    w = w / np.maximum(np.linalg.norm(w, axis=-1, keepdims=True), 1e-12)
    inv_eta = np.random.default_rng(6).uniform(0.5, 2.0, 4096).astype(np.float32)
    j = jm.refract(jnp.asarray(w), jnp.asarray(n), jnp.asarray(inv_eta))
    t = tm.refract(torch.from_numpy(w), torch.from_numpy(n), torch.from_numpy(inv_eta))
    _close(j, t)
    tir = 1.0 + inv_eta ** 2 * ((w * n).sum(-1) ** 2 - 1.0) <= 0.0
    assert tir.any() and (t.numpy()[tir] == 0.0).all()


def test_div_scalar_is_ieee_division():
    """Bit-equal to numpy's float32 division, for divisors that are not
    powers of two (where x * (1/s) would round differently)."""
    x = np.random.default_rng(7).uniform(0, 300, 100000).astype(np.float32)
    for s in (3, 31, 255, 7.0):
        want = x / np.float32(s)
        got = tm.div_scalar(torch.from_numpy(x), s).numpy()
        assert np.array_equal(got, want), s
