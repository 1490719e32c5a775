"""Debug and numerical-sanity modes (port of pathtrace_tpu/utils/debug.py).

They stand in for the reference's crash-on-NaN macros and device asserts
(CHECKNAN CudaVector.cuh:9-10; the integrator's asserts CudaUtil.cuh:304-346;
checkCudaErrors -> exit(99) CudaUtil.cuh:23-36):

- debug_nans(): a context manager around torch.autograd's anomaly mode, in
  which a backward that produces NaN raises with the forward op's
  traceback (JAX's jax_debug_nans);
- check_image(): validation of a rendered film on the host;
- checked_render(): render() and check_image().
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """torch.autograd.set_detect_anomaly(enable) for the block, restored
    after it."""
    with torch.autograd.set_detect_anomaly(enable):
        yield


class RenderCheckError(AssertionError):
    pass


def check_image(img, context: str = "render") -> None:
    """Invariants every film must satisfy: finite and non-negative."""
    a = torch.as_tensor(img).detach()
    finite = torch.isfinite(a)
    if not bool(finite.all()):
        raise RenderCheckError(f"{context}: {int((~finite).sum())} non-finite film values")
    if bool((a < 0).any()):
        raise RenderCheckError(f"{context}: negative radiance in film")


def checked_render(scene, camera, spp, key, cfg=None, **kw):
    """render(scene, camera, spp, key, cfg, **kw) (integrator/render.py),
    raising RenderCheckError unless its image passes check_image."""
    from pathtrace_tpu_torch.integrator.config import IntegratorConfig
    from pathtrace_tpu_torch.integrator.render import render

    img = render(scene, camera, spp, key, cfg or IntegratorConfig(), **kw)
    check_image(img)
    return img
