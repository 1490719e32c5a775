"""Differentiable rendering: gradients with respect to material parameters
(port of pathtrace_tpu/diff/grad.py), through torch autograd.

The lockstep megakernel is differentiated end to end. With
IntegratorConfig.detach_sampling the sampled directions, pdfs and Russian
roulette probabilities are detached (the "detached sampling" estimator):
unbiased gradients of the radiance estimate with respect to albedo,
roughness, metallic, specular (hence IOR) and emission, checked against the
finite-difference oracle in diff/fd.py. Geometry is out of scope: the
searches are detached and only the hit is recomputed at the winner.

Materials enter as leaf tensors that require grad, swapped into the scene
with dataclasses.replace (with_materials).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from pathtrace_tpu_torch.core.camera import Camera
from pathtrace_tpu_torch.integrator.config import IntegratorConfig
from pathtrace_tpu_torch.integrator.render import render
from pathtrace_tpu_torch.models.scene import Material, Scene
from pathtrace_tpu_torch.utils.device import resolve_device

MAT_FIELDS = tuple(f.name for f in dataclasses.fields(Material))


def with_materials(scene: Scene, tri_mat: Material, sph_mat: Material) -> Scene:
    """The scene with these triangle and sphere materials."""
    return dataclasses.replace(scene, mat=tri_mat,
                               spheres=dataclasses.replace(scene.spheres, mat=sph_mat))


def leaf_materials(mat: Material) -> Material:
    """A copy of mat whose fields are fresh leaf tensors that require grad."""
    return Material(*[getattr(mat, f).detach().clone().requires_grad_(True)
                      for f in MAT_FIELDS])


def material_grad(loss: torch.Tensor, tri_mat: Material, sph_mat: Material):
    """(d loss / d tri_mat, d loss / d sph_mat) over leaf_materials; a field
    the loss does not reach gets zeros."""
    leaves = [getattr(m, f) for m in (tri_mat, sph_mat) for f in MAT_FIELDS]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    n = len(MAT_FIELDS)
    return Material(*grads[:n]), Material(*grads[n:])


def add_materials(a: Material, b: Material) -> Material:
    """Fieldwise a + b (sums of per-sample or per-chunk grads)."""
    return Material(*[getattr(a, f) + getattr(b, f) for f in MAT_FIELDS])


def render_with_params(scene: Scene, tri_mat: Material, sph_mat: Material,
                       camera: Camera, spp: int, key,
                       cfg: IntegratorConfig = IntegratorConfig(),
                       sample_mat_fn=None, *, device="cuda") -> torch.Tensor:
    """Render with the materials as explicit (differentiable) arguments.
    sample_mat_fn: the sampling-side material override of
    megakernel.make_bounce_fn (diff/fd.py::make_frozen_sampler)."""
    return render(with_materials(scene, tri_mat, sph_mat), camera, spp, key, cfg,
                  sample_mat_fn=sample_mat_fn, device=device)


def material_grads(scene: Scene, camera: Camera, spp: int, key,
                   loss_fn: Optional[Callable] = None,
                   cfg: IntegratorConfig = IntegratorConfig(), *, device="cuda"):
    """(d loss / d tri_materials, d loss / d sphere_materials, loss) on
    `device`. loss_fn maps the (H, W, 3) linear image to a scalar; default
    sum (summed pixel gradients, comparable to the FD oracle's)."""
    scene = scene.to(resolve_device(device))
    tri, sph = leaf_materials(scene.mat), leaf_materials(scene.spheres.mat)
    img = render_with_params(scene, tri, sph, camera, spp, key, cfg, device=scene.device)
    loss = img.sum() if loss_fn is None else loss_fn(img)
    g_tri, g_sph = material_grad(loss, tri, sph)
    return g_tri, g_sph, loss.detach()
