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
with dataclasses.replace (with_materials). Forward mode (material_jvp)
enters them as dual tensors of torch.autograd.forward_ad instead.
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
                       sample_mat_fn=None, *, search=None, device="cuda") -> torch.Tensor:
    """Render with the materials as explicit (differentiable) arguments.
    sample_mat_fn: the sampling-side material override of
    megakernel.make_bounce_fn (diff/fd.py::make_frozen_sampler); search as
    in render."""
    return render(with_materials(scene, tri_mat, sph_mat), camera, spp, key, cfg,
                  sample_mat_fn=sample_mat_fn, search=search, device=device)


def material_grads(scene: Scene, camera: Camera, spp: int, key,
                   loss_fn: Optional[Callable] = None,
                   cfg: IntegratorConfig = IntegratorConfig(), *, search=None,
                   device="cuda"):
    """(d loss / d tri_materials, d loss / d sphere_materials, loss) on
    `device`. loss_fn maps the (H, W, 3) linear image to a scalar; default
    sum (summed pixel gradients, comparable to the FD oracle's). search as
    in render."""
    scene = scene.to(resolve_device(device))
    tri, sph = leaf_materials(scene.mat), leaf_materials(scene.spheres.mat)
    img = render_with_params(scene, tri, sph, camera, spp, key, cfg, search=search,
                             device=scene.device)
    loss = img.sum() if loss_fn is None else loss_fn(img)
    g_tri, g_sph = material_grad(loss, tri, sph)
    return g_tri, g_sph, loss.detach()


def material_jvp(scene: Scene, camera: Camera, spp: int, key, tri_tangent: Material,
                 sph_tangent: Optional[Material] = None, loss_fn: Optional[Callable] = None,
                 cfg: IntegratorConfig = IntegratorConfig(), *, search=None,
                 device="cuda"):
    """(loss, d loss along the tangent) by forward-mode AD on `device`: the
    counterpart of jax.jvp(loss, (mat,), (tangent,)) over render_with_params
    (JAX tests/test_grad.py:184-215). The materials enter as dual tensors
    (torch.autograd.forward_ad) with tri_tangent and sph_tangent (default:
    zero) as their tangents; loss_fn and search as in material_grads.

    Every detach of the reverse mode (detached sampling, the searches)
    drops the tangent at the same place, so the directional derivative is
    the reverse mode's gradient dotted with the tangent. The searches see
    geometry only: no tangent reaches a kernel. Forward mode keeps no
    activations, so cfg.remat has nothing to save and the render runs
    without checkpoints."""
    import torch.autograd.forward_ad as fwad

    scene = scene.to(resolve_device(device))
    if sph_tangent is None:
        sph_tangent = Material(*[torch.zeros_like(getattr(scene.spheres.mat, f))
                                 for f in MAT_FIELDS])
    with fwad.dual_level():
        tri, sph = (Material(*[fwad.make_dual(getattr(m, f).detach(),
                                              getattr(t, f).to(scene.device))
                               for f in MAT_FIELDS])
                    for m, t in ((scene.mat, tri_tangent), (scene.spheres.mat, sph_tangent)))
        img = render_with_params(scene, tri, sph, camera, spp, key,
                                 dataclasses.replace(cfg, remat=False), search=search,
                                 device=scene.device)
        loss = img.sum() if loss_fn is None else loss_fn(img)
        primal, tangent = fwad.unpack_dual(loss)
        tangent = torch.zeros_like(primal) if tangent is None else tangent
        return primal.detach().clone(), tangent.detach().clone()
