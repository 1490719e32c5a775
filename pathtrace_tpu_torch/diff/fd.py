"""Finite-difference gradient oracle (port of pathtrace_tpu/diff/fd.py).

With the counter-based RNG a render is a pure function of its inputs, so
central differences with the same key estimate the derivative of the very
estimator realization that autograd differentiates.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from pathtrace_tpu_torch.core.camera import Camera
from pathtrace_tpu_torch.diff.grad import MAT_FIELDS, render_with_params
from pathtrace_tpu_torch.integrator.config import IntegratorConfig
from pathtrace_tpu_torch.models.scene import Material, Scene


def make_frozen_sampler(scene: Scene):
    """HitRecord -> Material gather of the UNPERTURBED scene's materials,
    for make_bounce_fn's sample_mat_fn (the scene must be on the render's
    device).

    Freezing the sampling-side materials pins the path realization
    (sampled directions, lobe families, pdf denominators, transparency
    flags) while the eval-side materials vary, so a central difference
    measures exactly the detached-sampling derivative that production
    autograd (cfg.detach_sampling) computes."""
    tri = Material(*[getattr(scene.mat, f).detach() for f in MAT_FIELDS])
    sph = Material(*[getattr(scene.spheres.mat, f).detach() for f in MAT_FIELDS])
    n_tris = max(scene.num_tris, 1)
    n_sph = scene.num_spheres

    def sample_mat_fn(hit):
        tm = tri.gather(torch.clamp(hit.prim_id, 0, n_tris - 1))
        if n_sph == 0:
            return tm
        sm = sph.gather(torch.clamp(hit.prim_id, 0, n_sph - 1))

        def pick(a, b):
            sel = hit.is_sphere[:, None] if a.dim() == 2 else hit.is_sphere
            return torch.where(sel, a, b)

        return Material(*[pick(getattr(sm, f), getattr(tm, f)) for f in MAT_FIELDS])

    return sample_mat_fn


def _perturb(mat: Material, field: str, index, h: float):
    """(mat with field[index] + h, mat with field[index] - h)."""
    out = []
    for step in (h, -h):
        arr = getattr(mat, field).detach().clone()
        arr[index] += step
        out.append(Material(*[arr if f == field else getattr(mat, f) for f in MAT_FIELDS]))
    return tuple(out)


def _host_sum(img: torch.Tensor) -> float:
    return img.detach().cpu().double().sum().item()


def fd_material_grad(scene: Scene, camera: Camera, spp: int, key,
                     target: str, field: str, index,
                     h: float = 1e-2,
                     loss_fn: Optional[Callable] = None,
                     cfg: IntegratorConfig = IntegratorConfig(),
                     sample_mat_fn=None, *, device="cuda") -> float:
    """Central-difference d loss / d mat.field[index].

    target: "tris" or "spheres". index: int or tuple into the field.
    The default loss sums the image in float64 on the host (fd.py:83-90):
    a float32 sum quantizes at ~loss * 2^-24, which dominates (lp - lm)
    once h gets small."""
    loss_fn = loss_fn or _host_sum
    tri_mat, sph_mat = scene.mat, scene.spheres.mat
    if target == "tris":
        pairs = [(m, sph_mat) for m in _perturb(tri_mat, field, index, h)]
    elif target == "spheres":
        pairs = [(tri_mat, m) for m in _perturb(sph_mat, field, index, h)]
    else:
        raise ValueError(target)
    with torch.no_grad():
        lp, lm = (loss_fn(render_with_params(scene, t, s, camera, spp, key, cfg,
                                             sample_mat_fn=sample_mat_fn, device=device))
                  for t, s in pairs)
    return float((lp - lm) / (2.0 * h))


def fd_material_grad_auto(scene: Scene, camera: Camera, spp: int, key,
                          target: str, field: str, index,
                          h0: float = 1e-2, h_min: float = 4e-5,
                          agree: float = 0.02, richardson: bool = False,
                          loss_fn: Optional[Callable] = None,
                          cfg: IntegratorConfig = IntegratorConfig(),
                          sample_mat_fn=None, *, device="cuda"):
    """Adaptive-step central difference (fd.py:110-151): halve h until two
    consecutive estimates agree to `agree` relative error. The estimator is
    only piecewise smooth in the materials (sampled directions cross
    accept/reject boundaries), and crossings are isolated, so shrinking h
    eventually brackets none; h_min floors the step above the float32 noise.

    richardson: on convergence return (4 f(h) - f(2h)) / 3, which removes
    the leading truncation term. Returns (fd, h_used, converged)."""
    prev = None
    h = h0
    while True:
        cur = fd_material_grad(scene, camera, spp, key, target, field, index, h=h,
                               loss_fn=loss_fn, cfg=cfg, sample_mat_fn=sample_mat_fn,
                               device=device)
        if prev is not None:
            scale = max(abs(cur), abs(prev), 1.0)
            if abs(cur - prev) <= agree * scale:
                if richardson:
                    return (4.0 * cur - prev) / 3.0, h, True
                return cur, h, True
        if h <= h_min:
            return cur, h, False
        prev = cur
        h = h / 2.0
