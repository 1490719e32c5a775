"""Render driver: a Python loop over samples of the lockstep integrator
(port of pathtrace_tpu/integrator/render.py).

Ray id convention matches the reference's stream layout
(pathtracer.cu:71: offset + SampleIDX*W*H): ray_id = sample*W*H + pixel,
an int64 below 2**32 (utils/rng.py::check_path_ids).
"""

from __future__ import annotations

from typing import Optional

import torch

from pathtrace_tpu_torch.core.camera import Camera
from pathtrace_tpu_torch.integrator.config import IntegratorConfig
from pathtrace_tpu_torch.integrator.megakernel import trace_paths
from pathtrace_tpu_torch.models.scene import Scene
from pathtrace_tpu_torch.utils import rng
from pathtrace_tpu_torch.utils.device import resolve_device


def render_sample(scene: Scene, camera: Camera, sample_idx: int, base_key,
                  cfg: IntegratorConfig = IntegratorConfig(),
                  raycast_fn=None, sample_mat_fn=None, *, search=None) -> torch.Tensor:
    """Trace one sample per pixel on the scene's device; (W*H, 3) radiance.
    search, raycast_fn and sample_mat_fn as in megakernel.make_bounce_fn."""
    px, py = camera.pixel_grid(scene.device)
    num_pix = px.shape[0]
    ray_ids = sample_idx * num_pix + torch.arange(num_pix, dtype=torch.int64,
                                                  device=scene.device)
    ju = rng.pixel_jitter(base_key, ray_ids)
    dirs = camera.ray_directions(px, py, ju[:, 0], ju[:, 1])
    org = torch.as_tensor(camera.pos, device=scene.device).expand_as(dirs)
    return trace_paths(scene, org, dirs, ray_ids, base_key, cfg, raycast_fn, sample_mat_fn,
                       search=search)


def render(scene: Scene, camera: Camera, spp: int, base_key,
           cfg: IntegratorConfig = IntegratorConfig(), raycast_fn=None,
           sample_mat_fn=None, *, search=None, device="cuda") -> torch.Tensor:
    """Mean radiance over spp samples; (H, W, 3) linear float32 on device
    (StartRender's sample loop, pathtracer.cu:77-81). Differentiable with
    respect to the scene's material tensors (diff/grad.py). `search`
    replaces the scene's closest-hit and shadow search
    (megakernel.default_raycast)."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    rng.check_path_ids(camera.width * camera.height, spp)
    accum = torch.zeros((camera.width * camera.height, 3), device=dev)
    for s in range(spp):
        accum = accum + render_sample(scene, camera, s, base_key, cfg, raycast_fn,
                                      sample_mat_fn, search=search)
    return (accum / spp).reshape(camera.height, camera.width, 3)


def render_image(scene: Scene, camera: Camera, spp: int, seed: int = 0,
                 cfg: IntegratorConfig = IntegratorConfig(), raycast_fn=None,
                 passes: int = 1, progressive_path: Optional[str] = None, *,
                 device="cuda") -> torch.Tensor:
    """Multi-pass render (JAX render.py:73-94): pass p renders spp // passes
    samples with key rng.iter_key(make_key(seed), 1000 + p), the running
    mean is written to progressive_path as a PNG after each pass, and the
    (H, W, 3) mean over passes is returned (the reference's 8-pass loop with
    temp.png after each pass, pathtracer.cu:236-246)."""
    from pathtrace_tpu_torch.io import image as imageio

    dev = resolve_device(device)
    key = rng.make_key(seed)
    accum = torch.zeros((camera.height, camera.width, 3), device=dev)
    spp_per_pass = max(spp // passes, 1)
    for p in range(passes):
        accum = accum + render(scene, camera, spp_per_pass, rng.iter_key(key, 1000 + p), cfg,
                               raycast_fn, device=dev)
        if progressive_path is not None:
            imageio.write_png(progressive_path, accum / (p + 1))
    return accum / passes
