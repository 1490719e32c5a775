"""The production training step (port of the one-device body of
pathtrace_tpu/parallel/mesh.py::train_step_wavetape_sharded, :330-342).

Pixel-slice sharding over devices and the all-reduce of loss and grads are
ROADMAP queue A11 and not ported yet: this step runs on one device.
"""

from __future__ import annotations

import torch

from pathtrace_tpu_torch.core.camera import Camera
from pathtrace_tpu_torch.diff.wavetape import wavetape_grads_core
from pathtrace_tpu_torch.integrator.config import IntegratorConfig
from pathtrace_tpu_torch.models.scene import Scene
from pathtrace_tpu_torch.utils.device import resolve_device


def train_step_wavetape(scene: Scene, camera: Camera, target: torch.Tensor, spp: int,
                        base_key, cfg: IntegratorConfig = IntegratorConfig(),
                        lanes: int = 65536, chunk: int = 65536, *, device="cuda",
                        search=None):
    """One training step of an L2 image loss on the wavefront-taped
    backward (diff/wavetape.py): ONE recording sweep, the cotangent
    2 (film - target) / spp from the recorded film, then the chunked replay
    backwards. Returns (loss, (tri_mat_grads, sphere_mat_grads), image) with
    loss = sum((image - target)^2) over the replay image.

    The cotangent is divided by spp, so the grads are those of
    material_grads_wavetape with loss_grad_img = 2 (film - target). The JAX
    step omits the division (mesh.py:339) and returns grads spp times too
    large; that fault is not carried over."""
    scene = scene.to(resolve_device(device))
    num_pix = camera.width * camera.height
    tgt = target.to(scene.device).reshape(num_pix, 3)
    g_tri, g_sph, film, _ = wavetape_grads_core(
        scene, camera, spp, base_key, cfg, None, lanes, chunk,
        ct_fn=lambda rec_film: 2.0 * (rec_film - tgt) / float(spp), search=search)
    loss = ((film - tgt) ** 2).sum()
    return loss, (g_tri, g_sph), film.reshape(camera.height, camera.width, 3)
