"""Pixel-slice data parallelism over torch.distributed (port of
pathtrace_tpu/parallel/mesh.py).

Rank r of N owns the contiguous pixel slice [r * P / N, (r + 1) * P / N) of
the image's P pixels and a private lane pool; the scene is replicated on
every rank's device. Lanes and film slots run in local path ids, RNG
streams and camera rays in global ones (integrator/wavefront.py::
_make_to_global, kernel B1's to_global), so an N-rank render is path for
path the 1-rank render. Rendering needs no communication but the gather of
the film slices and the sum of the ray counts; a training step all-reduces
its loss and material grads (data parallelism with replicated parameters).

Each sharded entry point is a per-shard body `*_shard(..., shard,
n_shards)`, a plain function that one process can call for any shard (the
tests and chip_smoke.py hold N slices against the whole render on one
device that way), then the collectives over the mesh's process group. A
mesh of one process without a group runs no collective.

The lockstep entry points (render_sharded, render_grad_sharded) draw each
sample's own camera jitter, as integrator/render.py does, so their image is
render()'s: the JAX package's reuse sample 0's jittered rays for every
sample (mesh.py:86-99). The wavetape step divides its cotangent by spp
(ROADMAP C5): its grads are the replay step's, where JAX's are spp times
too large (mesh.py:339).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from pathtrace_tpu_torch.core.camera import Camera
from pathtrace_tpu_torch.diff.grad import (MAT_FIELDS, leaf_materials, material_grad,
                                           with_materials)
from pathtrace_tpu_torch.diff.replay import (_camera_rays, _material_grads_replay_impl,
                                             record_paths)
from pathtrace_tpu_torch.diff.wavetape import wavetape_grads_core
from pathtrace_tpu_torch.integrator.config import IntegratorConfig
from pathtrace_tpu_torch.integrator.megakernel import trace_paths
from pathtrace_tpu_torch.integrator.wavefront import _run_wavefront
from pathtrace_tpu_torch.models.scene import Material, Scene
from pathtrace_tpu_torch.ops.cuda.bounce_kernel import render_wavefront_fused
from pathtrace_tpu_torch.utils import rng
from pathtrace_tpu_torch.utils.device import resolve_device
from pathtrace_tpu_torch.utils.profiling import span

RAY_AXIS = "rays"


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """The ranks that split the image's pixels along RAY_AXIS: their
    number, this process's rank, the process group (None: one process, no
    collective) and this rank's device."""

    world_size: int
    rank: int
    group: object
    device: torch.device


def make_ray_mesh(device="cuda", group=None) -> RayMesh:
    """The mesh of this process: every rank of `group` (default: the
    world) when torch.distributed is initialized, else this process alone.
    Under torchrun, parallel/distributed.py::initialize makes cuda:{LOCAL_RANK}
    the current device, which "cuda" then names."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        return RayMesh(1, 0, None, dev)
    group = dist.group.WORLD if group is None else group
    return RayMesh(dist.get_world_size(group), dist.get_rank(group), group, dev)


def pixel_slice(camera: Camera, shard: int, n_shards: int):
    """(pix_offset, num_pix_local) of shard `shard` of `n_shards`; the
    image's pixels must divide evenly."""
    num_pix = camera.width * camera.height
    if num_pix % n_shards or not 0 <= shard < n_shards:
        raise ValueError(f"{num_pix} pixels do not split into shard {shard} of {n_shards}")
    npl = num_pix // n_shards
    return shard * npl, npl


def _local_lanes(lanes: int, mesh: RayMesh) -> int:
    if lanes % mesh.world_size:
        raise ValueError(f"lanes={lanes} do not split over {mesh.world_size} ranks")
    return lanes // mesh.world_size


def _gather_image(film: torch.Tensor, camera: Camera, mesh: RayMesh) -> torch.Tensor:
    """(H, W, 3) image from every rank's flat (num_pix_local, 3) slice."""
    if mesh.group is not None:
        parts = [torch.empty_like(film) for _ in range(mesh.world_size)]
        dist.all_gather(parts, film.contiguous(), group=mesh.group)
        film = torch.cat(parts)
    return film.reshape(camera.height, camera.width, 3)


def _all_sum(tensors: list, mesh: RayMesh) -> list:
    """The tensors summed over the ranks: one all-reduce of one flat buffer
    (JAX's psums coalesce into one all-reduce too)."""
    if mesh.group is None:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return out


def _sum_rays(rays: int, mesh: RayMesh) -> int:
    t = torch.tensor([rays], dtype=torch.int64, device=mesh.device)
    return int(_all_sum([t], mesh)[0])


def _sum_step(loss, g_tri: Material, g_sph: Material, mesh: RayMesh):
    """(loss, (g_tri, g_sph)) summed over the ranks."""
    n = len(MAT_FIELDS)
    fields = [getattr(g, f) for g in (g_tri, g_sph) for f in MAT_FIELDS]
    loss, *fields = _all_sum([loss.reshape(1)] + fields, mesh)
    return loss[0], (Material(*fields[:n]), Material(*fields[n:]))


def _target_slice(target, camera: Camera, pix_offset: int, npl: int, dev) -> torch.Tensor:
    flat = torch.as_tensor(target).reshape(camera.width * camera.height, 3)
    return flat[pix_offset:pix_offset + npl].to(dev)


# ---------------------------------------------------------------------------
# per-shard bodies: plain functions on the scene's device
# ---------------------------------------------------------------------------

def render_shard(scene: Scene, camera: Camera, spp: int, base_key, shard: int,
                 n_shards: int, cfg: IntegratorConfig = IntegratorConfig()) -> torch.Tensor:
    """(num_pix_local, 3) mean radiance of the shard's pixels, spp lockstep
    samples (megakernel.trace_paths), each with its own camera jitter keyed
    by global ray id."""
    pix0, npl = pixel_slice(camera, shard, n_shards)
    rng.check_path_ids(camera.width * camera.height, spp)
    accum = torch.zeros((npl, 3), device=scene.device)
    for s in range(spp):
        org, dirs, ray_ids = _camera_rays(scene, camera, s, base_key, pix0, npl)
        accum = accum + trace_paths(scene, org, dirs, ray_ids, base_key, cfg)
    return accum / spp


def render_grad_shard(scene: Scene, camera: Camera, target, spp: int, base_key, shard: int,
                      n_shards: int, cfg: IntegratorConfig = IntegratorConfig()):
    """(loss, (g_tri, g_sph)) of the shard's L2 loss sum((img - target)^2)
    over its pixels, by autograd through the lockstep samples (the scan-AD
    estimator of diff/grad.py). `target` is the whole (H, W, 3) image."""
    pix0, npl = pixel_slice(camera, shard, n_shards)
    tgt = _target_slice(target, camera, pix0, npl, scene.device)
    tri, sph = leaf_materials(scene.mat), leaf_materials(scene.spheres.mat)
    img = render_shard(with_materials(scene, tri, sph), camera, spp, base_key, shard,
                       n_shards, cfg)
    loss = ((img - tgt) ** 2).sum()
    return loss.detach(), material_grad(loss, tri, sph)


def render_wavefront_shard(scene: Scene, camera: Camera, spp: int, base_key, shard: int,
                           n_shards: int, cfg: IntegratorConfig = IntegratorConfig(),
                           lanes: int = 65536, sample_offset: int = 0):
    """((num_pix_local, 3) film, rays traced) of the shard's pixels through
    the wavefront with `lanes` lanes of its own."""
    pix0, npl = pixel_slice(camera, shard, n_shards)
    return _run_wavefront(scene, camera, spp, base_key, cfg, lanes, sample_offset,
                          pix_offset=pix0, num_pix_local=npl)


def render_fused_shard(scene: Scene, camera: Camera, spp: int, base_key, shard: int,
                       n_shards: int, cfg: IntegratorConfig = IntegratorConfig(),
                       lanes: int = 65536, sample_offset: int = 0):
    """((num_pix_local, 3) film, rays traced) of the shard's pixels through
    the fused engine: one launch of kernel B1 on CUDA (its plain version,
    the wavefront, on the CPU). lanes % num_pix_local == 0 or
    num_pix_local % lanes == 0 (JAX mesh.py:223-228)."""
    pix0, npl = pixel_slice(camera, shard, n_shards)
    return render_wavefront_fused(scene, camera, spp, base_key, cfg, lanes, chunk_spp=spp,
                                  sample_offset=sample_offset, pix_offset=pix0,
                                  num_pix_local=npl, device=scene.device)


def train_step_replay_shard(scene: Scene, camera: Camera, target, spp: int, base_key,
                            shard: int, n_shards: int,
                            cfg: IntegratorConfig = IntegratorConfig()):
    """(loss, (g_tri, g_sph), (num_pix_local, 3) image) of one record/replay
    training step on the shard's pixels (JAX mesh.py:266-290): a recorded
    forward per sample for the L2 cotangent 2 (img - target), then
    diff/replay.py's per-sample replay backwards, which divide it by spp."""
    pix0, npl = pixel_slice(camera, shard, n_shards)
    tgt = _target_slice(target, camera, pix0, npl, scene.device)
    accum = torch.zeros((npl, 3), device=scene.device)
    for s in range(spp):
        org, dirs, ray_ids = _camera_rays(scene, camera, s, base_key, pix0, npl)
        rad, _ = record_paths(scene, org, dirs, ray_ids, base_key, cfg)
        accum = accum + rad
    ct = 2.0 * (accum / spp - tgt)
    g_tri, g_sph, img = _material_grads_replay_impl(scene, camera, spp, base_key, cfg, ct,
                                                    pix0, npl)
    return ((img - tgt) ** 2).sum(), (g_tri, g_sph), img


def train_step_wavetape_shard(scene: Scene, camera: Camera, target, spp: int, base_key,
                              shard: int, n_shards: int,
                              cfg: IntegratorConfig = IntegratorConfig(), lanes: int = 65536,
                              chunk: int = 65536, *, search=None):
    """(loss, (g_tri, g_sph), (num_pix_local, 3) image) of one wavetape
    training step on the shard's pixels: ONE recording sweep, the cotangent
    2 (film - target) / spp from the recorded film, then the chunked replay
    backwards (diff/wavetape.py). loss = sum((image - target)^2) over the
    replay image."""
    with span("train.step"):
        pix0, npl = pixel_slice(camera, shard, n_shards)
        tgt = _target_slice(target, camera, pix0, npl, scene.device)
        g_tri, g_sph, film, _ = wavetape_grads_core(
            scene, camera, spp, base_key, cfg, None, lanes, chunk,
            ct_fn=lambda rec_film: 2.0 * (rec_film - tgt) / float(spp), pix_offset=pix0,
            num_pix_local=npl, search=search)
        return ((film - tgt) ** 2).sum(), (g_tri, g_sph), film


# ---------------------------------------------------------------------------
# sharded entry points: this rank's body, then the collectives
# ---------------------------------------------------------------------------

def render_sharded(scene: Scene, camera: Camera, spp: int, base_key, mesh: RayMesh,
                   cfg: IntegratorConfig = IntegratorConfig()) -> torch.Tensor:
    """(H, W, 3) lockstep render, pixels split over the mesh (JAX
    mesh.py:75)."""
    film = render_shard(scene.to(mesh.device), camera, spp, base_key, mesh.rank,
                        mesh.world_size, cfg)
    return _gather_image(film, camera, mesh)


def render_grad_sharded(scene: Scene, camera: Camera, target, spp: int, base_key,
                        mesh: RayMesh, cfg: IntegratorConfig = IntegratorConfig()):
    """(loss, (tri_mat_grads, sphere_mat_grads)) of the L2 loss against
    `target`, each rank's by autograd over its pixels, summed over the mesh
    (JAX mesh.py:101)."""
    loss, (g_tri, g_sph) = render_grad_shard(scene.to(mesh.device), camera, target, spp,
                                             base_key, mesh.rank, mesh.world_size, cfg)
    return _sum_step(loss, g_tri, g_sph, mesh)


def render_wavefront_sharded(scene: Scene, camera: Camera, spp: int, base_key,
                             mesh: RayMesh, cfg: IntegratorConfig = IntegratorConfig(),
                             lanes: int = 65536, sample_offset: int = 0):
    """((H, W, 3) image, rays traced on every rank) of the wavefront, each
    rank with lanes / world_size lanes over its pixel slice (JAX
    mesh.py:147)."""
    film, rays = render_wavefront_shard(scene.to(mesh.device), camera, spp, base_key,
                                        mesh.rank, mesh.world_size, cfg,
                                        _local_lanes(lanes, mesh), sample_offset)
    return _gather_image(film, camera, mesh), _sum_rays(rays, mesh)


def render_fused_sharded(scene: Scene, camera: Camera, spp: int, base_key, mesh: RayMesh,
                         cfg: IntegratorConfig = IntegratorConfig(), lanes: int = 65536,
                         sample_offset: int = 0):
    """((H, W, 3) image, rays traced on every rank) of the fused engine,
    kernel B1 keyed by global path ids, each rank one launch over its pixel
    slice with lanes / world_size lanes (JAX mesh.py:184; its TPU knobs
    block_r, interpret and g_inner are not carried over)."""
    film, rays = render_fused_shard(scene.to(mesh.device), camera, spp, base_key, mesh.rank,
                                    mesh.world_size, cfg, _local_lanes(lanes, mesh),
                                    sample_offset)
    return _gather_image(film, camera, mesh), _sum_rays(rays, mesh)


def train_step_replay_sharded(scene: Scene, camera: Camera, target, spp: int, base_key,
                              mesh: RayMesh, cfg: IntegratorConfig = IntegratorConfig()):
    """(loss, (tri_mat_grads, sphere_mat_grads), (H, W, 3) image) of one
    record/replay training step, loss and grads summed over the mesh (JAX
    mesh.py:249)."""
    loss, (g_tri, g_sph), img = train_step_replay_shard(
        scene.to(mesh.device), camera, target, spp, base_key, mesh.rank, mesh.world_size, cfg)
    loss, grads = _sum_step(loss, g_tri, g_sph, mesh)
    return loss, grads, _gather_image(img, camera, mesh)


def train_step_wavetape_sharded(scene: Scene, camera: Camera, target, spp: int, base_key,
                                mesh: RayMesh, cfg: IntegratorConfig = IntegratorConfig(),
                                lanes: int = 65536, chunk: int = 65536):
    """(loss, (tri_mat_grads, sphere_mat_grads), (H, W, 3) image) of one
    wavetape training step (the production step), each rank recording with
    `lanes` lanes over its pixel slice, loss and grads summed over the mesh
    (JAX mesh.py:303). Its grads equal train_step_replay_sharded's (C5)."""
    loss, (g_tri, g_sph), img = train_step_wavetape_shard(
        scene.to(mesh.device), camera, target, spp, base_key, mesh.rank, mesh.world_size,
        cfg, lanes, chunk)
    loss, grads = _sum_step(loss, g_tri, g_sph, mesh)
    return loss, grads, _gather_image(img, camera, mesh)


def train_step_wavetape(scene: Scene, camera: Camera, target: torch.Tensor, spp: int,
                        base_key, cfg: IntegratorConfig = IntegratorConfig(),
                        lanes: int = 65536, chunk: int = 65536, *, device="cuda",
                        search=None):
    """One training step of an L2 image loss on one device: the whole image
    as the one shard of train_step_wavetape_shard. Returns (loss,
    (tri_mat_grads, sphere_mat_grads), (H, W, 3) image).

    The cotangent is divided by spp, so the grads are those of
    material_grads_wavetape with loss_grad_img = 2 (film - target). The JAX
    step omits the division (mesh.py:339) and returns grads spp times too
    large; that fault is not carried over."""
    loss, grads, film = train_step_wavetape_shard(
        scene.to(resolve_device(device)), camera, target, spp, base_key, 0, 1, cfg, lanes,
        chunk, search=search)
    return loss, grads, film.reshape(camera.height, camera.width, 3)
