"""Wavefront path tracing with path regeneration (port of
pathtrace_tpu/integrator/wavefront.py:74-242).

One persistent lane array: every iteration each lane continues its path
or, when the path ended, commits its radiance to the film and starts a
new camera path. Randomness is keyed by (path id, path-local iteration),
so every path sees the same stream as in the lockstep megakernel, whichever
lane traces it. Two assignments of paths to lanes, as in JAX:

- static strided, whenever lanes % num_pix == 0 or num_pix % lanes == 0:
  lane i traces path ids base + i, base + i + lanes, ... and commits to a
  per-lane film (K, lanes, 3), K = max(1, num_pix // lanes). This is the
  plain version of the CUDA bounce kernel (ops/cuda/bounce_kernel.py),
  which runs the same per-lane loop and sums each slot in path order;
- pool, for any other lane count: dead lanes take the next unstarted path
  ids from a shared counter (cumsum over the lanes that died), each lane
  keeps its pixel, and the per-pixel film (num_pix, 3) is committed with
  index_add_ (on CUDA its atomics add in no fixed order).

Closest-hit and shadow rays go through megakernel.default_raycast, so a
scene with KD cells takes the mesh path in both assignments, and any other
scene the all-triangles search.
"""

from __future__ import annotations

import torch

from pathtrace_tpu_torch.core.camera import Camera
from pathtrace_tpu_torch.integrator.config import IntegratorConfig
from pathtrace_tpu_torch.integrator.megakernel import make_bounce_fn
from pathtrace_tpu_torch.models.scene import Scene
from pathtrace_tpu_torch.utils import rng
from pathtrace_tpu_torch.utils.device import resolve_device


def check_lanes(lanes: int, num_pix: int) -> int:
    """Pixels per lane K for the static strided assignment; raises unless
    lanes % num_pix == 0 or num_pix % lanes == 0."""
    if lanes <= 0 or (lanes % num_pix and num_pix % lanes):
        raise ValueError(f"lanes={lanes} must divide or be a multiple of "
                         f"num_pix={num_pix}")
    return max(1, num_pix // lanes)


def _regen_rays(camera: Camera, path_idx: torch.Tensor, base_key, num_pix: int):
    """Camera ray for global path index = sample*num_pix + pixel."""
    pixel = path_idx % num_pix
    px = (pixel % camera.width).to(torch.float32)
    py = (pixel // camera.width).to(torch.float32)
    ju = rng.pixel_jitter(base_key, path_idx)
    dirs = camera.ray_directions(px, py, ju[:, 0], ju[:, 1])
    org = torch.as_tensor(camera.pos, device=dirs.device).expand_as(dirs)
    return org, dirs


def _run_wavefront(scene: Scene, camera: Camera, spp: int, base_key,
                   cfg: IntegratorConfig, lanes: int, sample_offset: int = 0, *,
                   search=None, raycast_fn=None, visible_fn=None, on_iteration=None):
    """((H, W, 3) mean image, int rays traced) over path ids
    [sample_offset*num_pix, (sample_offset+spp)*num_pix) on the scene's
    device; `search`, `raycast_fn` and `visible_fn` as in
    megakernel.make_bounce_fn. on_iteration(ray_ids, lane_iter, alive), if
    given, runs after each bounce with the lanes' state before it (the
    gradient recorder commits its tape there, diff/wavetape.py)."""
    num_pix = camera.width * camera.height
    if lanes <= 0:
        raise ValueError(f"lanes={lanes} must be positive")
    static = lanes % num_pix == 0 or num_pix % lanes == 0
    k_pix = max(1, num_pix // lanes)
    rng.check_path_ids(num_pix, spp, sample_offset)
    dev = scene.device
    base_path = sample_offset * num_pix
    total_paths = num_pix * spp
    bounce = make_bounce_fn(scene, cfg, base_key, search=search, raycast_fn=raycast_fn,
                            visible_fn=visible_fn)

    film = torch.zeros((k_pix, lanes, 3) if static else (num_pix, 3), device=dev)
    lane = torch.arange(lanes, dtype=torch.int64, device=dev)
    ray_ids = base_path + lane  # int64: ray_id + lanes may pass 2**31 - 1
    org, dirn = _regen_rays(camera, ray_ids, base_key, num_pix)
    alive = lane < total_paths  # lanes may exceed tiny pools
    pixel = ray_ids % num_pix  # pool: each lane's film pixel
    next_path = torch.full((), lanes, dtype=torch.int64, device=dev)  # pool counter
    radiance = torch.zeros((lanes, 3), device=dev)
    weight = torch.ones((lanes, 3), device=dev)
    depth = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    refract_cnt = torch.zeros_like(depth)
    refracted = torch.zeros_like(alive)
    lane_iter = torch.zeros_like(depth)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    zero3 = torch.zeros_like(radiance)

    while bool(alive.any()):
        (org, dirn, radiance, weight, depth, refract_cnt, refracted,
         alive_next, traced) = bounce(org, dirn, radiance, weight, depth,
                                      refract_cnt, refracted, alive, ray_ids,
                                      lane_iter)
        rays = rays + traced
        if on_iteration is not None:
            on_iteration(ray_ids, lane_iter, alive)

        died = alive & ~alive_next
        contrib = torch.where(died[:, None], radiance, zero3)
        if not static:
            film.index_add_(0, pixel, contrib)
            # pool regeneration: the dead lanes take the next unstarted ids
            # in lane order
            died_i = died.to(torch.int64)
            new_local = next_path + torch.cumsum(died_i, 0) - 1
            regen = died & (new_local < total_paths)
            new_safe = torch.where(regen, base_path + new_local, torch.zeros_like(new_local))
            pixel = torch.where(regen, new_safe % num_pix, pixel)
            next_path = next_path + died_i.sum()
        else:
            # commit: lane i's k-th path lands in film[k % K, i], which is
            # pixel (i + (k % K) * lanes) % num_pix
            if k_pix == 1:
                film[0] += contrib
            else:
                kmod = ((ray_ids - base_path) // lanes) % k_pix
                film.view(-1, 3).index_add_(0, kmod * lanes + lane, contrib)
            # strided regeneration: lane i's next path id is ray_id + lanes
            new_idx = ray_ids + lanes
            regen = died & (new_idx - base_path < total_paths)
            new_safe = torch.where(regen, new_idx, torch.zeros_like(new_idx))
        r_org, r_dir = _regen_rays(camera, new_safe, base_key, num_pix)
        sel = regen[:, None]
        org = torch.where(sel, r_org, org)
        dirn = torch.where(sel, r_dir, dirn)
        radiance = torch.where(sel, zero3, radiance)
        weight = torch.where(sel, torch.ones_like(weight), weight)
        depth = torch.where(regen, 0, depth)
        refract_cnt = torch.where(regen, 0, refract_cnt)
        refracted = refracted & ~regen
        alive = alive_next | regen
        ray_ids = torch.where(regen, new_safe, ray_ids)
        lane_iter = torch.where(regen, 0, lane_iter + 1)

    # static: film[k, i] belongs to pixel (i + k*lanes) % num_pix
    if not static or num_pix >= lanes:
        film_pix = film.reshape(num_pix, 3)
    else:
        film_pix = film.reshape(lanes // num_pix, num_pix, 3).sum(dim=0)
    img = film_pix.reshape(camera.height, camera.width, 3) / spp
    return img, int(rays)


def render_wavefront_stats(scene: Scene, camera: Camera, spp: int, base_key,
                           cfg: IntegratorConfig = IntegratorConfig(),
                           lanes: int = 65536, sample_offset: int = 0, *,
                           device="cuda", search=None):
    """((H, W, 3) mean radiance, rays traced); `lanes` is the persistent
    wavefront width; `search` as in megakernel.default_raycast."""
    dev = resolve_device(device)
    return _run_wavefront(scene.to(dev), camera, spp, base_key, cfg, lanes,
                          sample_offset, search=search)


def render_wavefront(scene: Scene, camera: Camera, spp: int, base_key,
                     cfg: IntegratorConfig = IntegratorConfig(),
                     lanes: int = 65536, sample_offset: int = 0, *,
                     device="cuda") -> torch.Tensor:
    """(H, W, 3) mean radiance; see render_wavefront_stats."""
    return render_wavefront_stats(scene, camera, spp, base_key, cfg, lanes,
                                  sample_offset, device=device)[0]


def accumulate_chunks(run_chunk, camera: Camera, spp: int, chunk_spp: int, dev):
    """Chunks of chunk_spp samples, accumulated as the JAX driver does
    (film += chunk_image * chunk_spp). run_chunk(spp, sample_offset) returns
    one chunk's ((H, W, 3) mean image, rays traced). Returns ((H, W, 3)
    image on dev, rays traced)."""
    film = torch.zeros((camera.height, camera.width, 3), device=dev)
    rays = 0
    done = 0
    while done < spp:
        cur = min(chunk_spp, spp - done)
        img, n = run_chunk(cur, done)
        film = film + img * cur
        rays += n
        done += cur
    return film / spp, rays


def render_wavefront_chunked(scene: Scene, camera: Camera, spp: int, base_key,
                             cfg: IntegratorConfig = IntegratorConfig(),
                             lanes: int = 65536, chunk_spp: int = 64, *,
                             device="cuda"):
    """render_wavefront_stats in chunks of chunk_spp samples
    (accumulate_chunks)."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    return accumulate_chunks(
        lambda n, offset: _run_wavefront(scene, camera, n, base_key, cfg, lanes, offset),
        camera, spp, chunk_spp, dev)
