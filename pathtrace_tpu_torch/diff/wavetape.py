"""Wavefront-taped record/replay gradients, the production train step's
backward (port of pathtrace_tpu/diff/wavetape.py).

- RECORD: one regenerating wavefront sweep (integrator/wavefront.py) over
  the whole pixel x sample pool, under torch.no_grad, through the scene's
  searches (B3 or B2 on the card). Per bounce every discrete outcome is
  packed into ONE int32 word (written<<27 | hit<<30 | is_sphere<<29 |
  reached<<28 | prim_id) at slot (path-local iteration, path id), so the
  tape a wavefront writes is the tape a lockstep recorder would write. The
  prim id is masked into its 27 bits, never clamped (the JAX package's
  jnp.minimum, wavetape.py:70, would let a negative id set flag bits).
- REPLAY: path-major chunks through diff/replay.py's differentiable
  reconstruction, sorted by taped length so that each chunk replays only as
  many bounces as its longest path (the JAX package picks among static
  depths 4/8/max_iters; an eager loop takes the exact one). Each bounce is
  checkpointed (torch.utils.checkpoint), so a chunk's autograd memory is one
  bounce's activations plus the state between bounces.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from pathtrace_tpu_torch.core.camera import Camera
from pathtrace_tpu_torch.diff.grad import (add_materials, leaf_materials, material_grad,
                                           with_materials)
from pathtrace_tpu_torch.diff.replay import recording_hooks, replay_hooks
from pathtrace_tpu_torch.integrator.config import IntegratorConfig
from pathtrace_tpu_torch.integrator.megakernel import init_state, make_bounce_fn
from pathtrace_tpu_torch.integrator.wavefront import _make_to_global, _regen_rays, _run_wavefront
from pathtrace_tpu_torch.models.scene import Scene
from pathtrace_tpu_torch.utils import rng
from pathtrace_tpu_torch.utils.device import resolve_device
from pathtrace_tpu_torch.utils.profiling import span

_HIT_BIT = 1 << 30
_SPH_BIT = 1 << 29
_RCH_BIT = 1 << 28
_WRT_BIT = 1 << 27   # slot was written: a path's length is the count of set bits
_PID_MASK = (1 << 27) - 1


def _pack_rec(hit, pid, sph, reached) -> torch.Tensor:
    bit = lambda flag, b: flag.to(torch.int32) * b
    return (bit(hit, _HIT_BIT) | bit(sph, _SPH_BIT) | bit(reached, _RCH_BIT)
            | (pid.to(torch.int32) & _PID_MASK) | _WRT_BIT)


def unpack_rec(packed: torch.Tensor) -> dict:
    return dict(hit=(packed & _HIT_BIT) != 0,
                pid=packed & _PID_MASK,
                sph=(packed & _SPH_BIT) != 0,
                reached=(packed & _RCH_BIT) != 0)


def record_paths_wavefront(scene: Scene, camera: Camera, spp: int, base_key,
                           cfg: IntegratorConfig = IntegratorConfig(),
                           lanes: int = 65536, sample_offset: int = 0, *,
                           pix_offset: int = 0, num_pix_local=None, search=None):
    """Tape the whole pixel x sample pool with a regenerating wavefront on
    the scene's device.

    Returns (records, film): records (max_iters, P) int32 with
    P = num_pix * spp, slot (i, p) holding path p's i-th bounce outcome
    (_pack_rec; 0 past the path's end), and film (num_pix, 3), the recorded
    primal's per-pixel mean (the wavefront's image; the replay primal to
    float-sum order, so it can weight an L2 cotangent).

    pix_offset and num_pix_local restrict the pool to a pixel slice as in wavefront._run_wavefront: p is then a local path id and
    num_pix the slice's pixel count, while RNG and camera rays take global
    ids, so an N-shard recording is path for path the 1-shard one. Path ids
    stop below rng.TAPE_ID_LIMIT (2**31)."""
    rng.check_path_ids(camera.width * camera.height, spp, sample_offset,
                       limit=rng.TAPE_ID_LIMIT)
    num_pix = camera.width * camera.height if num_pix_local is None else num_pix_local
    total = num_pix * spp
    mi = cfg.max_iters
    base_path = sample_offset * num_pix
    # the last slot takes the writes of dead lanes
    rec = torch.zeros((mi * total + 1,), dtype=torch.int32, device=scene.device)
    tape: dict = {}
    rec_raycast, rec_visible = recording_hooks(scene, tape, search)

    def commit(ray_ids, lane_iter, alive):
        reached = tape.get("reached")
        if reached is None:  # NEE off or no lights
            reached = torch.zeros_like(alive)
        packed = _pack_rec(tape["hit"], tape["pid"], tape["sph"], reached)
        slot = lane_iter.to(torch.int64) * total + (ray_ids - base_path)
        slot = torch.where(alive & (lane_iter < mi), slot, torch.full_like(slot, mi * total))
        rec[slot] = packed
        tape.clear()

    with torch.no_grad():
        img, _ = _run_wavefront(scene, camera, spp, base_key, cfg, lanes, sample_offset,
                                pix_offset=pix_offset, num_pix_local=num_pix_local,
                                raycast_fn=rec_raycast, visible_fn=rec_visible,
                                on_iteration=commit)
    return rec[:-1].reshape(mi, total), img.reshape(num_pix, 3)


def _chunk_rays(camera: Camera, ids: torch.Tensor, base_key, *, pix_offset: int = 0,
                num_pix_local=None):
    """(org, dirs, local pixel, global ids) of the camera rays of arbitrary
    local path ids of a pixel slice (wavefront._run_wavefront's keywords;
    the whole image by default): global id = (ids // num_pix_local) *
    num_pix + pix_offset + local pixel, num_pix the camera's (JAX
    wavetape.py:314)."""
    npt = camera.width * camera.height
    npl = npt if num_pix_local is None else num_pix_local
    gids = _make_to_global(npl, npt, pix_offset)(ids)
    org, dirs = _regen_rays(camera, gids, base_key, npt)
    return org, dirs, ids % npl, gids


def _replay_step(scene, packed, ray_ids, it, base_key, cfg, *state):
    raycast, visible = replay_hooks(unpack_rec(packed))
    bounce = make_bounce_fn(scene, cfg, base_key, raycast_fn=raycast, visible_fn=visible)
    return tuple(bounce(*state, ray_ids, it)[:8])


def replay_chunk(scene: Scene, records, org, dirn, ray_ids, base_key,
                 cfg: IntegratorConfig):
    """Differentiable radiance (L, 3) of one path chunk from its packed
    records (depth, L): the NEE verdict comes from the reached bit, so no
    shadow ray and no second light pick is needed. Each bounce is
    recomputed in the backward instead of storing its activations
    (replay_chunk's jax.checkpoint, wavetape.py:264)."""
    state = init_state(org, dirn)
    for it in range(records.shape[0]):
        step = functools.partial(_replay_step, scene, records[it], ray_ids, it, base_key, cfg)
        state = checkpoint(step, *state, use_reentrant=False)
    return state[2]


def wavetape_grads_core(scene: Scene, camera: Camera, spp: int, base_key,
                        cfg: IntegratorConfig, ct_flat, lanes: int, chunk: int,
                        ct_fn=None, *, pix_offset: int = 0, num_pix_local=None,
                        search=None):
    """One recording sweep, then length-sorted chunked replay backwards, over
    the pixel slice [pix_offset, pix_offset + num_pix_local) of the camera's
    image (the whole image by default).

    ct_flat: (num_pix_local, 3) cotangent (any 1/spp already in it), or None
    with ct_fn(rec_film) -> cotangent from the recorded primal (an L2 loss
    reuses the one recording pass). Returns (g_tri, g_sph, film
    (num_pix_local, 3) replay primal mean, rec_film (num_pix_local, 3)
    recorded primal mean). Local path ids order the tape, global ids
    (JAX wavetape.py:314) drive RNG and camera rays."""
    npl = camera.width * camera.height if num_pix_local is None else num_pix_local
    total = npl * spp
    chunk = min(chunk, total)
    if total % chunk:
        raise ValueError(f"chunk={chunk} must divide the {total} paths")

    # the sweep ends in its host reads, so the device's sweep is done when
    # train.record closes
    with span("train.record"):
        records, rec_film = record_paths_wavefront(
            scene, camera, spp, base_key, cfg, lanes, pix_offset=pix_offset,
            num_pix_local=num_pix_local, search=search)
    if ct_flat is None:
        ct_flat = ct_fn(rec_film)

    with span("train.replay"):
        # length-sorted chunks: each replays as many bounces as its last path has
        with span("train.sort"):
            lens = ((records & _WRT_BIT) != 0).sum(dim=0)
            order = torch.argsort(lens, stable=True)
            depths = lens[order].reshape(-1, chunk)[:, -1].tolist()
        rec_rows = records.t()

        tri, sph = leaf_materials(scene.mat), leaf_materials(scene.spheres.mat)
        live = with_materials(scene, tri, sph)
        g_tri = g_sph = None
        # each path's radiance at its own slot (unique indices), summed over
        # the samples at the end: a fixed order, where index_add_'s atomics
        # would reorder a pixel's sums from run to run on CUDA
        path_rad = torch.zeros((total, 3), device=rec_film.device)
        for c, depth in enumerate(depths):
            with span("replay.chunk", depth=depth, paths=chunk):
                ids = order[c * chunk:(c + 1) * chunk]
                org, dirs, lpix, gids = _chunk_rays(camera, ids, base_key,
                                                    pix_offset=pix_offset, num_pix_local=npl)
                with span("replay.forward"):
                    rad = replay_chunk(live, rec_rows[ids, :depth].t(), org, dirs, gids,
                                       base_key, cfg)
                with span("replay.backward"):
                    gt, gs = material_grad((rad * ct_flat[lpix]).sum(), tri, sph)
                g_tri, g_sph = (gt, gs) if g_tri is None else (add_materials(g_tri, gt),
                                                               add_materials(g_sph, gs))
                path_rad[ids] = rad.detach()
    return g_tri, g_sph, path_rad.reshape(spp, npl, 3).sum(dim=0) / spp, rec_film


def material_grads_wavetape(scene: Scene, camera: Camera, spp: int, base_key,
                            cfg: IntegratorConfig = IntegratorConfig(),
                            loss_grad_img=None, lanes: int = 65536, chunk: int = 65536, *,
                            device="cuda", search=None):
    """(d loss / d tri_materials, d loss / d sphere_materials, image) with
    loss = sum(image * loss_grad_img), default ones: the contract of
    diff/replay.material_grads_replay, with one wavefront recording sweep
    and chunked replays. The image is the replay primal per pixel."""
    scene = scene.to(resolve_device(device))
    num_pix = camera.width * camera.height
    if loss_grad_img is None:
        loss_grad_img = torch.ones((camera.height, camera.width, 3))
    ct_pix = loss_grad_img.to(scene.device).reshape(num_pix, 3) / float(spp)
    g_tri, g_sph, film, _ = wavetape_grads_core(
        scene, camera, spp, base_key, cfg, ct_pix, lanes, chunk, search=search)
    return g_tri, g_sph, film.reshape(camera.height, camera.width, 3)
