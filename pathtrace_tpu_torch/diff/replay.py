"""Compact path-record replay differentiation (port of
pathtrace_tpu/diff/replay.py).

1. RECORD (primal, no autograd): the lockstep bounce loop with the
   detached search, saving per bounce only the discrete outcome it
   produced: hit, prim_id, is_sphere of the closest hit and whether the NEE
   shadow ray reached its light. Everything else (barycentrics, hit points,
   BSDF draws, Russian roulette) is recomputable, since the RNG is a
   counter-based Philox keyed by (ray_id, path-local bounce).
2. REPLAY (differentiable): the same bounce with the search replaced by a
   hit rebuilt from the record: the recorded triangle's Möller-Trumbore
   (mt_gather) or the recorded sphere's root, then the shading attributes,
   differentiably in the materials. No search appears in the graph.

The JAX record keeps the shadow winner (s_hit, s_pid, s_sph); the port
keeps nee_contribution's verdict, `reached` (the wavetape's bit), since the
replay needs nothing else. The replay primal equals the record primal,
because the recording searches recompute (t, u, v) at the winner with the
same mt_gather (ops/intersect.py::finalize_hit_at); gradients equal the
lockstep autograd ones because the record holds what that detaches.
"""

from __future__ import annotations

import torch

from pathtrace_tpu_torch.core.camera import Camera
from pathtrace_tpu_torch.diff.grad import (MAT_FIELDS, add_materials, leaf_materials,
                                           material_grad, with_materials)
from pathtrace_tpu_torch.integrator.config import IntegratorConfig
from pathtrace_tpu_torch.integrator.megakernel import (default_raycast, default_shadow_raycast,
                                                       init_state, make_bounce_fn,
                                                       shadow_visibility)
from pathtrace_tpu_torch.models.scene import Material, Scene
from pathtrace_tpu_torch.ops.intersect import (BIG_T, HitRecord, _gather_sphere_hit,
                                               _gather_tri_hit, mt_gather, no_tri_hit)
from pathtrace_tpu_torch.utils import math3, rng
from pathtrace_tpu_torch.utils.device import resolve_device

RECORD_FIELDS = ("hit", "pid", "sph", "reached")


# ---------------------------------------------------------------------------
# record phase
# ---------------------------------------------------------------------------

def recording_hooks(scene: Scene, tape: dict, search=None):
    """(raycast_fn, visible_fn) for make_bounce_fn that run the scene's
    searches and write this bounce's outcome into `tape` (RECORD_FIELDS)."""
    raycast = default_raycast(scene, search)
    visible = shadow_visibility(default_shadow_raycast(scene, search))

    def rec_raycast(sc, org, dirn, t_min, t_max):
        h = raycast(sc, org, dirn, t_min, t_max)
        tape.update(hit=h.hit, pid=h.prim_id, sph=h.is_sphere)
        return h

    def rec_visible(sc, org, dirn, t_min, t_max, light_tri):
        tape["reached"] = visible(sc, org, dirn, t_min, t_max, light_tri)
        return tape["reached"]

    return rec_raycast, rec_visible


def record_paths(scene: Scene, org, dirn, ray_ids, base_key,
                 cfg: IntegratorConfig = IntegratorConfig(), *, search=None):
    """Primal lockstep loop that tapes the discrete outcomes.

    Returns (radiance (R, 3), records): a dict of (max_iters, R) tensors,
    hit/pid/sph of the closest hit and `reached` of the NEE shadow ray of
    every bounce (iterations after every lane died hold zeros)."""
    r = org.shape[0]
    tape: dict = {}
    rec_raycast, rec_visible = recording_hooks(scene, tape, search)
    bounce = make_bounce_fn(scene, cfg, base_key, raycast_fn=rec_raycast,
                            visible_fn=rec_visible)
    state = init_state(org, dirn)
    rows = []
    with torch.no_grad():
        for it in range(cfg.max_iters):
            if not bool(state[7].any()):
                break
            tape.clear()
            *state, _ = bounce(*state, ray_ids, it)
            if "reached" not in tape:  # NEE off or no lights
                tape["reached"] = torch.zeros_like(tape["hit"])
            rows.append(dict(tape))
    pad = cfg.max_iters - len(rows)
    records = {}
    for f in RECORD_FIELDS:
        like = rows[0][f] if rows else torch.zeros((r,), dtype=torch.bool, device=org.device)
        records[f] = torch.stack([row[f] for row in rows]
                                 + [torch.zeros_like(like)] * pad)
    return state[2], records


# ---------------------------------------------------------------------------
# replay phase: record-driven differentiable hit reconstruction
# ---------------------------------------------------------------------------

def _sphere_t_at(scene: Scene, idx, org, dirn, t_min):
    """Nearest valid root of the recorded sphere, per lane (replay.py:127-142):
    the record already decided this sphere wins, so only t_min excludes the
    near root."""
    idx = idx.long()
    center = scene.spheres.center[idx]
    radius = scene.spheres.radius[idx]
    oc = org - center
    a = math3.squared_length(dirn)
    half_b = math3.dot(oc, dirn)
    c = math3.squared_length(oc) - radius * radius
    disc = half_b * half_b - a * c
    sqrtd = math3.safe_sqrt(torch.clamp(disc, min=0.0))
    root0 = (-half_b - sqrtd) / a
    root1 = (-half_b + sqrtd) / a
    return torch.where(root0 >= t_min, root0, root1)


def _replay_hit(scene: Scene, org, dirn, t_min, rec) -> HitRecord:
    """The full HitRecord rebuilt differentiably from a bounce record
    (replay.py:145-199)."""
    r = org.shape[0]
    hit, use_sphere, pid = rec["hit"], rec["sph"], rec["pid"]
    tri_sel = hit & ~use_sphere
    zero = torch.zeros((r,), device=org.device)
    big = torch.full_like(zero, BIG_T)

    if scene.num_tris > 0:
        safe_tri = torch.where(tri_sel, pid, torch.zeros_like(pid))
        t_tri, u, v, _ = mt_gather(scene.tris, safe_tri, org, dirn, t_min, big)
        tp, tn, tt, tb, tf, tuv = _gather_tri_hit(
            scene, org, dirn, torch.where(tri_sel, t_tri, zero), u, v, safe_tri)
        tmat = scene.mat.gather(safe_tri)
    else:
        t_tri = zero
        tp, tn, tt, tb, tf, tuv, tmat = no_tri_hit(r, org.device)
    t_final = torch.where(tri_sel, t_tri, big)
    if scene.num_spheres == 0:
        return HitRecord(hit=hit, t=t_final, p=tp, normal=tn, tangent=tt, bitangent=tb,
                         front_face=tf, uv=tuv, prim_id=pid, is_sphere=use_sphere, mat=tmat)

    safe_sph = torch.where(use_sphere, pid, torch.zeros_like(pid))
    sph_t = _sphere_t_at(scene, safe_sph, org, dirn, t_min)
    sp, sn, stt, sb, sf, suv = _gather_sphere_hit(
        scene, org, dirn, torch.where(use_sphere, sph_t, zero), safe_sph)
    smat = scene.spheres.mat.gather(safe_sph)

    def pick(a, b):
        return torch.where(use_sphere[:, None] if a.dim() == 2 else use_sphere, a, b)

    mat = Material(*[pick(getattr(smat, f), getattr(tmat, f)) for f in MAT_FIELDS])
    return HitRecord(hit=hit, t=torch.where(use_sphere, sph_t, t_final), p=pick(sp, tp),
                     normal=pick(sn, tn), tangent=pick(stt, tt), bitangent=pick(sb, tb),
                     front_face=pick(sf, tf), uv=pick(suv, tuv), prim_id=pid,
                     is_sphere=use_sphere, mat=mat)


def replay_hooks(rec: dict):
    """(raycast_fn, visible_fn) for make_bounce_fn that rebuild one bounce
    from its record instead of searching."""
    def raycast(sc, org, dirn, t_min, t_max):
        return _replay_hit(sc, org, dirn, t_min, rec)

    def visible(sc, org, dirn, t_min, t_max, light_tri):
        return rec["reached"]

    return raycast, visible


def replay_paths(scene: Scene, records, org, dirn, ray_ids, base_key,
                 cfg: IntegratorConfig = IntegratorConfig()):
    """Differentiable re-execution of recorded paths -> radiance (R, 3).
    Its graph holds O(R) tensors per bounce and no search."""
    state = init_state(org, dirn)
    for it in range(records["hit"].shape[0]):
        if not bool(state[7].any()):
            break
        raycast, visible = replay_hooks({f: records[f][it] for f in RECORD_FIELDS})
        bounce = make_bounce_fn(scene, cfg, base_key, raycast_fn=raycast, visible_fn=visible)
        *state, _ = bounce(*state, ray_ids, it)
    return state[2]


# ---------------------------------------------------------------------------
# user-facing: render + material grads via record/replay
# ---------------------------------------------------------------------------

def _camera_rays(scene: Scene, camera: Camera, sample_idx: int, base_key,
                 pix_offset: int = 0, num_pix_local=None):
    """(org, dirs, ray_ids) of sample `sample_idx`'s camera rays on the
    scene's device, ray_id = sample * num_pix + pixel (render_sample's),
    for the pixel slice [pix_offset, pix_offset + num_pix_local) (the whole
    image when num_pix_local is None; JAX replay.py:240-254): a shard keys
    its rays by global id, so N-shard grads are path for path 1-shard's."""
    num_pix = camera.width * camera.height
    npl = num_pix if num_pix_local is None else num_pix_local
    pixel = pix_offset + torch.arange(npl, dtype=torch.int32, device=scene.device)
    px = (pixel % camera.width).to(torch.float32)
    py = (pixel // camera.width).to(torch.float32)
    ray_ids = sample_idx * num_pix + pixel
    ju = rng.pixel_jitter(base_key, ray_ids)
    dirs = camera.ray_directions(px, py, ju[:, 0], ju[:, 1])
    org = torch.as_tensor(camera.pos, device=scene.device).expand_as(dirs)
    return org, dirs, ray_ids


def _material_grads_replay_impl(scene: Scene, camera: Camera, spp: int, base_key, cfg,
                                loss_grad_flat, pix_offset: int = 0, num_pix_local=None, *,
                                search=None):
    """Record/replay gradient core over a pixel slice (the whole image when
    num_pix_local is None): per sample one recorded forward and one backward
    through the replay. loss_grad_flat: (num_pix_local, 3) cotangent, divided
    by spp here. Returns (g_tri, g_sph, (num_pix_local, 3) image slice)."""
    ct = loss_grad_flat / float(spp)
    tri, sph = leaf_materials(scene.mat), leaf_materials(scene.spheres.mat)
    live = with_materials(scene, tri, sph)
    g_tri = g_sph = None
    accum = torch.zeros_like(ct)
    for s in range(spp):
        org, dirs, ray_ids = _camera_rays(scene, camera, s, base_key, pix_offset,
                                          num_pix_local)
        _, records = record_paths(scene, org, dirs, ray_ids, base_key, cfg, search=search)
        rad = replay_paths(live, records, org, dirs, ray_ids, base_key, cfg)
        gt, gs = material_grad((rad * ct).sum(), tri, sph)
        g_tri, g_sph = (gt, gs) if g_tri is None else (add_materials(g_tri, gt),
                                                       add_materials(g_sph, gs))
        accum = accum + rad.detach()
    return g_tri, g_sph, accum / spp


def material_grads_replay(scene: Scene, camera: Camera, spp: int, base_key,
                          cfg: IntegratorConfig = IntegratorConfig(),
                          loss_grad_img=None, *, device="cuda", search=None):
    """(d loss / d tri_materials, d loss / d sphere_materials, image) with
    loss = sum(image * loss_grad_img), loss_grad_img defaulting to ones
    (summed pixel gradients, comparable to diff/grad.material_grads).
    Per sample: one recorded forward (detached search), then the backward
    of the cheap replay; peak memory is one sample's."""
    scene = scene.to(resolve_device(device))
    num_pix = camera.width * camera.height
    if loss_grad_img is None:
        loss_grad_img = torch.ones((camera.height, camera.width, 3))
    g_tri, g_sph, flat = _material_grads_replay_impl(
        scene, camera, spp, base_key, cfg,
        loss_grad_img.to(scene.device).reshape(num_pix, 3), search=search)
    return g_tri, g_sph, flat.reshape(camera.height, camera.width, 3)
