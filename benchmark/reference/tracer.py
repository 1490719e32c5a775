"""The plain reference path tracer: brute-force closest hit over every
triangle and sphere, the reference's one-bounce transition, and a lockstep
loop over any set of global path ids (a frozen, trimmed copy of the port's
ops/intersect.py, ops/mt_closest.py and integrator/megakernel.py).

Estimator (the reference's GetColor_iter, CudaUtil.cuh:193-382, quirks
included): NEE and emissive hits add every bounce, no MIS; a miss adds
weight * 0.1 gray and ends the path; weight *= eval / max(pdf, 1e-2); a
zero sampled direction ends the path; refraction consumes no depth and is
capped by `RefractCnt++ > 8`; Russian roulette from bounce 3, skipped by
refracting bounces; the next origin is offset by EPS along the normal.
Randomness is keyed by (global path id, path-local iteration), so a path
traced here sees the draws it sees in any of the port's engines.

The searches run detached and the winner's (t, u, v) is recomputed
differentiably, so material gradients (train_step) follow the port's
detached-sampling estimator. Geometry takes no gradient.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference import bsdf
from benchmark.reference.core import (BIG_T, COL_LIGHT_PICK, COL_LOBE, COL_NEE_R1, COL_NEE_R2,
                                      COL_PHI, COL_RR, COL_RY, EPS, MAT_FIELDS, TINY, Camera,
                                      Material, Scene, cross, div_scalar, dot, max3, normalize,
                                      randint_from_uniform, safe_div, safe_sqrt,
                                      squared_length, uniforms)

_INF = float("inf")
# Rays x triangles per Möller-Trumbore batch: bounds the (rows x T)
# temporaries on 82k-triangle scenes (a few hundred MB each).
PAIR_CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class Config:
    """The integrator settings a configuration file states."""

    max_bounce: int = 8
    rr_bounce: int = 3
    rr_stop_prob: float = 0.5
    refract_cap: int = 8
    miss_radiance: tuple = (0.1, 0.1, 0.1)
    pdf_clamp: float = 1e-2
    nee: bool = True

    @property
    def max_iters(self) -> int:
        return self.max_bounce + self.refract_cap + 2


# --------------------------------------------------------------------------
# brute-force search
# --------------------------------------------------------------------------


def closest_masked(t_masked):
    """(best_t, idx int32, hit) over (R, N), inf = invalid; ties to the
    lowest index."""
    n = t_masked.shape[1]
    best = torch.amin(t_masked, dim=1)
    hit = torch.isfinite(best)
    lane = torch.arange(n, dtype=torch.int32, device=t_masked.device)[None, :]
    cand = torch.isfinite(t_masked) & (t_masked <= best[:, None])
    idx = torch.amin(torch.where(cand, lane, torch.full_like(lane, n)), dim=1)
    return best, torch.clamp(idx, max=n - 1).to(torch.int32), hit


def intersect_tris_all(v0, e1, e2, org, dirn, t_min, t_max):
    """All-pairs Möller-Trumbore with the backface cull det >= EPS."""
    d = dirn[:, None, :]
    tvec = org[:, None, :] - v0[None]
    p = cross(d, e2[None])
    q = cross(tvec, e1[None])
    det = dot(p, e1[None])
    inv_det = torch.where(torch.abs(det) > TINY, 1.0 / det, torch.zeros_like(det))
    t = dot(q, e2[None]) * inv_det
    u = dot(p, tvec)
    v = dot(q, d)
    valid = det >= EPS
    valid &= (t >= t_min[:, None]) & (t <= t_max[:, None])
    valid &= (u >= 0.0) & (u <= det)
    valid &= (v >= 0.0) & (u + v <= det)
    return t, valid, u * inv_det, v * inv_det


def search(table, org, dirn, t_min, t_max, closest: bool = True):
    """(hit, t, idx, u, v) of every ray against every row [v0 | e1 | e2]:
    the least t, ties to the lowest id; a miss gives t = u = v = 0."""
    rows = max(1, PAIR_CHUNK // max(table.shape[0], 1))
    out = []
    for i in range(0, max(org.shape[0], 1), rows):
        sl = slice(i, i + rows)
        t, valid, u, v = intersect_tris_all(table[:, 0:3], table[:, 3:6], table[:, 6:9],
                                            org[sl], dirn[sl], t_min[sl], t_max[sl])
        best_t, idx, hit = closest_masked(torch.where(valid, t, torch.full_like(t, _INF)))
        zero = torch.zeros_like(best_t)
        if closest:
            pick = idx.long()[:, None]
            u = torch.where(hit, torch.gather(u, 1, pick)[:, 0], zero)
            v = torch.where(hit, torch.gather(v, 1, pick)[:, 0], zero)
        else:
            u = v = zero
        out.append((hit, torch.where(hit, best_t, zero), idx, u, v))
    return out[0] if len(out) == 1 else tuple(torch.cat(x) for x in zip(*out))


def intersect_spheres_all(center, radius, org, dirn, t_min, t_max):
    oc = org[:, None, :] - center[None, :, :]
    a = squared_length(dirn)[:, None]
    half_b = dot(oc, dirn[:, None, :])
    c = squared_length(oc) - (radius * radius)[None, :]
    disc = half_b * half_b - a * c
    has = disc >= 0.0
    sqrtd = safe_sqrt(disc)
    root0 = (-half_b - sqrtd) / a
    root1 = (-half_b + sqrtd) / a
    in0 = (root0 >= t_min[:, None]) & (root0 <= t_max[:, None])
    in1 = (root1 >= t_min[:, None]) & (root1 <= t_max[:, None])
    return torch.where(in0, root0, root1), has & (in0 | in1)


def _closest_sphere(scene: Scene, org, dirn, t_min, cur_max):
    st, ok = intersect_spheres_all(scene.sph_center, scene.sph_radius, org, dirn, t_min, cur_max)
    return closest_masked(torch.where(ok, st, torch.full_like(st, _INF)))


def mt_gather(scene: Scene, pid, org, dirn, t_min, t_max):
    """Möller-Trumbore against one triangle a lane: the winner's
    differentiable (t, u, v), bit for bit the search's values."""
    pid = pid.long()
    v0 = scene.v0[pid]
    e1 = scene.v1[pid] - v0
    e2 = scene.v2[pid] - v0
    tvec = org - v0
    p = cross(dirn, e2)
    q = cross(tvec, e1)
    det = dot(p, e1)
    big = torch.abs(det) > TINY
    inv_det = torch.where(big, 1.0 / torch.where(big, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    t = dot(q, e2) * inv_det
    u = dot(p, tvec)
    v = dot(q, dirn)
    return t, u * inv_det, v * inv_det


@dataclasses.dataclass(frozen=True)
class Hit:
    hit: torch.Tensor
    p: torch.Tensor
    normal: torch.Tensor
    tangent: torch.Tensor
    bitangent: torch.Tensor
    front_face: torch.Tensor
    prim_id: torch.Tensor
    is_sphere: torch.Tensor
    mat: Material


def _w3(mask, a, b):
    return torch.where(mask[:, None], a, b)


def raycast(scene: Scene, org, dirn, observe=None) -> Hit:
    """Closest hit over triangles then spheres (CudaUtil.cuh:93-148)."""
    r = org.shape[0]
    t_min = torch.zeros((r,), device=org.device)
    t_max = torch.full((r,), BIG_T, device=org.device)
    tri_hit, best_t, tri_idx, tri_u, tri_v = search(scene.search_table, org.detach(),
                                                    dirn.detach(), t_min, t_max)
    if observe is not None:
        observe("closest", org.detach(), dirn.detach(), t_min, t_max, tri_hit, best_t)
    t2, u2, v2 = mt_gather(scene, tri_idx, org, dirn, t_min, t_max)
    best_t = torch.where(tri_hit, t2, best_t)
    tri_u = torch.where(tri_hit, u2, tri_u)
    tri_v = torch.where(tri_hit, v2, tri_v)

    best_t = torch.where(tri_hit, best_t, torch.full_like(best_t, _INF))
    zero = torch.zeros_like(best_t)

    # triangle side: swapped barycentric weights (CudaPrimitive.cuh:141-146)
    idx = torch.where(tri_hit, tri_idx, torch.zeros_like(tri_idx)).long()
    w0 = (1.0 - tri_u - tri_v)[:, None]
    wu, wv = tri_u[:, None], tri_v[:, None]
    interp = lambda a: w0 * a[0][idx] + wv * a[1][idx] + wu * a[2][idx]
    out_n = normalize(interp(scene.n))
    tf = dot(dirn, out_n) < 0.0
    tri = Hit(hit=tri_hit, p=org + torch.where(tri_hit, best_t, zero)[:, None] * dirn,
              normal=_w3(tf, out_n, -out_n), tangent=normalize(interp(scene.t)),
              bitangent=normalize(interp(scene.b)), front_face=tf, prim_id=tri_idx,
              is_sphere=torch.zeros_like(tri_hit), mat=scene.mat.gather(idx))
    if scene.num_spheres == 0:
        return tri

    cur_max = torch.where(tri_hit, best_t, t_max)
    sph_t, sph_idx, sph_hit = _closest_sphere(scene, org, dirn, t_min, cur_max)
    use_sphere = sph_hit & (~tri_hit | (sph_t < best_t))
    # sphere side: frame from +Y (CudaPrimitive.cuh:287-288)
    sidx = torch.where(sph_hit, sph_idx, torch.zeros_like(sph_idx)).long()
    sp = org + torch.where(sph_hit, sph_t, zero)[:, None] * dirn
    outward = (sp - scene.sph_center[sidx]) / torch.clamp(scene.sph_radius[sidx], min=TINY)[:, None]
    sf = dot(dirn, outward) < 0.0
    sn = _w3(sf, outward, -outward)
    up = torch.zeros_like(sn)
    up[:, 1] = 1.0
    st = normalize(cross(up, sn))
    sph = Hit(hit=sph_hit, p=sp, normal=sn, tangent=st, bitangent=cross(sn, st),
              front_face=sf, prim_id=sph_idx, is_sphere=use_sphere,
              mat=scene.sph_mat.gather(sidx))
    pick = lambda a, b: _w3(use_sphere, a, b) if a.dim() == 2 else torch.where(use_sphere, a, b)
    return Hit(hit=tri_hit | sph_hit, p=pick(sph.p, tri.p), normal=pick(sph.normal, tri.normal),
               tangent=pick(sph.tangent, tri.tangent),
               bitangent=pick(sph.bitangent, tri.bitangent),
               front_face=pick(sph.front_face, tri.front_face),
               prim_id=torch.where(use_sphere, sph_idx, tri_idx), is_sphere=use_sphere,
               mat=Material(*[pick(getattr(sph.mat, f), getattr(tri.mat, f))
                              for f in MAT_FIELDS]))


def shadow_reaches(scene: Scene, org, dirn, t_min, t_max, light_tri, observe=None):
    """Whether an NEE ray's closest winner IS the sampled light triangle."""
    tri_hit, best_t, tri_idx, _, _ = search(scene.search_table, org, dirn, t_min, t_max,
                                            closest=False)
    if observe is not None:
        observe("shadow", org, dirn, t_min, t_max, tri_hit, best_t)
    on_light = tri_hit & (tri_idx == light_tri.to(tri_idx.dtype))
    if scene.num_spheres == 0:
        return on_light
    best_t = torch.where(tri_hit, best_t, torch.full_like(best_t, _INF))
    cur_max = torch.where(tri_hit, best_t, t_max)
    sph_t, _, sph_hit = _closest_sphere(scene, org, dirn, t_min, cur_max)
    return on_light & ~(sph_hit & (~tri_hit | (sph_t < best_t)))


# --------------------------------------------------------------------------
# one bounce, and the lockstep loop
# --------------------------------------------------------------------------


def nee(scene: Scene, hit: Hit, frame, wo, draws, observe=None):
    """Next-event estimation: uniform light pick, area sample, shadow ray,
    brdfcos * Le * cosA / (dist^2 * pdfLight) (CudaUtil.cuh:234-272)."""
    nl = scene.num_lights
    slot = randint_from_uniform(draws[:, COL_LIGHT_PICK], nl).long()
    light_tri = scene.lights[slot]
    row = scene.light_pack[slot]
    v0, v1, v2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    area, light_normal = row[:, 9], row[:, 10:13]
    r1 = safe_sqrt(draws[:, COL_NEE_R1])[:, None]
    r2 = draws[:, COL_NEE_R2][:, None]
    point = (1.0 - r1) * v0 + r1 * (1.0 - r2) * v1 + r1 * r2 * v2
    to_light = point - hit.p
    dist2 = squared_length(to_light)
    dist = torch.sqrt(torch.clamp(dist2, min=TINY))
    sdir = normalize(to_light)
    reached = shadow_reaches(scene, hit.p.detach(), sdir.detach(), torch.full_like(dist, EPS),
                             dist.detach() + 1.0, light_tri, observe)
    l_emit = scene.mat.emittance[light_tri]
    light_color = torch.where(reached[:, None], l_emit, torch.zeros_like(l_emit))
    cos_a = torch.clamp(dot(light_normal, normalize(hit.p - point)), min=0.0)
    pdf_light = div_scalar(safe_div(torch.ones_like(area), area), nl)
    brdfcos = bsdf.eval_bsdfcos(hit.mat, frame, wo, sdir)
    contrib = (brdfcos * light_color * cos_a[:, None]
               / torch.clamp(dist2 * pdf_light, min=TINY)[:, None])
    finite = torch.isfinite(contrib).all(dim=-1, keepdim=True)
    return torch.where(finite, contrib, torch.zeros_like(contrib)), reached


def bounce(scene: Scene, cfg: Config, key, state, ray_ids, it, observe=None):
    """One lockstep iteration; state = (org, dirn, radiance, weight, depth,
    refract_cnt, refracted, alive). observe(kind, ...) sees each search
    (the roofline counts, benchmark/roofline)."""
    org, dirn, radiance, weight, depth, refract_cnt, refracted, alive = state
    draws = uniforms(key, ray_ids, it)
    hit = raycast(scene, org, dirn, observe)
    live_hit = alive & hit.hit
    live_miss = alive & ~hit.hit
    zero3 = torch.zeros_like(radiance)
    miss_rgb = torch.tensor(cfg.miss_radiance, device=org.device)
    radiance = radiance + torch.where(live_miss[:, None], weight * miss_rgb, zero3)
    frame = bsdf.ShadeFrame(normal=hit.normal, tangent=hit.tangent, bitangent=hit.bitangent,
                            front_face=hit.front_face)
    wo = -dirn
    emissive = squared_length(hit.mat.emittance) > EPS
    radiance = radiance + torch.where((live_hit & emissive)[:, None],
                                      weight * hit.mat.emittance, zero3)
    reached = None
    if cfg.nee and scene.num_lights > 0:
        contrib, reached = nee(scene, hit, frame, wo, draws, observe)
        radiance = radiance + torch.where(live_hit[:, None], weight * contrib, zero3)
    wi = bsdf.sample_bsdf(hit.mat, frame, wo, draws[:, COL_LOBE], draws[:, COL_PHI],
                          draws[:, COL_RY]).detach()
    w1 = bsdf.eval_bsdfcos(hit.mat, frame, wo, wi)
    w2 = torch.clamp(bsdf.pdf_bsdf(hit.mat, frame, wo, wi), min=cfg.pdf_clamp).detach()
    current_weight = w1 / w2[:, None]
    dead_sample = squared_length(wi) <= EPS
    cont = live_hit & ~dead_sample
    weight = torch.where(cont[:, None], weight * current_weight, weight)
    transparent = hit.mat.opacity < (1.0 - EPS)
    new_refracted = dot(frame.normal, wo) * dot(frame.normal, wi) <= 0.0
    refracted = torch.where(cont & transparent, new_refracted, refracted)
    offset = torch.where(refracted, -EPS, EPS).to(org.dtype)
    org = torch.where(cont[:, None], hit.p + frame.normal * offset[:, None], org)
    dirn = torch.where(cont[:, None], normalize(wi), dirn)
    refract_now = cont & refracted
    over_cap = refract_now & (refract_cnt > cfg.refract_cap)
    refract_cnt = refract_cnt + refract_now.to(torch.int32)
    rr_lane = cont & ~refracted & (depth >= cfg.rr_bounce)
    rr_prob = torch.clamp(max3(weight.detach()), cfg.rr_stop_prob, 1.0)
    rr_survive = draws[:, COL_RR] < rr_prob
    weight = torch.where((rr_lane & rr_survive)[:, None], weight / rr_prob[:, None], weight)
    depth_next = depth + (cont & ~refracted).to(torch.int32)
    alive_next = (cont & ~over_cap & ~(rr_lane & ~rr_survive) & (depth_next < cfg.max_bounce))
    info = dict(alive=alive, live_hit=live_hit, reached=reached)
    return (org, dirn, radiance, weight, depth_next, refract_cnt, refracted, alive_next), info


def trace(scene: Scene, camera: Camera, cfg: Config, key, path_ids, observe=None,
          on_bounce=None):
    """(R, 3) radiance of the camera paths with these global ids, every
    lane in lockstep (lane_iter = the global iteration). on_bounce(info)
    sees each iteration's alive, live_hit and reached masks."""
    org, dirn = camera.rays(key, path_ids)
    r, dev = org.shape[0], org.device
    state = (org, dirn, torch.zeros((r, 3), device=dev), torch.ones((r, 3), device=dev),
             torch.zeros((r,), dtype=torch.int32, device=dev),
             torch.zeros((r,), dtype=torch.int32, device=dev),
             torch.zeros((r,), dtype=torch.bool, device=dev),
             torch.ones((r,), dtype=torch.bool, device=dev))
    for it in range(cfg.max_iters):
        if not bool(state[7].any()):
            break
        state, info = bounce(scene, cfg, key, state, path_ids, it, observe)
        if on_bounce is not None:
            on_bounce(info)
    return state[2]


def pixel_sums(scene: Scene, camera: Camera, cfg: Config, key, pixels, spp: int,
               chunk_spp: int, block: int = 1 << 19):
    """(P, 3) images of these global pixels over samples [0, spp), summed
    as the port's engines sum them: each chunk's paths in sample order from
    0, the chunks added in order, the total divided by spp. Paths are traced
    in blocks of about `block`."""
    pixels = torch.as_tensor(pixels, dtype=torch.int64)
    npix = pixels.shape[0]
    dev = scene.v0.device
    samples = torch.arange(spp, dtype=torch.int64)
    ids = (samples[:, None] * camera.num_pix + pixels[None, :]).reshape(-1).to(dev)
    per = max(1, block // npix)
    rad = torch.cat([trace(scene, camera, cfg, key, ids[s * npix:(s + per) * npix])
                     for s in range(0, spp, per)]).reshape(spp, npix, 3)
    film = None
    for c in range(0, spp, chunk_spp):
        acc = torch.zeros((npix, 3), device=dev)
        for s in range(c, min(c + chunk_spp, spp)):
            acc = acc + rad[s]
        film = acc if film is None else film + acc
    return film / spp


def train_step(scene: Scene, camera: Camera, cfg: Config, key, spp: int, target, chunk: int):
    """(loss, (tri grads, sphere grads), (H, W, 3) image) of the L2 step
    sum((image - target)^2) over all camera paths of the film, by autograd
    through the lockstep tracer. The primal runs first without grad; the
    gradient pass replays the paths in chunks with the cotangent
    2 (image - target) / spp."""
    npix = camera.num_pix
    dev = scene.v0.device
    ids = torch.arange(npix * spp, dtype=torch.int64, device=dev)
    with torch.no_grad():
        rad = torch.cat([trace(scene, camera, cfg, key, ids[i:i + chunk])
                         for i in range(0, ids.numel(), chunk)])
    film = rad.reshape(spp, npix, 3).sum(dim=0) / spp
    tgt = target.reshape(npix, 3)
    ct = 2.0 * (film - tgt) / float(spp)
    tri = Material(*[getattr(scene.mat, f).detach().clone().requires_grad_(True)
                     for f in MAT_FIELDS])
    sph = Material(*[getattr(scene.sph_mat, f).detach().clone().requires_grad_(True)
                     for f in MAT_FIELDS])
    live = scene.with_materials(tri, sph)
    leaves = [getattr(m, f) for m in (tri, sph) for f in MAT_FIELDS]
    grads = [torch.zeros_like(x) for x in leaves]
    for i in range(0, ids.numel(), chunk):
        sl = ids[i:i + chunk]
        out = trace(live, camera, cfg, key, sl)
        g = torch.autograd.grad((out * ct[sl % npix]).sum(), leaves, allow_unused=True)
        grads = [a if b is None else a + b for a, b in zip(grads, g)]
    n = len(MAT_FIELDS)
    loss = ((film - tgt) ** 2).sum()
    return (loss, (Material(*grads[:n]), Material(*grads[n:])),
            film.reshape(camera.height, camera.width, 3))
