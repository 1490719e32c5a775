"""Batch "SIMT" path integrator: all rays advance through bounces in
lockstep, dead lanes masked (port of pathtrace_tpu/integrator/megakernel.py).

Estimator semantics follow the reference's GetColor_iter
(CudaUtil.cuh:193-382), quirks included:
- additive NEE + emissive hit every bounce, no MIS;
- miss adds weight * (0.1, 0.1, 0.1);
- weight *= eval / max(pdf, 1e-2);
- a zero sampled direction kills the path;
- refraction consumes no depth; RefractCnt cap with the pre-increment
  check `RefractCnt++ > 8`; the refraction flag is sticky (reassigned
  only on transparent hits);
- Russian roulette from bounce 3, survive prob clamp(max(weight), 0.5, 1),
  skipped on refracted bounces;
- next origin offset +-EPS along the shading normal;
- NaN NEE contributions are skipped.

Differentiation (torch autograd): with cfg.detach_sampling the sampled
direction, its pdf and the Russian-roulette probability are detached
("detached sampling"), which leaves the primal unchanged and the material
and emission gradients unbiased; the searches are detached too, and the hit
is recomputed differentiably at the winner. cfg.remat checkpoints each
lockstep iteration (torch.utils.checkpoint).
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from pathtrace_tpu_torch.integrator.config import IntegratorConfig
from pathtrace_tpu_torch.models.scene import Scene
from pathtrace_tpu_torch.ops import bsdf, mat_gather
from pathtrace_tpu_torch.ops.bsdf import ShadeFrame
from pathtrace_tpu_torch.ops.intersect import BIG_T, HitRecord
from pathtrace_tpu_torch.ops.kd_raycast import kd_closest, raycast_kd, shadow_kd
from pathtrace_tpu_torch.ops.mt_closest import mt_closest, raycast_mt, shadow_mt
from pathtrace_tpu_torch.utils import math3, rng
from pathtrace_tpu_torch.utils.math3 import EPS, dot, normalize


def _maybe_detach(x: torch.Tensor, cfg: IntegratorConfig) -> torch.Tensor:
    return x.detach() if cfg.detach_sampling else x


def default_raycast(scene: Scene, search=None):
    """Closest-hit backend for the scene (megakernel.py:51-73):
    (scene, org, dirn, t_min, t_max) -> HitRecord. A scene with KD cells
    goes through them (raycast_kd), any other scene through the
    all-triangles search (raycast_mt, the JAX package's MT-matmul and Pallas
    route). Either search is the CUDA kernel on CUDA tensors and its plain
    version on CPU tensors; `search` replaces it (kd_closest_plain or
    mt_closest_plain, as chip_smoke.py does to run the plain version on the
    card). A scene with a BVH (Scene.with_bvh) keeps the all-triangles
    route over its leaf-ordered table, where the JAX package routes it
    through MT-matmul (with_mt, a TPU formulation the port does not build);
    both find raycast_brute's winners. accel/traverse.py::raycast_bvh, the
    JAX package's BVH route, is reachable as a raycast_fn. JAX's binned v1
    route is not ported (ROADMAP "Not to port")."""
    if scene.clusters is not None:
        return functools.partial(raycast_kd, search=search or kd_closest)
    return functools.partial(raycast_mt, search=search or mt_closest)


def default_shadow_raycast(scene: Scene, search=None):
    """Shadow-ray backend (megakernel.py:76-100): (scene, org, dirn,
    t_min, t_max) -> (hit, prim_id, is_sphere), routed as default_raycast."""
    if scene.clusters is not None:
        return functools.partial(shadow_kd, search=search or kd_closest)
    return functools.partial(shadow_mt, search=search or mt_closest)


def shadow_visibility(shadow):
    """visible_fn(scene, org, dirn, t_min, t_max, light_tri) -> reached,
    from a shadow raycast: the NEE ray reaches the light iff the winning
    primitive IS the sampled light triangle (megakernel.py:146-169)."""
    def visible(scene, org, dirn, t_min, t_max, light_tri):
        s_hit, s_prim, s_sph = shadow(scene, org, dirn, t_min, t_max)
        return s_hit & ~s_sph & (s_prim == light_tri)
    return visible


def nee_light_pick(scene: Scene, draws: torch.Tensor):
    """(light_slot, light_tri) for this bounce's NEE draw."""
    slot = rng.randint_from_uniform(draws[:, rng.COL_LIGHT_PICK], scene.num_lights)
    return slot, scene.lights[slot.long()]


def nee_contribution(scene: Scene, hit: HitRecord, frame: ShadeFrame,
                     wo: torch.Tensor, draws: torch.Tensor, visible_fn) -> torch.Tensor:
    """Next-event estimation (CudaUtil.cuh:234-272): uniform light pick,
    area sample (SamplePrimitive), shadow ray, and
    brdfcos * Llight * cosA / (dist^2 * pdfLight), pdfLight = (1/area)/Nl.

    The shadow ray leaves the surface with t in [EPS, dist+1] and reaches
    the light iff the winning primitive IS the sampled light triangle
    (megakernel.py:146-169 gives the reasons for both deviations from the
    reference). visible_fn(scene, org, dirn, t_min, t_max, light_tri) ->
    reached decides it (shadow_visibility of a shadow raycast; the replay
    reads it from the record). The ray is detached: visibility is discrete."""
    nl = scene.num_lights
    slot, light_tri = nee_light_pick(scene, draws)
    row = scene.light_pack[slot.long()]
    v0, v1, v2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    area = row[:, 9]
    light_normal = row[:, 10:13]
    # SamplePrimitive: r1 = sqrt(u), point = (1-r1)V0 + r1(1-r2)V1 + r1 r2 V2
    r1 = math3.safe_sqrt(draws[:, rng.COL_NEE_R1])[:, None]
    r2 = draws[:, rng.COL_NEE_R2][:, None]
    point = (1.0 - r1) * v0 + r1 * (1.0 - r2) * v1 + r1 * r2 * v2

    to_light = point - hit.p
    dist2 = math3.squared_length(to_light)
    dist = torch.sqrt(torch.clamp(dist2, min=math3.TINY))
    sdir = normalize(to_light)

    reached = visible_fn(scene, hit.p.detach(), sdir.detach(), torch.full_like(dist, EPS),
                         dist.detach() + 1.0, light_tri)
    (l_emit,) = mat_gather.gather((scene.mat.emittance,), light_tri)
    light_color = torch.where(reached[:, None], l_emit, torch.zeros_like(l_emit))

    cos_a = torch.clamp(dot(light_normal, normalize(hit.p - point)), min=0.0)
    pdf_light = math3.div_scalar(math3.safe_div(torch.ones_like(area), area), nl)

    brdfcos = bsdf.eval_bsdfcos(hit.mat, frame, wo, sdir)
    contrib = (brdfcos * light_color * cos_a[:, None]
               / torch.clamp(dist2 * pdf_light, min=math3.TINY)[:, None])
    finite = torch.isfinite(contrib).all(dim=-1, keepdim=True)
    return torch.where(finite, contrib, torch.zeros_like(contrib))


def make_bounce_fn(scene: Scene, cfg: IntegratorConfig, base_key, *, search=None,
                   raycast_fn=None, visible_fn=None, sample_mat_fn=None):
    """One-bounce transition shared by the lockstep megakernel, the
    regenerating wavefront and the gradient recorder and replay
    (megakernel.py:185-305). Randomness is keyed by (ray_id, lane_iter), so
    every integrator realizes the identical estimator per path.

    raycast_fn(scene, org, dirn, t_min, t_max) -> HitRecord defaults to
    default_raycast(scene, search); visible_fn (see nee_contribution) to the
    shadow_visibility of default_shadow_raycast(scene, search). The
    recorder tapes through them, the replay rebuilds hits from the tape.
    sample_mat_fn: optional HitRecord -> Material used ONLY for the
    sampling-side decisions (direction, pdf, transparency flag); the FD
    oracle passes a gather of the unperturbed materials (diff/fd.py).

    Returns bounce(org, dirn, radiance, weight, depth, refract_cnt,
    refracted, alive, ray_ids, lane_iter) -> (the same state minus the
    ids, plus the int64 count of rays traced this iteration)."""
    if cfg.hemisphere not in ("cosine", "uniform"):
        raise ValueError(f"unknown hemisphere {cfg.hemisphere!r}")
    uni = cfg.hemisphere == "uniform"
    raycast = raycast_fn or default_raycast(scene, search)
    visible = visible_fn or shadow_visibility(default_shadow_raycast(scene, search))

    def bounce(org, dirn, radiance, weight, depth, refract_cnt, refracted,
               alive, ray_ids, lane_iter):
        draws = rng.uniforms(base_key, ray_ids, lane_iter)
        r = org.shape[0]
        hit = raycast(scene, org, dirn, torch.zeros((r,), device=org.device),
                      torch.full((r,), BIG_T, device=org.device))
        live_hit = alive & hit.hit
        live_miss = alive & ~hit.hit
        zero3 = torch.zeros_like(radiance)

        # miss: += weight * 0.1 gray, path ends (CudaUtil.cuh:375-379)
        miss_rgb = torch.tensor(cfg.miss_radiance, dtype=torch.float32,
                                device=org.device)
        radiance = radiance + torch.where(live_miss[:, None], weight * miss_rgb, zero3)

        frame = ShadeFrame(normal=hit.normal, tangent=hit.tangent,
                           bitangent=hit.bitangent, front_face=hit.front_face)
        wo = -dirn

        # emissive hit accumulates every bounce (CudaUtil.cuh:220-224)
        emissive = math3.squared_length(hit.mat.emittance) > EPS
        radiance = radiance + torch.where((live_hit & emissive)[:, None],
                                          weight * hit.mat.emittance, zero3)

        # rays traced: one closest hit per alive lane, plus one shadow ray
        # per live hit when NEE runs
        rays = alive.sum(dtype=torch.int64)
        if cfg.nee and scene.num_lights > 0:
            contrib = nee_contribution(scene, hit, frame, wo, draws, visible)
            radiance = radiance + torch.where(live_hit[:, None], weight * contrib,
                                              zero3)
            rays = rays + live_hit.sum(dtype=torch.int64)

        # BSDF sampling (CudaUtil.cuh:276-338); sampling-side material smat
        u_lobe = draws[:, rng.COL_LOBE]
        u_phi = draws[:, rng.COL_PHI]
        u_ry = draws[:, rng.COL_RY]
        smat = hit.mat if sample_mat_fn is None else sample_mat_fn(hit)
        wi = _maybe_detach(bsdf.sample_bsdf(smat, frame, wo, u_lobe, u_phi, u_ry,
                                            uniform_hemi=uni), cfg)
        w1 = bsdf.eval_bsdfcos(hit.mat, frame, wo, wi)
        w2 = _maybe_detach(torch.clamp(bsdf.pdf_bsdf(smat, frame, wo, wi, uniform_hemi=uni),
                                       min=cfg.pdf_clamp), cfg)
        current_weight = w1 / w2[:, None]

        dead_sample = math3.squared_length(wi) <= EPS
        cont = live_hit & ~dead_sample
        weight = torch.where(cont[:, None], weight * current_weight, weight)

        # sticky refraction flag: reassigned only on transparent hits
        # (CudaUtil.cuh:307); a sampling-side decision
        transparent = smat.opacity < (1.0 - EPS)
        new_refracted = dot(frame.normal, wo) * dot(frame.normal, wi) <= 0.0
        refracted = torch.where(cont & transparent, new_refracted, refracted)

        # next ray (CudaUtil.cuh:349-350); the Ray ctor normalizes dir
        offset = torch.where(refracted, -EPS, EPS).to(torch.float32)
        org_next = hit.p + frame.normal * offset[:, None]
        dir_next = normalize(wi)
        org = torch.where(cont[:, None], org_next, org)
        dirn = torch.where(cont[:, None], dir_next, dirn)

        # refraction depth exemption + cap: `if (RefractCnt++ > 8) break`
        refract_now = cont & refracted
        over_cap = refract_now & (refract_cnt > cfg.refract_cap)
        refract_cnt = refract_cnt + refract_now.to(torch.int32)

        # Russian roulette (CudaUtil.cuh:361-373) from the loop-entry depth,
        # skipped by refracting lanes
        rr_lane = cont & ~refracted & (depth >= cfg.rr_bounce)
        rr_prob = torch.clamp(math3.max3(_maybe_detach(weight, cfg)), cfg.rr_stop_prob, 1.0)
        rr_survive = draws[:, rng.COL_RR] < rr_prob
        weight = torch.where((rr_lane & rr_survive)[:, None],
                             weight / rr_prob[:, None], weight)

        depth_next = depth + (cont & ~refracted).to(torch.int32)
        alive = (cont & ~over_cap & ~(rr_lane & ~rr_survive)
                 & (depth_next < cfg.max_bounce))
        return (org, dirn, radiance, weight, depth_next, refract_cnt, refracted,
                alive, rays)

    return bounce


def init_state(org: torch.Tensor, dirn: torch.Tensor):
    """The lockstep state of fresh camera rays: (org, dirn, radiance,
    weight, depth, refract_cnt, refracted, alive)."""
    r, dev = org.shape[0], org.device
    return (
        org, dirn,
        torch.zeros((r, 3), device=dev),                   # radiance
        torch.ones((r, 3), device=dev),                    # weight
        torch.zeros((r,), dtype=torch.int32, device=dev),  # depth
        torch.zeros((r,), dtype=torch.int32, device=dev),  # refract count
        torch.zeros((r,), dtype=torch.bool, device=dev),   # sticky refraction flag
        torch.ones((r,), dtype=torch.bool, device=dev),    # alive
    )


def trace_paths_stats(scene: Scene, org: torch.Tensor, dirn: torch.Tensor,
                      ray_ids: torch.Tensor, base_key,
                      cfg: IntegratorConfig = IntegratorConfig(),
                      raycast_fn=None, sample_mat_fn=None, *, search=None):
    """Radiance for a batch of camera rays in lockstep, up to cfg.max_iters
    iterations (every lane shares the global iteration counter). Returns
    ((R, 3) radiance, int rays traced). The loop stops early once every
    lane is dead: dead lanes change nothing. cfg.remat recomputes each
    iteration in the backward instead of storing it (megakernel.py:356-357).
    search, raycast_fn and sample_mat_fn as in make_bounce_fn."""
    bounce = make_bounce_fn(scene, cfg, base_key, search=search, raycast_fn=raycast_fn,
                            sample_mat_fn=sample_mat_fn)
    state = init_state(org, dirn)
    rays = torch.zeros((), dtype=torch.int64, device=org.device)
    for it in range(cfg.max_iters):
        if not bool(state[7].any()):
            break
        if cfg.remat:
            *state, traced = checkpoint(bounce, *state, ray_ids, it, use_reentrant=False)
        else:
            *state, traced = bounce(*state, ray_ids, it)
        rays = rays + traced
    return state[2], int(rays)


def trace_paths(scene: Scene, org, dirn, ray_ids, base_key,
                cfg: IntegratorConfig = IntegratorConfig(),
                raycast_fn=None, sample_mat_fn=None, *, search=None) -> torch.Tensor:
    """Radiance only; see trace_paths_stats."""
    return trace_paths_stats(scene, org, dirn, ray_ids, base_key, cfg, raycast_fn,
                             sample_mat_fn, search=search)[0]
