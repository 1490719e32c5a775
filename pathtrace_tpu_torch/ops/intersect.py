"""Brute-force ray-primitive intersection (port of the brute path of
pathtrace_tpu/ops/intersect.py).

Semantics preserved exactly, quirks included:
- backface cull: det < EPS rejects (CudaPrimitive.cuh:99);
- attributes interpolate as (1-u-v)*A0 + v*A1 + u*A2 - v weights vertex 1
  and u vertex 2, swapped vs. textbook MT (CudaPrimitive.cuh:141-146);
- the shading normal is flipped toward the ray (CudaPrimitive.cuh:41-44);
- the closest triangle breaks ties to the lowest index, and spheres are
  scanned against the running closest t (CudaUtil.cuh:137-145).

This is the O(R*T) oracle that the CUDA bounce kernel's search equals.
"""

from __future__ import annotations

import dataclasses

import torch

from pathtrace_tpu_torch.models.scene import Material, Scene
from pathtrace_tpu_torch.utils import math3
from pathtrace_tpu_torch.utils.math3 import EPS

BIG_T = 999999.0  # reference RayCast default t_max (CudaUtil.cuh:93)
_INF = float("inf")


def closest_masked(t_masked: torch.Tensor):
    """(best_t, idx int32, hit) over an (R, N) matrix with inf = invalid.
    Ties break to the lowest index."""
    n = t_masked.shape[1]
    best = torch.amin(t_masked, dim=1)
    hit = torch.isfinite(best)
    lane = torch.arange(n, dtype=torch.int32, device=t_masked.device)[None, :]
    cand = torch.isfinite(t_masked) & (t_masked <= best[:, None])
    idx = torch.amin(torch.where(cand, lane, torch.full_like(lane, n)), dim=1)
    return best, torch.clamp(idx, max=n - 1).to(torch.int32), hit


@dataclasses.dataclass(frozen=True)
class HitRecord:
    """SoA closest-hit result (reference HitResult, CudaPrimitive.cuh:25-45)."""

    hit: torch.Tensor         # (R,) bool
    t: torch.Tensor           # (R,)
    p: torch.Tensor           # (R, 3)
    normal: torch.Tensor      # (R, 3) shading normal, flipped toward ray
    tangent: torch.Tensor     # (R, 3)
    bitangent: torch.Tensor   # (R, 3)
    front_face: torch.Tensor  # (R,) bool
    uv: torch.Tensor          # (R, 2)
    prim_id: torch.Tensor     # (R,) int32: triangle or sphere index
    is_sphere: torch.Tensor   # (R,) bool
    mat: Material             # gathered per-ray material


def _where3(mask, a, b):
    return torch.where(mask[:, None], a, b)


def intersect_tris_all(v0, e1, e2, org, dirn, t_min, t_max):
    """All-pairs Möller-Trumbore of R rays against T triangles given as
    (T, 3) v0, e1 = v1 - v0, e2 = v2 - v0: (t (R,T), valid (R,T), u, v)
    with u, v the normalized barycentrics (post inv_det)."""
    v0 = v0[None]
    e1 = e1[None]
    e2 = e2[None]
    d = dirn[:, None, :]
    tvec = org[:, None, :] - v0
    p = math3.cross(d, e2)
    q = math3.cross(tvec, e1)
    det = math3.dot(p, e1)
    inv_det = torch.where(torch.abs(det) > math3.TINY, 1.0 / det,
                          torch.zeros_like(det))
    t = math3.dot(q, e2) * inv_det
    u = math3.dot(p, tvec)
    v = math3.dot(q, d)
    valid = det >= EPS
    valid &= (t >= t_min[:, None]) & (t <= t_max[:, None])
    valid &= (u >= 0.0) & (u <= det)
    valid &= (v >= 0.0) & (u + v <= det)
    return t, valid, u * inv_det, v * inv_det


def intersect_spheres_all(spheres, org, dirn, t_min, t_max):
    """All-pairs sphere intersection, nearest valid root: (t (R,S), valid)."""
    oc = org[:, None, :] - spheres.center[None, :, :]
    a = math3.squared_length(dirn)[:, None]
    half_b = math3.dot(oc, dirn[:, None, :])
    c = math3.squared_length(oc) - (spheres.radius * spheres.radius)[None, :]
    disc = half_b * half_b - a * c
    has = disc >= 0.0
    sqrtd = math3.safe_sqrt(disc)
    root0 = (-half_b - sqrtd) / a
    root1 = (-half_b + sqrtd) / a
    in0 = (root0 >= t_min[:, None]) & (root0 <= t_max[:, None])
    in1 = (root1 >= t_min[:, None]) & (root1 <= t_max[:, None])
    return torch.where(in0, root0, root1), has & (in0 | in1)


def _gather_tri_hit(scene: Scene, org, dirn, t, u, v, idx):
    """Hit attributes at normalized barycentrics with the reference's
    swapped weights: w0=1-u-v on A0, v on A1, u on A2."""
    tr = scene.tris
    idx = idx.long()
    w0 = (1.0 - u - v)[:, None]
    wu = u[:, None]
    wv = v[:, None]

    def interp(a0, a1, a2):
        return w0 * a0[idx] + wv * a1[idx] + wu * a2[idx]

    outward_n = math3.normalize(interp(tr.n0, tr.n1, tr.n2))
    front = math3.dot(dirn, outward_n) < 0.0
    normal = _where3(front, outward_n, -outward_n)
    tangent = math3.normalize(interp(tr.t0, tr.t1, tr.t2))
    bitangent = math3.normalize(interp(tr.b0, tr.b1, tr.b2))
    uv = interp(tr.uv0, tr.uv1, tr.uv2)
    p = org + t[:, None] * dirn
    return p, normal, tangent, bitangent, front, uv


def _gather_sphere_hit(scene: Scene, org, dirn, t, idx):
    sp = scene.spheres
    idx = idx.long()
    p = org + t[:, None] * dirn
    outward = (p - sp.center[idx]) / torch.clamp(sp.radius[idx], min=math3.TINY)[:, None]
    front = math3.dot(dirn, outward) < 0.0
    normal = _where3(front, outward, -outward)
    # tangent frame from +Y (CudaPrimitive.cuh:287-288)
    up = torch.zeros_like(normal)
    up[:, 1] = 1.0
    tangent = math3.normalize(math3.cross(up, normal))
    bitangent = math3.cross(normal, tangent)
    uv = torch.zeros((t.shape[0], 2), dtype=torch.float32, device=t.device)
    return p, normal, tangent, bitangent, front, uv


def _closest_sphere(scene: Scene, org, dirn, t_min, cur_max):
    st, svalid = intersect_spheres_all(scene.spheres, org, dirn, t_min, cur_max)
    return closest_masked(torch.where(svalid, st, torch.full_like(st, _INF)))


def mt_gather(tris, pid: torch.Tensor, org, dirn, t_min, t_max):
    """Möller-Trumbore against one gathered triangle per lane (pid in
    range): (t, u, v, valid) with the backface cull and normalized
    barycentrics. The winner's differentiable recompute: 1/det is taken of
    a det that is never 0, so a lane whose det is 0 gets a zero gradient,
    not 0 * inf; the values equal intersect_tris_all's bit for bit."""
    pid = pid.long()
    v0 = tris.v0[pid]
    e1 = tris.v1[pid] - v0
    e2 = tris.v2[pid] - v0
    tvec = org - v0
    p = math3.cross(dirn, e2)
    q = math3.cross(tvec, e1)
    det = math3.dot(p, e1)
    big = torch.abs(det) > math3.TINY
    inv_det = torch.where(big, 1.0 / torch.where(big, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    t = math3.dot(q, e2) * inv_det
    u = math3.dot(p, tvec)
    v = math3.dot(q, dirn)
    valid = det >= EPS
    valid &= (t >= t_min) & (t <= t_max)
    valid &= (u >= 0.0) & (u <= det)
    valid &= (v >= 0.0) & (u + v <= det)
    return t, u * inv_det, v * inv_det, valid


def no_tri_hit(r: int, dev):
    """The triangle side of a hit in a scene without triangles (JAX
    intersect.py:285-290): zero position and frame, front_face False, uv 0
    and the default material; hits then come from the spheres alone."""
    z3 = torch.zeros((r, 3), device=dev)
    one = Material.make(1)
    mat = Material(*[getattr(one, f.name).to(dev) for f in dataclasses.fields(Material)])
    return (z3, z3, z3, z3, torch.zeros((r,), dtype=torch.bool, device=dev),
            torch.zeros((r, 2), device=dev),
            mat.gather(torch.zeros((r,), dtype=torch.int32, device=dev)))


def finalize_hit(scene: Scene, org, dirn, t_min, t_max,
                 tri_hit, best_t, tri_idx, tri_u, tri_v) -> HitRecord:
    """Merge the triangle closest hit with the sphere scan and gather the
    shading attributes (CudaUtil.cuh:137-145)."""
    r = org.shape[0]
    dev = org.device
    best_t = torch.where(tri_hit, best_t, torch.full_like(best_t, _INF))
    sph_hit = torch.zeros((r,), dtype=torch.bool, device=dev)
    sph_idx = torch.zeros((r,), dtype=torch.int32, device=dev)
    sph_t = torch.full((r,), _INF, device=dev)
    if scene.num_spheres > 0:
        cur_max = torch.where(tri_hit, best_t, t_max)
        sph_t, sph_idx, sph_hit = _closest_sphere(scene, org, dirn, t_min, cur_max)

    use_sphere = sph_hit & (~tri_hit | (sph_t < best_t))
    hit = tri_hit | sph_hit
    t_final = torch.where(use_sphere, sph_t,
                          torch.where(tri_hit, best_t, torch.full_like(best_t, BIG_T)))
    zero = torch.zeros_like(best_t)

    if scene.num_tris > 0:
        safe_tri = torch.where(tri_hit, tri_idx, torch.zeros_like(tri_idx))
        tp, tn, tt, tb, tf, tuv = _gather_tri_hit(
            scene, org, dirn, torch.where(tri_hit, best_t, zero), tri_u, tri_v,
            safe_tri)
        tmat = scene.mat.gather(safe_tri)
    else:
        tp, tn, tt, tb, tf, tuv, tmat = no_tri_hit(r, dev)
    if scene.num_spheres == 0:
        return HitRecord(hit=hit, t=t_final, p=tp, normal=tn, tangent=tt,
                         bitangent=tb, front_face=tf, uv=tuv, prim_id=tri_idx,
                         is_sphere=use_sphere, mat=tmat)

    safe_sph = torch.where(sph_hit, sph_idx, torch.zeros_like(sph_idx))
    sp, sn, stt, sb, sf, suv = _gather_sphere_hit(
        scene, org, dirn, torch.where(sph_hit, sph_t, zero), safe_sph)
    smat = scene.spheres.mat.gather(safe_sph)
    sel = use_sphere

    def pick(a, b):
        return _where3(sel, a, b) if a.dim() == 2 else torch.where(sel, a, b)

    mat = Material(*[pick(getattr(smat, f.name), getattr(tmat, f.name))
                     for f in dataclasses.fields(Material)])
    return HitRecord(
        hit=hit, t=t_final, p=pick(sp, tp), normal=pick(sn, tn),
        tangent=pick(stt, tt), bitangent=pick(sb, tb), front_face=pick(sf, tf),
        uv=pick(suv, tuv), prim_id=torch.where(use_sphere, sph_idx, tri_idx),
        is_sphere=use_sphere, mat=mat)


def detached_rows(*xs: torch.Tensor):
    """The search's inputs: detached (the winner is a discrete choice) and
    contiguous (the kernels take dense rows; camera origins arrive
    broadcast)."""
    return tuple(x.detach().contiguous() for x in xs)


def finalize_hit_at(scene: Scene, org, dirn, t_min, t_max,
                    tri_hit, best_t, tri_idx, tri_u, tri_v) -> HitRecord:
    """finalize_hit after a detached search: (t, u, v) are recomputed
    differentiably at the chosen triangle with mt_gather (raycast_matmul,
    mt_matmul.py:184-204), so gradients flow through org and dirn as they do
    through raycast_brute's all-pairs test; the values are the search's."""
    if scene.num_tris > 0:
        t2, u2, v2, _ = mt_gather(scene.tris, tri_idx, org, dirn, t_min,
                                  torch.full_like(t_max, BIG_T))
        best_t = torch.where(tri_hit, t2, best_t)
        tri_u = torch.where(tri_hit, u2, tri_u)
        tri_v = torch.where(tri_hit, v2, tri_v)
    return finalize_hit(scene, org, dirn, t_min, t_max, tri_hit, best_t, tri_idx,
                        tri_u, tri_v)


def _closest_tri(scene: Scene, org, dirn, t_min, t_max):
    """(best_t, tri_idx, tri_hit, u, v) of the all-pairs search; a scene
    without triangles gives every ray a miss with idx 0 and (R, 1) zero
    barycentrics (JAX raycast_brute's initial values)."""
    tr = scene.tris
    if scene.num_tris == 0:
        r = org.shape[0]
        zero = torch.zeros((r, 1), device=org.device)
        return (torch.full((r,), _INF, device=org.device),
                torch.zeros((r,), dtype=torch.int32, device=org.device),
                torch.zeros((r,), dtype=torch.bool, device=org.device), zero, zero)
    t, valid, u, v = intersect_tris_all(tr.v0, tr.e1, tr.e2, org, dirn, t_min, t_max)
    best_t, tri_idx, tri_hit = closest_masked(
        torch.where(valid, t, torch.full_like(t, _INF)))
    return best_t, tri_idx, tri_hit, u, v


def raycast_brute(scene: Scene, org: torch.Tensor, dirn: torch.Tensor,
                  t_min=None, t_max=None) -> HitRecord:
    """Closest hit over the whole scene, brute force O(R*T) (RayCast,
    CudaUtil.cuh:93-148)."""
    r = org.shape[0]
    if t_min is None:
        t_min = torch.zeros((r,), device=org.device)
    if t_max is None:
        t_max = torch.full((r,), BIG_T, device=org.device)
    best_t, tri_idx, tri_hit, u, v = _closest_tri(scene, org, dirn, t_min, t_max)
    pick = tri_idx.long()[:, None]
    tri_u = torch.gather(u, 1, pick)[:, 0]
    tri_v = torch.gather(v, 1, pick)[:, 0]
    return finalize_hit(scene, org, dirn, t_min, t_max,
                        tri_hit, best_t, tri_idx, tri_u, tri_v)


def finalize_shadow(scene: Scene, org, dirn, t_min, t_max,
                    tri_hit, best_t, tri_idx):
    """(hit, prim_id, is_sphere) for NEE shadow rays: visibility only needs
    the identity of the winning primitive (see nee_contribution)."""
    best_t = torch.where(tri_hit, best_t, torch.full_like(best_t, _INF))
    use_sphere = torch.zeros_like(tri_hit)
    sph_idx = torch.zeros_like(tri_idx)
    if scene.num_spheres > 0:
        cur_max = torch.where(tri_hit, best_t, t_max)
        sph_t, sph_idx, sph_hit = _closest_sphere(scene, org, dirn, t_min, cur_max)
        use_sphere = sph_hit & (~tri_hit | (sph_t < best_t))
    hit = tri_hit | use_sphere
    return hit, torch.where(use_sphere, sph_idx, tri_idx), use_sphere


def shadow_brute(scene: Scene, org, dirn, t_min, t_max):
    """Brute-force shadow raycast -> (hit, prim_id, is_sphere)."""
    best_t, tri_idx, tri_hit, _, _ = _closest_tri(scene, org, dirn, t_min, t_max)
    return finalize_shadow(scene, org, dirn, t_min, t_max, tri_hit,
                           torch.where(tri_hit, best_t, torch.zeros_like(best_t)),
                           tri_idx)
