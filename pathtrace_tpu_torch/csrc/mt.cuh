// Möller-Trumbore ray-triangle test as a __device__ function, shared by the
// bounce kernel's brute search and the KD raycast (and meant for the port
// of the all-pairs kernel, pathtrace_tpu/ops/pallas/intersect_kernel.py).
//
// The arithmetic is ops/intersect.py::intersect_tris_all (and mt_gather)
// operation by operation and in the same association, so that with
// -fmad=false the kernel and the eager PyTorch version round alike:
// backface cull det >= EPS, 0 <= u <= det, v >= 0, u + v <= det,
// t = dot(q, e2) * inv_det with inv_det = 1/det where |det| > TINY (else 0),
// t in [tmin, tmax]. u and v come back raw (before * inv_det).
#pragma once

#include "bsdf.cuh"

namespace pt {

struct MtHit {
  float t, u, v, inv_det;
  bool valid;
};

__device__ __forceinline__ MtHit mt_intersect(V3 org, V3 dir, V3 v0, V3 e1, V3 e2, float tmin,
                                              float tmax) {
  V3 tvec = org - v0;
  V3 p = cross(dir, e2);
  V3 q = cross(tvec, e1);
  float det = dot(p, e1);
  float inv_det = fabsf(det) > TINY ? 1.0f / det : 0.0f;
  float t = dot(q, e2) * inv_det;
  float u = dot(p, tvec);
  float v = dot(q, dir);
  bool valid = det >= EPS && t >= tmin && t <= tmax && u >= 0.0f && u <= det && v >= 0.0f &&
               u + v <= det;
  return {t, u, v, inv_det, valid};
}

// mt_intersect in two parts, for scans that keep a running closest t.
// mt_inside runs stages 1-3 (p and det; tvec and u; q and v) with no
// division and no branch and says whether the pair passes the backface cull
// det >= EPS and the barycentric tests 0 <= u <= det, v >= 0, u + v <= det;
// mt_hit runs stage 4, 1/det and t, for a pair that passed. A scan runs
// mt_inside for every pair, whose tests then overlap from one triangle to
// the next, and mt_hit for the few that pass. Every value is
// mt_intersect's operation in its association, and det >= EPS > TINY is
// mt_intersect's 1/det branch, so a pair that passes has the same bits.
// `g` is a table row [v0 e1 e2].
static_assert(EPS > TINY, "mt_hit takes 1/det for every det >= EPS");

__device__ __forceinline__ bool mt_inside(V3 org, V3 dir, const float* g) {
  V3 e1 = {g[3], g[4], g[5]}, e2 = {g[6], g[7], g[8]};
  V3 tvec = org - V3{g[0], g[1], g[2]};
  V3 p = cross(dir, e2);
  V3 q = cross(tvec, e1);
  float det = dot(p, e1);
  float u = dot(p, tvec);
  float v = dot(q, dir);
  return (det >= EPS) & (u >= 0.0f) & (u <= det) & (v >= 0.0f) & (u + v <= det);  // no branch
}

// Stage 4 of a pair that passed mt_inside: true, with *out set, iff
// tmin <= t <= tmax and t < t_best.
__device__ __forceinline__ bool mt_hit(V3 org, V3 dir, const float* g, float tmin, float tmax,
                                       float t_best, MtHit* out) {
  V3 e1 = {g[3], g[4], g[5]}, e2 = {g[6], g[7], g[8]};
  V3 tvec = org - V3{g[0], g[1], g[2]};
  V3 p = cross(dir, e2);
  V3 q = cross(tvec, e1);
  float det = dot(p, e1);
  float inv_det = 1.0f / det;
  float t = dot(q, e2) * inv_det;
  if (!(t >= tmin && t <= tmax && t < t_best)) return false;
  *out = {t, dot(p, tvec), dot(q, dir), inv_det, true};
  return true;
}

// mt_hit with t <= t_best in place of t < t_best, for scans whose equal t
// goes to the lower id though the rows are not in id order (the KD
// raycast's cells): the caller breaks the tie. The same operations as
// mt_hit, so the same bits.
__device__ __forceinline__ bool mt_hit_upto(V3 org, V3 dir, const float* g, float tmin,
                                            float tmax, float t_best, MtHit* out) {
  V3 e1 = {g[3], g[4], g[5]}, e2 = {g[6], g[7], g[8]};
  V3 tvec = org - V3{g[0], g[1], g[2]};
  V3 p = cross(dir, e2);
  V3 q = cross(tvec, e1);
  float det = dot(p, e1);
  float inv_det = 1.0f / det;
  float t = dot(q, e2) * inv_det;
  if (!(t >= tmin && t <= tmax && t <= t_best)) return false;
  *out = {t, dot(p, tvec), dot(q, dir), inv_det, true};
  return true;
}

}  // namespace pt
