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

}  // namespace pt
