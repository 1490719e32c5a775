// Closest-hit Möller-Trumbore of every ray against every triangle, for
// Hopper (sm_90a): one thread per ray.
//
// Replaces the Pallas kernel pathtrace_tpu/ops/pallas/intersect_kernel.py::
// _kernel (launched by mt_closest_pallas, used by raycast_pallas), and the
// contract of ops/mt_matmul.py::raycast_matmul / shadow_matmul around it:
// for each ray with its own [tmin, tmax], the closest valid triangle of the
// whole table, (hit, t, idx, u, v). The TPU kernel fits 16 ray features to
// per-triangle coefficients and runs four MXU products per (ray block,
// triangle block) with a running argmin carried across the grid; here each
// thread runs plain f32 Möller-Trumbore (mt.cuh, ops/intersect.py's
// arithmetic) over the triangles in ascending id order and keeps the first
// strictly smaller t, brute's tie rule (closest_masked). So the kernel, its
// plain version (ops/mt_closest.py::mt_closest_plain) and raycast_brute
// agree bit for bit.
//
// Design: the block stages the triangle table [v0 e1 e2] (36 B a triangle)
// in shared memory in tiles of MT_TILE triangles, so the triangle count is
// unbounded (a 1,294-triangle icosphere takes two tiles; the Cornell room's
// 38 one). Every thread of the block takes part in the tile loads, also the
// threads past the last ray. A miss gives t = 0, u = v = 0 and idx = T - 1
// (closest_masked's clamp); shadow mode leaves u = v = 0 and skips their
// update.
//
// What bounds it on this card: FP32 work, about 43 flops per (ray,
// triangle) test, not bytes (each ray reads 32 B and writes 17 B; the table
// is read once per block from L2). Nothing here addresses that yet: no
// early-out structure (that is the KD and BVH paths' job), no FMA
// contraction (-fmad=false keeps the rounding of the plain version), no
// cp.async/TMA double buffering of the tiles.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false, no
// fast math (ops/cuda/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt.cuh"

namespace pt {

constexpr int MT_BLOCK = 128;
constexpr int MT_TILE = 1024;      // triangles per shared-memory tile (36 KB)
constexpr int TRI_STRIDE = 9;      // v0 e1 e2

__global__ void __launch_bounds__(MT_BLOCK)
    mt_closest_kernel(int num_rays, int num_tris, int closest, const float* __restrict__ tris,
                      const float* __restrict__ org, const float* __restrict__ dir,
                      const float* __restrict__ tmin, const float* __restrict__ tmax,
                      uint8_t* __restrict__ hit_out, float* __restrict__ t_out,
                      int* __restrict__ idx_out, float* __restrict__ u_out,
                      float* __restrict__ v_out) {
  __shared__ float tile[MT_TILE * TRI_STRIDE];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = r < num_rays;
  V3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 0.0f};
  float t_lo = 0.0f, t_hi = 0.0f;
  if (active) {
    o = {org[3 * r], org[3 * r + 1], org[3 * r + 2]};
    d = {dir[3 * r], dir[3 * r + 1], dir[3 * r + 2]};
    t_lo = tmin[r];
    t_hi = tmax[r];
  }

  float best_t = INFINITY, best_u = 0.0f, best_v = 0.0f;
  int best = -1;
  for (int base = 0; base < num_tris; base += MT_TILE) {
    const int n = min(MT_TILE, num_tris - base);
    __syncthreads();  // the previous tile is no longer read
    const float* src = tris + (long long)base * TRI_STRIDE;
    for (int j = threadIdx.x; j < n * TRI_STRIDE; j += blockDim.x) tile[j] = src[j];
    __syncthreads();
    if (!active) continue;
    for (int k = 0; k < n; ++k) {
      const float* m = tile + k * TRI_STRIDE;
      MtHit h = mt_intersect(o, d, {m[0], m[1], m[2]}, {m[3], m[4], m[5]}, {m[6], m[7], m[8]},
                             t_lo, t_hi);
      if (h.valid && h.t < best_t) {
        best_t = h.t;
        best = base + k;
        if (closest) {
          best_u = h.u * h.inv_det;
          best_v = h.v * h.inv_det;
        }
      }
    }
  }
  if (!active) return;
  const bool hit = best >= 0;
  hit_out[r] = hit ? 1 : 0;
  t_out[r] = hit ? best_t : 0.0f;
  idx_out[r] = hit ? best : num_tris - 1;
  u_out[r] = best_u;
  v_out[r] = best_v;
}

}  // namespace pt

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int pt_mt_closest(int num_rays, int num_tris, int closest, const float* tris,
                             const float* org, const float* dir, const float* tmin,
                             const float* tmax, uint8_t* hit, float* t, int* idx, float* u,
                             float* v, void* stream) {
  if (num_rays == 0) return 0;
  const int grid = (num_rays + pt::MT_BLOCK - 1) / pt::MT_BLOCK;
  pt::mt_closest_kernel<<<grid, pt::MT_BLOCK, 0, (cudaStream_t)stream>>>(
      num_rays, num_tris, closest, tris, org, dir, tmin, tmax, hit, t, idx, u, v);
  return (int)cudaGetLastError();
}

// Triangle row width and tile size, so the wrapper can check its packing
// against this library.
extern "C" int pt_mt_layout(int* out2) {
  out2[0] = pt::TRI_STRIDE;
  out2[1] = pt::MT_TILE;
  return pt::MT_BLOCK;
}
