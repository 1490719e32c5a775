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
// agree bit for bit. A miss gives t = 0, u = v = 0 and idx = max(T - 1, 0)
// (closest_masked's clamp; 0 for an empty table, where every ray misses);
// shadow mode leaves u = v = 0.
//
// What bounds it on this card: instruction issue. Every (ray, triangle)
// pair runs stages 1-3 of the test (mt_inside: 37 FP32 operations and 5
// compares, no FMA under -fmad=false); the rays' bytes (49 B a ray) would
// take a fifth of the time. The design:
// - Stage 4 (an IEEE division for 1/det, then t) is deferred: stages 1-3
//   run over CHUNK rows into a bit mask, then stage 4 runs on the mask's
//   bits in ascending id order, which keeps the strict-< tie rule. A lane
//   passes stages 1-3 on about 2 rows of the train step's 38, but after the
//   first bounce a warp's 32 lanes pass on about 16 different rows, so a
//   test that divided where it passed made the whole warp divide 16 times;
//   with the mask the warp divides as often as its busiest lane.
// - The block stages the table in shared memory in tiles of MT_TILE rows,
//   each padded to ROW = 12 floats and read as three 16-B loads that every
//   lane of the warp shares (a broadcast), so the triangle count is
//   unbounded (sphere_mesh_scene(4)'s 5,134 rows take six tiles) and a
//   38-row table costs a block 1.8 KB of shared memory.
// - A whole chunk's stages 1-3 are unrolled (8% faster on the train sweep
//   than a loop).
// Measured and dropped (PERF.md, section 6): the table in __constant__ memory
// (2.4-8.9x slower on the train sweep); 2 or 4 rays a thread (2: 4% faster
// on the 1M-ray sweep, 6-8% slower on 65,536 rays; 4: slower on both);
// blocks of 256; warp-uniform exits after stages 1 and 2 (13-21% faster on
// coherent camera rays, 13% slower on bounce rays, equal on the sweep,
// where some lane of a warp passes stage 1 on every row).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false, no
// fast math (ops/cuda/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt.cuh"

namespace pt {

constexpr int MT_BLOCK = 128;
constexpr int MT_TILE = 1024;   // rows per shared-memory tile (48 KB)
constexpr int TRI_STRIDE = 9;   // v0 e1 e2, a row of the table
constexpr int ROW = 12;         // a row in shared memory: three float4
constexpr int CHUNK = 32;       // rows of one bit mask

__device__ __forceinline__ void load_row(const float* tile, int k, float g[9]) {
  const float4* r = reinterpret_cast<const float4*>(tile + k * ROW);
  const float4 a = r[0], b = r[1], c = r[2];
  g[0] = a.x, g[1] = a.y, g[2] = a.z, g[3] = a.w, g[4] = b.x, g[5] = b.y, g[6] = b.z;
  g[7] = b.w, g[8] = c.x;
}

template <bool kClosest>
__global__ void __launch_bounds__(MT_BLOCK)
    mt_closest_kernel(int num_rays, int num_tris, const float* __restrict__ tris,
                      const float* __restrict__ org, const float* __restrict__ dir,
                      const float* __restrict__ tmin, const float* __restrict__ tmax,
                      uint8_t* __restrict__ hit_out, float* __restrict__ t_out,
                      int* __restrict__ idx_out, float* __restrict__ u_out,
                      float* __restrict__ v_out) {
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);
  const int r = blockIdx.x * MT_BLOCK + threadIdx.x;
  const bool active = r < num_rays;
  // a thread past the last ray keeps a zero direction: det = 0 fails stage 1
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
    for (int j = threadIdx.x; j < n * TRI_STRIDE; j += MT_BLOCK)
      tile[j / TRI_STRIDE * ROW + j % TRI_STRIDE] = src[j];
    __syncthreads();
    for (int k0 = 0; k0 < n; k0 += CHUNK) {
      const int m = min(CHUNK, n - k0);
      auto inside = [&](int k) {  // bit k: row k0 + k passes stages 1-3
        float g[9];
        load_row(tile, k0 + k, g);
        return (unsigned)mt_inside(o, d, g) << k;
      };
      unsigned mask = 0u;
      if (m == CHUNK) {  // unrolled: immediate shifts and offsets, no loop counter
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) mask |= inside(k);
      } else {
        for (int k = 0; k < m; ++k) mask |= inside(k);
      }
      while (mask) {  // stage 4 in ascending id order
        const int k = k0 + __ffs(mask) - 1;
        mask &= mask - 1u;
        float g[9];
        load_row(tile, k, g);
        MtHit h;
        if (mt_hit(o, d, g, t_lo, t_hi, best_t, &h)) {
          best_t = h.t;
          best = base + k;
          if (kClosest) {
            best_u = h.u * h.inv_det;
            best_v = h.v * h.inv_det;
          }
        }
      }
    }
  }
  if (!active) return;
  const bool hit = best >= 0;
  hit_out[r] = hit ? 1 : 0;
  t_out[r] = hit ? best_t : 0.0f;
  idx_out[r] = hit ? best : max(num_tris - 1, 0);
  u_out[r] = best_u;
  v_out[r] = best_v;
}

inline size_t smem_bytes(int num_tris) {
  return sizeof(float) * ROW * (size_t)(num_tris < MT_TILE ? num_tris : MT_TILE);
}

}  // namespace pt

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int pt_mt_closest(int num_rays, int num_tris, int closest, const float* tris,
                             const float* org, const float* dir, const float* tmin,
                             const float* tmax, uint8_t* hit, float* t, int* idx, float* u,
                             float* v, void* stream) {
  if (num_rays == 0) return 0;
  const int grid = (num_rays + pt::MT_BLOCK - 1) / pt::MT_BLOCK;
  const size_t smem = pt::smem_bytes(num_tris);
  cudaStream_t s = (cudaStream_t)stream;
  if (closest)
    pt::mt_closest_kernel<true><<<grid, pt::MT_BLOCK, smem, s>>>(
        num_rays, num_tris, tris, org, dir, tmin, tmax, hit, t, idx, u, v);
  else
    pt::mt_closest_kernel<false><<<grid, pt::MT_BLOCK, smem, s>>>(
        num_rays, num_tris, tris, org, dir, tmin, tmax, hit, t, idx, u, v);
  return (int)cudaGetLastError();
}

// The closest-mode kernel as built and as the card holds it for a table of
// num_tris rows: out4 = {registers a thread, local memory bytes a thread
// (stack frame and spills), resident blocks per SM, threads a block}.
// Returns the first CUDA error (0 = none).
extern "C" int pt_mt_occupancy(int num_tris, int* out4) {
  const void* fn = (const void*)pt::mt_closest_kernel<true>;
  cudaFuncAttributes attr = {};
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, pt::MT_BLOCK,
                                                        pt::smem_bytes(num_tris));
  out4[0] = attr.numRegs;
  out4[1] = (int)attr.localSizeBytes;
  out4[2] = blocks;
  out4[3] = pt::MT_BLOCK;
  return (int)err;
}

// Triangle row width and tile size, so the wrapper can check its packing
// against this library.
extern "C" int pt_mt_layout(int* out2) {
  out2[0] = pt::TRI_STRIDE;
  out2[1] = pt::MT_TILE;
  return pt::MT_BLOCK;
}
