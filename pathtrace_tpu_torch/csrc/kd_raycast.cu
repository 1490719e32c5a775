// Closest-hit raycast over KD cells for Hopper (sm_90a): one thread per ray.
//
// Replaces the Pallas pair kernel pathtrace_tpu/ops/pallas/pair_kernel.py::
// _pair_kernel (launched by pair_blocks_search from
// accel/binned.py::raycast_binned_pallas_v3), together with the v3 pair
// dispatch before it and the packed scatter-min after it. It computes what
// that chain computes: for each ray with its own [tmin, tmax], the closest
// triangle over the KD cells its segment crosses, with plain f32
// Möller-Trumbore (mt.cuh) and equal t resolved to the lowest original
// triangle id, brute's rule. So the kernel equals its plain version
// (ops/kd_raycast.py::kd_closest_plain) and raycast_brute.
//
// Design: the cell table (bmin, bmax, first slot, slot count; 32 B a cell,
// about 5 KB for blob82k's 157 cells) sits in shared memory. Each thread
// slab-tests the cells (safe 1/dir, far bound widened by 1.00000024, as
// accel/binned.py::slab_all) and visits the crossed ones in ascending
// (tnear, cell) order, found by re-scanning the table; it stops when the
// next cell's tnear exceeds the best t (times the same widening, so a hit
// on a cell face is never skipped). A later cell can only hold an equal or
// farther hit, and the strict test still visits same-box chunked cells whose
// tnear equals the best t. The member table [v0 | e1 | e2] (36 B a slot,
// 3.5 MB on blob82k) and the ids are read from device memory and stay
// resident in the 50 MB L2.
//
// What bounds it on this card: FP32 ALU work and divergence, not bytes.
// A ray tests a few cells of up to 1024 members (blob82k: ~611 on average),
// about 35 flops each; the rays of a warp walk different cells at different
// depths. Nothing here addresses that yet (warp-per-ray or cell-sorted
// rays, cp.async/TMA staging of member tiles and FMA contraction are later
// work).
//
// Not carried over (TPU workarounds; the per-ray walk has no capacity to
// overflow): the slot budget and v3 dispatch, the overflow repair, the bf16
// split products and accept band, the top-2 recompute, the packed
// scatter-min key, the `lean` flag.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false, no
// fast math (ops/cuda/build.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "mt.cuh"

namespace pt {

constexpr int KD_BLOCK = 128;
constexpr int MEMBER_STRIDE = 9;  // v0 e1 e2
constexpr int CELL_FLOATS = 8;    // bmin bmax start count
constexpr float SLAB_WIDEN = 1.00000024f;

// accel/binned.py::safe_inv_dir for one component.
__device__ __forceinline__ float safe_inv(float d) {
  return fabsf(d) > 1e-12f ? 1.0f / d : (d >= 0.0f ? 1e30f : -1e30f);
}

// accel/binned.py::slab_all for one (ray, cell): crossing flag and tnear.
__device__ __forceinline__ bool slab(const float* bmin, const float* bmax, V3 org, V3 inv,
                                     float tmin, float tmax, float* tnear) {
  float t0x = (bmin[0] - org.x) * inv.x, t1x = (bmax[0] - org.x) * inv.x;
  float t0y = (bmin[1] - org.y) * inv.y, t1y = (bmax[1] - org.y) * inv.y;
  float t0z = (bmin[2] - org.z) * inv.z, t1z = (bmax[2] - org.z) * inv.z;
  float tlo = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  float thi = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  float tn = fmaxf(tlo, tmin);
  float tf = fminf(thi, tmax) * SLAB_WIDEN;
  *tnear = tn;
  return tn <= tf;
}

__global__ void __launch_bounds__(KD_BLOCK)
    kd_raycast_kernel(int num_rays, int num_cells, int closest, const float* __restrict__ bmin,
                      const float* __restrict__ bmax, const int* __restrict__ start,
                      const int* __restrict__ count, const float* __restrict__ members,
                      const int* __restrict__ ids, const float* __restrict__ org,
                      const float* __restrict__ dir, const float* __restrict__ tmin,
                      const float* __restrict__ tmax, uint8_t* __restrict__ hit_out,
                      float* __restrict__ t_out, float* __restrict__ u_out,
                      float* __restrict__ v_out, int* __restrict__ id_out) {
  extern __shared__ float smem[];  // per cell: bmin[3] bmax[3] start count
  for (int j = threadIdx.x; j < num_cells; j += blockDim.x) {
    float* c = smem + j * CELL_FLOATS;
    c[0] = bmin[3 * j], c[1] = bmin[3 * j + 1], c[2] = bmin[3 * j + 2];
    c[3] = bmax[3 * j], c[4] = bmax[3 * j + 1], c[5] = bmax[3 * j + 2];
    c[6] = __int_as_float(start[j]);
    c[7] = __int_as_float(count[j]);
  }
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= num_rays) return;
  const V3 o = {org[3 * r], org[3 * r + 1], org[3 * r + 2]};
  const V3 d = {dir[3 * r], dir[3 * r + 1], dir[3 * r + 2]};
  const V3 inv = {safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
  const float t_lo = tmin[r], t_hi = tmax[r];

  float best_t = INFINITY, best_u = 0.0f, best_v = 0.0f;
  int best_id = INT_MAX;
  float last_tn = -INFINITY;
  int last_c = -1;
  for (;;) {
    // next crossed cell in ascending (tnear, cell) order
    float next_tn = INFINITY;
    int next_c = -1;
    for (int c = 0; c < num_cells; ++c) {
      const float* cell = smem + c * CELL_FLOATS;
      float tn;
      if (!slab(cell, cell + 3, o, inv, t_lo, t_hi, &tn)) continue;
      bool after = tn > last_tn || (tn == last_tn && c > last_c);
      if (after && tn < next_tn) {
        next_tn = tn;
        next_c = c;
      }
    }
    if (next_c < 0 || next_tn > fmaxf(best_t, best_t * SLAB_WIDEN)) break;
    const float* cell = smem + next_c * CELL_FLOATS;
    const int s = __float_as_int(cell[6]), n = __float_as_int(cell[7]);
    for (int j = s; j < s + n; ++j) {
      const float* m = members + (long long)j * MEMBER_STRIDE;
      MtHit h = mt_intersect(o, d, {m[0], m[1], m[2]}, {m[3], m[4], m[5]}, {m[6], m[7], m[8]},
                             t_lo, t_hi);
      if (!h.valid) continue;
      const int id = ids[j];
      if (h.t < best_t || (h.t == best_t && id < best_id)) {
        best_t = h.t;
        best_id = id;
        if (closest) {
          best_u = h.u * h.inv_det;
          best_v = h.v * h.inv_det;
        }
      }
    }
    last_tn = next_tn;
    last_c = next_c;
  }
  const bool hit = best_id != INT_MAX;
  hit_out[r] = hit ? 1 : 0;
  t_out[r] = hit ? best_t : 0.0f;
  u_out[r] = best_u;
  v_out[r] = best_v;
  id_out[r] = hit ? best_id : 0;
}

}  // namespace pt

// Launch on `stream`; returns cudaGetLastError() (0 = launched). The
// dynamic shared memory holds the cell table.
extern "C" int pt_kd_raycast(int num_rays, int num_cells, int closest, const float* bmin,
                             const float* bmax, const int* start, const int* count,
                             const float* members, const int* ids, const float* org,
                             const float* dir, const float* tmin, const float* tmax,
                             uint8_t* hit, float* t, float* u, float* v, int* id, void* stream) {
  if (num_rays == 0) return 0;
  const int smem = (int)(sizeof(float) * pt::CELL_FLOATS * (size_t)num_cells);
  cudaError_t err = cudaFuncSetAttribute(pt::kd_raycast_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (num_rays + pt::KD_BLOCK - 1) / pt::KD_BLOCK;
  pt::kd_raycast_kernel<<<grid, pt::KD_BLOCK, smem, (cudaStream_t)stream>>>(
      num_rays, num_cells, closest, bmin, bmax, start, count, members, ids, org, dir, tmin, tmax,
      hit, t, u, v, id);
  return (int)cudaGetLastError();
}

// Member row width and shared-memory bytes per cell, so the wrapper can
// check its packing against this library.
extern "C" int pt_kd_layout(int* out2) {
  out2[0] = pt::MEMBER_STRIDE;
  out2[1] = (int)(sizeof(float) * pt::CELL_FLOATS);
  return pt::KD_BLOCK;
}
