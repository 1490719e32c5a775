// Closest-hit raycast over KD cells for Hopper (sm_90a): one warp a ray.
//
// Replaces the Pallas pair kernel pathtrace_tpu/ops/pallas/pair_kernel.py::
// _pair_kernel (launched by pair_blocks_search from
// accel/binned.py::raycast_binned_pallas_v3), together with the v3 pair
// dispatch before it and the packed scatter-min after it. It computes what
// that chain computes: for each ray with its own [tmin, tmax], the closest
// triangle over the KD cells its segment crosses, with plain f32
// Möller-Trumbore (mt.cuh) and equal t resolved to the lowest original
// triangle id, brute's rule. So the kernel equals its plain version
// (ops/kd_raycast.py::kd_closest_plain) and raycast_brute, bit for bit.
//
// Design: the 32 lanes of a warp walk one ray (kd_walk.cuh, which the
// bounce kernel's KD variant shares). The block holds the cell table (bmin,
// bmax, first slot, slot count; 32 B a cell, about 5 KB for blob82k's 157
// cells) in shared memory, and each warp its list of crossed cells.
//
// What bounds it on this card: FP32 work and divergence, not device memory.
// A ray tests a few cells of up to 1024 members, about 44 flops a member;
// one thread a ray (the first port) left its lanes waiting on the longest
// ray of a warp, re-scanned every cell for each visit and kept 15.5 warps
// per SM busy. A warp shares one ray's work, so its lanes stay busy as long
// as its ray does. The rows stay in L2 (3.5 MB on blob82k).
// Measured and dropped (PERF.md, section 6): teams of 4, 8 and 16 lanes a
// ray (slower on every ray set); staging each cell's rows in shared memory
// for the (ray, cell) pairs grouped by cell, as the TPU kernel does (20-40%
// slower: more tests and a pair-grouping pass); rows of 48 B read as three
// 16-B loads; a cap of 40 registers (no faster).
//
// Not carried over (TPU workarounds): the slot budget and v3 dispatch, the
// overflow repair, the bf16 split products and accept band, the top-2
// recompute, the packed scatter-min key, the `lean` flag.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false, no
// fast math (ops/cuda/build.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "kd_walk.cuh"

namespace pt {

constexpr int KD_BLOCK = 256;     // threads of a block
constexpr int RAYS_A_BLOCK = KD_BLOCK / TEAM;

__device__ __forceinline__ Ray load_ray(int r, const float* org, const float* dir,
                                        const float* tmin, const float* tmax) {
  Ray ray;
  ray.o = {org[3 * r], org[3 * r + 1], org[3 * r + 2]};
  ray.d = {dir[3 * r], dir[3 * r + 1], dir[3 * r + 2]};
  ray.inv = {safe_inv(ray.d.x), safe_inv(ray.d.y), safe_inv(ray.d.z)};
  ray.lo = tmin[r];
  ray.hi = tmax[r];
  return ray;
}

__device__ __forceinline__ void write_result(int r, const Best& b, uint8_t* hit_out, float* t_out,
                                             float* u_out, float* v_out, int* id_out) {
  const bool hit = b.id != INT_MAX;
  hit_out[r] = hit ? 1 : 0;
  t_out[r] = hit ? b.t : 0.0f;
  u_out[r] = b.u;
  v_out[r] = b.v;
  id_out[r] = hit ? b.id : 0;
}

struct KdArgs {
  int num_rays, num_cells, closest;
  const float *bmin, *bmax;
  const int *start, *count;
  const float* members;
  const int* ids;
  const float *org, *dir, *tmin, *tmax;
  uint8_t* hit;
  float *t, *u, *v;
  int* id;
};

__global__ void __launch_bounds__(KD_BLOCK) kd_walk_kernel(KdArgs a) {
  extern __shared__ float smem[];
  load_cells(smem, a.num_cells, a.bmin, a.bmax, a.start, a.count);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * RAYS_A_BLOCK + warp;
  if (r >= a.num_rays) return;  // the whole warp
  float2* list = (float2*)(smem + a.num_cells * CELL_FLOATS) + warp * LIST_CAP;
  const Ray ray = load_ray(r, a.org, a.dir, a.tmin, a.tmax);
  Best b = {INFINITY, 0.0f, 0.0f, INT_MAX};
  walk(lane, smem, a.num_cells, list, ray, a.members, a.ids, a.closest, b);
  if (lane == 0) write_result(r, b, a.hit, a.t, a.u, a.v, a.id);
}

// ---- launch ---------------------------------------------------------------

__host__ inline int walk_smem(int num_cells) {
  return (int)(sizeof(float) * CELL_FLOATS * num_cells + sizeof(float2) * LIST_CAP * RAYS_A_BLOCK);
}

constexpr int MAX_DEVICES = 64;

// The kernel's dynamic shared-memory limit, lifted to the card's maximum
// once per device.
__host__ cudaError_t allow_smem(int dev) {
  static bool done[MAX_DEVICES];
  if (done[dev]) return cudaSuccess;
  int opt = 0;
  cudaError_t err = cudaDeviceGetAttribute(&opt, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kd_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, opt);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

}  // namespace pt

// Launch on `stream`. Returns the first CUDA error (0 = launched).
extern "C" int pt_kd_raycast(int num_rays, int num_cells, int closest, const float* bmin,
                             const float* bmax, const int* start, const int* count,
                             const float* members, const int* ids, const float* org,
                             const float* dir, const float* tmin, const float* tmax,
                             uint8_t* hit, float* t, float* u, float* v, int* id, void* stream) {
  if (num_rays == 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= pt::MAX_DEVICES) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess) err = pt::allow_smem(dev);
  if (err != cudaSuccess) return (int)err;
  const pt::KdArgs a = {num_rays, num_cells, closest, bmin, bmax, start, count, members, ids,
                        org, dir, tmin, tmax, hit, t, u, v, id};
  const int grid = (num_rays + pt::RAYS_A_BLOCK - 1) / pt::RAYS_A_BLOCK;
  pt::kd_walk_kernel<<<grid, pt::KD_BLOCK, pt::walk_smem(num_cells), (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Member row width, shared-memory bytes per cell, crossed cells a warp
// lists and threads a ray, so the wrapper can check its packing against
// this library. Returns the threads of a block.
extern "C" int pt_kd_layout(int* out4) {
  out4[0] = pt::MEMBER_STRIDE;
  out4[1] = (int)(sizeof(float) * pt::CELL_FLOATS);
  out4[2] = pt::LIST_CAP;
  out4[3] = pt::TEAM;
  return pt::KD_BLOCK;
}

// The kernel at `num_cells` cells: out4 = {registers a thread, local-memory
// bytes a thread (stack frame and spills), resident blocks per SM, threads a
// block}. Returns the first CUDA error (0 = none).
extern "C" int pt_kd_occupancy(int num_cells, int* out4) {
  cudaFuncAttributes attr = {};
  int dev = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= pt::MAX_DEVICES) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess) err = pt::allow_smem(dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, pt::kd_walk_kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pt::kd_walk_kernel, pt::KD_BLOCK,
                                                        pt::walk_smem(num_cells));
  out4[0] = attr.numRegs;
  out4[1] = (int)attr.localSizeBytes;
  out4[2] = blocks;
  out4[3] = pt::KD_BLOCK;
  return (int)err;
}
