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
// Design: the 32 lanes of a warp walk one ray. The block holds the cell
// table (bmin, bmax, first slot, slot count; 32 B a cell, about 5 KB for
// blob82k's 157 cells) in shared memory. The warp slab-tests the cells once,
// split over its lanes (safe 1/dir, far bound widened by 1.00000024, as
// accel/binned.py::slab_all), into a list of its crossed cells in shared
// memory, and visits them in ascending (tnear, cell) order, each next cell a
// warp-wide min over the list by shuffles. It splits a cell's members over
// its lanes (consecutive slots on consecutive lanes, so the warp's loads of a
// row block are contiguous), runs mt_inside on each and stage 4
// (mt_hit_upto) only on those that pass, reduces (t, id) by shuffles and
// stops when the next cell's tnear exceeds the best t times the same
// widening: a later cell can only hold an equal or farther hit, and the
// strict test still visits same-box chunked cells whose tnear equals the
// best t. A ray that crosses more than LIST_CAP cells keeps the least cell
// beyond its list aside and lists again after it has visited that cell.
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

#include "mt.cuh"

namespace pt {

constexpr int KD_BLOCK = 256;     // threads of a block
constexpr int TEAM = 32;          // threads a ray: one warp
static_assert(TEAM == 32, "the walk's shuffles and ballots span a whole warp");
constexpr int RAYS_A_BLOCK = KD_BLOCK / TEAM;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MEMBER_STRIDE = 9;  // v0 e1 e2
constexpr int CELL_FLOATS = 8;    // bmin bmax start count
constexpr int LIST_CAP = 32;      // crossed cells a warp lists in shared memory
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

// The exit rule: a cell whose tnear lies beyond this holds no hit nearer
// than best_t.
__device__ __forceinline__ float reach(float best_t) { return fmaxf(best_t, best_t * SLAB_WIDEN); }

// (tn, c) before (tn2, c2) in the visiting order.
__device__ __forceinline__ bool before(float tn, int c, float tn2, int c2) {
  return tn < tn2 || (tn == tn2 && c < c2);
}

struct Ray {
  V3 o, d, inv;
  float lo, hi;
};

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

struct Best {
  float t, u, v;
  int id;  // INT_MAX: no hit
};

// Lexicographic min of (tn, c) over the warp, in every lane.
__device__ __forceinline__ void warp_min_cell(float& tn, int& c) {
#pragma unroll
  for (int off = TEAM / 2; off > 0; off >>= 1) {
    const float otn = __shfl_xor_sync(FULL, tn, off);
    const int oc = __shfl_xor_sync(FULL, c, off);
    if (before(otn, oc, tn, c)) tn = otn, c = oc;
  }
}

// The least (t, id) over the warp with its u, v, in every lane.
__device__ __forceinline__ void warp_min_best(Best& b) {
#pragma unroll
  for (int off = TEAM / 2; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(FULL, b.t, off);
    const int oid = __shfl_xor_sync(FULL, b.id, off);
    const float ou = __shfl_xor_sync(FULL, b.u, off);
    const float ov = __shfl_xor_sync(FULL, b.v, off);
    if (ot < b.t || (ot == b.t && oid < b.id)) b = {ot, ou, ov, oid};
  }
}

// The test of one member row g (slot j) against the running best of this
// thread: mt_inside for every row, stage 4 only for those that pass.
__device__ __forceinline__ bool test_row(const Ray& ray, const float* g, int j, const int* ids,
                                         bool closest, Best& b) {
  if (!mt_inside(ray.o, ray.d, g)) return false;
  MtHit h;
  if (!mt_hit_upto(ray.o, ray.d, g, ray.lo, ray.hi, b.t, &h)) return false;
  const int id = ids[j];
  if (!(h.t < b.t || id < b.id)) return false;  // h.t <= b.t: the tie goes to the lower id
  b.t = h.t;
  b.id = id;
  if (closest) {
    b.u = h.u * h.inv_det;
    b.v = h.v * h.inv_det;
  }
  return true;
}

// The crossed cells after the cursor (ctn, cc), in the warp's list: returns
// how many it holds (<= LIST_CAP) and sets (dtn, dc) to the least one that
// did not fit ((INFINITY, INT_MAX) if all did).
__device__ __forceinline__ int build_list(int lane, const float* cells, int num_cells,
                                          const Ray& ray, float ctn, int cc, float2* list,
                                          float& dtn, int& dc) {
  int n = 0;
  dtn = INFINITY, dc = INT_MAX;
  __syncwarp();  // the list is no longer read
  for (int base = 0; base < num_cells; base += TEAM) {
    const int c = base + lane;
    float tn = 0.0f;
    bool x = false;
    if (c < num_cells) {
      const float* cell = cells + c * CELL_FLOATS;
      x = slab(cell, cell + 3, ray.o, ray.inv, ray.lo, ray.hi, &tn) && before(ctn, cc, tn, c);
    }
    const unsigned bits = __ballot_sync(FULL, x);
    const int pos = n + __popc(bits & ((1u << lane) - 1u));
    if (x) {
      if (pos < LIST_CAP)
        list[pos] = make_float2(tn, __int_as_float(c));
      else if (before(tn, c, dtn, dc))
        dtn = tn, dc = c;
    }
    n += __popc(bits);
  }
  warp_min_cell(dtn, dc);
  __syncwarp();  // the list is written
  return min(n, LIST_CAP);
}

// Walks the ray's crossed cells in ascending (tnear, cell) order under the
// exit rule into b (the same in every lane of the warp).
__device__ __forceinline__ void walk(int lane, const float* cells, int num_cells, float2* list,
                                     const Ray& ray, const float* members, const int* ids,
                                     bool closest, Best& b) {
  float ctn = -INFINITY, dtn;  // the cursor: the last cell visited
  int cc = -1, dc;
  int n = build_list(lane, cells, num_cells, ray, ctn, cc, list, dtn, dc);
  for (;;) {
    float ntn = INFINITY;
    int nc = INT_MAX;
    for (int j = lane; j < n; j += TEAM) {
      const float2 e = list[j];
      const int c = __float_as_int(e.y);
      if (before(ctn, cc, e.x, c) && before(e.x, c, ntn, nc)) ntn = e.x, nc = c;
    }
    warp_min_cell(ntn, nc);
    const bool set_aside = before(dtn, dc, ntn, nc);
    if (set_aside) ntn = dtn, nc = dc;
    if (nc == INT_MAX || ntn > reach(b.t)) break;
    const float* cell = cells + nc * CELL_FLOATS;
    const int s = __float_as_int(cell[6]), cnt = __float_as_int(cell[7]);
    for (int j = s + lane; j < s + cnt; j += TEAM)
      test_row(ray, members + (long long)j * MEMBER_STRIDE, j, ids, closest, b);
    warp_min_best(b);
    ctn = ntn, cc = nc;
    if (set_aside) n = build_list(lane, cells, num_cells, ray, ctn, cc, list, dtn, dc);
  }
}

// The block's cell table in shared memory (its warps' lists follow it).
__device__ __forceinline__ void load_cells(float* smem, int num_cells, const float* bmin,
                                           const float* bmax, const int* start,
                                           const int* count) {
  for (int j = threadIdx.x; j < num_cells; j += blockDim.x) {
    float* c = smem + j * CELL_FLOATS;
    c[0] = bmin[3 * j], c[1] = bmin[3 * j + 1], c[2] = bmin[3 * j + 2];
    c[3] = bmax[3 * j], c[4] = bmax[3 * j + 1], c[5] = bmax[3 * j + 2];
    c[6] = __int_as_float(start[j]);
    c[7] = __int_as_float(count[j]);
  }
  __syncthreads();
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
