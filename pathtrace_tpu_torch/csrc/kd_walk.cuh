// The KD cell walk of one ray by a whole warp, shared by the KD raycast
// kernel B2 (kd_raycast.cu: one warp a ray) and the bounce kernel's KD
// variant (bounce_kernel.cu: each warp walks its lanes' rays one after
// another).
//
// The warp slab-tests the cells once, split over its lanes (safe 1/dir, far
// bound widened by 1.00000024, as accel/binned.py::slab_all), into a list of
// its crossed cells in shared memory, and visits them in ascending (tnear,
// cell) order, each next cell a warp-wide min over the list by shuffles. It
// splits a cell's members over its lanes (consecutive slots on consecutive
// lanes, so the warp's loads of a row block are contiguous), runs mt_inside
// on each and stage 4 (mt_hit_upto) only on those that pass, reduces (t, id)
// by shuffles and stops when the next cell's tnear exceeds the best t times
// the same widening: a later cell can only hold an equal or farther hit, and
// the strict test still visits same-box chunked cells whose tnear equals the
// best t. Equal t goes to the lowest original triangle id, brute's rule. A
// ray that crosses more than LIST_CAP cells keeps the least cell beyond its
// list aside and lists again after it has visited that cell.
//
// `walk` has two member loops, chosen at compile time. Kernel B2 takes the
// plain one, a row a lane at a time; the bounce kernel's variant takes the
// pipelined one (test_rows, below), with each lane's next member row in
// flight while it tests the current one, since the variant's ~16 warps an
// SM leave the L2 round trip of each row exposed. B2's 40 warps an SM hide
// that latency, so B2 keeps the plain loop.
//
// Every function here is called by all 32 lanes of a warp together.
#pragma once

#include <limits.h>

#include "mt.cuh"

namespace pt {

constexpr int TEAM = 32;          // threads a ray: one warp
static_assert(TEAM == 32, "the walk's shuffles and ballots span a whole warp");
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

// ---- the pipelined member loop of the bounce kernel's KD variant ----------
//
// What bounds the variant on this card is neither the FP32 rate nor device
// memory (the member rows, 3.4 MB for the bunny scene, stay in L2) but the
// L2 round trip of each row. Its 65,536 lanes are one wave of about 16
// warps an SM, and the warps whose rays cross the mesh's dense cells run
// several times longer than the rest, at the end nearly alone on their SMs,
// where no other warp hides their latency. In the plain loop a lane loads
// its next row only after testing its last one, so a warp waits out a
// whole round trip for every 32 rows. test_rows loads a lane's next row
// before it tests the current one, so that the test and the next round
// trip overlap. Nine more registers a lane hold it, and the variant stays
// at 128, within its 4 blocks an SM; three or four rows a lane spilled and
// ran no faster.
//
// Kernel B2 keeps the plain loop: it runs 40 warps an SM, over many waves,
// so occupancy hides its latency, and the registers would cost it warps.
// Both loops test the same rows against the same running best, and the
// (t, id) winner does not depend on the order, so both give the same bits.

// A member row [v0 e1 e2] into registers.
__device__ __forceinline__ void load_row(float* g, const float* members, int j) {
  const float* p = members + (long long)j * MEMBER_STRIDE;
#pragma unroll
  for (int k = 0; k < MEMBER_STRIDE; ++k) g[k] = p[k];
}

// The member loop over the cell's slots [s, end): lane l tests slots
// s + l, s + l + 32, ..., each with the lane's next slot in flight. The
// `j + TEAM < end` guard fetches no row past the cell's end, so the loop
// fetches exactly the rows it tests.
__device__ __forceinline__ void test_rows(int lane, int s, int end, const Ray& ray,
                                          const float* members, const int* ids, bool closest,
                                          Best& b) {
  float g[MEMBER_STRIDE], next[MEMBER_STRIDE];
  int j = s + lane;
  if (j < end) load_row(g, members, j);
  for (; j < end; j += TEAM) {
    if (j + TEAM < end) load_row(next, members, j + TEAM);
    test_row(ray, g, j, ids, closest, b);
#pragma unroll
    for (int k = 0; k < MEMBER_STRIDE; ++k) g[k] = next[k];
  }
}

// Walks the ray's crossed cells in ascending (tnear, cell) order under the
// exit rule into b (the same in every lane of the warp), with the plain
// member loop, or test_rows if PIPELINED. Returns the member rows tested,
// the same in every lane: a cell's rows are fetched only once the exit rule
// has let the walk into the cell, so these are also the rows fetched.
template <bool PIPELINED = false>
__device__ __forceinline__ int walk(int lane, const float* cells, int num_cells, float2* list,
                                    const Ray& ray, const float* members, const int* ids,
                                    bool closest, Best& b) {
  int tested = 0;
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
    if constexpr (PIPELINED) {
      test_rows(lane, s, s + cnt, ray, members, ids, closest, b);
    } else {
      for (int j = s + lane; j < s + cnt; j += TEAM)
        test_row(ray, members + (long long)j * MEMBER_STRIDE, j, ids, closest, b);
    }
    tested += cnt;
    warp_min_best(b);
    ctn = ntn, cc = nc;
    if (set_aside) n = build_list(lane, cells, num_cells, ray, ctn, cc, list, dtn, dc);
  }
  return tested;
}

// The block's cell table at the start of its shared memory, loaded by all
// its threads, which then meet at a barrier.
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

}  // namespace pt
