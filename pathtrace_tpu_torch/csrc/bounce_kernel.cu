// Fused wavefront render kernel for Hopper (sm_90a): one thread per lane.
//
// Replaces the Pallas kernel pathtrace_tpu/ops/pallas/bounce_kernel.py::
// _bounce_kernel (launched by fused_bounce_step, driven by _run_fused). It
// computes what _run_fused computes: lane i traces path ids base + i,
// base + i + lanes, ... below base + total, each with its Philox stream
// keyed by (path id, path-local iteration), adds each path's radiance to
// its film slot, and counts the rays it traced.
//
// Semantics are those of the plain version, the static strided wavefront
// of pathtrace_tpu_torch/integrator/wavefront.py over the brute raycast and
// the four-lobe BSDF (bsdf.cuh): plain float32 Moller-Trumbore with the
// backface cull det >= EPS and lowest-index ties (so the winner equals
// raycast_brute's), the sphere scan against the running closest t, NEE with
// a shadow ray on t in [EPS, dist+1] accepted by the identity of the winner,
// and the reference's quirks (no MIS, miss gray, pdf clamp, dead zero
// samples, sticky refraction flag with the pre-increment cap, Russian
// roulette from depth 3 skipped on refracted bounces, NaN-skipped NEE).
// The TPU layout (bf16 split products, paneled state, one-hot attribute
// fetch, k_pix film rows, g_inner host loop) is not carried over.
//
// A launch may render one pixel slice of the image (a shard of
// parallel/mesh.py::render_fused_sharded): pixels [pix_offset, pix_offset +
// num_pix) of num_pix_total. Lanes and film slots then run in local path ids
// (sample * num_pix + local pixel), while the Philox streams and the camera
// ray take the global id (sample * num_pix_total + pix_offset + local
// pixel), as wavefront._make_to_global and the TPU kernel
// (bounce_kernel.py:464-480) do, so N slices are path for path the whole
// render. The global id is computed once per path, at its regeneration, and
// kept in a register; a launch over the whole image (num_pix_total ==
// num_pix) takes the identity in a branch uniform over the launch.
//
// Film: slot (k % K) * lanes + i holds lane i's k-th path, K = max(1,
// num_pix / lanes). When num_pix % lanes == 0 the slot is the pixel and the
// lanes own disjoint pixel sets; when lanes % num_pix == 0 the caller sums
// the (lanes / num_pix) slots of each pixel. No atomics: every slot is
// written by one thread, in path order, exactly as the plain version sums.
//
// What bounds it on this card: divergent FP32 ALU work, warp convergence
// and latency, not bytes. Each bounce runs two brute searches over the
// triangle table and one of four BSDF lobes; device-memory traffic is a few
// bytes per path. The design:
// - the triangle search table (v0, e1, e2), the spheres and the lights sit
//   in shared memory, read by a warp's threads at one address (broadcast);
//   per-triangle shading rows are read from global memory at the winner;
// - each lane runs ONE loop over bounce iterations and regenerates its
//   path in place: when a path ends, the lane commits it, takes its next
//   strided path id and starts that camera ray in the next iteration, as
//   the plain version (wavefront.py::_run_wavefront) and the TPU kernel
//   (bounce_kernel.py:762-809) do. The loop leaves only through its
//   condition, so the lanes of a warp meet again at the end of every
//   iteration and run the next scans together (PERF.md: 2x faster than a
//   nested loop that traced each path to its end, and than an in-place
//   loop that left through a `break`);
// - both scans split the Moller-Trumbore test (mt.cuh): stages 1-3 with no
//   division and no branch for every pair, the IEEE 1/det and t only for
//   the pairs that pass the backface cull and the barycentric tests;
// - 128 threads a block and no register cap: 65,536 lanes are 512 blocks,
//   four per SM at 101 registers. A cap at 64 or 80 registers (so that
//   131,072 lanes fit one wave) spilled and measured no faster, nor did
//   computing NEE's BSDF term before its shadow scan or deciding the
//   shadow ray at the light triangle first (PERF.md).
//
// A scene whose triangles exceed shared memory takes bounce_kernel_kd, the
// same paths, draws, shading and film with the triangle searches over its
// KD cells (ops/kd_raycast.py), whose plain version is the wavefront through
// kd_closest_plain. Both kernels run one path step (shade_hit, light_sample,
// nee_term, scatter, start_path, commit). The variant keeps the cell table,
// the spheres and the lights in shared memory and reads the member rows
// from global memory (L2). Its searches walk the cells as kernel B2 does
// (kd_walk.cuh), one warp a ray, measured faster than one thread a ray
// (PERF.md): each warp walks its lanes' closest-hit rays one after another,
// then their shadow rays, so its lanes stay in the loop until all of them
// are done. Caps at 96 and 80 registers (20 and 24 warps an SM) ran no
// faster, within the noise of three rounds: 65,536 lanes are fewer than
// four blocks an SM, so the lanes, not the registers, bound the warps in
// flight.
// What bounds the variant on this card is the L2 round trip of each member
// row. At about 16 warps an SM the round trips are poorly hidden, and the
// launch is one wave whose warps differ several-fold in work: those whose
// rays cross the mesh's dense cells finish last, nearly alone on their SMs,
// testing one row a lane per round trip. So the variant walks with the
// walk's pipelined member loop, which loads each lane's next row while it
// tests the current one (kd_walk.cuh), at 128 registers, still four blocks
// an SM; kernel B2 keeps the plain loop, which its 40 warps an SM hide.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false (no fast math: IEEE division, sqrt and denormals), so the
// kernel rounds like the eager PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bsdf.cuh"
#include "kd_walk.cuh"
#include "mt.cuh"

namespace pt {

constexpr int BLOCK = 128;
constexpr float BIG_T = 999999.0f;
constexpr int GEO_STRIDE = 12;    // v0 e1 e2 pad
constexpr int ATTR_STRIDE = 40;   // n0 n1 n2 t0 t1 t2 b0 b1 b2 emit albedo spec opac rough metal pad
constexpr int SPHERE_STRIDE = 16; // center radius emit albedo spec opac rough metal
constexpr int LIGHT_STRIDE = 16;  // v0 v1 v2 area normal tri_id pad pad
constexpr uint32_t STREAM_PATH = 0x50415448u;
constexpr uint32_t STREAM_JITTER = 0x4A495454u;

}  // namespace pt

// Kernel parameters; mirrored field for field by ops/cuda/bounce_kernel.py.
struct PtParams {
  long long base_path;    // first local path id of this launch
  long long total_paths;  // local path ids [base_path, base_path + total_paths)
  float cam_pos[3], cam_forward[3], cam_up[3], cam_right[3];
  float tan_x, tan_y;  // tan(fov/2), float32 values taken on the host
  int width, height, num_pix, lanes, k_pix;
  int num_pix_total, pix_offset;  // the slice: pixels [pix_offset, pix_offset + num_pix)
  int num_tris, num_spheres, num_lights;
  unsigned int key0, key1;
  int max_bounce, rr_bounce, refract_cap, nee;
  float rr_stop_prob, pdf_clamp;
  float miss[3];
};

namespace pt {

__device__ __forceinline__ void philox(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    uint32_t hi0 = __umulhi(0xD2511F53u, c[0]), lo0 = 0xD2511F53u * c[0];
    uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]), lo1 = 0xCD9E8D57u * c[2];
    uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

__device__ __forceinline__ float u01(uint32_t u) { return (float)(u >> 8) * (1.0f / 16777216.0f); }

__device__ __forceinline__ V3 ld3(const float* p) { return {p[0], p[1], p[2]}; }

struct TriHit {
  float t, u, v;
  int idx;
  bool hit;
};

// Closest triangle over the whole shared-memory table (intersect_tris_all +
// closest_masked): strict '<' keeps the lowest index on ties. Each pair runs
// mt_inside, whose branch-free tests overlap from triangle to triangle, and
// mt_hit only where it passes.
__device__ __forceinline__ TriHit closest_tri(const float* geo, int num_tris, V3 org, V3 dir,
                                              float tmin, float tmax) {
  TriHit best{INFINITY, 0.0f, 0.0f, 0, false};
  for (int j = 0; j < num_tris; ++j) {
    const float* g = geo + j * GEO_STRIDE;
    MtHit h;
    if (mt_inside(org, dir, g) && mt_hit(org, dir, g, tmin, tmax, best.t, &h)) {
      best.t = h.t;
      best.idx = j;
      best.u = h.u * h.inv_det;
      best.v = h.v * h.inv_det;
      best.hit = true;
    }
  }
  return best;
}

// Nearest-valid-root sphere scan against cur_max (intersect_spheres_all +
// closest_masked).
__device__ __forceinline__ bool closest_sphere(const float* sph, int num_spheres, V3 org, V3 dir,
                                               float tmin, float cur_max, float* t_out,
                                               int* idx_out) {
  float best = INFINITY;
  int idx = 0;
  bool hit = false;
  float a = sqlen(dir);
  for (int s = 0; s < num_spheres; ++s) {
    const float* row = sph + s * SPHERE_STRIDE;
    V3 oc = org - ld3(row);
    float radius = row[3];
    float half_b = dot(oc, dir);
    float c = sqlen(oc) - radius * radius;
    float disc = half_b * half_b - a * c;
    float sq = safe_sqrt(disc);
    float r0 = (-half_b - sq) / a;
    float r1 = (-half_b + sq) / a;
    bool in0 = r0 >= tmin && r0 <= cur_max;
    bool in1 = r1 >= tmin && r1 <= cur_max;
    float t = in0 ? r0 : r1;
    if (disc >= 0.0f && (in0 || in1) && t < best) {
      best = t;
      idx = s;
      hit = true;
    }
  }
  *t_out = best;
  *idx_out = idx;
  return hit;
}

struct Hit {
  bool hit;
  V3 p;
  Frame frame;
  Material mat;
};

// finalize_hit for one ray on [0, BIG_T] whose closest triangle is th: the
// sphere scan against it, then the winner's frame and material.
__device__ __forceinline__ Hit shade_hit(const TriHit& th, const float* __restrict__ attr,
                                         const float* sph, const PtParams& P, V3 org, V3 dir) {
  Hit h;
  float sph_t = INFINITY;
  int sph_idx = 0;
  bool sph_hit = false;
  if (P.num_spheres > 0)
    sph_hit = closest_sphere(sph, P.num_spheres, org, dir, 0.0f, th.hit ? th.t : BIG_T, &sph_t,
                             &sph_idx);
  bool use_sphere = sph_hit && (!th.hit || sph_t < th.t);
  h.hit = th.hit || sph_hit;
  if (!h.hit) return h;
  if (use_sphere) {
    const float* row = sph + sph_idx * SPHERE_STRIDE;
    h.p = org + sph_t * dir;
    V3 outward = (h.p - ld3(row)) / fmaxf(row[3], TINY);
    bool front = dot(dir, outward) < 0.0f;
    V3 normal = front ? outward : -outward;
    V3 tangent = normalize(cross(v3(0.0f, 1.0f, 0.0f), normal));
    h.frame = {normal, tangent, cross(normal, tangent), front};
    h.mat = {ld3(row + 4), ld3(row + 7), ld3(row + 10), row[13], row[14], row[15]};
  } else {
    const float* a = attr + (long long)th.idx * ATTR_STRIDE;
    float w0 = 1.0f - th.u - th.v, wu = th.u, wv = th.v;
    auto interp = [&](int base) {
      return w0 * ld3(a + base) + wv * ld3(a + base + 3) + wu * ld3(a + base + 6);
    };
    V3 outward = normalize(interp(0));
    bool front = dot(dir, outward) < 0.0f;
    h.frame = {front ? outward : -outward, normalize(interp(9)), normalize(interp(18)), front};
    h.p = org + th.t * dir;
    h.mat = {ld3(a + 27), ld3(a + 30), ld3(a + 33), a[36], a[37], a[38]};
  }
  return h;
}

// raycast_brute + finalize_hit for one ray on [0, BIG_T].
__device__ __forceinline__ Hit raycast(const float* geo, const float* __restrict__ attr,
                                       const float* sph, const PtParams& P, V3 org, V3 dir) {
  return shade_hit(closest_tri(geo, P.num_tris, org, dir, 0.0f, BIG_T), attr, sph, P, org, dir);
}

// NEE's light sample: the point, its light's row, and the shadow ray from
// the hit to it on [EPS, s_tmax].
struct LightSample {
  V3 point, sdir, light_normal;
  float dist2, s_tmax, area;
  int light_tri;
};

__device__ __forceinline__ LightSample light_sample(const float* lights, const PtParams& P,
                                                    const Hit& h, const float u[8]) {
  LightSample s;
  int nl = P.num_lights;
  int slot = min((int)(u[0] * (float)nl), nl - 1);
  const float* row = lights + slot * LIGHT_STRIDE;
  float r1 = safe_sqrt(u[1]);
  float r2 = u[2];
  s.point = (1.0f - r1) * ld3(row) + (r1 * (1.0f - r2)) * ld3(row + 3) + (r1 * r2) * ld3(row + 6);
  s.area = row[9];
  s.light_normal = ld3(row + 10);
  s.light_tri = (int)row[13];

  V3 to_light = s.point - h.p;
  s.dist2 = sqlen(to_light);
  float dist = sqrtf(fmaxf(s.dist2, TINY));
  s.sdir = normalize(to_light);
  s.s_tmax = dist + 1.0f;
  return s;
}

// NEE's term once the shadow ray's closest triangle st is known: the ray is
// accepted iff the winner is the sampled light triangle and not a sphere.
__device__ __forceinline__ V3 nee_term(const float* __restrict__ attr, const float* sph,
                                       const PtParams& P, const Hit& h, V3 wo,
                                       const LightSample& s, const TriHit& st) {
  bool s_use_sph = false;
  if (P.num_spheres > 0) {
    float so_t;
    int so_idx;
    bool so_hit = closest_sphere(sph, P.num_spheres, h.p, s.sdir, EPS, st.hit ? st.t : s.s_tmax,
                                 &so_t, &so_idx);
    s_use_sph = so_hit && (!st.hit || so_t < st.t);
  }
  if (!(st.hit && !s_use_sph && st.idx == s.light_tri)) return zero3();

  V3 l_emit = ld3(attr + (long long)s.light_tri * ATTR_STRIDE + 27);
  float cos_a = fmaxf(dot(s.light_normal, normalize(h.p - s.point)), 0.0f);
  float pdf_light = safe_div(1.0f, s.area) / (float)P.num_lights;
  V3 brdfcos = eval_bsdfcos(h.mat, h.frame, wo, s.sdir);
  V3 contrib = brdfcos * l_emit * cos_a / fmaxf(s.dist2 * pdf_light, TINY);
  return finite3(contrib) ? contrib : zero3();  // NaN skip (CudaUtil.cuh:271)
}

// Next-event estimation (megakernel.nee_contribution): uniform light pick,
// area sample, shadow ray on [EPS, dist+1] accepted iff the winner is the
// sampled light triangle and not a sphere. The caller counts the ray.
__device__ __forceinline__ V3 nee(const float* geo, const float* __restrict__ attr,
                                  const float* sph, const float* lights, const PtParams& P,
                                  const Hit& h, V3 wo, const float u[8]) {
  LightSample s = light_sample(lights, P, h, u);
  TriHit st = closest_tri(geo, P.num_tris, h.p, s.sdir, EPS, s.s_tmax);
  return nee_term(attr, sph, P, h, wo, s, st);
}

// One path's state (make_bounce_fn), reset at each regeneration.
struct PathState {
  V3 org, dir, radiance, weight;
  int depth, refract_cnt;
  bool refracted;
};

// BSDF sampling, the next ray, the refraction cap and Russian roulette of a
// shaded hit (megakernel.make_bounce_fn): whether the path ends.
__device__ __forceinline__ bool scatter(const PtParams& P, const Hit& h, V3 wo, const float u[8],
                                        PathState& s) {
  V3 wi = sample_bsdf(h.mat, h.frame, wo, u[3], u[4], u[5]);
  if (sqlen(wi) <= EPS) return true;  // a dead sample ends the path (CudaUtil.cuh:335-338)
  V3 w1 = eval_bsdfcos(h.mat, h.frame, wo, wi);
  float w2 = fmaxf(pdf_bsdf(h.mat, h.frame, wo, wi), P.pdf_clamp);
  s.weight = s.weight * (w1 / w2);
  if (h.mat.opacity < ONE_MINUS_EPS)  // sticky flag (CudaUtil.cuh:307)
    s.refracted = dot(h.frame.normal, wo) * dot(h.frame.normal, wi) <= 0.0f;
  s.org = h.p + h.frame.normal * (s.refracted ? -EPS : EPS);
  s.dir = normalize(wi);

  bool over_cap = s.refracted && s.refract_cnt > P.refract_cap;  // `RefractCnt++ > 8`
  s.refract_cnt += s.refracted ? 1 : 0;

  bool rr_lane = !s.refracted && s.depth >= P.rr_bounce;
  float rr_prob = clampf(max3(s.weight), P.rr_stop_prob, 1.0f);
  bool rr_survive = u[6] < rr_prob;
  if (rr_lane && rr_survive) s.weight = s.weight / rr_prob;

  s.depth += s.refracted ? 0 : 1;
  return over_cap || (rr_lane && !rr_survive) || s.depth >= P.max_bounce;
}

// The global path id of a local one (wavefront._make_to_global).
__device__ __forceinline__ long long to_global(const PtParams& P, long long local) {
  if (P.num_pix_total == P.num_pix) return local;  // the whole image
  return local / P.num_pix * P.num_pix_total + P.pix_offset + local % P.num_pix;
}

// The camera ray of a path, by its global id (wavefront._regen_rays).
__device__ __forceinline__ void camera_ray(const PtParams& P, long long path_id, V3* org, V3* dir) {
  uint32_t jc[4] = {(uint32_t)path_id, 0u, 0u, STREAM_JITTER};
  philox(jc, P.key0, P.key1);
  long long pixel = path_id % P.num_pix_total;
  float px = (float)(pixel % P.width);
  float py = (float)(pixel / P.width);
  float sx = 2.0f * ((px + u01(jc[0])) / (float)(P.width - 1) - 0.5f);
  float sy = 2.0f * ((py + u01(jc[1])) / (float)(P.height - 1) - 0.5f);
  float ax = sx * P.tan_x, ay = sy * P.tan_y;
  V3 d = ld3(P.cam_forward) + ax * ld3(P.cam_right) - ay * ld3(P.cam_up);
  *dir = normalize(d);
  *org = ld3(P.cam_pos);
}

// The eight uniforms of (path id, path-local iteration) (rng.uniforms).
__device__ __forceinline__ void draws(const PtParams& P, uint32_t rid, uint32_t it, float u[8]) {
#pragma unroll
  for (uint32_t block = 0; block < 2; ++block) {
    uint32_t c[4] = {rid, it, block, STREAM_PATH};
    philox(c, P.key0, P.key1);
#pragma unroll
    for (int j = 0; j < 4; ++j) u[4 * block + j] = u01(c[j]);
  }
}

// Starts the path of local id base_path + off, if there is one: its camera
// ray, keyed by its global id rid, and a fresh state.
__device__ __forceinline__ void start_path(const PtParams& P, long long off, PathState& s,
                                           uint32_t& rid) {
  if (off < P.total_paths) {
    long long gid = to_global(P, P.base_path + off);
    rid = (uint32_t)gid;
    camera_ray(P, gid, &s.org, &s.dir);
  }
  s.radiance = zero3();
  s.weight = v3(1.0f, 1.0f, 1.0f);
  s.depth = s.refract_cnt = 0;
  s.refracted = false;
}

// Adds the ended path of local id base_path + off to the lane's film slot.
__device__ __forceinline__ void commit(const PtParams& P, float* film, int lane, long long off,
                                       const PathState& s) {
  float* slot = film + 3 * ((off / P.lanes) % P.k_pix * P.lanes + lane);
  slot[0] += s.radiance.x;
  slot[1] += s.radiance.y;
  slot[2] += s.radiance.z;
}

__global__ void __launch_bounds__(BLOCK)
    bounce_kernel(PtParams P, const float* __restrict__ tri_geo, const float* __restrict__ tri_attr,
                  const float* __restrict__ spheres, const float* __restrict__ lights,
                  float* __restrict__ film, long long* __restrict__ rays_out) {
  extern __shared__ float smem[];
  const int n_geo = P.num_tris * GEO_STRIDE;
  const int n_sph = P.num_spheres * SPHERE_STRIDE;
  const int n_li = P.num_lights * LIGHT_STRIDE;
  for (int j = threadIdx.x; j < n_geo + n_sph + n_li; j += blockDim.x)
    smem[j] = j < n_geo ? tri_geo[j] : j < n_geo + n_sph ? spheres[j - n_geo] : lights[j - n_geo - n_sph];
  __syncthreads();
  const float* geo = smem;
  const float* sph = smem + n_geo;
  const float* li = smem + n_geo + n_sph;

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P.lanes) return;
  for (int k = 0; k < P.k_pix; ++k) {
    float* slot = film + 3 * ((long long)k * P.lanes + lane);
    slot[0] = slot[1] = slot[2] = 0.0f;
  }
  long long rays = 0;
  long long off = lane;  // the current path's local id is base_path + off
  // rid is the path's global id as the Philox counter takes it (rng.uniforms)
  PathState s;
  uint32_t it = 0, rid = 0;
  start_path(P, off, s, rid);
  const bool do_nee = P.nee && P.num_lights > 0;
  // The loop leaves only through its condition: a `break` in the body would
  // move the point where a warp's diverged lanes meet again past the loop,
  // and lanes that regenerated would run the next scans apart from the rest.
  while (off < P.total_paths) {
    rays += 1;
    Hit h = raycast(geo, tri_attr, sph, P, s.org, s.dir);
    bool ended = true;
    if (!h.hit) {  // miss: += weight * gray, path ends (CudaUtil.cuh:375-379)
      s.radiance = s.radiance + s.weight * ld3(P.miss);
    } else {
      float u[8];
      draws(P, rid, it, u);
      V3 wo = -s.dir;
      if (sqlen(h.mat.emittance) > EPS) s.radiance = s.radiance + s.weight * h.mat.emittance;
      if (do_nee) {
        s.radiance = s.radiance + s.weight * nee(geo, tri_attr, sph, li, P, h, wo, u);
        rays += 1;
      }
      ended = scatter(P, h, wo, u, s);
    }
    if (ended) {  // commit, then regenerate in place: the lane's next strided path
      commit(P, film, lane, off, s);
      off += P.lanes;
      start_path(P, off, s, rid);
      it = 0;
    } else {
      ++it;
    }
  }
  rays_out[lane] = rays;
}

// ---- the KD variant ---------------------------------------------------------

// The KD tables as the launch passes them: the cells (bmin, bmax (M, 3),
// first slot and slot count (M,)), the member rows [v0 e1 e2] (D, 9) and
// their original triangle ids (D,), as ops/kd_raycast.py states them.
struct KdTables {
  const float *bmin, *bmax;
  const int *start, *count;
  const float* members;
  const int* ids;
  int num_cells;
};

// What a warp walks: the cell table in shared memory, the warp's list of
// crossed cells and its lanes' row counts there, the member rows and ids in
// global memory.
struct KdWalk {
  const float* cells;
  int num_cells;
  float2* list;
  long long* rows;  // lane i's member rows tested at [i]
  const float* members;
  const int* ids;
};

// The closest triangle of each lane's ray on [tmin, tmax] that `want`s one,
// over the KD cells: the warp walks the rays one after another, each with
// all its 32 lanes (kd_walk.cuh, with the pipelined member loop), so every
// lane of the warp must call it. A lane that wants none gets a miss; the
// lane whose ray was walked adds the rows its walk tested to its count.
template <bool CLOSEST>
__device__ __forceinline__ TriHit warp_closest(int wl, bool want, V3 org, V3 dir, float tmin,
                                               float tmax, const KdWalk& kd) {
  TriHit out{INFINITY, 0.0f, 0.0f, 0, false};
  unsigned todo = __ballot_sync(FULL, want);
  while (todo) {  // the same in every lane
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    Ray ray;
    ray.o = {__shfl_sync(FULL, org.x, src), __shfl_sync(FULL, org.y, src),
             __shfl_sync(FULL, org.z, src)};
    ray.d = {__shfl_sync(FULL, dir.x, src), __shfl_sync(FULL, dir.y, src),
             __shfl_sync(FULL, dir.z, src)};
    ray.inv = {safe_inv(ray.d.x), safe_inv(ray.d.y), safe_inv(ray.d.z)};
    ray.lo = __shfl_sync(FULL, tmin, src);
    ray.hi = __shfl_sync(FULL, tmax, src);
    Best b = {INFINITY, 0.0f, 0.0f, INT_MAX};
    const int rows = walk<true>(wl, kd.cells, kd.num_cells, kd.list, ray, kd.members, kd.ids,
                                CLOSEST, b);
    if (wl == src) kd.rows[wl] += rows;
    if (wl == src && b.id != INT_MAX) out = {b.t, b.u, b.v, b.id, true};
  }
  return out;
}

// bounce_kernel with the triangle searches over KD cells: the same paths,
// draws, shading and film, for scenes whose triangles exceed shared memory.
// The block keeps the cell table, the spheres, the lights and one list of
// crossed cells a warp in shared memory; the member rows and the shading rows
// stay in global memory (L2). One warp walks one ray, so the lanes of a warp
// stay in the loop until all of them are done and meet at each search: first
// every live lane's closest-hit ray, then the shadow ray of every lane that
// shades a hit with NEE. The walk keeps member rows in flight while the
// lanes test others (kd_walk.cuh). rays_out is (2, P.lanes): each lane's
// rays traced, then the member rows its walks tested (which are the rows
// they fetched), counted in shared memory.
__global__ void __launch_bounds__(BLOCK)
    bounce_kernel_kd(PtParams P, KdTables K, const float* __restrict__ tri_attr,
                     const float* __restrict__ spheres, const float* __restrict__ lights,
                     float* __restrict__ film, long long* __restrict__ rays_out) {
  extern __shared__ __align__(16) float kd_shared[];
  float* smem = kd_shared;
  const int n_sph = P.num_spheres * SPHERE_STRIDE;
  const int n_li = P.num_lights * LIGHT_STRIDE;
  float* sph = smem + K.num_cells * CELL_FLOATS;
  for (int j = threadIdx.x; j < n_sph + n_li; j += blockDim.x)
    sph[j] = j < n_sph ? spheres[j] : lights[j - n_sph];
  load_cells(smem, K.num_cells, K.bmin, K.bmax, K.start, K.count);  // and the barrier
  const float* li = sph + n_sph;
  const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float2* lists = (float2*)(sph + n_sph + n_li);
  long long* rows = (long long*)(lists + LIST_CAP * (BLOCK / 32));  // 8-B aligned: kd_smem
  const KdWalk kd = {smem, K.num_cells, lists + warp * LIST_CAP, rows + warp * 32, K.members,
                     K.ids};
  rows[threadIdx.x] = 0;  // this thread's own

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = lane < P.lanes;  // a thread past the lanes stays for the walks
  if (valid)
    for (int k = 0; k < P.k_pix; ++k) {
      float* slot = film + 3 * ((long long)k * P.lanes + lane);
      slot[0] = slot[1] = slot[2] = 0.0f;
    }
  long long rays = 0;
  long long off = valid ? lane : P.total_paths;
  PathState s;
  uint32_t it = 0, rid = 0;
  start_path(P, off, s, rid);
  const bool do_nee = P.nee && P.num_lights > 0;
  while (__any_sync(FULL, off < P.total_paths)) {
    const bool live = off < P.total_paths;
    const TriHit th = warp_closest<true>(wl, live, s.org, s.dir, 0.0f, BIG_T, kd);
    Hit h{};
    LightSample ls{};
    float u[8];
    const V3 wo = -s.dir;
    bool shaded = false, ended = true;
    if (live) {
      rays += 1;
      h = shade_hit(th, tri_attr, sph, P, s.org, s.dir);
      if (!h.hit) {  // miss: += weight * gray, path ends (CudaUtil.cuh:375-379)
        s.radiance = s.radiance + s.weight * ld3(P.miss);
      } else {
        draws(P, rid, it, u);
        if (sqlen(h.mat.emittance) > EPS) s.radiance = s.radiance + s.weight * h.mat.emittance;
        if (do_nee) ls = light_sample(li, P, h, u);
        shaded = true;
      }
    }
    const TriHit st = warp_closest<false>(wl, shaded && do_nee, h.p, ls.sdir, EPS, ls.s_tmax, kd);
    if (shaded) {
      if (do_nee) {
        s.radiance = s.radiance + s.weight * nee_term(tri_attr, sph, P, h, wo, ls, st);
        rays += 1;
      }
      ended = scatter(P, h, wo, u, s);
    }
    if (live) {
      if (ended) {  // commit, then regenerate in place
        commit(P, film, lane, off, s);
        off += P.lanes;
        start_path(P, off, s, rid);
        it = 0;
      } else {
        ++it;
      }
    }
  }
  if (valid) {
    rays_out[lane] = rays;
    rays_out[P.lanes + lane] = rows[threadIdx.x];
  }
}

// Dynamic shared memory of a KD variant block: the cells, the spheres, the
// lights, the warps' lists and each thread's row count.
__host__ inline size_t kd_smem(int num_cells, int num_spheres, int num_lights) {
  static_assert(CELL_FLOATS % 2 == 0 && SPHERE_STRIDE % 2 == 0 && LIGHT_STRIDE % 2 == 0,
                "the row counts after the lists are 8-B aligned");
  return sizeof(float) * ((size_t)num_cells * CELL_FLOATS + (size_t)num_spheres * SPHERE_STRIDE +
                          (size_t)num_lights * LIGHT_STRIDE) +
         sizeof(float2) * LIST_CAP * (BLOCK / 32) + sizeof(long long) * BLOCK;
}

}  // namespace pt

// Launch on `stream`; returns cudaGetLastError() (0 = launched). The
// dynamic shared memory holds the search table, spheres and lights.
extern "C" int pt_bounce_render(const PtParams* params, const float* tri_geo, const float* tri_attr,
                                const float* spheres, const float* lights, float* film,
                                long long* rays, void* stream) {
  const PtParams P = *params;
  size_t smem = sizeof(float) * ((size_t)P.num_tris * pt::GEO_STRIDE +
                                 (size_t)P.num_spheres * pt::SPHERE_STRIDE +
                                 (size_t)P.num_lights * pt::LIGHT_STRIDE);
  cudaError_t err = cudaFuncSetAttribute(pt::bounce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int grid = (P.lanes + pt::BLOCK - 1) / pt::BLOCK;
  pt::bounce_kernel<<<grid, pt::BLOCK, smem, (cudaStream_t)stream>>>(P, tri_geo, tri_attr, spheres,
                                                                   lights, film, rays);
  return (int)cudaGetLastError();
}

// The kernel (its KD variant if `kd`) as built and as the card holds it at
// `smem` bytes of dynamic shared memory: out4 = {registers a thread, local
// memory bytes a thread (spills), resident blocks per SM, threads a block}.
// Returns the first CUDA error (0 = none).
extern "C" int pt_bounce_occupancy(int kd, int smem, int* out4) {
  const void* fn = kd ? (const void*)pt::bounce_kernel_kd : (const void*)pt::bounce_kernel;
  cudaFuncAttributes attr = {};
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, pt::BLOCK, smem);
  out4[0] = attr.numRegs;
  out4[1] = (int)attr.localSizeBytes;
  out4[2] = blocks;
  out4[3] = pt::BLOCK;
  return (int)err;
}

// Table row widths and sizeof(PtParams), so the wrapper can check that its
// packing and its ctypes struct match this library.
extern "C" int pt_bounce_strides(int* out4) {
  out4[0] = pt::GEO_STRIDE;
  out4[1] = pt::ATTR_STRIDE;
  out4[2] = pt::SPHERE_STRIDE;
  out4[3] = pt::LIGHT_STRIDE;
  return (int)sizeof(PtParams);
}

// The KD variant's launch on `stream`, as pt_bounce_render's, with the KD
// tables of ops/kd_raycast.py in place of the search table; `rays` holds
// 2 * lanes: the rays, then the member rows tested, of each lane.
extern "C" int pt_bounce_render_kd(const PtParams* params, int num_cells, const float* bmin,
                                   const float* bmax, const int* start, const int* count,
                                   const float* members, const int* ids, const float* tri_attr,
                                   const float* spheres, const float* lights, float* film,
                                   long long* rays, void* stream) {
  const PtParams P = *params;
  const pt::KdTables K = {bmin, bmax, start, count, members, ids, num_cells};
  size_t smem = pt::kd_smem(num_cells, P.num_spheres, P.num_lights);
  cudaError_t err = cudaFuncSetAttribute(pt::bounce_kernel_kd,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int grid = (P.lanes + pt::BLOCK - 1) / pt::BLOCK;
  pt::bounce_kernel_kd<<<grid, pt::BLOCK, smem, (cudaStream_t)stream>>>(P, K, tri_attr, spheres,
                                                                      lights, film, rays);
  return (int)cudaGetLastError();
}

// The KD variant's dynamic shared-memory bytes at these table sizes.
extern "C" int pt_bounce_kd_smem(int num_cells, int num_spheres, int num_lights) {
  return (int)pt::kd_smem(num_cells, num_spheres, num_lights);
}
