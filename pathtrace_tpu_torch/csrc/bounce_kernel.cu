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
//   four per SM at 108 registers. A cap at 64 or 80 registers (so that
//   131,072 lanes fit one wave) spilled and measured no faster, nor did
//   computing NEE's BSDF term before its shadow scan or deciding the
//   shadow ray at the light triangle first (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false (no fast math: IEEE division, sqrt and denormals), so the
// kernel rounds like the eager PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bsdf.cuh"
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
  long long base_path;    // first path id of this launch
  long long total_paths;  // path ids [base_path, base_path + total_paths)
  float cam_pos[3], cam_forward[3], cam_up[3], cam_right[3];
  float tan_x, tan_y;  // tan(fov/2), float32 values taken on the host
  int width, height, num_pix, lanes, k_pix;
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

// raycast_brute + finalize_hit for one ray on [0, BIG_T].
__device__ __forceinline__ Hit raycast(const float* geo, const float* __restrict__ attr,
                                       const float* sph, const PtParams& P, V3 org, V3 dir) {
  Hit h;
  TriHit th = closest_tri(geo, P.num_tris, org, dir, 0.0f, BIG_T);
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

// Next-event estimation (megakernel.nee_contribution): uniform light pick,
// area sample, shadow ray on [EPS, dist+1] accepted iff the winner is the
// sampled light triangle and not a sphere. The caller counts the ray.
__device__ __forceinline__ V3 nee(const float* geo, const float* __restrict__ attr,
                                  const float* sph, const float* lights, const PtParams& P,
                                  const Hit& h, V3 wo, const float u[8]) {
  int nl = P.num_lights;
  int slot = min((int)(u[0] * (float)nl), nl - 1);
  const float* row = lights + slot * LIGHT_STRIDE;
  float r1 = safe_sqrt(u[1]);
  float r2 = u[2];
  V3 point = (1.0f - r1) * ld3(row) + (r1 * (1.0f - r2)) * ld3(row + 3) + (r1 * r2) * ld3(row + 6);
  float area = row[9];
  V3 light_normal = ld3(row + 10);
  int light_tri = (int)row[13];

  V3 to_light = point - h.p;
  float dist2 = sqlen(to_light);
  float dist = sqrtf(fmaxf(dist2, TINY));
  V3 sdir = normalize(to_light);
  float s_tmax = dist + 1.0f;
  TriHit st = closest_tri(geo, P.num_tris, h.p, sdir, EPS, s_tmax);
  bool s_use_sph = false;
  if (P.num_spheres > 0) {
    float so_t;
    int so_idx;
    bool so_hit = closest_sphere(sph, P.num_spheres, h.p, sdir, EPS, st.hit ? st.t : s_tmax,
                                 &so_t, &so_idx);
    s_use_sph = so_hit && (!st.hit || so_t < st.t);
  }
  if (!(st.hit && !s_use_sph && st.idx == light_tri)) return zero3();

  V3 l_emit = ld3(attr + (long long)light_tri * ATTR_STRIDE + 27);
  float cos_a = fmaxf(dot(light_normal, normalize(h.p - point)), 0.0f);
  float pdf_light = safe_div(1.0f, area) / (float)nl;
  V3 brdfcos = eval_bsdfcos(h.mat, h.frame, wo, sdir);
  V3 contrib = brdfcos * l_emit * cos_a / fmaxf(dist2 * pdf_light, TINY);
  return finite3(contrib) ? contrib : zero3();  // NaN skip (CudaUtil.cuh:271)
}

// The camera ray of a path (wavefront._regen_rays).
__device__ __forceinline__ void camera_ray(const PtParams& P, long long path_id, V3* org, V3* dir) {
  uint32_t jc[4] = {(uint32_t)path_id, 0u, 0u, STREAM_JITTER};
  philox(jc, P.key0, P.key1);
  long long pixel = path_id % P.num_pix;
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
  long long off = lane;  // the current path is base_path + off
  // one path's state (make_bounce_fn), reset at each regeneration
  V3 org, dir, radiance = zero3(), weight = v3(1.0f, 1.0f, 1.0f);
  int depth = 0, refract_cnt = 0;
  bool refracted = false;
  uint32_t it = 0;
  if (off < P.total_paths) camera_ray(P, P.base_path + off, &org, &dir);
  const bool do_nee = P.nee && P.num_lights > 0;
  // The loop leaves only through its condition: a `break` in the body would
  // move the point where a warp's diverged lanes meet again past the loop,
  // and lanes that regenerated would run the next scans apart from the rest.
  while (off < P.total_paths) {
    rays += 1;
    Hit h = raycast(geo, tri_attr, sph, P, org, dir);
    bool ended = true;
    if (!h.hit) {  // miss: += weight * gray, path ends (CudaUtil.cuh:375-379)
      radiance = radiance + weight * ld3(P.miss);
    } else {
      const uint32_t rid = (uint32_t)(P.base_path + off);
      float u[8];
      draws(P, rid, it, u);
      V3 wo = -dir;
      if (sqlen(h.mat.emittance) > EPS) radiance = radiance + weight * h.mat.emittance;
      if (do_nee) {
        radiance = radiance + weight * nee(geo, tri_attr, sph, li, P, h, wo, u);
        rays += 1;
      }

      V3 wi = sample_bsdf(h.mat, h.frame, wo, u[3], u[4], u[5]);
      if (!(sqlen(wi) <= EPS)) {  // else a dead sample ends the path (CudaUtil.cuh:335-338)
        V3 w1 = eval_bsdfcos(h.mat, h.frame, wo, wi);
        float w2 = fmaxf(pdf_bsdf(h.mat, h.frame, wo, wi), P.pdf_clamp);
        weight = weight * (w1 / w2);
        if (h.mat.opacity < ONE_MINUS_EPS)  // sticky flag (CudaUtil.cuh:307)
          refracted = dot(h.frame.normal, wo) * dot(h.frame.normal, wi) <= 0.0f;
        org = h.p + h.frame.normal * (refracted ? -EPS : EPS);
        dir = normalize(wi);

        bool over_cap = refracted && refract_cnt > P.refract_cap;  // `RefractCnt++ > 8`
        refract_cnt += refracted ? 1 : 0;

        bool rr_lane = !refracted && depth >= P.rr_bounce;
        float rr_prob = clampf(max3(weight), P.rr_stop_prob, 1.0f);
        bool rr_survive = u[6] < rr_prob;
        if (rr_lane && rr_survive) weight = weight / rr_prob;

        depth += refracted ? 0 : 1;
        ended = over_cap || (rr_lane && !rr_survive) || depth >= P.max_bounce;
      }
    }
    if (ended) {  // commit, then regenerate in place: the lane's next strided path
      float* slot = film + 3 * ((off / P.lanes) % P.k_pix * P.lanes + lane);
      slot[0] += radiance.x;
      slot[1] += radiance.y;
      slot[2] += radiance.z;
      off += P.lanes;
      if (off < P.total_paths) camera_ray(P, P.base_path + off, &org, &dir);
      radiance = zero3();
      weight = v3(1.0f, 1.0f, 1.0f);
      depth = refract_cnt = 0;
      refracted = false;
      it = 0;
    } else {
      ++it;
    }
  }
  rays_out[lane] = rays;
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

// The kernel as built and as the card holds it at `smem` bytes of dynamic
// shared memory: out4 = {registers a thread, local memory bytes a thread
// (spills), resident blocks per SM, threads a block}. Returns the first
// CUDA error (0 = none).
extern "C" int pt_bounce_occupancy(int smem, int* out4) {
  cudaFuncAttributes attr = {};
  cudaError_t err = cudaFuncGetAttributes(&attr, pt::bounce_kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pt::bounce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pt::bounce_kernel, pt::BLOCK, smem);
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
