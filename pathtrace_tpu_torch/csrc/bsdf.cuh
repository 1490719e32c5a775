// Four-lobe BSDF (eval / sample / pdf) as __device__ functions for the
// bounce kernel.
//
// Replaces the lane-major Pallas library pathtrace_tpu/ops/pallas/bsdf_t.py
// (lobes at bsdf_t.py:203-370, dispatch at :385-409). The arithmetic follows
// the port's plain version, pathtrace_tpu_torch/ops/bsdf.py, operation by
// operation and in the same order, so that with -fmad=false both round alike:
// sin/cos of the microfacet angle come from atanf/sinf/cosf as in ops/bsdf.py
// (bsdf_t.py takes them algebraically; either is ulp-level apart).
// Diffuse sampling is cosine-weighted only, like bsdf_t.py; the fused entry
// point rejects hemisphere="uniform".
//
// Unlike the plain version, which evaluates every lobe and selects, each
// function here branches on the lobe and evaluates one.
#pragma once

#include <math.h>

namespace pt {

// Constants are cast from the same double literals the Python side uses,
// so float32 comparisons see the same thresholds.
constexpr float EPS = (float)1e-4;
constexpr float TINY = (float)1e-20;
constexpr float PI_F = (float)3.141592;
constexpr float TWO_PI = (float)(2.0 * 3.141592);
constexpr float INV_PI = (float)(1.0 / 3.141592);
constexpr float ONE_MINUS_EPS = (float)(1.0 - 1e-4);

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ V3 operator/(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ V3 operator/(V3 a, V3 b) { return {a.x / b.x, a.y / b.y, a.z / b.z}; }

__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float sqlen(V3 v) { return dot(v, v); }
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }
__device__ __forceinline__ V3 zero3() { return {0.0f, 0.0f, 0.0f}; }
__device__ __forceinline__ float max3(V3 v) { return fmaxf(fmaxf(v.x, v.y), v.z); }
__device__ __forceinline__ float mean3(V3 v) { return (v.x + v.y + v.z) * (float)0.333333; }
__device__ __forceinline__ bool finite3(V3 v) {
  return isfinite(v.x) && isfinite(v.y) && isfinite(v.z);
}

// 0 -> 0 safe normalize with 1/sqrt (math3.normalize, math3.py:41-48).
__device__ __forceinline__ V3 normalize(V3 v) {
  float sq = sqlen(v);
  float inv = 1.0f / sqrtf(fmaxf(sq, TINY));
  return v * (sq > TINY ? inv : 0.0f);
}

__device__ __forceinline__ float safe_sqrt(float x) { return x > (float)1e-12 ? sqrtf(x) : 0.0f; }

__device__ __forceinline__ float safe_div(float a, float b) {
  float floor = b >= 0.0f ? TINY : -TINY;
  return a / (fabsf(b) > TINY ? b : floor);
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

__device__ __forceinline__ V3 reflect(V3 w, V3 n) { return -w + (2.0f * dot(n, w)) * n; }

__device__ __forceinline__ V3 refract(V3 w, V3 n, float inv_eta) {
  float cosine = dot(n, w);
  float k = 1.0f + inv_eta * inv_eta * (cosine * cosine - 1.0f);
  if (!(k > 0.0f)) return zero3();
  return -w * inv_eta + (inv_eta * cosine - sqrtf(k)) * n;
}

__device__ __forceinline__ V3 lerp(V3 x, V3 y, float a) { return x * (1.0f - a) + y * a; }

struct Material {
  V3 emittance, albedo, specular;
  float opacity, roughness, metallic;
};

struct Frame {
  V3 normal, tangent, bitangent;  // normal flipped toward the viewer
  bool front;
};

enum Lobe { GLTFPBR = 0, REFLECTIVE = 1, REFRACTIVE = 2, PURE_REFRACTIVE = 3 };

__device__ __forceinline__ int select_lobe(const Material& m) {
  bool transparent = m.opacity < ONE_MINUS_EPS;
  bool delta = m.roughness < (float)1e-2;
  return transparent ? (delta ? PURE_REFRACTIVE : REFRACTIVE) : (delta ? REFLECTIVE : GLTFPBR);
}

// ---- Fresnel / microfacet building blocks (Bxdf.cuh:49-158) ----

__device__ __forceinline__ float reflectivity_to_eta(float r) {
  float sr = safe_sqrt(clampf(r, 0.0f, (float)0.99));
  return (1.0f + sr) / (1.0f - sr);
}

__device__ __forceinline__ float fresnel_dielectric(float eta, V3 normal, V3 outgoing) {
  float cosw = fabsf(dot(normal, outgoing));
  float sin2 = 1.0f - cosw * cosw;
  float eta2 = eta * eta;
  float cos2t = 1.0f - sin2 / fmaxf(eta2, TINY);
  if (cos2t < 0.0f) return 1.0f;
  float t0 = safe_sqrt(cos2t);
  float t1 = eta * t0;
  float t2 = eta * cosw;
  float rs = safe_div(cosw - t1, cosw + t1);
  float rp = safe_div(t0 - t2, t0 + t2);
  return (rs * rs + rp * rp) / 2.0f;
}

__device__ __forceinline__ V3 fresnel_schlick(V3 specular, V3 normal, V3 outgoing) {
  if (sqlen(specular) < EPS) return zero3();
  float cosine = dot(normal, outgoing);
  float pow5 = powf(clampf(1.0f - fabsf(cosine), EPS, (float)0.999), 5.0f);
  return specular + (v3(1.0f, 1.0f, 1.0f) - specular) * pow5;
}

__device__ __forceinline__ float microfacet_distribution(float roughness, V3 normal, V3 halfway) {
  float cosine = dot(normal, halfway);
  if (cosine <= EPS) return 0.0f;
  float r2 = roughness * roughness;
  float c2 = cosine * cosine;
  float divisor = fmaxf(c2 * r2 + 1.0f - c2, (float)1e-2);
  return r2 / (PI_F * divisor * divisor);
}

__device__ __forceinline__ float microfacet_shadowing1(float roughness, V3 normal, V3 halfway, V3 dir) {
  float cosine = dot(normal, dir);
  float cosineh = dot(halfway, dir);
  if (cosine * cosineh <= 0.0f) return 0.0f;
  float c2 = cosine * cosine;
  float r2 = roughness * roughness;
  float denom = fabsf(cosine) + safe_sqrt(c2 - r2 * c2 + r2);
  return 2.0f * fabsf(cosine) / fmaxf(denom, TINY);
}

__device__ __forceinline__ float microfacet_shadowing(float roughness, V3 normal, V3 halfway,
                                                      V3 outgoing, V3 incoming) {
  return microfacet_shadowing1(roughness, normal, halfway, outgoing) *
         microfacet_shadowing1(roughness, normal, halfway, incoming);
}

__device__ __forceinline__ V3 sample_microfacet(float roughness, const Frame& f, float u_phi, float u_ry) {
  float phi = TWO_PI * u_phi;
  float ry = clampf(u_ry, 0.0f, (float)(1.0 - 1e-6));
  float theta = atanf(roughness * safe_sqrt(ry / (1.0f - ry)));
  float st = sinf(theta), ct = cosf(theta);
  return (cosf(phi) * st) * f.tangent + (sinf(phi) * st) * f.bitangent + ct * f.normal;
}

__device__ __forceinline__ float sample_microfacet_pdf(float roughness, const Frame& f, V3 halfway) {
  float cosine = dot(f.normal, halfway);
  if (cosine < 0.0f) return 0.0f;
  return microfacet_distribution(roughness, f.normal, halfway) * cosine;
}

__device__ __forceinline__ V3 sample_hemisphere_cosine(const Frame& f, float u_phi, float u_ct) {
  float phi = TWO_PI * u_phi;
  float ct = safe_sqrt(u_ct);
  float st = safe_sqrt(1.0f - ct * ct);
  return normalize((cosf(phi) * st) * f.tangent + (sinf(phi) * st) * f.bitangent + ct * f.normal);
}

// ---- Lobe 0: gltfpbr (Bxdf.cuh:160-207) ----

__device__ __forceinline__ V3 eval_gltfpbr(const Material& m, const Frame& fr, V3 wo, V3 wi) {
  V3 n = fr.normal;
  if (!(dot(n, wi) * dot(n, wo) > 0.0f)) return zero3();
  V3 refl = lerp(m.specular, m.albedo, m.metallic);
  V3 f1 = fresnel_schlick(refl, n, wo);
  V3 h = normalize(wi + wo);
  V3 f = fresnel_schlick(refl, h, wi);
  float d = microfacet_distribution(m.roughness, n, h);
  float g = microfacet_shadowing(m.roughness, n, h, wo, wi);
  V3 k = (1.0f - m.metallic) * (v3(1.0f, 1.0f, 1.0f) - f1);
  float abs_cos_wi = fabsf(dot(n, wi));
  float denom = 4.0f * dot(n, wo) * dot(n, wi);
  V3 spec = f * (d * g) * safe_div(abs_cos_wi, denom);
  V3 diffuse = m.albedo * k * INV_PI * abs_cos_wi;
  return diffuse + spec;
}

__device__ __forceinline__ V3 sample_gltfpbr(const Material& m, const Frame& fr, V3 wo,
                                             float u_lobe, float u_phi, float u_ry) {
  V3 n = fr.normal;
  float f_mean = mean3(fresnel_schlick(lerp(m.specular, m.albedo, m.metallic), n, wo));
  if (u_lobe < f_mean) {
    V3 h = sample_microfacet(m.roughness, fr, u_phi, u_ry);
    V3 wi = reflect(wo, h);
    return dot(n, wi) * dot(n, wo) < -EPS ? zero3() : wi;
  }
  return sample_hemisphere_cosine(fr, u_phi, u_ry);
}

__device__ __forceinline__ float pdf_gltfpbr(const Material& m, const Frame& fr, V3 wo, V3 wi) {
  V3 n = fr.normal;
  if (!(dot(n, wi) * dot(n, wo) > 0.0f)) return 0.0f;
  V3 h = normalize(wo + wi);
  float f = mean3(fresnel_schlick(lerp(m.specular, m.albedo, m.metallic), n, wo));
  float pdf_spec = safe_div(sample_microfacet_pdf(m.roughness, fr, h), 4.0f * fabsf(dot(wo, h)));
  float pdf_diff = dot(n, wi) * INV_PI;
  return f * pdf_spec + (1.0f - f) * pdf_diff;
}

// ---- Lobe 1: delta reflective (Bxdf.cuh:211-234) ----

__device__ __forceinline__ V3 eval_reflective(const Material& m, const Frame& fr, V3 wo, V3 wi) {
  V3 n = fr.normal;
  if (!(dot(n, wi) * dot(n, wo) > 0.0f)) return zero3();
  V3 refl = lerp(m.specular, m.albedo, m.metallic);
  V3 f1 = fresnel_schlick(refl, n, wo);
  V3 f = fresnel_schlick(refl, n, wi);
  V3 k = (1.0f - m.metallic) * (v3(1.0f, 1.0f, 1.0f) - f1);
  float abs_cos_wi = fabsf(dot(n, wi));
  return m.albedo * k * INV_PI * abs_cos_wi + f * abs_cos_wi;
}

// ---- Lobes 2/3: rough and delta refractive (Walter 2007; Bxdf.cuh:236-370) ----

struct RefrSetup {
  V3 normal, up_normal;
  bool entering;
  float ior, rel_ior;
};

__device__ __forceinline__ RefrSetup refractive_setup(const Material& m, const Frame& fr, V3 wo) {
  RefrSetup s;
  s.normal = fr.front ? fr.normal : -fr.normal;  // outward normal (Bxdf.cuh:238)
  s.entering = dot(s.normal, wo) >= 0.0f;
  s.up_normal = s.entering ? s.normal : -s.normal;
  s.ior = reflectivity_to_eta(m.specular.x);  // channel x only (CudaUtil.cuh:231)
  s.rel_ior = s.entering ? s.ior : 1.0f / fmaxf(s.ior, TINY);
  return s;
}

__device__ __forceinline__ V3 walter_halfway(float rel_ior, bool entering, V3 wi, V3 wo) {
  V3 h = -normalize(rel_ior * wi + wo);
  return entering ? h : -h;
}

__device__ __forceinline__ V3 eval_refractive(const Material& m, const Frame& fr, V3 wo, V3 wi) {
  RefrSetup s = refractive_setup(m, fr, wo);
  bool reflecting = dot(s.normal, wi) * dot(s.normal, wo) >= 0.0f;
  float abs_cos_wi = fabsf(dot(s.normal, wi));
  float val;
  if (reflecting) {
    V3 h = normalize(wi + wo);
    float f = fresnel_dielectric(s.rel_ior, h, wo);
    float d = microfacet_distribution(m.roughness, s.up_normal, h);
    float g = microfacet_shadowing(m.roughness, s.up_normal, h, wo, wi);
    float denom = fabsf(4.0f * dot(s.normal, wo) * dot(s.normal, wi));
    val = f * d * g * safe_div(abs_cos_wi, denom);
  } else {
    V3 h = walter_halfway(s.rel_ior, s.entering, wi, wo);
    float f = fresnel_dielectric(s.rel_ior, h, wo);
    float d = microfacet_distribution(m.roughness, s.up_normal, h);
    float g = microfacet_shadowing(m.roughness, s.up_normal, h, wo, wi);
    float jac_num = dot(wo, h) * dot(wi, h);
    float jac_den = dot(wo, s.normal) * dot(wi, s.normal);
    float denom = s.rel_ior * dot(h, wi) + dot(h, wo);
    denom = denom * denom;
    val = fabsf(safe_div(jac_num, jac_den)) * (1.0f - f) * d * g * safe_div(abs_cos_wi, denom);
  }
  return m.albedo * val;
}

__device__ __forceinline__ V3 sample_refractive(const Material& m, const Frame& fr, V3 wo,
                                                float u_lobe, float u_phi, float u_ry) {
  RefrSetup s = refractive_setup(m, fr, wo);
  V3 h = sample_microfacet(m.roughness, fr, u_phi, u_ry);
  if (u_lobe < fresnel_dielectric(s.rel_ior, h, wo)) {
    V3 wi = reflect(wo, h);
    return dot(s.normal, wo) * dot(s.normal, wi) >= 0.0f ? wi : zero3();
  }
  float inv_eta = s.entering ? 1.0f / fmaxf(s.ior, TINY) : s.ior;
  V3 wi = refract(wo, h, inv_eta);
  return dot(s.normal, wo) * dot(s.normal, wi) >= 0.0f ? zero3() : wi;
}

__device__ __forceinline__ float pdf_refractive(const Material& m, const Frame& fr, V3 wo, V3 wi) {
  RefrSetup s = refractive_setup(m, fr, wo);
  if (dot(s.normal, wi) * dot(s.normal, wo) >= 0.0f) {
    V3 h = normalize(wi + wo);
    return fresnel_dielectric(s.rel_ior, h, wo) * sample_microfacet_pdf(m.roughness, fr, h) *
           safe_div(1.0f, 4.0f * fabsf(dot(wo, h)));
  }
  V3 h = walter_halfway(s.rel_ior, s.entering, wi, wo);
  float denom = s.rel_ior * dot(h, wi) + dot(h, wo);
  denom = denom * denom;
  return (1.0f - fresnel_dielectric(s.rel_ior, h, wo)) * sample_microfacet_pdf(m.roughness, fr, h) *
         safe_div(fabsf(dot(h, wi)), denom);
}

__device__ __forceinline__ V3 eval_pure_refractive(const Material& m, const Frame& fr, V3 wo, V3 wi) {
  RefrSetup s = refractive_setup(m, fr, wo);
  float val;
  if (dot(s.normal, wi) * dot(s.normal, wo) >= 0.0f) {
    val = fresnel_dielectric(s.rel_ior, normalize(wi + wo), wo);
  } else {
    V3 h = walter_halfway(s.rel_ior, s.entering, wi, wo);
    val = (1.0f - fresnel_dielectric(s.rel_ior, h, wo)) / fmaxf(s.rel_ior * s.rel_ior, TINY);
  }
  return m.albedo * val;
}

__device__ __forceinline__ V3 sample_pure_refractive(const Material& m, const Frame& fr, V3 wo,
                                                     float u_lobe) {
  RefrSetup s = refractive_setup(m, fr, wo);
  if (u_lobe < fresnel_dielectric(s.rel_ior, s.up_normal, wo)) return reflect(wo, s.up_normal);
  float inv_eta = s.entering ? 1.0f / fmaxf(s.ior, TINY) : s.ior;
  return refract(wo, s.up_normal, inv_eta);
}

__device__ __forceinline__ float pdf_pure_refractive(const Material& m, const Frame& fr, V3 wo, V3 wi) {
  RefrSetup s = refractive_setup(m, fr, wo);
  if (dot(s.normal, wi) * dot(s.normal, wo) >= 0.0f)
    return fresnel_dielectric(s.rel_ior, normalize(wi + wo), wo);
  V3 h = walter_halfway(s.rel_ior, s.entering, wi, wo);
  return 1.0f - fresnel_dielectric(s.rel_ior, h, wo);
}

// ---- dispatch on the reference's opacity/roughness policy ----

__device__ __forceinline__ V3 eval_bsdfcos(const Material& m, const Frame& fr, V3 wo, V3 wi) {
  switch (select_lobe(m)) {
    case GLTFPBR: return eval_gltfpbr(m, fr, wo, wi);
    case REFLECTIVE: return eval_reflective(m, fr, wo, wi);
    case REFRACTIVE: return eval_refractive(m, fr, wo, wi);
    default: return eval_pure_refractive(m, fr, wo, wi);
  }
}

__device__ __forceinline__ V3 sample_bsdf(const Material& m, const Frame& fr, V3 wo,
                                          float u_lobe, float u_phi, float u_ry) {
  switch (select_lobe(m)) {
    case GLTFPBR: return sample_gltfpbr(m, fr, wo, u_lobe, u_phi, u_ry);
    case REFLECTIVE: return reflect(wo, fr.normal);
    case REFRACTIVE: return sample_refractive(m, fr, wo, u_lobe, u_phi, u_ry);
    default: return sample_pure_refractive(m, fr, wo, u_lobe);
  }
}

__device__ __forceinline__ float pdf_bsdf(const Material& m, const Frame& fr, V3 wo, V3 wi) {
  switch (select_lobe(m)) {
    case GLTFPBR: return pdf_gltfpbr(m, fr, wo, wi);
    case REFLECTIVE: return 1.0f;
    case REFRACTIVE: return pdf_refractive(m, fr, wo, wi);
    default: return pdf_pure_refractive(m, fr, wo, wi);
  }
}

}  // namespace pt
