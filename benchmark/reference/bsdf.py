"""The reference's four-lobe BSDF: eval, sample and pdf (a frozen copy of
the port's plain lobe code, ops/bsdf.py, cosine hemisphere only).

  opacity < 1-EPS  ?  (roughness < 1e-2 ? pure_refractive : refractive)
                   :  (roughness < 1e-2 ? reflective      : gltfpbr)

`wo` and `wi` point away from the surface; `frame.normal` is the shading
normal flipped toward the viewer; eval_* returns BSDF * |cos wi|.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.core import (EPS, TINY, Material, dot, lerp, mean3, normalize,
                                      reflect, refract, safe_div, safe_sqrt,
                                      squared_length)

PI = 3.141592
INV_PI = 1.0 / PI

LOBE_GLTFPBR = 0
LOBE_REFLECTIVE = 1
LOBE_REFRACTIVE = 2
LOBE_PURE_REFRACTIVE = 3


def _where(mask, a, b):
    """Select with a per-lane (R,) mask over (R,) or (R, 3) values; either
    value may be a Python scalar."""
    ref = a if torch.is_tensor(a) else b
    if ref.dim() > mask.dim():
        mask = mask[:, None]
    if not torch.is_tensor(a):
        a = torch.full_like(ref, a)
    if not torch.is_tensor(b):
        b = torch.full_like(ref, b)
    return torch.where(mask, a, b)


@dataclasses.dataclass(frozen=True)
class ShadeFrame:
    """Local shading frame at a batch of hit points."""

    normal: torch.Tensor      # (R,3) flipped toward viewer
    tangent: torch.Tensor     # (R,3)
    bitangent: torch.Tensor   # (R,3)
    front_face: torch.Tensor  # (R,) bool

    @property
    def outward_normal(self) -> torch.Tensor:
        """Geometric-side normal (Bxdf.cuh:238 `bFrontFace ? normal : -normal`)."""
        return _where(self.front_face, self.normal, -self.normal)


def select_lobe(mat: Material) -> torch.Tensor:
    """(R,) int32 lobe id per the reference's opacity/roughness policy."""
    transparent = mat.opacity < (1.0 - EPS)
    delta = mat.roughness < 1e-2
    lobe = torch.where(transparent,
                       torch.where(delta, LOBE_PURE_REFRACTIVE, LOBE_REFRACTIVE),
                       torch.where(delta, LOBE_REFLECTIVE, LOBE_GLTFPBR))
    return lobe.to(torch.int32)


# --- Fresnel / microfacet building blocks (Bxdf.cuh:49-158) ---

def reflectivity_to_eta(reflectivity: torch.Tensor) -> torch.Tensor:
    """(Bxdf.cuh:53-56); clamped to 0.99 like the reference."""
    sr = safe_sqrt(torch.clamp(reflectivity, 0.0, 0.99))
    return (1.0 + sr) / (1.0 - sr)


def ior_from_specular(specular: torch.Tensor) -> torch.Tensor:
    """(R,) IOR from channel x of specular (CudaUtil.cuh:231)."""
    return reflectivity_to_eta(specular[..., 0])


def fresnel_dielectric(eta, normal, outgoing):
    """(R,) dielectric Fresnel (Bxdf.cuh:59-79)."""
    cosw = torch.abs(dot(normal, outgoing))
    sin2 = 1.0 - cosw * cosw
    eta2 = eta * eta
    cos2t = 1.0 - sin2 / torch.clamp(eta2, min=TINY)
    tir = cos2t < 0.0
    t0 = safe_sqrt(cos2t)
    t1 = eta * t0
    t2 = eta * cosw
    rs = safe_div(cosw - t1, cosw + t1)
    rp = safe_div(t0 - t2, t0 + t2)
    f = (rs * rs + rp * rp) / 2.0
    return _where(tir, 1.0, f)


def fresnel_schlick(specular, normal, outgoing):
    """(R,3) Schlick (Bxdf.cuh:81-87) with the zero-specular early-out."""
    cosine = dot(normal, outgoing, keepdim=True)
    pow5 = torch.clamp(1.0 - torch.abs(cosine), EPS, 0.999) ** 5.0
    f = specular + (1.0 - specular) * pow5
    zero = squared_length(specular, keepdim=True) < EPS
    return torch.where(zero, torch.zeros_like(f), f)


def microfacet_distribution(roughness, normal, halfway):
    """GGX NDF with the reference's 1e-2 divisor clamp (Bxdf.cuh:89-106)."""
    cosine = dot(normal, halfway)
    r2 = roughness * roughness
    c2 = cosine * cosine
    divisor = torch.clamp(c2 * r2 + 1.0 - c2, min=1e-2)
    d = r2 / (PI * divisor * divisor)
    return _where(cosine <= EPS, 0.0, d)


def microfacet_shadowing1(roughness, normal, halfway, direction):
    """Smith GGX single-direction term (Bxdf.cuh:109-129)."""
    cosine = dot(normal, direction)
    cosineh = dot(halfway, direction)
    c2 = cosine * cosine
    r2 = roughness * roughness
    denom = torch.abs(cosine) + safe_sqrt(c2 - r2 * c2 + r2)
    g = 2.0 * torch.abs(cosine) / torch.clamp(denom, min=TINY)
    return _where(cosine * cosineh <= 0.0, 0.0, g)


def microfacet_shadowing(roughness, normal, halfway, outgoing, incoming):
    return (microfacet_shadowing1(roughness, normal, halfway, outgoing)
            * microfacet_shadowing1(roughness, normal, halfway, incoming))


def sample_microfacet(roughness, frame: ShadeFrame, u_phi, u_ry):
    """GGX halfway sample in the shading frame (Bxdf.cuh:140-150)."""
    phi = 2.0 * PI * u_phi
    ry = torch.clamp(u_ry, 0.0, 1.0 - 1e-6)
    theta = torch.atan(roughness * safe_sqrt(ry / (1.0 - ry)))
    st, ct = torch.sin(theta), torch.cos(theta)
    return ((torch.cos(phi) * st)[:, None] * frame.tangent
            + (torch.sin(phi) * st)[:, None] * frame.bitangent
            + ct[:, None] * frame.normal)


def sample_microfacet_pdf(roughness, frame: ShadeFrame, halfway):
    """(Bxdf.cuh:153-158): D * cos, zero below the horizon."""
    cosine = dot(frame.normal, halfway)
    pdf = microfacet_distribution(roughness, frame.normal, halfway) * cosine
    return _where(cosine < 0.0, 0.0, pdf)


def sample_hemisphere_cosine(frame: ShadeFrame, u_phi, u_ct):
    """Cosine-weighted hemisphere in the shading frame (Bxdf.cuh:23-41)."""
    phi = 2.0 * PI * u_phi
    ct = safe_sqrt(u_ct)
    st = safe_sqrt(1.0 - ct * ct)
    return normalize((torch.cos(phi) * st)[:, None] * frame.tangent
                     + (torch.sin(phi) * st)[:, None] * frame.bitangent
                     + ct[:, None] * frame.normal)


# --- Lobe 0: gltfpbr (Bxdf.cuh:160-207) ---

def _reflectivity(mat: Material):
    return lerp(mat.specular, mat.albedo, mat.metallic[:, None])


def eval_gltfpbr(mat: Material, frame: ShadeFrame, wo, wi):
    n = frame.normal
    same_hemi = dot(n, wi) * dot(n, wo) > 0.0
    reflectivity = _reflectivity(mat)
    f1 = fresnel_schlick(reflectivity, n, wo)
    halfway = normalize(wi + wo)
    f = fresnel_schlick(reflectivity, halfway, wi)
    d = microfacet_distribution(mat.roughness, n, halfway)
    g = microfacet_shadowing(mat.roughness, n, halfway, wo, wi)
    k = (1.0 - mat.metallic[:, None]) * (1.0 - f1)
    abs_cos_wi = torch.abs(dot(n, wi, keepdim=True))
    denom = 4.0 * dot(n, wo, keepdim=True) * dot(n, wi, keepdim=True)
    spec = f * (d * g)[:, None] * safe_div(abs_cos_wi, denom)
    diffuse = mat.albedo * k * INV_PI * abs_cos_wi
    return _where(same_hemi, diffuse + spec, 0.0)


def sample_gltfpbr(mat: Material, frame: ShadeFrame, wo, u_lobe, u_phi, u_ry):
    """(Bxdf.cuh:179-194). Zero vector = dead sample (CudaUtil.cuh:335-338)."""
    n = frame.normal
    f_mean = mean3(fresnel_schlick(_reflectivity(mat), n, wo))
    pick_spec = u_lobe < f_mean
    halfway = sample_microfacet(mat.roughness, frame, u_phi, u_ry)
    wi_spec = reflect(wo, halfway)
    bad = dot(n, wi_spec) * dot(n, wo) < -EPS
    wi_spec = _where(bad, 0.0, wi_spec)
    return _where(pick_spec, wi_spec, sample_hemisphere_cosine(frame, u_phi, u_ry))


def pdf_gltfpbr(mat: Material, frame: ShadeFrame, wo, wi):
    n = frame.normal
    same_hemi = dot(n, wi) * dot(n, wo) > 0.0
    halfway = normalize(wo + wi)
    f = mean3(fresnel_schlick(_reflectivity(mat), n, wo))
    pdf_spec = safe_div(sample_microfacet_pdf(mat.roughness, frame, halfway),
                        4.0 * torch.abs(dot(wo, halfway)))
    pdf_diff = dot(n, wi) * INV_PI
    pdf = f * pdf_spec + (1.0 - f) * pdf_diff
    return _where(same_hemi, pdf, 0.0)


# --- Lobe 1: delta reflective (Bxdf.cuh:211-234) ---

def eval_reflective(mat: Material, frame: ShadeFrame, wo, wi):
    n = frame.normal
    same_hemi = dot(n, wi) * dot(n, wo) > 0.0
    reflectivity = _reflectivity(mat)
    f1 = fresnel_schlick(reflectivity, n, wo)
    f = fresnel_schlick(reflectivity, n, wi)
    k = (1.0 - mat.metallic[:, None]) * (1.0 - f1)
    abs_cos_wi = torch.abs(dot(n, wi, keepdim=True))
    val = mat.albedo * k * INV_PI * abs_cos_wi + f * abs_cos_wi
    return _where(same_hemi, val, 0.0)


def sample_reflective(mat: Material, frame: ShadeFrame, wo):
    return reflect(wo, frame.normal)


def pdf_reflective(mat: Material, frame: ShadeFrame, wo, wi):
    return torch.ones_like(wo[:, 0])


# --- Lobe 2: rough refractive (Walter 2007; Bxdf.cuh:236-315) ---

def _refractive_setup(mat: Material, frame: ShadeFrame, wo):
    normal = frame.outward_normal
    entering = dot(normal, wo) >= 0.0
    up_normal = _where(entering, normal, -normal)
    ior = ior_from_specular(mat.specular)
    rel_ior = _where(entering, ior, 1.0 / torch.clamp(ior, min=TINY))
    return normal, entering, up_normal, ior, rel_ior


def _walter_halfway(rel_ior, entering, wi, wo):
    """halfway = -normalize(rel_ior*wi + wo) * (entering ? 1 : -1)."""
    h = -normalize(rel_ior[:, None] * wi + wo)
    return _where(entering, h, -h)


def eval_refractive(mat: Material, frame: ShadeFrame, wo, wi):
    normal, entering, up_normal, _, rel_ior = _refractive_setup(mat, frame, wo)
    reflecting = dot(normal, wi) * dot(normal, wo) >= 0.0
    abs_cos_wi = torch.abs(dot(normal, wi))

    h_r = normalize(wi + wo)
    f_r = fresnel_dielectric(rel_ior, h_r, wo)
    d_r = microfacet_distribution(mat.roughness, up_normal, h_r)
    g_r = microfacet_shadowing(mat.roughness, up_normal, h_r, wo, wi)
    denom_r = torch.abs(4.0 * dot(normal, wo) * dot(normal, wi))
    val_r = f_r * d_r * g_r * safe_div(abs_cos_wi, denom_r)

    h_t = _walter_halfway(rel_ior, entering, wi, wo)
    f_t = fresnel_dielectric(rel_ior, h_t, wo)
    d_t = microfacet_distribution(mat.roughness, up_normal, h_t)
    g_t = microfacet_shadowing(mat.roughness, up_normal, h_t, wo, wi)
    jac_num = dot(wo, h_t) * dot(wi, h_t)
    jac_den = dot(wo, normal) * dot(wi, normal)
    denom_t = rel_ior * dot(h_t, wi) + dot(h_t, wo)
    denom_t = denom_t * denom_t
    val_t = (torch.abs(safe_div(jac_num, jac_den))
             * (1.0 - f_t) * d_t * g_t * safe_div(abs_cos_wi, denom_t))

    return mat.albedo * _where(reflecting, val_r, val_t)[:, None]


def sample_refractive(mat: Material, frame: ShadeFrame, wo, u_lobe, u_phi, u_ry):
    """(Bxdf.cuh:271-288). Zero vector on hemisphere-check failure."""
    normal, entering, up_normal, ior, rel_ior = _refractive_setup(mat, frame, wo)
    halfway = sample_microfacet(mat.roughness, frame, u_phi, u_ry)
    pick_reflect = u_lobe < fresnel_dielectric(rel_ior, halfway, wo)

    wi_r = reflect(wo, halfway)
    bad_r = ~(dot(normal, wo) * dot(normal, wi_r) >= 0.0)
    wi_r = _where(bad_r, 0.0, wi_r)

    inv_eta = _where(entering, 1.0 / torch.clamp(ior, min=TINY), ior)
    wi_t = refract(wo, halfway, inv_eta)
    bad_t = dot(normal, wo) * dot(normal, wi_t) >= 0.0
    wi_t = _where(bad_t, 0.0, wi_t)
    return _where(pick_reflect, wi_r, wi_t)


def pdf_refractive(mat: Material, frame: ShadeFrame, wo, wi):
    normal, entering, up_normal, _, rel_ior = _refractive_setup(mat, frame, wo)
    reflecting = dot(normal, wi) * dot(normal, wo) >= 0.0

    h_r = normalize(wi + wo)
    pdf_r = (fresnel_dielectric(rel_ior, h_r, wo)
             * sample_microfacet_pdf(mat.roughness, frame, h_r)
             * safe_div(torch.ones_like(rel_ior), 4.0 * torch.abs(dot(wo, h_r))))

    h_t = _walter_halfway(rel_ior, entering, wi, wo)
    denom_t = rel_ior * dot(h_t, wi) + dot(h_t, wo)
    denom_t = denom_t * denom_t
    pdf_t = ((1.0 - fresnel_dielectric(rel_ior, h_t, wo))
             * sample_microfacet_pdf(mat.roughness, frame, h_t)
             * safe_div(torch.abs(dot(h_t, wi)), denom_t))
    return _where(reflecting, pdf_r, pdf_t)


# --- Lobe 3: delta refractive (Bxdf.cuh:317-370) ---

def eval_pure_refractive(mat: Material, frame: ShadeFrame, wo, wi):
    normal, entering, up_normal, _, rel_ior = _refractive_setup(mat, frame, wo)
    reflecting = dot(normal, wi) * dot(normal, wo) >= 0.0
    f_r = fresnel_dielectric(rel_ior, normalize(wi + wo), wo)
    h_t = _walter_halfway(rel_ior, entering, wi, wo)
    f_t = fresnel_dielectric(rel_ior, h_t, wo)
    val_t = (1.0 - f_t) / torch.clamp(rel_ior * rel_ior, min=TINY)
    return mat.albedo * _where(reflecting, f_r, val_t)[:, None]


def sample_pure_refractive(mat: Material, frame: ShadeFrame, wo, u_lobe):
    normal, entering, up_normal, ior, rel_ior = _refractive_setup(mat, frame, wo)
    pick_reflect = u_lobe < fresnel_dielectric(rel_ior, up_normal, wo)
    wi_r = reflect(wo, up_normal)
    inv_eta = _where(entering, 1.0 / torch.clamp(ior, min=TINY), ior)
    wi_t = refract(wo, up_normal, inv_eta)
    return _where(pick_reflect, wi_r, wi_t)


def pdf_pure_refractive(mat: Material, frame: ShadeFrame, wo, wi):
    normal, entering, up_normal, _, rel_ior = _refractive_setup(mat, frame, wo)
    reflecting = dot(normal, wi) * dot(normal, wo) >= 0.0
    f_r = fresnel_dielectric(rel_ior, normalize(wi + wo), wo)
    h_t = _walter_halfway(rel_ior, entering, wi, wo)
    f_t = 1.0 - fresnel_dielectric(rel_ior, h_t, wo)
    return _where(reflecting, f_r, f_t)


# --- Branchless dispatch over the four lobes ---

def _select4(lobe, v0, v1, v2, v3):
    return _where(lobe == LOBE_GLTFPBR, v0,
                  _where(lobe == LOBE_REFLECTIVE, v1,
                         _where(lobe == LOBE_REFRACTIVE, v2, v3)))


def eval_bsdfcos(mat: Material, frame: ShadeFrame, wo, wi):
    return _select4(select_lobe(mat),
                    eval_gltfpbr(mat, frame, wo, wi),
                    eval_reflective(mat, frame, wo, wi),
                    eval_refractive(mat, frame, wo, wi),
                    eval_pure_refractive(mat, frame, wo, wi))


def sample_bsdf(mat: Material, frame: ShadeFrame, wo, u_lobe, u_phi, u_ry):
    return _select4(select_lobe(mat),
                    sample_gltfpbr(mat, frame, wo, u_lobe, u_phi, u_ry),
                    sample_reflective(mat, frame, wo),
                    sample_refractive(mat, frame, wo, u_lobe, u_phi, u_ry),
                    sample_pure_refractive(mat, frame, wo, u_lobe))


def pdf_bsdf(mat: Material, frame: ShadeFrame, wo, wi):
    return _select4(select_lobe(mat),
                    pdf_gltfpbr(mat, frame, wo, wi),
                    pdf_reflective(mat, frame, wo, wi),
                    pdf_refractive(mat, frame, wo, wi),
                    pdf_pure_refractive(mat, frame, wo, wi))
