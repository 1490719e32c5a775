"""The least time a kernel's work could take on one H100, counted by the
benchmark's own frozen code (a copy of the port's profile_main model) on
its plain reference's paths, never from the program's counters.

A kernel's share of its roofline is bound / measured device time, where
the bound is the larger of its FP32 operations at FP32_PEAK and its bytes
(each input read once, each output written once) at HBM_RATE. The work is
what the paths need: rays of live lanes only, each Möller-Trumbore test
charged only the stages its pair reaches. `Need` counts it per camera path
over a fixed sample of a cell's paths (benchmark/roofline/need.py); the
metric scales it by the paths the traced slice rendered.
"""

from __future__ import annotations

# One H100 SXM, NVIDIA's data sheet: FP32 outside the tensor cores and HBM3,
# both at the full 700 W power limit. The card's own limit is printed beside
# every traced result (device.power_limit).
FP32_PEAK = 67e12   # operations/s
HBM_RATE = 3.35e12  # bytes/s

# FP32 operations of one Möller-Trumbore test, stage by stage, each needed
# only where the one before passed: p = dir x e2 and det (14); tvec and u
# where det >= EPS (8); q, v and u + v where 0 <= u <= det (15); 1/det and
# t where v >= 0 and u + v <= det (7). One ray-sphere test; one ray-cell
# slab test. Integer work (Philox) is not counted: the bound stays a least
# time.
MT_STAGE_OPS = (14, 8, 15, 7)
SPHERE_OPS, SLAB_OPS = 28, 12
# One bounce's shading of a gltfpbr surface (the room's walls), counted by
# hand from the port's csrc/bsdf.cuh and csrc/bounce_kernel.cu as of this
# benchmark: + - * / and sqrt count 1, and so does each special function;
# comparisons, selects, min, max and abs count 0. SHADE_PARTS is charged to
# every shaded hit; NEE_VISIBLE_PARTS only to a hit whose shadow ray
# reaches the sampled light.
SHADE_PARTS = {
    "hit frame (barycentric interpolation, three normalizes, hit point)": 90,
    "emission test": 5,
    "NEE light sample": 41,
    "sample_gltfpbr (Fresnel mean 34, cosine hemisphere 34)": 68,
    "eval_gltfpbr": 147,
    "pdf_gltfpbr": 84,
    "dead-sample test": 5,
    "weight, next ray, Russian roulette": 25,
}
NEE_VISIBLE_PARTS = {"cos_a and pdf": 20, "eval_gltfpbr": 147, "contribution": 16}
SHADE_OPS = sum(SHADE_PARTS.values())              # 465
NEE_VISIBLE_OPS = sum(NEE_VISIBLE_PARTS.values())  # 183
RAY_BYTES = 32  # org, dir, t_min, t_max: float32
HIT_BYTES = 17  # hit (1), t, u, v, idx (4 each)


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(bound in seconds, "operations" or "bytes"): the larger of the two."""
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def mt_pair_ops(table, org, dirn, eps: float = 1e-4):
    """(R,) float64: the operations the tests of each ray against the rows
    [v0 | e1 | e2] of `table` need, stage by stage."""
    import torch

    from benchmark.reference.core import cross

    v0, e1, e2 = (table[None, :, i:i + 3] for i in (0, 3, 6))
    rows = max(1, (1 << 22) // max(table.shape[0], 1))
    out = []
    a, b, c, e = MT_STAGE_OPS
    for i in range(0, org.shape[0], rows):
        o, d = org[i:i + rows, None, :], dirn[i:i + rows, None, :]
        p = cross(d.expand(-1, table.shape[0], -1), e2.expand(d.shape[0], -1, -1))
        det = (p * e1).sum(-1)
        tvec = o - v0
        u = (p * tvec).sum(-1)
        v = (cross(tvec, e1.expand_as(tvec)) * d).sum(-1)
        s1 = det >= eps
        s2 = s1 & (u >= 0) & (u <= det)
        s3 = s2 & (v >= 0) & (u + v <= det)
        out.append((a + b * s1.double() + c * s2.double() + e * s3.double()).sum(-1))
    return torch.cat(out) if out else torch.zeros((0,), dtype=torch.float64, device=org.device)
