"""Kernel B1 (csrc/bounce_kernel.cu) as a share of its roofline: the least
time of the work the traced paths need (roofline/need.py, b1_ops: the
Möller-Trumbore stages of every needed ray, a sphere test a ray, one
shading a hit, NEE's BSDF term a visible light sample) over B1's device
time in the trace, summed over the ranks."""

KERNEL = "pt::bounce_kernel"


def read(rec):
    t = rec.kernel_seconds(KERNEL)
    if not t:
        return None
    need = rec.need()
    launches = rec.kernel_launches(KERNEL)
    # film slots (3 floats) and the ray count (int64) of each lane, once a launch
    nbytes = launches * rec.lanes_per_rank() * (12 + 8)
    return 100.0 * rec.bound_s(need["b1_ops"] * rec.traced_paths(), nbytes) / t
