"""Kernel B3 (csrc/mt_closest.cu) as a share of its roofline: the least
time of the needed rays' tests against every triangle (roofline/need.py,
b3_ops: the Möller-Trumbore stages of each live closest-hit ray and each
live hit's shadow ray) over B3's device time in the trace."""

from benchmark import roofline

KERNEL = "pt::mt_closest_kernel"
# a triangle's three vertices, float32, read once a launch
TRI_BYTES = 36


def read(rec):
    t = rec.kernel_seconds(KERNEL)
    if not t:
        return None
    need = rec.need()
    paths = rec.traced_paths()
    nbytes = (need["rays"] * paths * (roofline.RAY_BYTES + roofline.HIT_BYTES)
              + rec.kernel_launches(KERNEL) * len(rec.ctx.arrays["positions"]) * TRI_BYTES)
    return 100.0 * rec.bound_s(need["b3_ops"] * paths, nbytes) / t
