"""Kernel B2 (csrc/kd_raycast.cu) as a share of its roofline: the least
time of the needed rays' walk over the benchmark's own KD cells at the
cell's parameters (roofline/need.py, b2_ops: a slab test a cell and the
Möller-Trumbore stages over the members of every cell entered before the
hit) over B2's device time in the trace."""

from benchmark import roofline

KERNEL = "pt::kd_walk_kernel"


def kd_table_bytes(cells: int, members: int) -> int:
    """The KD table read once a launch: each member's triangle (36 B) and
    index (4 B), each cell's box (24 B) and member range (8 B)."""
    return members * (36 + 4) + cells * (24 + 8)


def read(rec):
    t = rec.kernel_seconds(KERNEL)
    if not t:
        return None
    need = rec.need()
    paths = rec.traced_paths()
    nbytes = (need["rays"] * paths * (roofline.RAY_BYTES + roofline.HIT_BYTES)
              + rec.kernel_launches(KERNEL) * kd_table_bytes(*need["cells"]))
    return 100.0 * rec.bound_s(need["b2_ops"] * paths, nbytes) / t
