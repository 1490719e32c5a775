"""Kernel B1's KD variant (csrc/bounce_kernel.cu, bounce_kernel_kd) as a
share of its roofline: the least time of the work the traced paths need
(roofline/need.py: b1_ops less the brute-force Möller-Trumbore stages,
b3_ops, plus the KD walk over the benchmark's own frozen cells, b2_ops: a
slab test a cell and the stages over the members of every cell entered
before the hit) over the variant's device time in the trace."""

KERNEL = "pt::bounce_kernel_kd"


def kd_table_bytes(cells: int, members: int) -> int:
    """The KD table read once a launch: each member's triangle (36 B) and
    index (4 B), each cell's box (24 B) and member range (8 B)."""
    return members * (36 + 4) + cells * (24 + 8)


def read(rec):
    t = rec.kernel_seconds(KERNEL)
    if not t:
        return None
    need = rec.need()
    launches = rec.kernel_launches(KERNEL)
    # film slots (3 floats) and the ray count (int64) of each lane, and the
    # KD table, once a launch
    nbytes = launches * (rec.lanes_per_rank() * (12 + 8) + kd_table_bytes(*need["cells"]))
    ops = need["b1_ops"] - need["b3_ops"] + need["b2_ops"]
    return 100.0 * rec.bound_s(ops * rec.traced_paths(), nbytes) / t
