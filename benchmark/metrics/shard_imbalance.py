"""The largest rank's kernel B1 device time over the ranks' mean, in the
traced pass: what the slowest pixel band costs the sharded entry point
(parallel/mesh.py::render_fused_sharded)."""

KERNEL = "pt::bounce_kernel"


def read(rec):
    per = [t.op_seconds(lambda n: KERNEL in n) for t in rec.traces]
    if len(per) < 2 or not all(per):
        return None
    return max(per) / (sum(per) / len(per))
