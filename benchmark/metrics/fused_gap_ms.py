"""Idle device milliseconds an image put down to the fused driver: rank 0's
idle time that benchmark/spans.py puts down to a `fused.render` span or a
span inside it (the chunk loop, the pack, B1's launches, the ray-count
reads), over the `fused.render` spans. Idle time between images, in the
harness, is not the driver's and is left out. The reading includes the
profiler's host cost (benchmark/spans.py)."""

from benchmark import spans


def read(rec):
    return spans.idle_ms_per(rec, "fused.render", "fused.render")
