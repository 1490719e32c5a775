"""Host milliseconds a pass spends writing its output: the `io.png`
(io/image.py::write_png) and `io.checkpoint` (io/checkpoint.py::save_state)
spans of the traced slice, over its passes. The reading includes the
profiler's host cost (benchmark/spans.py)."""

from benchmark import spans

NAMES = ("io.png", "io.checkpoint")


def read(rec):
    recs = spans.program_records()
    if recs is None or not rec.units:
        return None
    ns = sum(s.end_ns - s.start_ns for s in recs if s.name in NAMES and s.end_ns is not None)
    return ns / 1e6 / len(rec.units) if ns else None
