"""Host milliseconds a train step spends in its recording sweep: the
`train.record` spans (diff/wavetape.py), which close after the sweep's
last host read, so the device's sweep is done by then, over the
`train.step` spans. The reading includes the profiler's host cost
(benchmark/spans.py): each eager launch of the sweep is slower traced."""

from benchmark import spans


def read(rec):
    recs = spans.program_records()
    if recs is None:
        return None
    steps = sum(1 for s in recs if s.name == "train.step")
    ns = sum(s.end_ns - s.start_ns for s in recs
             if s.name == "train.record" and s.end_ns is not None)
    return ns / 1e6 / steps if steps and ns else None
