"""Idle device milliseconds a train step put down to its record: rank 0's
idle time that benchmark/spans.py puts down to a `train.record` span or a
span inside it, over the `train.step` spans. The reading includes the
profiler's host cost (benchmark/spans.py)."""

from benchmark import spans


def read(rec):
    return spans.idle_ms_per(rec, "train.record", "train.step")
