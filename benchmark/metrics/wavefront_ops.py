"""Device operations a bounce iteration of the eager wavefront launches:
rank 0's operations that start inside `wavefront.iteration` spans on the
aligned clock (benchmark/spans.py), over the iterations. A count: the
profiler's host cost does not move it."""

from benchmark import spans


def read(rec):
    n = spans.ops_in(rec, "wavefront.iteration")
    recs = spans.program_records()
    if n is None or recs is None:
        return None
    its = sum(1 for s in recs if s.name == "wavefront.iteration")
    return n / its if its else None
