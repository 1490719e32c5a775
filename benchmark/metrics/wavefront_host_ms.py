"""Host milliseconds of one bounce iteration of the eager wavefront: the
mean length of the `wavefront.iteration` spans (integrator/wavefront.py),
each the bounce's eager launches, the commit, the regeneration and the
iteration's one host read of whether a lane is alive. The reading
includes the profiler's host cost (benchmark/spans.py): each of the
iteration's ~4,000 eager launches is slower traced."""

from benchmark import spans


def read(rec):
    recs = spans.program_records()
    if recs is None:
        return None
    its = [s.end_ns - s.start_ns for s in recs
           if s.name == "wavefront.iteration" and s.end_ns is not None]
    return sum(its) / len(its) / 1e6 if its else None
