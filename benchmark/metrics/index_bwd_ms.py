"""Device milliseconds a train step spends in PyTorch's index backward:
the replay's gathers of materials and attributes, whose backward is
index_put_ with accumulation, by the names the profiler prints: the
accumulating kernels (indexing_backward_kernel*) and the radix sort of the
indices that runs just before each. A sort that some other kernel follows
is not theirs (the replay's own sort of the paths by length) and is not
counted; a memset between the sort's kernels does not break the run."""

BACKWARD = "indexing_backward"
SORT = "RadixSort"
NEUTRAL = "Memset"


def index_backward_s(events) -> float:
    """Seconds of the index backward's kernels and their sorts in one
    rank's device operations (name, start_us, end_us), in start order."""
    total, sorts = 0.0, 0.0
    for name, s, e in events:
        if SORT in name:
            sorts += e - s
        elif BACKWARD in name:
            total += e - s + sorts
            sorts = 0.0
        elif not name.startswith(NEUTRAL):
            sorts = 0.0
    return total / 1e6


def read(rec):
    if not rec.units:
        return None
    s = sum(index_backward_s(t.events) for t in rec.traces)
    return 1e3 * s / len(rec.units) if s else None
