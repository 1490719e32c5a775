"""The device's idle share of the traced window (1 - busy / window), busy
being the union of the device operations in the trace, summed over the
ranks: how far the host holds the card back on the train path. It is read
under the profiler, whose own host cost on this eager path is in it: the
result line's breakdown.windows gives the same slice's untraced wall."""


def read(rec):
    return rec.idle_percent()
