"""The device's idle share of the traced window (1 - busy / window), busy
being the union of the device operations in the trace, summed over the
ranks: how far the host holds the card back on the fused path."""


def read(rec):
    return rec.idle_percent()
