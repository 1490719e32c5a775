"""Milliseconds to a finished image, the 90th percentile (nearest rank)
over every image of the window."""

import math


def read(rec):
    if not rec.units:
        return None
    ms = sorted((e - s) * 1e3 for s, e, _ in rec.units)
    return ms[max(0, math.ceil(0.9 * len(ms)) - 1)]
