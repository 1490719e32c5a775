"""Seconds per gradient step: the window's time to the end of its last
step, over the steps completed."""


def read(rec):
    return rec.window_s() / len(rec.units) if rec.units else None
