"""Camera paths per second of the fused engine: every path of every
completed image (or pass) of the window, over the time from the window's
start to the end of its last unit."""


def read(rec):
    return rec.paths_per_s()
