"""Camera paths per second of the eager wavefront (the mesh path): every
path of every completed render of the window, over the time from the
window's start to the end of its last render."""


def read(rec):
    return rec.paths_per_s()
