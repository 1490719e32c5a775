"""The native SAH BVH builder (native/bvh_builder.cpp), loaded with ctypes
(port of pathtrace_tpu/native/__init__.py:25-92).

bvh_builder.cpp is a copy of the JAX package's, with one change: it
computes the split cost in double, as accel/bvh.py's numpy builder does,
so the two build the same arrays also where two costs nearly tie (the
tests hold them equal). g++ compiles it at first use into pathtrace_tpu_torch/_build/ (not
beside the source), named by a hash of the source and the flags; importing
this module builds nothing. Where no g++ exists, get_lib() returns None and
accel/bvh.py's backend="auto" takes the numpy builder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bvh_builder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
LIB_PREFIX = "libbvh_builder_"
# No -march=native (the JAX package's flag): the build directory may be
# copied to another machine, where a library tuned for this CPU could fault;
# and no contraction into FMA, which would round the costs otherwise than
# numpy does.
GXX_FLAGS = ("-O2", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lock = threading.Lock()


def library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"{LIB_PREFIX}{h.hexdigest()[:16]}.so")


def _compile() -> str | None:
    """The library's path, compiled unless this source is built already;
    None when g++ is missing or fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, SRC, "-o", tmp], check=True, capture_output=True,
                       timeout=120)
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    return path


def get_lib():
    """The loaded builder library, or None if it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            path = _compile()
            if path is None:
                return None
            lib = ctypes.CDLL(path)
            lib.pt_build_bvh.restype = ctypes.c_int64
            lib.pt_build_bvh.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ]
            _lib = lib
        return _lib


def build_bvh_native(positions: np.ndarray, leaf_size: int = 4):
    """C++ SAH build of (T, 3, 3) float32 positions: (bmin, bmax, next_hit,
    next_miss, prim_start, prim_count, prim_order, max_depth) as numpy
    arrays, or None if the library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    t = positions.shape[0]
    tris = np.ascontiguousarray(positions.reshape(t, 9), np.float32)
    cap = max(2 * t, 1)  # a binary tree over t leaves' prims has < 2t nodes
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    next_hit = np.empty(cap, np.int32)
    next_miss = np.empty(cap, np.int32)
    prim_start = np.empty(cap, np.int32)
    prim_count = np.empty(cap, np.int32)
    prim_order = np.empty(t, np.int64)
    max_depth = np.zeros(1, np.int32)

    def p(a, ty):
        return a.ctypes.data_as(ctypes.POINTER(ty))

    n = int(lib.pt_build_bvh(
        p(tris, ctypes.c_float), t, leaf_size,
        p(bmin, ctypes.c_float), p(bmax, ctypes.c_float),
        p(next_hit, ctypes.c_int32), p(next_miss, ctypes.c_int32),
        p(prim_start, ctypes.c_int32), p(prim_count, ctypes.c_int32),
        p(prim_order, ctypes.c_int64), p(max_depth, ctypes.c_int32)))
    return (bmin[:n], bmax[:n], next_hit[:n], next_miss[:n], prim_start[:n],
            prim_count[:n], prim_order, int(max_depth[0]))
