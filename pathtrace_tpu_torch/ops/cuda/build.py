"""Build the CUDA kernels of this package with nvcc, at first use.

The sources are the package's csrc/*.cu and csrc/*.cuh and nothing else.
Each .cu is compiled to an object by its own nvcc process, all started
together, and one more nvcc links them into a shared library (a plain C
interface, loaded with ctypes) under pathtrace_tpu_torch/_build/, named by
a hash of the sources and the flags, so an edit rebuilds and an unchanged
tree reuses the library.
Importing this module runs nothing: `load_library()` builds on its first
call. nvcc comes from $CUDA_HOME/bin, else PATH, else /usr/local/cuda/bin.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

# No --use_fast_math: IEEE division, sqrt and denormals, as the eager torch
# version computes them. -fmad=false keeps a*b+c as two roundings, so the
# kernel rounds like the eager version; whether contraction may come back
# is a performance question for later.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


def sources() -> list[str]:
    """The .cu sources compiled into the library (headers are hashed too)."""
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith(".cu"))


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of pathtrace_tpu_torch are built at first use")


def compile_command(nvcc: str, source: str, obj_path: str) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-c", "-o", obj_path, source]


def link_command(nvcc: str, objects: list[str], out_path: str) -> list[str]:
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", out_path,
            *objects]


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libpathtrace_{_digest()}.so")


def _run_all(commands: list[list[str]]) -> list[tuple[int, str]]:
    """Run the commands concurrently; (return code, stdout + stderr) each."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in commands]
    return [(p.returncode, out) for p, out in ((p, p.communicate()[0]) for p in procs)]


def build() -> str:
    """Compile the library unless this source hash is already built; the
    compilers' output (-Xptxas -v: registers, shared memory, spills) is
    kept beside it as <library>.log. Returns the library path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = sources()
        objs = [os.path.join(tmp, os.path.basename(src) + ".o") for src in srcs]
        results = _run_all([compile_command(nvcc, s, o) for s, o in zip(srcs, objs)])
        lib_tmp = os.path.join(tmp, "lib.so")
        if all(rc == 0 for rc, _ in results):
            results += _run_all([link_command(nvcc, objs, lib_tmp)])
        names = [os.path.basename(s) for s in srcs] + ["link"]
        log = "".join(f"== {name}\n{out}" for name, (_, out) in zip(names, results))
        with open(path + ".log", "w") as f:
            f.write(log)
        if any(rc != 0 for rc, _ in results):
            raise RuntimeError(f"nvcc failed:\n{log}")
        os.replace(lib_tmp, path)  # atomic: a concurrent build never sees half a file
    return path


def check_tensor(name: str, x, dtype, shape: tuple, dev) -> None:
    """Raise unless x is a contiguous `dtype` tensor on `dev` whose shape
    matches `shape` (None entries match any size): what a kernel wrapper
    checks before it hands x's pointer to a launch."""
    if x.device != dev or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on {dev}, got "
                         f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})")
    if x.dim() != len(shape) or any(s is not None and s != n for s, n in zip(shape, x.shape)):
        raise ValueError(f"{name}: need shape {shape}, got {tuple(x.shape)}")


def load_library() -> ctypes.CDLL:
    """The built library, compiled on first call in this process."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build())
    return _lib
