"""Build the CUDA kernels of this package with nvcc, at first use.

The sources are the package's csrc/*.cu and csrc/*.cuh and nothing else.
The shared library (a plain C interface, loaded with ctypes) goes to
pathtrace_tpu_torch/_build/, named by a hash of the sources and the
command, so an edit rebuilds and an unchanged tree reuses the library.
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
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def nvcc_command(nvcc: str, out_path: str) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", out_path, *sources()]


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


def build() -> str:
    """Compile the library unless this source hash is already built; the
    compiler's output (-Xptxas -v: registers, shared memory, spills) is
    kept beside it as <library>.log. Returns the library path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(find_nvcc(), tmp), capture_output=True,
                              text=True, check=False)
        with open(path + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)  # atomic: concurrent builders never see half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load_library() -> ctypes.CDLL:
    """The built library, compiled on first call in this process."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build())
    return _lib
