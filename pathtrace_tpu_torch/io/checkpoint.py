"""Checkpoint / resume of accumulation state (port of
pathtrace_tpu/io/checkpoint.py, whose file format it keeps).

The accumulated image, the passes done, the base seed, the samples per
pass and optionally the material tables round-trip through one .npz, so a
long render can resume pass-exactly: with counter-based RNG, resuming at
pass k draws exactly the samples the uninterrupted run would have drawn.
The keys are the JAX package's (accum_image, meta as JSON bytes,
tri_<field> and sph_<field>), so a file written by either package loads in
the other. The file is written to <path>.tmp.npz and renamed over <path>,
so a reader never sees half a file.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from pathtrace_tpu_torch.models.scene import Material
from pathtrace_tpu_torch.utils.profiling import span

FORMAT_VERSION = 1
# Bytes of the checkpoint files save_state wrote in this process.
BYTES_WRITTEN = 0


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_state(path: str, accum_image, passes_done: int, seed: int, spp_per_pass: int,
               tri_mat: Optional[Material] = None, sph_mat: Optional[Material] = None) -> None:
    """Writes the state to `path` (span io.checkpoint; BYTES_WRITTEN counts
    the file's bytes)."""
    global BYTES_WRITTEN
    with span("io.checkpoint"):
        arrays = {
            "accum_image": _numpy(accum_image).astype(np.float32),
            "meta": np.frombuffer(json.dumps({
                "version": FORMAT_VERSION,
                "passes_done": int(passes_done),
                "seed": int(seed),
                "spp_per_pass": int(spp_per_pass),
                "has_materials": tri_mat is not None,
            }).encode(), dtype=np.uint8),
        }
        for prefix, mat in (("tri", tri_mat), ("sph", sph_mat)):
            if mat is not None:
                for f in dataclasses.fields(Material):
                    arrays[f"{prefix}_{f.name}"] = _numpy(getattr(mat, f.name))
        tmp = path + ".tmp"
        np.savez(tmp, **arrays)  # numpy appends .npz
        BYTES_WRITTEN += os.path.getsize(tmp + ".npz")
        os.replace(tmp + ".npz", path)


def load_state(path: str) -> dict:
    """{accum_image (numpy), passes_done, seed, spp_per_pass, tri_mat,
    sph_mat}: the materials as Materials of CPU tensors, or None."""
    z = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(z["meta"]).decode())
    if meta["version"] != FORMAT_VERSION:
        raise ValueError(f"{path}: checkpoint format {meta['version']}, this reader knows "
                         f"{FORMAT_VERSION}")
    out = {"accum_image": z["accum_image"], "passes_done": meta["passes_done"],
           "seed": meta["seed"], "spp_per_pass": meta["spp_per_pass"],
           "tri_mat": None, "sph_mat": None}
    if meta.get("has_materials"):
        fields = [f.name for f in dataclasses.fields(Material)]
        for prefix in ("tri", "sph"):
            if f"{prefix}_{fields[0]}" in z:
                out[f"{prefix}_mat"] = Material(
                    **{f: torch.from_numpy(z[f"{prefix}_{f}"]) for f in fields})
    return out
