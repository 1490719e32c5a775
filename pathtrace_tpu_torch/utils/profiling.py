"""Timing and tracing (port of pathtrace_tpu/utils/profiling.py:21-87).

The reference's only telemetry is millisecond prints per pass
(pathtracer.cu:234-248) and an occupancy query (:227). Here:
- Timer: wall-clock scopes that synchronize the device of a tensor before
  they stop the clock (PyTorch returns before a CUDA device finishes);
- RayMeter: paths/s and rays/s from the engines' counts;
- trace(): a torch.profiler scope that writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Optional

import torch


def _sync(x) -> None:
    """Wait for the device work behind every CUDA tensor in x (a tensor or
    a nest of lists, tuples and dicts)."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _sync(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _sync(v)


class Timer:
    """Wall-clock scope timing with an optional device sync."""

    def __init__(self):
        self.laps: dict = {}

    @contextlib.contextmanager
    def scope(self, name: str, sync_on=None):
        """Times the block; the devices of sync_on (a tensor, or a nest of
        them, as jax.block_until_ready takes) are synchronized before the
        clock stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(sync_on)
            self.laps.setdefault(name, []).append(time.perf_counter() - t0)

    def mean(self, name: str) -> float:
        laps = self.laps.get(name, [])
        return sum(laps) / max(len(laps), 1)

    def report(self) -> str:
        return "\n".join(
            f"{k}: n={len(v)} mean={sum(v) / len(v) * 1e3:.2f}ms total={sum(v):.3f}s"
            for k, v in self.laps.items())


@dataclass
class RayMeter:
    """Accumulates path and ray counts and elapsed seconds."""

    paths: float = 0.0
    rays: float = 0.0
    seconds: float = 0.0

    def add(self, num_paths: float, num_rays: float, seconds: float) -> None:
        self.paths += num_paths
        self.rays += num_rays
        self.seconds += seconds

    @property
    def paths_per_sec(self) -> float:
        return self.paths / max(self.seconds, 1e-12)

    @property
    def rays_per_sec(self) -> float:
        return self.rays / max(self.seconds, 1e-12)

    def summary(self) -> dict:
        return {
            "paths_per_sec": self.paths_per_sec,
            "rays_per_sec": self.rays_per_sec,
            "rays_per_path": self.rays / max(self.paths, 1.0),
            "seconds": self.seconds,
        }


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """torch.profiler over the block (CPU, and CUDA when a card is
    present); its Chrome trace goes to log_dir/trace.json (open it in
    chrome://tracing or Perfetto). Yields the profiler, or None and
    profiles nothing when log_dir is None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
