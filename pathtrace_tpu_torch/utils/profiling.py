"""Spans at the port's layer boundaries, and the Chrome-trace exporter
(port of pathtrace_tpu/utils/profiling.py:21-87, whose Timer and RayMeter
had no caller and are not carried over).

The reference's only telemetry is millisecond prints per pass
(pathtracer.cu:234-248) and an occupancy query (:227). Here:
- span(name, **counts): a host-side scope stamped with time.time_ns(),
  the clock torch.profiler's own events are on. Spans record only while
  a torch profiler runs; otherwise span() returns one shared null handle
  after one flag test. A span never synchronises,
  reads a tensor or adds a device operation; its counts are integers the
  host already holds;
- records() / clear(): the store, one flat list of Span records in the
  order they opened. A record's parent and root are indices into it, from
  a per-thread stack, so the spans of one unit of work (an image, a step)
  share their root;
- trace(log_dir): torch.profiler over a block, its Chrome trace written to
  log_dir/trace.json with the block's spans beside the profiler's events.

The spans, by layer (PERF.md names the metric that reads each):
- fused driver: fused.render (root), fused.pack, render.chunk, b1.launch
  (lanes, spp), fused.read_rays;
- eager wavefront: wavefront.render (root), render.chunk,
  wavefront.iteration (index) holding wavefront.bounce, wavefront.commit,
  wavefront.regen and wavefront.sync (its one host read), b2.launch and
  b3.launch around the kernels' calls;
- train step: train.step (root), train.record (the recording sweep),
  train.replay holding train.sort and replay.chunk (depth, paths), which
  holds replay.forward and replay.backward;
- a render's output: io.png (io/image.py::write_png) and io.checkpoint
  (io/checkpoint.py::save_state), roots where `cli render` writes a pass.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _torch_profiler


class Span:
    """One record: name, [start_ns, end_ns] on time.time_ns() (end_ns is
    None while open), its own index and those of its parent (-1 for a root)
    and root in records(), the opening thread's native id, and integer
    counts."""

    __slots__ = ("name", "start_ns", "end_ns", "index", "parent", "root", "tid", "counts",
                 "_store")

    def __init__(self, name, index, parent, root, tid, counts, store):
        self.name, self.index, self.parent, self.root, self.tid = name, index, parent, root, tid
        self.counts, self._store = counts, store
        self.end_ns = None
        self.start_ns = time.time_ns()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        _stack().pop()
        return False


class _Null:
    """The handle span() returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()
_store: list = []
_lock = threading.Lock()  # a span's index is the store's length as it joins
_local = threading.local()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        _local.tid = threading.get_native_id()
        return _local.stack


def span(name: str, **counts):
    """A context manager recording `name` over its block, with integer
    counts. Records while a torch profiler runs."""
    if not _torch_profiler._is_profiler_enabled:
        return _NULL
    stack = _stack()
    top = stack[-1] if stack else None
    with _lock:
        store = _store
        index = len(store)
        if top is not None and top._store is store:
            parent, root = top.index, top.root
        else:  # a root, or a span whose parent opened before the last clear()
            parent, root = -1, index
        sp = Span(name, index, parent, root, _local.tid, counts, store)
        store.append(sp)
    stack.append(sp)
    return sp


def records() -> list:
    """The spans recorded since the last clear(), in the order they opened."""
    return list(_store)


def clear() -> None:
    """Empties the store; spans open now record no parent in the next one."""
    global _store
    _store = []


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """torch.profiler over the block (CPU, and CUDA when a card is
    present); its Chrome trace goes to log_dir/trace.json (open it in
    chrome://tracing or Perfetto), the block's spans in it as complete
    events of category "span" on the profiler's clock. Yields the profiler,
    or None and profiles nothing when log_dir is None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear()
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    doc["traceEvents"].extend(
        {"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": s.tid,
         "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": dict(s.counts)}
        for s in records() if s.end_ns is not None)
    with open(path, "w") as f:
        json.dump(doc, f)
