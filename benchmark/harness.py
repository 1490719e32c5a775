"""One run of one cell: set-up, the measured window (or the traced slice),
the check against the plain reference, and the result line.

Everything that belongs to a cell is found by name:
- BENCHMARK.json's workload names its configuration, traffic and chips;
- benchmark/configs/<config>.json holds the scene and integrator settings;
- benchmark/traffic/<traffic>.json holds the entry point, film, spp,
  chunking, lanes, the unit of work, the traced slice and the check;
- benchmark/entries/<entry>.py drives the program's entry point;
- benchmark/metrics/<metric>.py reads one metric from the run's record.

A unit of work p (an image, a step, a pass) is keyed
iter_key(make_key(seed), 1000 + p), as `cli render` keys pass p; the
warm-up unit is keyed 999.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

from benchmark import compare, roofline, scenes
from benchmark.reference import core
from benchmark.trace import DeviceTrace, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "pathtrace_tpu")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list   # BENCHMARK.json metric entries this cell reports
    per_layer: list


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, bench_path: str = None, traffic_overrides: dict = None) -> Cell:
    bench = _json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = _json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    traffic.update(traffic_overrides or {})
    e2e = [m for m in bench["end_to_end"] if applies(m, workload)]
    layer = [m for m in bench["per_layer"] if applies(m, workload)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, layer)


@dataclasses.dataclass
class Ctx:
    """What an entry and the check see of a run."""

    config: dict
    traffic: dict
    arrays: dict
    device: torch.device
    rank: int
    world: int


def unit_key(seed: int, p: int) -> tuple:
    return core.iter_key(core.make_key(seed), 1000 + p)


class Record:
    """The run as the metric readers see it."""

    def __init__(self, cell: Cell, ctx: Ctx, setup_s, units, traces, need_fn):
        self.cell, self.ctx = cell, ctx
        self.traffic = cell.traffic
        self.setup_s = setup_s
        self.units = units        # (start_s, end_s, paths), window-relative host clock
        self.traces = traces      # one DeviceTrace a rank (traced run)
        self._need_fn, self._need = need_fn, None

    def window_s(self) -> float:
        return self.units[-1][1]

    def paths_per_s(self):
        return sum(u[2] for u in self.units) / self.window_s() if self.units else None

    def traced_paths(self) -> int:
        return sum(u[2] for u in self.units)

    def lanes_per_rank(self) -> int:
        return self.traffic["lanes"] // self.ctx.world

    def op_seconds(self, match) -> float:
        return sum(t.op_seconds(match) for t in self.traces)

    def kernel_seconds(self, kernel: str) -> float:
        return self.op_seconds(lambda n: kernel in n)

    def kernel_launches(self, kernel: str) -> int:
        return sum(t.op_count(lambda n: kernel in n) for t in self.traces)

    def idle_percent(self):
        if not self.traces:
            return None
        busy = sum(t.busy_s() for t in self.traces)
        return 100.0 * (1.0 - busy / sum(t.window_s for t in self.traces))

    def need(self) -> dict:
        if self._need is None:
            self._need = self._need_fn()
        return self._need

    def bound_s(self, ops: float, nbytes: float) -> float:
        return roofline.bound(ops, nbytes)[0]


def need_counts(ctx: Ctx, key, stride: int) -> dict:
    """Per-path work of the cell's paths on the plain reference: sample 0 of
    every `stride`-th pixel, keyed as the first traced unit."""
    from benchmark.roofline.kd import build_cells
    from benchmark.roofline.need import Need
    from benchmark.reference import tracer

    scene, camera, cfg = compare.reference_setup(ctx)
    cells = None
    if ctx.traffic.get("kd_max_tris"):
        cells = build_cells(ctx.arrays["positions"], ctx.traffic["kd_max_tris"]).to(ctx.device)
    need = Need(scene.search_table, cells)
    ids = torch.arange(0, camera.num_pix, stride, dtype=torch.int64, device=ctx.device)
    with torch.no_grad():
        for i in range(0, ids.numel(), 1 << 16):
            tracer.trace(scene, camera, cfg, key, ids[i:i + (1 << 16)], observe=need.observe,
                         on_bounce=need.on_bounce)
    out = need.per_path(ids.numel(), scene.num_spheres)
    out["cells"] = (cells.num_cells, cells.num_members) if cells else (0, 0)
    return out


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _finite(out) -> bool:
    vals = [v for v in out.values() if torch.is_tensor(v)]
    vals += [v for v in out.get("grads", {}).values()]
    return all(bool(torch.isfinite(v).all()) for v in vals)


def keep(out: dict, spp: int, rank: int) -> dict:
    """What the check needs of a unit's output, with the spp it ran at:
    rank 0 keeps it in host memory, so that the card's peak is the
    program's; the other ranks keep nothing (rank 0 holds the gathered
    answers)."""
    if rank != 0:
        return {"spp": spp}
    host = lambda v: v.detach().cpu() if torch.is_tensor(v) else {k: x.detach().cpu()
                                                                  for k, x in v.items()}
    return {**{k: host(v) for k, v in out.items()}, "spp": spp}


def run(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        device: str = "cuda", rank: int = 0, world: int = 1, port: int = 0,
        traffic_overrides: dict = None, bench_path: str = None, wrap_unit=None):
    """Run one cell once on this rank; rank 0 returns (result dict, check
    lines), the other ranks None. wrap_unit(unit) may replace the timed
    unit (the fault tests, benchmark/tests)."""
    cell = load_cell(workload, bench_path, traffic_overrides)
    tr = cell.traffic
    if world > 1:
        dev = torch.device(device, rank) if device == "cuda" else torch.device("cpu")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        torch.distributed.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                             init_method=f"tcp://localhost:{port}",
                                             world_size=world, rank=rank)
    else:
        dev = torch.device(device)
    ctx = Ctx(cell.config, tr, scenes.scene_arrays(cell.config), dev, rank, world)
    unit = load_module("entries", tr["entry"]).setup(ctx)
    if wrap_unit is not None:
        unit = wrap_unit(unit)
    unit(unit_key(seed, -1), tr["warmup_spp"])
    _sync(dev)
    if world > 1:
        torch.distributed.barrier()
    setup_s = time.perf_counter() - t_start

    pix_paths = tr["width"] * tr["height"]
    outputs, keys, units = [], [], []
    traces = []
    if not trace:
        spp = tr["spp"]
        w0 = time.perf_counter()
        go = True
        while go:
            p = len(outputs)
            s = time.perf_counter() - w0
            out = unit(unit_key(seed, p), spp)
            _sync(dev)
            e = time.perf_counter() - w0
            outputs.append(keep(out, spp, rank))
            keys.append(unit_key(seed, p))
            units.append((s, e, pix_paths * spp))
            go = e < seconds
            if world > 1:
                flag = torch.tensor([int(go)], device=dev)
                torch.distributed.broadcast(flag, 0)
                go = bool(flag.item())
    else:
        spp = tr["traced"]["spp"]

        def traced(record=True):
            w0 = time.perf_counter()
            for p in range(tr["traced"]["units"]):
                s = time.perf_counter() - w0
                out = unit(unit_key(seed, p), spp)
                _sync(dev)
                if record:
                    outputs.append(keep(out, spp, rank))
                    keys.append(unit_key(seed, p))
                    units.append((s, time.perf_counter() - w0, pix_paths * spp))
            return time.perf_counter() - w0

        if dev.type != "cuda":
            raise RuntimeError("a traced run needs a CUDA device: the profiler has no device "
                               "to trace")
        # the same slice first without the profiler: the traced window less
        # this one is what the profiler itself costs the host
        untraced_s = traced(record=False)
        _, t = profile(traced, dev)
        traces = [t]

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = sum(not _finite(o) for o in outputs)
    if world > 1:
        mine = {"peak": peak, "trace": traces[0] if traces else None,
                "untraced_s": untraced_s if trace else None}
        got = [None] * world
        torch.distributed.all_gather_object(got, mine)
        peak = max(g["peak"] for g in got)
        traces = [g["trace"] for g in got if g["trace"] is not None]
        if trace:
            untraced_s = sum(g["untraced_s"] for g in got) / world
        torch.distributed.destroy_process_group()
    del unit
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rank != 0:
        return None

    t_check = time.perf_counter()
    nums = compare.check(ctx, outputs, keys, seed)
    timings = [f"[timing] set-up {setup_s:.3f} s, window {units[-1][1]:.3f} s over "
               f"{len(units)} units, reference check {time.perf_counter() - t_check:.3f} s"]
    stride = tr["roofline_sample"]["pixel_stride"]
    rec = Record(cell, ctx, setup_s, units, traces, lambda: need_counts(ctx, keys[0], stride))
    group = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in group:
        v = load_module("metrics", m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": world, "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        device_info["power_limit"] = power_limit()
    result = {"correct": compare.correct(nums), "attempted": len(outputs), "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = sum(t.busy_s() for t in traces) / len(traces)
        device_info["window_s"] = sum(t.window_s for t in traces) / len(traces)
        merged = DeviceTrace([e for t in traces for e in t.events], traces[0].window_s)
        # the idle share is read under the profiler; "windows" gives the same
        # slice's time without it, so that the profiler's own cost shows
        result["breakdown"] = {"device_ops": merged.top_ops(10),
                               "idle_gaps": traces[0].idle_gaps(10),
                               "windows": [["traced", device_info["window_s"]],
                                           ["untraced", untraced_s]]}
        timings.append(f"[timing] traced slice {device_info['window_s']:.3f} s, the same "
                       f"slice untraced {untraced_s:.3f} s")
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in nums.items()}
    lines = timings + [f"check {k}: {v!r} (limit {lim!r})" for k, (v, lim) in nums.items()]
    return result, lines


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "unavailable"
    return out.splitlines()[0].strip() if out.strip() else "unavailable"
