"""The port's spans (utils/profiling.py), on the CPU, and one card test.

- Off, span() records nothing and hands out one shared null handle; under
  a torch profiler it records name, times on time.time_ns(), parent, root
  and counts, with a stack per thread, and stops when the profiler stops.
  The CPU tests record under a CPU-only profiler (`recording()`).
- The paths record their closed list of spans: the wavefront one
  wavefront.iteration a bounce iteration with one host read each (and one
  read before the first), the fused driver's chunks under fused.render,
  and the train step train.record, train.replay and one replay.chunk a
  chunk at the taped depth. Spans change no result.
- trace() and `cli render --trace DIR` write the spans into trace.json
  inside the profiler's events' time range.
- On the card (marker `gpu`): under the benchmark's own profile(), the
  spans align to the device trace by B1's launches, and the idle time of
  a 2 ms sleep between them is put down to the sleep's span.

This file imports no JAX: run its card test with
python -m pytest tests/test_torch_spans.py --noconftest -q.
"""

import json
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pathtrace_tpu_torch import cli
from pathtrace_tpu_torch.diff.wavetape import _WRT_BIT, record_paths_wavefront
from pathtrace_tpu_torch.integrator.config import IntegratorConfig
from pathtrace_tpu_torch.integrator.wavefront import render_wavefront_chunked
from pathtrace_tpu_torch.models import procedural
from pathtrace_tpu_torch.ops.cuda.bounce_kernel import render_wavefront_fused
from pathtrace_tpu_torch.parallel.mesh import train_step_wavetape
from pathtrace_tpu_torch.utils import profiling, rng

torch.set_num_threads(1)

WAVEFRONT = {"wavefront.render", "render.chunk", "wavefront.iteration", "wavefront.bounce",
             "wavefront.commit", "wavefront.regen", "wavefront.sync"}
TRAIN = {"train.step", "train.record", "train.replay", "train.sort", "replay.chunk",
         "replay.forward", "replay.backward"}


@pytest.fixture(autouse=True)
def empty_store():
    profiling.clear()
    yield
    profiling.clear()


def names(recs) -> list:
    return [s.name for s in recs]


def recording():
    """A torch profiler of the CPU alone: spans record while it runs."""
    return profile(activities=[ProfilerActivity.CPU])


def test_off_records_nothing():
    h = profiling.span("x", n=1)
    with h as got:
        pass
    assert got is h and profiling.span("y") is h
    assert profiling.records() == []


def test_parent_root_and_counts():
    with recording():
        with profiling.span("a", k=1):
            with profiling.span("b", n=3, m=5):
                pass
            with profiling.span("c"):
                pass
        with profiling.span("d"):
            pass
    r = profiling.records()
    assert names(r) == ["a", "b", "c", "d"]
    assert [(s.parent, s.root) for s in r] == [(-1, 0), (0, 0), (0, 0), (-1, 3)]
    assert r[1].counts == {"n": 3, "m": 5} and r[0].counts == {"k": 1}
    assert all(s.index == i for i, s in enumerate(r))
    for s in r:
        assert isinstance(s.start_ns, int) and s.start_ns <= s.end_ns
    assert r[0].start_ns <= r[1].start_ns <= r[1].end_ns <= r[2].start_ns <= r[0].end_ns


def test_threads_keep_their_own_stacks():
    """Spans opened on another thread while this one has a span open are
    roots of their own, not children of this thread's span."""
    inside, go = threading.Event(), threading.Event()

    def worker():
        with profiling.span("w"):
            inside.set()
            with profiling.span("w.child"):
                go.wait(10)

    with recording():
        with profiling.span("main"):
            t = threading.Thread(target=worker)
            t.start()
            assert inside.wait(10)
            with profiling.span("main.child"):
                go.set()
            t.join(10)
    assert not t.is_alive()
    r = {s.name: s for s in profiling.records()}
    idx = {s.name: s.index for s in profiling.records()}
    assert r["w"].parent == -1 and r["w"].root == idx["w"]
    assert r["w.child"].parent == idx["w"] and r["w.child"].root == idx["w"]
    assert r["main.child"].parent == idx["main"] and r["main.child"].root == idx["main"]
    assert r["w"].tid != r["main"].tid


def test_threads_opening_spans_at_once_lose_no_record():
    """Eight threads open nested spans at once with a short switch
    interval: every record's index is its place in the store and every
    parent is an earlier span of the same thread."""
    import sys

    def worker(k):
        for i in range(200):
            with profiling.span("outer", k=k):
                with profiling.span("inner", k=k, i=i):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recording():
            ts = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    r = profiling.records()
    assert len(r) == 8 * 200 * 2
    assert all(s.index == i for i, s in enumerate(r))
    for s in r:
        if s.name == "outer":
            assert s.parent == -1 and s.root == s.index
        else:
            p = r[s.parent]
            assert p.name == "outer" and p.tid == s.tid and p.counts["k"] == s.counts["k"]
            assert s.root == p.index < s.index


def test_records_under_a_profiler_and_stops_after_it():
    with profile(activities=[ProfilerActivity.CPU]):
        a = time.time_ns()
        with profiling.span("on"):
            torch.ones(16).sum()
        b = time.time_ns()
    with profiling.span("off"):
        pass
    r = profiling.records()
    assert names(r) == ["on"]
    # the profiler's clock: time.time_ns() brackets the span
    assert a <= r[0].start_ns <= r[0].end_ns <= b


def test_clear_empties_the_store():
    with recording():
        with profiling.span("x") as x:
            profiling.clear()
            with profiling.span("y"):
                pass
        assert x.end_ns is not None
    assert names(profiling.records()) == ["y"]
    assert profiling.records()[0].parent == -1  # its parent opened before the clear
    with profiling.span("z"):
        pass
    assert names(profiling.records()) == ["y"]


def _scene():
    return procedural.cornell_box_scene(include_spheres=True), procedural.default_camera(8, 8)


def test_wavefront_iterations_each_hold_one_host_read(monkeypatch):
    scene, cam = _scene()
    bounces, reads = [], []
    read = torch.Tensor.__bool__
    monkeypatch.setattr(torch.Tensor, "__bool__", lambda t: reads.append(1) or read(t))
    with recording():
        img, rays = render_wavefront_chunked(scene, cam, 4, rng.make_key(3), lanes=64,
                                             chunk_spp=2, device="cpu")
    monkeypatch.undo()
    r = profiling.records()
    assert set(names(r)) == WAVEFRONT
    assert names(r).count("render.chunk") == 2 and r[0].name == "wavefront.render"
    its = [s for s in r if s.name == "wavefront.iteration"]
    assert [s.counts["index"] for s in its if s.parent == its[0].parent] == list(
        range(sum(s.parent == its[0].parent for s in its)))
    for it in its:
        kids = [s.name for s in r if s.parent == it.index]
        assert kids == ["wavefront.bounce", "wavefront.commit", "wavefront.regen",
                        "wavefront.sync"]
    # one read an iteration, and one before each chunk's first
    assert len(reads) == len(its) + 2
    # as many iterations as bounce calls: count them through on_iteration
    from pathtrace_tpu_torch.integrator.wavefront import _run_wavefront
    scene = scene.to("cpu")
    for offset in (0, 2):
        _run_wavefront(scene, cam, 2, rng.make_key(3), IntegratorConfig(), 64, offset,
                       on_iteration=lambda *a: bounces.append(1))
    assert len(bounces) == len(its)


@pytest.mark.parametrize("engine", ["wavefront", "fused"])
def test_spans_change_no_result(engine):
    scene, cam = _scene()
    fn = render_wavefront_chunked if engine == "wavefront" else render_wavefront_fused
    run = lambda: fn(scene, cam, 2, rng.make_key(4), IntegratorConfig(), lanes=64,
                     chunk_spp=1, device="cpu")
    img0, rays0 = run()
    with recording():
        img1, rays1 = run()
    assert torch.equal(img0, img1) and rays0 == rays1
    root = "wavefront.render" if engine == "wavefront" else "fused.render"
    r = profiling.records()
    assert r[0].name == root and all(s.root == 0 for s in r)
    # on the CPU the fused engine runs the plain wavefront: no pack, no launch
    assert set(names(r)) == (WAVEFRONT - {"wavefront.render"}) | {root}


def test_train_step_records_record_replay_and_taped_depths():
    scene, cam = _scene()
    key, cfg, spp, lanes, chunk = rng.make_key(5), IntegratorConfig(), 2, 64, 32
    target = torch.zeros((8, 8, 3))
    with recording():
        train_step_wavetape(scene, cam, target, spp, key, cfg, lanes=lanes, chunk=chunk,
                            device="cpu")
    r = profiling.records()
    assert r[0].name == "train.step" and all(s.root == 0 for s in r)
    assert TRAIN <= set(names(r)) and set(names(r)) <= TRAIN | WAVEFRONT - {"wavefront.render"}
    by = lambda n: [s for s in r if s.name == n]
    (rec,), (rep,) = by("train.record"), by("train.replay")
    assert rec.end_ns <= rep.start_ns
    assert all(within(r, s, "train.record") for s in by("wavefront.iteration"))
    chunks = by("replay.chunk")
    assert all(s.parent == rep.index for s in chunks + by("train.sort"))
    records, _ = record_paths_wavefront(scene, cam, spp, key, cfg, lanes)
    lens = ((records & _WRT_BIT) != 0).sum(dim=0)
    depths = lens.sort(stable=True).values.reshape(-1, chunk)[:, -1].tolist()
    assert [s.counts for s in chunks] == [{"depth": d, "paths": chunk} for d in depths]
    for c in chunks:
        assert [s.name for s in r if s.parent == c.index] == ["replay.forward",
                                                             "replay.backward"]


def within(recs, s, name) -> bool:
    while s is not None:
        if s.name == name:
            return True
        s = recs[s.parent] if s.parent >= 0 else None
    return False


def _kineto_range(doc) -> tuple:
    ts = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
          for e in doc["traceEvents"] if e.get("ph") == "X" and e.get("cat") != "span"]
    return min(t for t, _ in ts), max(t for _, t in ts)


def test_trace_writes_the_spans_inside_the_profilers_range(tmp_path):
    with profiling.trace(None) as prof:
        assert prof is None
    with recording():
        with profiling.span("stale"):
            pass
    scene, cam = _scene()
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
        render_wavefront_chunked(scene, cam, 1, rng.make_key(0), lanes=64, device="cpu")
        torch.ones(8).sum()
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any("aten::" in e.get("name", "") for e in doc["traceEvents"])
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "span"]
    assert {e["name"] for e in spans} == WAVEFRONT
    assert "stale" not in {e["name"] for e in spans}
    lo, hi = _kineto_range(doc)
    for e in spans:
        assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi
    its = [e for e in spans if e["name"] == "wavefront.iteration"]
    assert [e["args"]["index"] for e in its] == list(range(len(its)))


def test_cli_render_trace_writes_the_passes(tmp_path):
    out = tmp_path / "prof"
    assert cli.main(["render", "--preset", "cornell64", "--width", "8", "--height", "8",
                     "--spp", "2", "--passes", "2", "--engine", "fused", "--device", "cpu",
                     "--out", str(tmp_path / "o.png"), "--trace", str(out)]) == 0
    doc = json.loads((out / "trace.json").read_text())
    roots = [e for e in doc["traceEvents"] if e.get("name") == "fused.render"]
    assert len(roots) == 2
    lo, hi = _kineto_range(doc)
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in roots)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_gap_goes_to_the_sleep_span(cuda):
    """B1, a 2 ms sleep in a span, B1 again, under benchmark.trace.profile,
    after one B1 launch that takes the profiler's first-launch cost. On the
    aligned clock no kernel starts before its b1.launch span opens (the
    anchor rule makes that so); each timed kernel starts before its span
    closes (the ctypes call: on an H100 machine 20-75 us long, the kernel
    starting 20-47 us before it returned), the two timed kernels lag their
    spans' opening alike, within 100 us (on an H100 machine they differ by
    0-64 us; an anchor paired with the wrong launch would shift one of them
    by the 2 ms sleep), and the kernel before the sleep ends
    before the host's synchronise returns; the sleep's span lies in the
    idle gap between the two kernels, all of it is put down to that span,
    and it takes most of the gap. The rest of the gap is the host's own:
    80-130 us to return from the synchronise and 240-300 us from the sleep
    to the second launch's span (the wrapper's checks and allocations run
    5-8x slower just after a sleep), so the sleep took 86-88% of it."""
    import types

    from benchmark import spans
    from benchmark.trace import profile as bench_profile
    from pathtrace_tpu_torch.ops.cuda import bounce_kernel as bk

    scene = procedural.cornell_box_scene().to(cuda)
    cam = procedural.default_camera(16, 16)
    pack = bk.build_fused_pack(scene)
    params = bk.make_params(cam, IntegratorConfig(), rng.make_key(1), pack, 256, 1, 0)
    bk.launch(pack, params)  # builds and loads the library outside the trace
    torch.cuda.synchronize(cuda)
    profiling.clear()
    synced = []

    def body():
        # the profiler's first launch of a kernel takes 400-470 us in its
        # ctypes call: an untimed launch takes that, its anchor one more
        # lower bound
        bk.launch(pack, params)
        torch.cuda.synchronize(cuda)
        bk.launch(pack, params)
        torch.cuda.synchronize(cuda)
        synced.append(time.time_ns())
        with profiling.span("sleep"):
            time.sleep(0.002)
        bk.launch(pack, params)

    _, tr = bench_profile(body, cuda)
    rec = types.SimpleNamespace(traces=[tr])
    al = spans.aligned(rec)
    assert al is not None
    r = al.records
    ops = [(s, e) for n, s, e in tr.events if "pt::bounce_kernel" in n][1:]
    launches = [i for i, s in enumerate(r) if s.name == "b1.launch"][1:]
    assert len(ops) == len(launches) == 2
    for i, (s, _) in zip(launches, ops):
        assert s <= al.end_us[i], (al.start_us[i], s, al.end_us[i])
    lags = [s - al.start_us[i] for i, (s, _) in zip(launches, ops)]
    assert abs(lags[0] - lags[1]) < 100.0, lags
    assert ops[0][1] <= (synced[0] - r[0].start_ns) / 1e3 - al.offset_us
    sleep = [i for i, s in enumerate(r) if s.name == "sleep"][0]
    length = al.end_us[sleep] - al.start_us[sleep]
    assert ops[0][1] <= al.start_us[sleep] and al.end_us[sleep] <= ops[1][0]
    idle = spans.idle_by_span(rec)
    assert idle.get(sleep, 0.0) == pytest.approx(length, abs=1e-6)
    gap = ops[1][0] - ops[0][1]
    assert length >= 2000.0 and idle[sleep] >= 0.75 * gap, (idle, gap)
