"""benchmark/spans.py and the six metrics that read the program's spans, on
synthetic records: the launch anchors recover the host clock's offset
exactly when a launch found the device idle, a count mismatch gives None,
idle time is split at span boundaries and put down to the innermost span,
and every reader reads None, without raising, where the program has no
recorder or recorded nothing (a program older than its spans)."""

import types

import pytest

from benchmark import harness, spans
from benchmark.trace import DeviceTrace

ORIGIN = 1_792_000_000_000_000_000  # ns on time.time_ns()'s scale
READERS = ("fused_gap_ms", "wavefront_host_ms", "wavefront_ops", "record_ms", "record_idle_ms",
           "replay_idle_ms")


class Rec:
    """A span record as utils/profiling.py keeps one."""

    def __init__(self, name, start_us, end_us, parent, root, index, counts):
        self.name, self.parent, self.root, self.index = name, parent, root, index
        self.counts = counts
        self.start_ns = ORIGIN + round(start_us * 1000)
        self.end_ns = None if end_us is None else ORIGIN + round(end_us * 1000)


def build(*rows) -> list:
    """Records from (name, start_us, end_us, parent, counts) rows, in
    order; roots follow the parents."""
    out = []
    for i, (name, s, e, parent, *counts) in enumerate(rows):
        root = i if parent < 0 else out[parent].root
        out.append(Rec(name, s, e, parent, root, i, counts[0] if counts else {}))
    return out


def record(events, window_us):
    return types.SimpleNamespace(traces=[DeviceTrace(sorted(events, key=lambda x: x[1]),
                                                     window_us / 1e6)])


@pytest.fixture
def program(monkeypatch):
    """Sets the records the readers see."""
    def use(recs):
        monkeypatch.setattr(spans, "program_records", lambda: recs or None)
    return use


@pytest.mark.parametrize("span_name,kernel", spans.ANCHORS)
def test_anchor_recovers_the_offset_when_a_launch_found_the_device_idle(program, span_name,
                                                                       kernel):
    base = 1000.0  # host us (from the first span) of the trace's zero
    lags = [0.0, 40.0, 7.0]  # the first launch found the device idle
    host = [1000.0, 1500.0, 2600.0]
    recs = build(("root", 0.0, 3000.0, -1), *[(span_name, h, h + 3.0, 0) for h in host])
    program(recs)
    ops = [(f"void {kernel}<true>(float*)", h - base + lag, h - base + lag + 20.0)
           for h, lag in zip(host, lags)]
    al = spans.aligned(record(ops, 3000.0))
    assert al.offset_us == base
    assert [al.start_us[i + 1] for i in range(3)] == [h - base for h in host]
    assert al.start_us[0] == -base


@pytest.mark.parametrize("extra", ["op", "span"])
def test_a_count_mismatch_gives_none(program, extra):
    rows = [("b1.launch", 0.0, 2.0, -1), ("b1.launch", 50.0, 52.0, -1)]
    ops = [("pt::bounce_kernel", 0.0, 10.0), ("pt::bounce_kernel", 50.0, 60.0)]
    if extra == "op":
        ops.append(("pt::bounce_kernel", 90.0, 95.0))
    else:
        rows.append(("b1.launch", 80.0, 81.0, -1))
    program(build(*rows))
    rec = record(ops, 100.0)
    assert spans.aligned(rec) is None
    assert spans.idle_by_span(rec) is None and spans.ops_in(rec, "b1.launch") is None


def test_no_launch_to_pair_gives_none(program):
    program(build(("fused.render", 0.0, 10.0, -1)))
    assert spans.aligned(record([("elementwise_kernel", 0.0, 5.0)], 20.0)) is None


def test_innermost_span_takes_each_piece_split_at_boundaries(program):
    # host = device (offset 0): the launch at 0 found the device idle
    recs = build(("R", -50.0, 1000.0, -1),
                 ("b1.launch", 0.0, 5.0, 0),
                 ("C", 200.0, 400.0, 0),
                 ("G", 250.0, 300.0, 2),
                 ("after", 1050.0, 1060.0, -1))
    program(recs)
    ops = [("pt::bounce_kernel", 0.0, 100.0), ("elementwise_kernel", 900.0, 1000.0)]
    idle = spans.idle_by_span(record(ops, 1100.0))
    # the window is [-50, 1060], R's start to after's end; idle: [-50, 0]
    # under R, before the first operation; [100, 900] under R, C, G;
    # [1000, 1060] between the roots, then with only "after" open
    assert idle == pytest.approx({0: 50.0 + 100.0 + 500.0, 2: 50.0 + 100.0, 3: 50.0, 4: 10.0,
                                  spans.OUTSIDE: 50.0})
    assert sum(idle.values()) == pytest.approx(910.0)


def test_idle_between_roots_is_outside_and_beyond_them_is_left_out(program):
    recs = build(("b1.launch", 10.0, 12.0, -1), ("A", 300.0, 400.0, -1))
    program(recs)
    ops = [("y", -100.0, -50.0), ("pt::bounce_kernel", 10.0, 100.0), ("x", 500.0, 600.0)]
    idle = spans.idle_by_span(record(ops, 600.0))
    # the window is [10, 400]: [-50, 10] and [400, 500] lie beyond the
    # roots; [100, 300] no span; [300, 400] A
    assert idle == pytest.approx({spans.OUTSIDE: 200.0, 1: 100.0})


def test_no_closed_root_gives_none(program):
    recs = build(("R", 0.0, None, -1), ("b1.launch", 5.0, 6.0, 0))
    program(recs)
    rec = record([("pt::bounce_kernel", 5.0, 10.0)], 20.0)
    assert spans.aligned(rec) is None and spans.idle_by_span(rec) is None


def test_ops_in_counts_operations_starting_inside_the_named_spans(program):
    recs = build(("b2.launch", 0.0, 1.0, -1), ("it", 5.0, 50.0, -1), ("it", 60.0, 70.0, -1))
    program(recs)
    ops = [("void pt::kd_walk_kernel(KdArgs)", 0.0, 4.0), ("a", 10.0, 80.0), ("b", 50.0, 51.0),
           ("c", 55.0, 56.0), ("d", 61.0, 62.0), ("e", 71.0, 72.0)]
    assert spans.ops_in(record(ops, 100.0), "it") == 3
    assert spans.ops_in(record(ops, 100.0), "missing") == 0


def fused_case():
    """Two images, each two chunks of one launch and one ray-count read;
    the harness between them. Host = device: each kernel starts as its
    launch span opens. Idle under fused.render: 15 (before the first
    launch) + 35 + 120 us an image (the 100 us between the images is
    outside)."""
    rows, ops = [], []
    for img, t0 in enumerate((0.0, 1000.0)):
        root = len(rows)
        rows.append(("fused.render", t0, t0 + 900.0, -1))
        for c in range(2):
            t = t0 + 10.0 + 400.0 * c
            ch = len(rows)
            rows.append(("render.chunk", t, t + 390.0, root))
            rows.append(("b1.launch", t + 5.0, t + 10.0, ch, {"lanes": 64, "spp": 1}))
            rows.append(("fused.read_rays", t + 12.0, t + 380.0, ch))
            ops.append(("pt::bounce_kernel(pt::PtParams)", t + 5.0, t + 370.0))
    return build(*rows), ops


def wavefront_case():
    """One render: three iterations of 100 us, each a B2 launch and two
    more operations; idle 50 us an iteration."""
    rows = [("wavefront.render", 0.0, 400.0, -1), ("render.chunk", 1.0, 390.0, 0)]
    ops = []
    for k in range(3):
        t = 10.0 + 110.0 * k
        it = len(rows)
        rows.append(("wavefront.iteration", t, t + 100.0, 1, {"index": k}))
        rows.append(("wavefront.bounce", t, t + 40.0, it))
        rows.append(("b2.launch", t + 2.0, t + 3.0, it + 1))
        rows.append(("wavefront.sync", t + 60.0, t + 100.0, it))
        ops += [("pt::kd_walk_kernel", t + 2.0, t + 20.0), ("mul", t + 20.0, t + 40.0),
                ("any", t + 70.0, t + 83.0)]
    return build(*rows), ops


def train_case():
    """One step: a record sweep with two B3 launches (idle 310 us in it,
    10 before the first launch), a replay of two chunks (idle 500 us in
    it), 110 us idle in the step outside both."""
    rows = [("train.step", 0.0, 3000.0, -1),
            ("train.record", 10.0, 1010.0, 0),
            ("b3.launch", 20.0, 21.0, 1), ("b3.launch", 500.0, 501.0, 1),
            ("train.replay", 1110.0, 2900.0, 0),
            ("train.sort", 1110.0, 1200.0, 4),
            ("replay.chunk", 1200.0, 2000.0, 4, {"depth": 3, "paths": 8}),
            ("replay.forward", 1200.0, 1500.0, 6),
            ("replay.chunk", 2000.0, 2900.0, 4, {"depth": 8, "paths": 8})]
    ops = [("void pt::mt_closest_kernel<true>", 20.0, 300.0),      # idle 0-20, 300-500
           ("void pt::mt_closest_kernel<false>", 500.0, 910.0),    # idle 910-1010 (record)
           ("x", 1010.0, 1010.5), ("y", 1110.0, 1500.0),           # idle 1010.5-1110 (step)
           ("z", 1700.0, 2000.0), ("w", 2300.0, 3000.0)]           # idle 200 + 300 (replay)
    return build(*rows), ops


CASES = {"fused_gap_ms": (fused_case, 1900.0, 340.0 / 2 / 1e3),
         "wavefront_host_ms": (wavefront_case, 400.0, 0.1),
         "wavefront_ops": (wavefront_case, 400.0, 3.0),
         "record_ms": (train_case, 3000.0, 1.0),
         "record_idle_ms": (train_case, 3000.0, 0.31),
         "replay_idle_ms": (train_case, 3000.0, 0.5)}


@pytest.mark.parametrize("name", READERS)
def test_each_reader_on_a_synthetic_record(program, name):
    case, window, want = CASES[name]
    recs, ops = case()
    program(recs)
    got = harness.load_module("metrics", name).read(record(ops, window))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("how", ["no recorder", "no records"])
def test_every_reader_is_none_without_a_recorder(monkeypatch, name, how):
    from pathtrace_tpu_torch.utils import profiling

    if how == "no recorder":
        monkeypatch.delattr(profiling, "records")
    else:
        profiling.clear()
    case, window, _ = CASES[name]
    _, ops = case()
    assert harness.load_module("metrics", name).read(record(ops, window)) is None


def test_trace_based_readers_are_none_without_a_trace(program):
    program(train_case()[0])
    rec = types.SimpleNamespace(traces=[])
    for name in ("record_idle_ms", "replay_idle_ms", "wavefront_ops", "fused_gap_ms"):
        assert harness.load_module("metrics", name).read(rec) is None
