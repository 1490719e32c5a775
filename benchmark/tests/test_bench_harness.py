"""The harness on the CPU: cells, configurations and metrics found by
name, a dummy cell added as files, the result line's keys, the statistics
of the window and the trace, and a run that finds no card."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT

from benchmark import harness, run
from benchmark.trace import DeviceTrace

TINY = dict(width=8, height=8, spp=2, chunk_spp=2, lanes=64, warmup_spp=1,
            check={"kind": "pixels", "units": 1, "pixels": 8, "limits": {"pixel_gap": 1e-3}})


def test_cells_configs_and_metrics_are_found_by_name():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.chips == w["chips"]
        harness.load_module("entries", cell.traffic["entry"])
        names = {m["name"] for m in cell.end_to_end + cell.per_layer}
        assert "setup_s" in names
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for n in names:
            assert callable(harness.load_module("metrics", n).read)


def test_a_dummy_cell_added_as_files_is_found_and_runs(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["workloads"].append({"name": "cornell.dummy8", "config": "cornell_spheres",
                               "traffic": "dummy8", "chips": 1, "why": "a dummy"})
    bench["end_to_end"][0]["workloads"].append("cornell.dummy8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.load(open(os.path.join(ROOT, "benchmark/traffic/image256_fused.json")))
    traffic.update(TINY)
    (tmp_path / "benchmark/traffic/dummy8.json").write_text(json.dumps(traffic))
    code = ("import time\nfrom benchmark import harness\n"
            "res, lines = harness.run('cornell.dummy8', 3000000021, 0.01, False,"
            " t_start=time.perf_counter(), device='cpu')\n"
            "import json; print(json.dumps(res))\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}:{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and set(res["metrics"]) == {"fused_paths_per_s", "setup_s"}


def test_the_result_line_has_the_contracts_keys_and_the_checks_last():
    res, lines = harness.run("cornell.image256", 3000000022, 0.01, False,
                             t_start=time.perf_counter(), device="cpu", traffic_overrides=TINY)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert res["checks"]["pixel_gap"]["limit"] == 1e-3
    assert lines[-1] == f"check pixel_gap: {res['checks']['pixel_gap']['value']!r} (limit 0.001)"
    assert set(res["metrics"]) == {"fused_paths_per_s", "image_p90_ms", "setup_s"}


def _record(units, traces=()):
    cell = harness.load_cell("cornell.image256")
    return harness.Record(cell, None, 1.0, units, list(traces), None)


def test_the_rate_is_all_work_over_all_the_windows_time_even_with_a_stall():
    units = [(0.0, 1.0, 100), (1.0, 9.0, 100), (9.0, 10.0, 100)]  # the second unit stalls
    rec = _record(units)
    assert harness.load_module("metrics", "fused_paths_per_s").read(rec) == 300 / 10.0
    assert harness.load_module("metrics", "step_s").read(rec) == 10.0 / 3


def test_the_p90_is_taken_over_all_images():
    units = [(i, i + (1.0 if i != 7 else 5.0) + 0.01 * i, 1) for i in range(20)]
    ms = sorted((e - s) * 1e3 for s, e, _ in units)
    assert harness.load_module("metrics", "image_p90_ms").read(_record(units)) == ms[17]


def test_the_idle_share_comes_from_one_synthetic_trace():
    # busy [0, 2) and [1, 3) overlap into 3 us busy, then [5, 6): 4 us of a 10 us window
    t = DeviceTrace([("a", 0.0, 2.0), ("b", 1.0, 3.0), ("pt::bounce_kernel", 5.0, 6.0)], 10e-6)
    assert t.busy_s() == pytest.approx(4e-6)
    rec = _record([(0.0, 1.0, 1)], [t])
    assert harness.load_module("metrics", "device_idle.fused").read(rec) == pytest.approx(60.0)
    assert rec.kernel_seconds("pt::bounce_kernel") == pytest.approx(1e-6)
    gaps = dict(t.idle_gaps())
    assert gaps["b -> pt::bounce_kernel"] == pytest.approx(2e-6)
    assert gaps["host: window edges"] == pytest.approx(4e-6)


def test_shard_imbalance_reads_the_largest_ranks_b1_time_over_the_mean():
    traces = [DeviceTrace([("void pt::bounce_kernel", 0.0, float(t))], 1.0) for t in (3, 2, 2, 1)]
    rec = _record([(0.0, 1.0, 1)], traces)
    assert harness.load_module("metrics", "shard_imbalance").read(rec) == pytest.approx(1.5)


def test_index_bwd_counts_the_sorts_just_before_the_index_backward_only():
    # the replay's length sort, followed by a gather, is not counted; the
    # index sort before indexing_backward is, across a memset between its kernels
    events = [("cub::DeviceRadixSortOnesweepKernel", 0.0, 5.0),
              ("index_elementwise_kernel", 5.0, 6.0),
              ("cub::DeviceRadixSortHistogramKernel", 10.0, 11.0), ("Memset (Device)", 11.0, 12.0),
              ("cub::DeviceRadixSortOnesweepKernel", 12.0, 14.0),
              ("at::native::indexing_backward_kernel_small_stride", 14.0, 24.0),
              ("at::native::indexing_backward_kernel_stride_1", 24.0, 28.0)]
    rec = _record([(0.0, 1.0, 1), (1.0, 2.0, 1)], [DeviceTrace(events, 1.0)])
    assert harness.load_module("metrics", "index_bwd_ms").read(rec) == pytest.approx(
        1e-3 * (1.0 + 2.0 + 10.0 + 4.0) / 2)


def test_every_process_of_a_run_takes_its_own_equal_share_of_the_cpus():
    assert run.cpu_share(0, 1) == run.CPUS
    shares = [run.cpu_share(r, 4) for r in range(4)]
    assert all(shares)
    if len(run.CPUS) >= 4:
        assert len({c for sh in shares for c in sh}) == sum(len(sh) for sh in shares)
        assert len({len(sh) for sh in shares}) == 1


def test_a_run_that_finds_no_card_fails_and_prints_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "cornell.image256", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_a_traced_run_without_a_card_reports_no_device_metrics():
    with pytest.raises(RuntimeError, match="CUDA"):
        harness.run("cornell.image256", 3000000023, 0.01, True, t_start=time.perf_counter(),
                    device="cpu", traffic_overrides=TINY)


@pytest.mark.gpu
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "cornell.image256",
                          "--seed", "3000000024", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
