"""The port's device-validation tools (tools/torch_*.py) on the CPU at tiny
sizes, and the committed card artifacts they write (docs/torch_*.json).

- torch_reference_frame: 12x27, 4 passes x 2 spp; the run that drops its
  accumulator after pass 2 and reloads it from the checkpoint equals the
  uninterrupted run bit for bit.
- torch_card_cpu_agreement: the five rows at the goldens' own sizes, each
  at the JAX tool's bar.
- torch_gradcheck_card: the mesh gradient check (wavetape against scan-AD)
  on sphere_mesh_scene(2) with KD cells of 64, and forward against reverse
  at 4x4 @ 1 spp (forward mode against JAX: test_torch_evidence.py), each
  with its comparison through the plain search, which on the card holds
  B2 and B3 to their plain versions (on the CPU both sides are plain).
- torch_gradcheck_oracle: two FD checks and the IOR forward/reverse check
  at 8x8 @ 2 spp.
- torch_glass512_render, torch_mesh512_render: one tiny render each.
- docs/torch_scaling_bench.json (tools/torch_scaling_bench.py, tested on
  the CPU in test_torch_scaling.py) comes from a four-card run and a
  four-card rerun of its train sweep merged into it: N = 1, 2, 4 in each
  sweep, every bit_equal flag true, efficiency_vs_1 equal to its
  definition, the reference job on four cards equal in rays to the
  one-card job.
- Each committed docs/torch_*.json comes from one run on the card: it
  passes, and names the card and its power limit (as
  tests/test_golden.py:83-95 and tests/test_grad.py:218-248 pin the TPU
  artifacts).
"""

import json
import os
import pathlib
import re
import statistics
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import torch_card_cpu_agreement as agreement  # noqa: E402
import torch_glass512_render as glass512  # noqa: E402
import torch_gradcheck_card as gradcheck  # noqa: E402
import torch_gradcheck_oracle as oracle  # noqa: E402
import torch_mesh512_render as mesh512  # noqa: E402
import torch_reference_frame as reference  # noqa: E402

from pathtrace_tpu_torch.models import procedural  # noqa: E402

torch.set_num_threads(1)


def test_reference_frame_resume_is_bit_equal(tmp_path):
    kw = dict(device="cpu", out_dir=str(tmp_path), lanes=12 * 27, write_png=False)
    straight, a = reference.render_job(12, 27, 4, 2, resume_at=0, **kw)
    resumed, b = reference.render_job(12, 27, 4, 2, resume_at=2, **kw)
    assert resumed["resumed_at_pass"] == 2 and straight["resumed_at_pass"] is None
    assert torch.equal(a, b) and straight["pass"] and resumed["pass"]
    assert resumed["camera_paths"] == 12 * 27 * 8 and resumed["b1_launches"] == 0
    assert resumed["card"] is None and resumed["device"] == "cpu"
    assert resumed["channel_sums"] == straight["channel_sums"]


def test_card_cpu_agreement_rows_on_the_cpu():
    rows = agreement.agreement_rows("cpu")
    assert [r["golden"] for r in rows] == ["cornell_32x32_8spp_seed123.npy"] * 3 + [
        "glass_24x24_8spp_seed7.npy", "blob82k_48x48_4spp_seed11.npy"]
    assert all(r["ok"] for r in rows), rows


def test_gradcheck_card_mesh_grads_on_the_cpu():
    scene = procedural.sphere_mesh_scene(2).with_kd_binned(max_tris=64)
    m = gradcheck.mesh_grads("cpu", scene, side=8, spp=2, against_plain=True)
    assert m["pass"] and m["b2_launches"] == 0, m
    p = m["plain_search"]
    assert p["pass"] and p["primal_equal"] and p["launches"] == 0, p


def test_gradcheck_card_forward_vs_reverse_on_the_cpu():
    f = gradcheck.forward_vs_reverse("cpu", 4, 1, against_plain=True)
    assert f["pass"] and f["rel_err"] < gradcheck.TOL, f
    assert f["plain_search"]["equal"] and f["plain_search"]["launches"] == 0, f
    assert gradcheck.forward_vs_reverse("cpu", 4, 1)["plain_search"] is None


def test_gradcheck_oracle_on_the_cpu():
    report = oracle.run_oracle("cpu", side=8, spp=2, checks=2)
    assert report["pass"] and len(report["checks"]) == 3, report
    assert report["checks"][-1]["param"].startswith("spheres.specular[1, 0]")


def test_512_renders_on_the_cpu():
    g = glass512.render_glass("cpu", side=8, spp=2, lanes=64)
    m = mesh512.render_mesh("cpu", side=8, spp=1, lanes=64)
    for out in (g, m):
        assert out["pass"] and out["paths"] == 8 * 8 * out["spp"] and out["card"] is None


def _artifact(name: str) -> dict:
    with open(REPO / "docs" / f"torch_{name}.json") as f:
        report = json.load(f)
    assert report["pass"] is True
    assert report["card"].startswith("NVIDIA") and report["device"].startswith("cuda")
    assert re.fullmatch(r"\d+(\.\d+)? W", report["power_limit"]), report["power_limit"]
    return report


def test_reference_frame_artifact():
    r = _artifact("reference_frame")
    assert r["resolution"] == [1080, 2400] and (r["passes"], r["spp_per_pass"]) == (8, 1024)
    assert r["b1_launches"] == 32 and r["resumed_at_pass"] == 4 and r["finite"]
    assert r["path_ids_a_pass"] >= 2**31 and r["paths_per_sec"] > 0


def test_card_cpu_agreement_artifact():
    r = _artifact("card_cpu_agreement")
    assert len(r["results"]) == 5 and all(row["ok"] for row in r["results"])


def test_gradcheck_card_artifact():
    r = _artifact("gradcheck_card")
    assert r["replay_vs_scan_ad"]["pass"] and r["forward_vs_reverse"]["pass"]
    assert r["forward_vs_reverse"]["forward_launches"]["b3"] > 0
    m = r["mesh_grads"]
    assert m["pass"] and m["primal_max_abs_diff"] < 1e-3 and m["b2_launches"] > 0
    assert max(m["wavetape_vs_scan_ad_max_rel_err"].values()) < 1e-3
    assert r["train_step_wavetape"]["seconds_per_step"] > 0
    assert r["train_step_replay"]["seconds_per_step"] > 0


def test_gradcheck_oracle_artifact():
    r = _artifact("gradcheck_oracle")
    assert r["max_rel_err"] <= 1e-3 and len(r["checks"]) >= 8
    assert r["config"]["width"] == 24 and r["config"]["spp"] == 16


@pytest.mark.parametrize("name,spp,launches", [("glass512_render", 1024, "b1_launches"),
                                               ("mesh512_render", 256, "b2_launches")])
def test_512_render_artifacts(name, spp, launches):
    r = _artifact(name)
    assert r["resolution"] == [512, 512] and r["spp"] == spp and r[launches] > 0


def test_tools_write_no_artifact_on_the_cpu(tmp_path, monkeypatch):
    """Run on the CPU, a tool prints its summary and leaves docs/ alone."""
    before = {p.name: p.stat().st_mtime_ns for p in (REPO / "docs").glob("torch_*.json")}
    monkeypatch.setenv("RF_W", "4")
    monkeypatch.setenv("RF_H", "4")
    monkeypatch.setenv("RF_PASSES", "1")
    monkeypatch.setenv("RF_SPP", "1")
    monkeypatch.setenv("RF_LANES", "16")
    assert reference.main(["--device", "cpu", "--out-dir", str(tmp_path)]) == 0
    after = {p.name: p.stat().st_mtime_ns for p in (REPO / "docs").glob("torch_*.json")}
    assert before == after and os.listdir(tmp_path)


def _bit_equal_flags(node) -> list:
    """Every `bit_equal` value anywhere in a report."""
    if isinstance(node, dict):
        return [v for k, v in node.items() if k == "bit_equal"] + [
            f for v in node.values() for f in _bit_equal_flags(v)]
    if isinstance(node, list):
        return [f for v in node for f in _bit_equal_flags(v)]
    return []


def test_scaling_bench_artifact():
    """The four-card runs of tools/torch_scaling_bench.py: the whole sweep,
    and the train sweep again (`--only train --merge`), its rows in place of
    the first run's, each row's entry point timed three times with a rank's
    lanes // N in both entry point and body. N = 1, 2, 4 in each sweep,
    every bit_equal flag true, efficiency_vs_1 equal to its definition,
    each rank's kernels bit-equal to their plain versions on cuda:0-3 in
    both runs, the reference job on four cards equal in rays to the
    one-card job. Its verdict is false for one check, which this pins with
    the measurements beside it: the train step's grads at N = 4 against the
    one-process call (bar 1e-5), where image and rays are exact, the N shard
    bodies summed in one process equal the all-reduced grads within the
    bar, and the one-process step moves as far from itself when only its
    replay chunking changes (float32 summation order over 262,144 paths)."""
    with open(REPO / "docs" / "torch_scaling_bench.json") as f:
        r = json.load(f)
    assert r["card"].startswith("NVIDIA") and r["device"] == "cuda:0"
    assert re.fullmatch(r"\d+(\.\d+)? W", r["power_limit"]), r["power_limit"]
    assert len(r["nvidia_smi"]) == 4 and all(line.startswith("NVIDIA") for line in r["nvidia_smi"])
    assert [s["name"] for s in r["sweeps"]] == ["main", "reference", "mesh", "train"]
    flags = _bit_equal_flags(r)
    assert len(flags) > 40 and all(f is True for f in flags)
    failing = []
    for s in r["sweeps"]:
        rows = s["rows"]
        assert [row["n_devices"] for row in rows] == [1, 2, 4]
        base = rows[0]["rays"] / rows[0]["seconds"]
        for row in rows:
            per_chip = row["rays"] / row["seconds"] / row["n_devices"]
            assert row["rays_per_sec_per_chip"] == pytest.approx(per_chip, rel=1e-12)
            assert row["efficiency_vs_1"] == pytest.approx(per_chip / base, rel=1e-12)
            assert all(c[s["kernel"]] > 0 for c in row["rank_launches"])
            check = row["check"]
            assert check["bit_equal"] and check["rays_equal"]
            if not check["pass"]:
                failing.append((s["name"], row["n_devices"], check))
    assert [f[:2] for f in failing] == [("train", 4)] and r["pass"] is False
    check = failing[0][2]
    assert max(check["shard_sum_rel_err"].values()) <= r["grad_rtol"]
    assert r["grad_rtol"] < check["grads_max_rel_err"] <= max(check["reorder_rel_err"].values())
    (rerun,) = r["merged_calls"]
    assert rerun["ran"] == ["train"] and len(rerun["nvidia_smi"]) == 4
    train = next(s for s in r["sweeps"] if s["name"] == "train")
    assert train["call"] == "merged_calls[0]"
    for row in train["rows"]:
        assert row["lanes"] == train["lanes"] * row["n_devices"]  # in all; a rank's: LANES
        assert len(row["repeat_seconds"]) == 3
        assert row["seconds"] == statistics.median(row["repeat_seconds"])
    for call, six in ((r, True), (rerun, False)):
        four = next(run for run in call["runs"] if run["n_devices"] == 4)
        assert four["backend"] == "nccl" and four["devices"] == [f"cuda:{k}" for k in range(4)]
        assert all(k["pass"] for k in four["kernel_checks"])
        if six:
            assert four["entry_points"]["pass"]
            assert four["entry_points"]["indexless_mesh"]["mesh_device"] == "cuda"
        else:  # not asked again
            assert four["entry_points"] is None
        assert [g["device"] for g in call["device_guard"]] == [f"cuda:{k}" for k in range(4)]
        assert all(g["pass"] and g["current_device"] == 0 for g in call["device_guard"])
    job = r["job"]
    assert job["n_devices"] == 4 and (job["passes"], job["spp"]) == (8, 1024)
    assert job["rank_b1_launches"] == [8, 8, 8, 8] and job["against_one_card"]["pass"]
    with open(REPO / "docs" / "torch_reference_frame.json") as f:
        assert job["rays"] == json.load(f)["rays"]
