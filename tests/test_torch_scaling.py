"""tools/torch_scaling_bench.py on the CPU (gloo), at tiny sizes.

- The sweep's worker runs as 1, 2 and 4 gloo processes at once, each group
  joined through its own file:// rendezvous (as tests/test_torch_sharding.py
  starts tools/torch_multihost_worker.py); the launcher's `assemble` and
  `verdict` make the report from their outputs. Every row is complete; every
  check pass is bit-equal to rank 0's one-process call, rays exact and the
  train step's loss and grads within rtol 1e-5; the six sharded entry points
  equal one process at each N; the strong sweep's images are bit-equal
  across N.
- Each row's entry point and its shard body give a rank the same lanes,
  lanes // N of the row's lanes in all, in every sweep and at every N (the
  train step's `lanes` are a rank's, the renders split theirs).
- `--only` picks sweeps (and the six entry points) by name and refuses a
  name it does not know;
  `merge` puts a call's sweeps in place of a report's own of the same name
  and keeps the call's runs, whose checks the verdict then reads too.
- The weak-mode shapes are JAX's (tools/scaling_bench.py:76-82): camera
  (W, H * N) and lanes LANES * N; efficiency_vs_1 is JAX's formula,
  recomputed from each row.
- The tool's N = 2 weak wavefront image against JAX's
  render_wavefront_sharded on make_ray_mesh(2) of the conftest's fake
  8-device CPU mesh, same camera, spp, key and lanes, at
  tests/test_torch_sharding.py's bar for that comparison (99.9% of values
  within 5e-3, mean within 1e-3, rays exact).
- The reference job's loop on two ranks equals one process, and its
  comparison with docs/torch_reference_frame.json holds rays exactly and the
  image statistics at 1e-5.
- The launcher refuses a cuda request without a card and a sweep larger
  than the visible card count, before it starts anything.
"""

import inspect
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from pathtrace_tpu.integrator.config import IntegratorConfig as JConfig  # noqa: E402
from pathtrace_tpu.models import procedural as jproc  # noqa: E402
from pathtrace_tpu.parallel.mesh import make_ray_mesh as jax_ray_mesh  # noqa: E402
from pathtrace_tpu.parallel.mesh import render_wavefront_sharded as jax_sharded  # noqa: E402
from pathtrace_tpu.utils import rng as jrng  # noqa: E402
from pathtrace_tpu_torch.models import procedural  # noqa: E402
from pathtrace_tpu_torch.parallel import mesh as M  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import torch_scaling_bench as tool  # noqa: E402

SIZES = (1, 2, 4)
WAVEFRONT = {"name": "wavefront", "engine": "wavefront", "scene": "cornell", "mode": "weak",
             "width": 16, "height": 16, "spp": 4, "lanes": 256, "key_pass": None,
             "kernel": "B3"}
PLAN = {
    "device": "cpu",
    "keep_images": True,
    "repeats": 2,
    "sweeps": [
        dict(tool.SWEEPS[0], width=8, height=8, spp=2, lanes=64),
        dict(tool.SWEEPS[1], width=8, height=16, spp=2, lanes=128),
        WAVEFRONT,
        dict(tool.SWEEPS[2], width=8, height=8, spp=1, lanes=64),
        dict(tool.SWEEPS[3], width=8, height=8, spp=2, lanes=64, chunk=64),
    ],
    "job": dict(tool.JOB, n_devices=2, width=8, height=8, passes=2, spp=2, lanes=64),
}


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """(report, images by N): every N's ranks started together."""
    tmp = tmp_path_factory.mktemp("scaling")
    plan_path = tmp / "plan.json"
    plan_path.write_text(json.dumps(PLAN))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for n in SIZES:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(REPO, "tools", "torch_scaling_bench.py"),
                 "--worker", str(plan_path), str(tmp / f"n{n}.json"), str(r), str(n),
                 str(tmp / f"rendezvous{n}")],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    runs = {}
    for n in SIZES:
        runs[n] = json.loads((tmp / f"n{n}.json").read_text())
        runs[n]["wall_seconds"] = 0.0
    images = {n: dict(np.load(tmp / f"n{n}.json.npz")) for n in SIZES}
    return tool.assemble(PLAN, runs), images


def test_rows_complete_and_every_check_passes(sweep):
    report, _ = sweep
    assert [s["name"] for s in report["sweeps"]] == [s["name"] for s in PLAN["sweeps"]]
    keys = {"n_devices", "seconds", "rays_per_sec", "rays_per_sec_per_chip", "efficiency_vs_1",
            "rank_seconds", "rank_cpu_seconds", "rank_body_seconds", "rank_body_cpu_seconds",
            "rank_body_rays", "rank_launches", "check"}
    for s in report["sweeps"]:
        assert [r["n_devices"] for r in s["rows"]] == list(SIZES)
        for row in s["rows"]:
            assert keys <= set(row), keys - set(row)
            n = row["n_devices"]
            assert len(row["rank_seconds"]) == len(row["rank_body_rays"]) == n
            assert len(row["repeat_seconds"]) == PLAN["repeats"]
            assert row["seconds"] == statistics.median(row["repeat_seconds"]) > 0
            assert max(row["rank_seconds"]) <= max(row["repeat_seconds"])
            assert row["rays"] == sum(row["rank_body_rays"]) > row["paths"]
            check = row["check"]
            assert check["pass"] and check["bit_equal"] and check["rays_equal"], (s["name"], n)
            assert row["entry_rays"] in (None, row["rays"])
            if s["engine"] == "train":
                assert check["grads_max_rel_err"] <= tool.GRAD_RTOL
            if s["engine"] == "train" and n > 1:
                assert set(check["reorder_rel_err"]) == set(check["grads_rel_err"])
                assert max(check["shard_sum_rel_err"].values()) <= tool.GRAD_RTOL
            assert all(c == {"B1": 0, "B2": 0, "B3": 0} for c in row["rank_launches"])
            assert ("collectives" in row) and row["collectives"]["rank0"]["slice_shape"] == [
                row["camera"][0] * row["camera"][1] // n, 3]
    strong = [s for s in report["sweeps"] if s["mode"] == "strong"]
    assert strong and all(s["images_bit_equal_across_n"] for s in strong)
    for run in report["runs"]:
        assert run["backend"] == "gloo" and run["entry_points"]["pass"], run
        assert run["kernel_checks"] == [None] * run["n_devices"]
    # the tiny job is not the reference's, so its comparison with the
    # one-card artifact is test_job_against_the_one_card_artifact's
    assert tool.verdict(dict(report, job=None), on_card=False)


def test_weak_shapes_and_efficiency_are_jax(sweep):
    report, _ = sweep
    for s in report["sweeps"]:
        base = s["rows"][0]
        for row in s["rows"]:
            n = row["n_devices"]
            if s["mode"] == "weak":
                assert row["camera"] == [s["width"], s["height"] * n]
                assert row["lanes"] == s["lanes"] * n
            else:
                assert row["camera"] == [s["width"], s["height"]] and row["lanes"] == s["lanes"]
            per_chip = row["rays"] / row["seconds"] / n
            assert row["rays_per_sec_per_chip"] == pytest.approx(per_chip, rel=1e-12)
            assert row["efficiency_vs_1"] == pytest.approx(
                per_chip / (base["rays"] / base["seconds"]), rel=1e-12)


def test_wavefront_n2_image_matches_jax(sweep):
    report, images = sweep
    row = next(s for s in report["sweeps"] if s["name"] == "wavefront")["rows"][1]
    w, h = row["camera"]
    cam = jproc.default_camera(w, h)
    img, rays = jax_sharded(jproc.cornell_box_scene(include_spheres=True), cam,
                            WAVEFRONT["spp"], jrng.make_key(0), jax_ray_mesh(2), JConfig(),
                            lanes=row["lanes"])
    ref, got = np.asarray(img), images[2]["wavefront"]
    assert got.shape == ref.shape == (h, w, 3)
    close = np.isclose(got, ref, rtol=5e-3, atol=5e-3)
    assert close.mean() > 0.999, f"pixel agreement {close.mean()}"
    assert abs(got.mean() - ref.mean()) / ref.mean() < 1e-3
    assert int(rays) == row["rays"] == row["entry_rays"]


def test_job_on_two_ranks_equals_one_process(sweep):
    report, _ = sweep
    job = report["job"]
    assert job["n_devices"] == 2 and len(job["pass_seconds"]) == job["passes"]
    assert job["rank_b1_launches"] == [0, 0] and job["finite"]
    scene = tool._scene("cornell", "cpu")
    one = tool.run_job(PLAN["job"], M.RayMesh(1, 0, None, torch.device("cpu")), scene)
    assert one["rays"] == job["rays"]
    assert one["channel_sums"] == job["channel_sums"] and one["image_mean"] == job["image_mean"]


def test_job_against_the_one_card_artifact():
    with open(os.path.join(REPO, "docs", "torch_reference_frame.json")) as f:
        ref = json.load(f)
    job = dict(tool.JOB, rays=ref["rays"], finite=True,
               image_mean=ref["image_mean"] * (1 + 5e-6),
               channel_sums=[c * (1 - 5e-6) for c in ref["channel_sums"]])
    good = tool.job_against_reference(job)
    assert good["pass"] and good["rays_equal"] and good["same_job"]
    assert good["one_card_wall_seconds"] == ref["wall_seconds"]
    assert not tool.job_against_reference(dict(job, rays=ref["rays"] + 1))["pass"]
    assert not tool.job_against_reference(dict(job, image_mean=ref["image_mean"] * 1.0001))["pass"]
    assert not tool.job_against_reference(dict(job, passes=4))["pass"]


def test_launcher_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tool.main(["--sizes", "1"])


def test_launcher_refuses_more_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="needs 4 cards, this machine has 2"):
        tool.main(["--sizes", "1,2,4"])
    tool.check_cards("cuda", [1, 2])  # enough cards: no error
    with pytest.raises(ValueError, match="starts at N = 1"):
        tool.main(["--sizes", "2,4", "--device", "cpu"])


def test_env_sweep_takes_the_jax_knobs():
    assert tool.env_sweep({}) is None
    s = tool.env_sweep({"SCALE_MODE": "strong"})
    assert (s["engine"], s["mode"], s["width"], s["height"], s["spp"], s["lanes"]) == (
        "wavefront", "strong", 64, 64, 8, 4096)
    assert tool.sweep_shape(s, 4) == (64, 64, 4096)
    s = tool.env_sweep({"SCALE_ENGINE": "fused", "SCALE_SIDE": "32", "SCALE_LANES": "1024"})
    assert s["mode"] == "weak" and s["kernel"] == "B1"
    assert tool.sweep_shape(s, 2) == (32, 64, 2048)
    with pytest.raises(ValueError, match="SCALE_ENGINE"):
        tool.env_sweep({"SCALE_ENGINE": "lockstep"})


class _Stop(Exception):
    pass


def test_entry_and_body_take_one_rank_lanes(monkeypatch):
    """The lanes a rank's work is given, recorded at the shard bodies that
    both the entry points and the tool's timed bodies call."""
    seen = []

    def recorder(fn):
        sig = inspect.signature(fn)

        def record(*args, **kwargs):
            seen.append(sig.bind(*args, **kwargs).arguments["lanes"])
            raise _Stop

        return record

    for name in ("render_fused_shard", "render_wavefront_shard", "train_step_wavetape_shard"):
        monkeypatch.setattr(M, name, recorder(getattr(M, name)))
    scene = tool._scene("cornell", "cpu")
    cpu = torch.device("cpu")
    for sweep in tool.SWEEPS:
        for n in SIZES:
            w, h, lanes = tool.sweep_shape(sweep, n)
            target = torch.zeros((h, w, 3))
            entry, body = tool._entry(sweep, scene, procedural.default_camera(w, h), tool._key(sweep),
                                      None, lanes, target)
            seen.clear()
            with pytest.raises(_Stop):
                entry(M.RayMesh(n, n - 1, None, cpu), tool.CHECK_SPP)
            with pytest.raises(_Stop):
                body(n - 1, n, tool.CHECK_SPP)
            assert seen == [lanes // n] * 2, (sweep["name"], n, seen)
            if sweep["mode"] == "weak":
                assert lanes // n == sweep["lanes"]


def test_only_option_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="nothing named"):
        tool.main(["--sizes", "1", "--device", "cpu", "--only", "train,nope"])


def test_merge_replaces_sweeps_by_name():
    def report(names, runs_pass, tag):
        return {"sweeps": [{"name": n, "mode": "weak", "rows": [], "tag": tag} for n in names],
                "runs": [{"entry_points": {"pass": runs_pass}, "kernel_checks": []}],
                "device_guard": [], "pass": runs_pass, "card": tag}

    old = report(["main", "mesh", "train"], True, "old")
    merged = tool.merge(old, report(["train"], True, "new"))
    assert [(s["name"], s["tag"], s.get("call")) for s in merged["sweeps"]] == [
        ("main", "old", None), ("mesh", "old", None), ("train", "new", "merged_calls[0]")]
    assert merged["card"] == "old" and merged["merged_calls"][0]["card"] == "new"
    assert merged["merged_calls"][0]["ran"] == ["train"] and "sweeps" not in merged["merged_calls"][0]
    assert tool.verdict(merged, on_card=False)
    again = tool.merge(merged, report(["mesh"], False, "third"))
    assert [s.get("call") for s in again["sweeps"]] == [None, "merged_calls[1]", "merged_calls[0]"]
    assert not tool.verdict(again, on_card=False)  # the third call's entry points failed
    skipped = dict(report(["train"], True, "four"), runs=[{"entry_points": None,
                                                          "kernel_checks": []}])
    assert tool.verdict(tool.merge(old, skipped), on_card=False)  # `--only` without six
