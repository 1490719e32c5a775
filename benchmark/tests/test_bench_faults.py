"""The comparison that decides `correct` fails what it should: the control
(the reference in bfloat16 put in the program's place) and each fault a
cell can have, planted under a run at a test size on the CPU with the
harness's look for a card skipped."""

import json
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, bench_with_refjob

from benchmark import compare, control, harness, scenes

IMAGE = dict(width=8, height=8, spp=4, chunk_spp=2, lanes=64, warmup_spp=1,
             check={"kind": "pixels", "units": 1, "pixels": 64, "limits": {"pixel_gap": 1e-3}})
TRAIN = dict(width=8, height=8, spp=4, lanes=256, chunk_paths=128, warmup_spp=1,
             check={"kind": "train", "units": 1, "chunk_paths": 128,
                    "limits": {"loss_gap": 1e-4, "image_gap": 1e-3, "grad_gap": 1e-3}})


def _run(workload, overrides, wrap=None, seed=3000000041):
    res, _ = harness.run(workload, seed, 0.01, False, t_start=time.perf_counter(), device="cpu",
                         traffic_overrides=overrides, wrap_unit=wrap)
    return res


@pytest.mark.parametrize("workload, overrides", [("cornell.image256", IMAGE),
                                                 ("cornell.train128", TRAIN)])
def test_sound_runs_are_correct(workload, overrides):
    assert _run(workload, overrides)["correct"]


@pytest.mark.parametrize("workload, overrides", [("cornell.image256", IMAGE),
                                                 ("cornell.train128", TRAIN),
                                                 ("cornell.refjob4", IMAGE)])
def test_the_bfloat16_control_is_not_correct(workload, overrides, tmp_path):
    cell = harness.load_cell(workload, bench_with_refjob(tmp_path), overrides)
    ctx = harness.Ctx(cell.config, cell.traffic, scenes.scene_arrays(cell.config),
                      torch.device("cpu"), 0, cell.chips)
    for seed in (11, 12, 13):
        key = harness.unit_key(seed, 0)
        spp = cell.traffic["spp"]
        nums = compare.check(ctx, [{"spp": spp}], [key], seed,
                             substitute=control.control_answers(ctx, [key], spp))
        assert not compare.correct(nums), nums


def _altered(unit):
    def run(key, spp):
        out = unit(key, spp)
        if "image" in out:
            out["image"] = out["image"].clone()
            out["image"][3, 5, 1] += 0.05
        if "loss" in out:
            out["loss"] = out["loss"] * 1.001
        return out
    return run


def _half_batch(unit):
    return lambda key, spp: unit(key, max(1, spp // 2))


@pytest.mark.parametrize("fault", [_altered, _half_batch], ids=["answer_altered", "half_batch"])
@pytest.mark.parametrize("workload, overrides", [("cornell.image256", IMAGE),
                                                 ("cornell.train128", TRAIN)])
def test_a_planted_fault_is_not_correct(workload, overrides, fault):
    assert not _run(workload, overrides, wrap=fault)["correct"]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("fault", [0, 1], ids=["exchange", "exchange_left_out"])
def test_the_exchange_between_ranks_left_out_is_not_correct(fault, tmp_path):
    port, world, bench = _free_port(), 2, bench_with_refjob(tmp_path)
    script = os.path.join(ROOT, "benchmark", "tests", "exchange_fault.py")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, script, str(r), str(world), str(port), str(fault),
                               bench],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    res = json.loads(outs[0][0].strip().splitlines()[-1])
    assert res["correct"] == (not fault)
