"""The port's debug and profiling tools (utils/debug.py, utils/profiling.py)
and `cli bench`, on the CPU.

- check_image rejects NaN, inf and negative values and passes a render;
  checked_render renders and checks; debug_nans turns autograd's anomaly
  mode on for its block only, where a NaN backward raises.
- trace writes a Chrome trace (its spans: tests/test_torch_spans.py).
- `cli bench` sets BENCH_W, BENCH_H and BENCH_SPP and calls bench.main
  (monkeypatched: the bench needs a card).
"""

import json
import os

import pytest
import torch

from pathtrace_tpu_torch import bench, cli
from pathtrace_tpu_torch.integrator.render import render
from pathtrace_tpu_torch.models import procedural
from pathtrace_tpu_torch.utils import debug, profiling, rng

torch.set_num_threads(1)


@pytest.mark.parametrize("bad,match", [(float("nan"), "non-finite"),
                                       (float("inf"), "non-finite"),
                                       (-1e-3, "negative")])
def test_check_image_rejects(bad, match):
    img = torch.ones((4, 4, 3))
    img[1, 2, 0] = bad
    with pytest.raises(debug.RenderCheckError, match=match):
        debug.check_image(img)


def test_checked_render_equals_render():
    scene, cam = procedural.cornell_box_scene(), procedural.default_camera(8, 8)
    img = debug.checked_render(scene, cam, 1, rng.make_key(2), device="cpu")
    assert torch.equal(img, render(scene, cam, 1, rng.make_key(2), device="cpu"))
    debug.check_image(img.numpy())


def test_debug_nans_scopes_anomaly_mode():
    assert not torch.is_anomaly_enabled()
    x = torch.zeros(1, requires_grad=True)
    with debug.debug_nans():
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1.0).sum().backward()
    assert not torch.is_anomaly_enabled()


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(None) as prof:
        assert prof is None
    with profiling.trace(str(tmp_path / "tr")):
        render(procedural.cornell_box_scene(), procedural.default_camera(4, 4), 1,
               rng.make_key(0), device="cpu")
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any("aten::" in e.get("name", "") for e in trace["traceEvents"])


def test_cli_bench_sets_the_variables(monkeypatch):
    for var in ("BENCH_W", "BENCH_H", "BENCH_SPP"):
        monkeypatch.setenv(var, "0")  # so the undo removes what the command sets
        monkeypatch.delenv(var)
    seen = {}
    monkeypatch.setattr(bench, "main", lambda: seen.update(
        {v: os.environ.get(v) for v in ("BENCH_W", "BENCH_H", "BENCH_SPP")}))
    assert cli.main(["bench", "--preset", "cornell64", "--width", "64", "--height", "32",
                     "--spp", "16"]) == 0
    assert seen == {"BENCH_W": "64", "BENCH_H": "32", "BENCH_SPP": "16"}
    monkeypatch.delenv("BENCH_W")
    monkeypatch.delenv("BENCH_H")
    monkeypatch.delenv("BENCH_SPP")
    assert cli.main(["bench"]) == 0
    assert seen == {"BENCH_W": None, "BENCH_H": None, "BENCH_SPP": None}
