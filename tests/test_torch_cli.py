"""The port's `cli render` flags for multi-pass rendering (JAX cli.py:39-55,
84-86, 191-202), on the CPU at 8x8 on cornell64, in-process.

- --checkpoint writes the state after every pass; a render of 2 passes
  resumed with --resume --passes 4 (same samples per pass) equals 4 passes
  straight through bit for bit, --out-npy against --out-npy (counter-based
  RNG: pass p's key is iter_key(key, 1000 + p) wherever it runs), and says
  "[resume] at pass 2" on stderr; --resume without a file starts at pass 0.
- --hemisphere uniform and --no-nee render what
  integrator/render.py::render_image renders with the preset's
  IntegratorConfig so replaced, bit for bit, and differ from the default.
- --engine fused --hemisphere uniform raises: the fused kernel samples the
  cosine hemisphere only (ROADMAP C3).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtrace_tpu_torch import cli
from pathtrace_tpu_torch.integrator.render import render_image
from pathtrace_tpu_torch.models import procedural
from pathtrace_tpu_torch.models.presets import build_preset_scene, get_preset

torch.set_num_threads(1)
BASE = ["render", "--preset", "cornell64", "--width", "8", "--height", "8",
        "--engine", "megakernel", "--device", "cpu"]


def _render(tmp_path, name, *flags):
    npy = str(tmp_path / f"{name}.npy")
    assert cli.main([*BASE, *flags, "--out", str(tmp_path / f"{name}.png"),
                     "--out-npy", npy]) == 0
    return np.load(npy)


def test_resume_equals_uninterrupted(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    straight = _render(tmp_path, "straight", "--spp", "8", "--passes", "4")
    _render(tmp_path, "first", "--spp", "4", "--passes", "2", "--checkpoint", ck)
    capsys.readouterr()
    resumed = _render(tmp_path, "resumed", "--spp", "8", "--passes", "4", "--checkpoint", ck,
                      "--resume")
    assert "[resume] at pass 2" in capsys.readouterr().err
    np.testing.assert_array_equal(resumed, straight)
    assert np.isfinite(straight).all() and straight.mean() > 0.0
    fresh = _render(tmp_path, "fresh", "--spp", "8", "--passes", "4", "--resume",
                    "--checkpoint", str(tmp_path / "missing.npz"))
    np.testing.assert_array_equal(fresh, straight)


@pytest.mark.parametrize("flags,fields", [
    (["--hemisphere", "uniform"], {"hemisphere": "uniform"}),
    (["--no-nee"], {"nee": False}),
])
def test_flags_equal_render_image(tmp_path, flags, fields):
    preset = get_preset("cornell64")
    cfg = dataclasses.replace(preset.cfg, **fields)
    img = _render(tmp_path, "flag", "--spp", "4", "--passes", "2", "--seed", "3", *flags)
    ref = render_image(build_preset_scene(preset), procedural.default_camera(8, 8), 4, seed=3,
                       cfg=cfg, passes=2, device="cpu").numpy()
    np.testing.assert_array_equal(img, ref)
    default = _render(tmp_path, "default", "--spp", "4", "--passes", "2", "--seed", "3")
    assert not np.array_equal(img, default)


def test_fused_uniform_hemisphere_raises(tmp_path):
    with pytest.raises(ValueError, match="cosine"):
        cli.main(["render", "--preset", "cornell64", "--width", "8", "--height", "8",
                  "--spp", "1", "--engine", "fused", "--hemisphere", "uniform",
                  "--device", "cpu", "--out", str(tmp_path / "f.png")])
