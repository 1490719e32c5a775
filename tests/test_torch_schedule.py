"""The count of the bounce kernel's schedules (profile_main.schedule_share)
against the plain wavefront, on the CPU at 16x16 @ 4 spp.

Each path's iterations (one closest-hit ray each) plus the NEE shadow rays
are the plain version's ray count, the per-lane counts sum to it, there is
one shadow ray per live hit and some but not all reach the light, the
triangle-test count sees each of those rays once, the image is the plain
version's, and regenerating paths in place keeps a warp at least as busy
as running each path to its end (PERF.md, kernel B1). The least-time model
beside the count (profile_main.bound, mt_pair_ops, b1_ops) by hand.
"""

import pytest
import torch

from pathtrace_tpu_torch import profile_main
from pathtrace_tpu_torch.integrator.config import IntegratorConfig
from pathtrace_tpu_torch.integrator.wavefront import _run_wavefront
from pathtrace_tpu_torch.models import procedural
from pathtrace_tpu_torch.utils import rng


def test_useful_share_by_hand():
    # two lanes in one warp of two; lane 0 traces 1 then 3 iterations,
    # lane 1 traces 3 then 1: nested rounds last 3 + 3, in place 4
    nested, in_place = profile_main.useful_share(torch.tensor([1, 3, 3, 1]), lanes=2, warp=2)
    assert nested == pytest.approx(8 / 12)
    assert in_place == 1.0
    # a lane past the pool idles in both schedules
    nested, in_place = profile_main.useful_share(torch.tensor([2, 2, 2]), lanes=4, warp=4)
    assert nested == in_place == pytest.approx(6 / 8)


def test_bound_model_by_hand():
    assert profile_main.bound(profile_main.FP32_PEAK * 1e-3, 1.0) == (1.0, "operations")
    assert profile_main.bound(1.0, profile_main.HBM_RATE * 2e-3) == (2.0, "bytes")
    assert (profile_main.SHADE_OPS, profile_main.NEE_VISIBLE_OPS) == (465, 183)
    # one triangle [v0 | e1 | e2] in the z = 0 plane; a ray through its
    # inside needs all four stages, one through the plane beside it stops
    # after stage 2 (u > det), one parallel to the plane after stage 1
    table = torch.tensor([[0.0, 0, 0, 1, 0, 0, 0, 1, 0]])
    org = torch.tensor([[0.2, 0.2, 1.0], [2.0, 0.2, 1.0], [0.2, 0.2, 1.0]])
    dirn = torch.tensor([[0.0, 0, -1], [0.0, 0, -1], [1.0, 0, 0]])
    assert profile_main.mt_pair_ops(table, org, dirn).tolist() == [44.0, 22.0, 14.0]
    scene = procedural.cornell_box_scene(include_spheres=True)
    need = {"mt_ops": 100.0, "rays": 3, "hits": 2, "visible": 1}
    assert profile_main.b1_ops(scene, need) == (100 + 3 * scene.num_spheres * 28
                                                + 2 * 465 + 183)


@pytest.mark.parametrize("scene_name,nee,lanes", [
    ("spheres", True, 256),
    ("spheres", False, 64),
    ("glass", True, 512),
])
def test_schedule_share_counts_the_plain_rays(scene_name, nee, lanes):
    scene = (procedural.glass_scene() if scene_name == "glass"
             else procedural.cornell_box_scene(include_spheres=True))
    cam = procedural.default_camera(16, 16)
    key, cfg = rng.make_key(3), IntegratorConfig(nee=nee)
    img, rays = _run_wavefront(scene, cam, 4, key, cfg, lanes)
    # a pair_ops of one a ray counts the traced rays again
    share = profile_main.schedule_share(
        scene, cam, 4, key, cfg, lanes,
        pair_ops=lambda org, dirn, *_: torch.ones(org.shape[0], dtype=torch.float64))
    assert torch.equal(share["image"], img)
    assert share["rays"] == rays
    iters = share["iters"]
    assert iters.shape == (16 * 16 * 4,) and int(iters.min()) >= 1
    assert int(iters.sum()) + share["nee_rays"] == rays
    assert int(share["lane_rays"].sum()) == rays
    assert 0 < share["hits"] <= int(iters.sum())
    if nee:
        assert share["nee_rays"] == share["hits"]
        assert 0 < share["visible"] < share["nee_rays"]
    else:
        assert share["nee_rays"] == share["visible"] == 0
    assert share["mt_ops"] == rays
    assert 0.0 < share["nested"] <= share["in_place"] <= 1.0
