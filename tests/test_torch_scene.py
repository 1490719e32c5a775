"""Scene, camera, config and preset data of the port vs the JAX package.

Geometry and material leaves are built by the same numpy code and must be
exactly equal. light_pack's area and normal columns are computed by each
framework's float32 cross/length/normalize (XLA vs eager torch), so they
are held to rtol 1e-6. Camera leaves are exactly equal; ray directions
come from tan/normalize in two frameworks and are held to 1e-6.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pathtrace_tpu.integrator.config import IntegratorConfig as JConfig  # noqa: E402
from pathtrace_tpu.models import presets as jpresets  # noqa: E402
from pathtrace_tpu.models import procedural as jproc  # noqa: E402
from pathtrace_tpu_torch.integrator.config import IntegratorConfig  # noqa: E402
from pathtrace_tpu_torch.models import presets, procedural  # noqa: E402
from pathtrace_tpu_torch.models.scene import Scene  # noqa: E402
from torch_port_helpers import port_camera, scene_to_numpy  # noqa: E402

SCENES = {
    "cornell_boxes": lambda m: m.cornell_box_scene(),
    "cornell_spheres": lambda m: m.cornell_box_scene(include_spheres=True),
    "reference_demo": lambda m: m.cornell_box_scene(include_spheres=True,
                                                    include_boxes=False),
    "glass": lambda m: m.glass_scene(),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_leaves_equal(name):
    ref = scene_to_numpy(SCENES[name](jproc))
    got = scene_to_numpy(SCENES[name](procedural))
    assert set(ref) == set(got)
    for k in ref:
        if k == "light_pack":
            continue
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
        if isinstance(ref[k], np.ndarray):
            assert got[k].dtype == ref[k].dtype, k
    # v0 v1 v2 are gathered vertices: exact; area and normal: rtol 1e-6
    np.testing.assert_array_equal(got["light_pack"][:, :9], ref["light_pack"][:, :9])
    np.testing.assert_allclose(got["light_pack"][:, 9:], ref["light_pack"][:, 9:],
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_from_numpy_round_trip(name):
    """A JAX scene carried across with Scene.from_numpy keeps every leaf."""
    ref = scene_to_numpy(SCENES[name](jproc))
    got = scene_to_numpy(Scene.from_numpy(ref))
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)


CAMERAS = [(32, 32), (24, 24), (64, 48), (16, 40)]


@pytest.mark.parametrize("wh", CAMERAS)
def test_camera_leaves_and_directions(wh):
    jc = jproc.default_camera(*wh)
    tc = procedural.default_camera(*wh)
    carried = port_camera(jc)
    for f in dataclasses.fields(jc):
        a = np.asarray(getattr(jc, f.name))
        np.testing.assert_array_equal(np.asarray(getattr(tc, f.name)), a, err_msg=f.name)
        np.testing.assert_array_equal(np.asarray(getattr(carried, f.name)), a,
                                      err_msg=f.name)

    r = np.random.default_rng(wh[0])
    px = r.integers(0, wh[0], 512).astype(np.float32)
    py = r.integers(0, wh[1], 512).astype(np.float32)
    jx, jy = r.random((2, 512)).astype(np.float32)
    a = np.asarray(jc.ray_directions(*(jnp.asarray(x) for x in (px, py, jx, jy))))
    b = tc.ray_directions(*(torch.from_numpy(x) for x in (px, py, jx, jy))).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)

    jpx, jpy = jc.pixel_grid()
    tpx, tpy = tc.pixel_grid()
    np.testing.assert_array_equal(tpx.numpy(), np.asarray(jpx))
    np.testing.assert_array_equal(tpy.numpy(), np.asarray(jpy))


def test_look_at_camera_equal():
    from pathtrace_tpu.core.camera import Camera as JCamera
    from pathtrace_tpu_torch.core.camera import Camera
    args = ((3.0, 25.0, 50.0), (1.0, 15.0, -3.0))
    jc = JCamera.look_at(*args, fovy_deg=38.0, width=40, height=30)
    tc = Camera.look_at(*args, fovy_deg=38.0, width=40, height=30)
    for f in dataclasses.fields(jc):
        np.testing.assert_array_equal(np.asarray(getattr(tc, f.name)),
                                      np.asarray(getattr(jc, f.name)), err_msg=f.name)


@pytest.mark.parametrize("kwargs", [{}, dict(nee=False), dict(max_bounce=4, rr_bounce=2)])
def test_config_fields_equal(kwargs):
    a = dataclasses.asdict(JConfig(**kwargs))
    b = dataclasses.asdict(IntegratorConfig(**kwargs))
    assert a == b
    assert JConfig(**kwargs).max_iters == IntegratorConfig(**kwargs).max_iters


def test_preset_table():
    assert set(presets.PRESETS) == set(jpresets.PRESETS)
    for name, jp in jpresets.PRESETS.items():
        tp = presets.get_preset(name)
        assert (tp.width, tp.height, tp.spp, tp.use_bvh) == (jp.width, jp.height, jp.spp,
                                                             jp.use_bvh)
        assert dataclasses.asdict(tp.cfg) == dataclasses.asdict(jp.cfg)
    with pytest.raises(KeyError):
        presets.get_preset("nope")


@pytest.mark.parametrize("name", ["cornell64", "diffuse256_nonee", "glass512",
                                  "reference_demo"])
def test_preset_scene_matches_unreordered_jax_scene(name):
    """Small presets stay on the brute raycast, without JAX's BVH reorder,
    so compare against the JAX preset's unreordered scene (the mesh
    presets: test_torch_mesh.py::test_mesh_preset_matches_jax)."""
    ref = scene_to_numpy(jpresets.get_preset(name).build_scene())
    got = scene_to_numpy(presets.build_preset_scene(presets.get_preset(name)))
    for k in ref:
        if k != "light_pack":
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
