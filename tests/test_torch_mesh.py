"""Mesh ingestion of the port against the JAX package: the OBJ/MTL loader,
the procedural meshes, the KD cell build and the mesh presets.

All of it is numpy on both sides (the port copies the numpy geometry
code), so every array is held bit-equal, except light_pack's area and
normal columns, which each framework computes with its own float32
cross/length (held to rtol 1e-6 as in test_torch_scene.py).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from pathtrace_tpu.accel.kdgrid import build_kd_clusters as jax_build_kd  # noqa: E402
from pathtrace_tpu.models import obj as jobj  # noqa: E402
from pathtrace_tpu.models import presets as jpresets  # noqa: E402
from pathtrace_tpu.models import procedural as jproc  # noqa: E402
from pathtrace_tpu_torch.accel.kdgrid import build_kd_clusters  # noqa: E402
from pathtrace_tpu_torch.models import obj, presets, procedural  # noqa: E402
from pathtrace_tpu_torch.models.scene import CLUSTER_FIELDS  # noqa: E402
from torch_port_helpers import scene_to_numpy  # noqa: E402

BLOB = procedural.ASSET_DIR + "/blob82k.obj"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_scenes_equal(got: dict, ref: dict):
    assert set(got) == set(ref)
    for k in ref:
        if k != "light_pack":
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_array_equal(got["light_pack"][:, :9], ref["light_pack"][:, :9])
    np.testing.assert_allclose(got["light_pack"][:, 9:], ref["light_pack"][:, 9:],
                               rtol=1e-6, atol=1e-7)


def assert_meshes_equal(a, b):
    for f in ("vertices", "normals", "uvs", "faces"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
    assert a.face_mtl == b.face_mtl
    assert {k: dataclasses.asdict(v) for k, v in a.materials.items()} == \
        {k: dataclasses.asdict(v) for k, v in b.materials.items()}


def assert_arrays_equal(got, ref):
    """obj_to_arrays outputs: positions, normals, uvs, Material."""
    for x, y in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(x, y)
    for f in ("emittance", "albedo", "specular", "opacity", "roughness", "metallic"):
        np.testing.assert_array_equal(getattr(got[3], f).numpy(), np.asarray(getattr(ref[3], f)),
                                      err_msg=f)


@pytest.fixture(scope="module")
def blob_meshes():
    return obj.load_obj(BLOB), jobj.load_obj(BLOB)


@pytest.fixture(scope="module")
def blob_scenes():
    return procedural.blob_mesh_scene(), jproc.blob_mesh_scene()


def test_blob_obj_equal(blob_meshes):
    got, ref = blob_meshes
    assert got.faces.shape == (81920, 3)
    assert_meshes_equal(got, ref)
    assert_arrays_equal(obj.obj_to_arrays(got, (0.0, 10.0, 0.0), 6.0),
                        jobj.obj_to_arrays(ref, (0.0, 10.0, 0.0), 6.0))


def test_blob_mesh_scene_equal(blob_scenes):
    got, ref = blob_scenes
    assert got.num_tris == 81934 and got.num_lights == 2
    assert_scenes_equal(scene_to_numpy(got), scene_to_numpy(ref))


SMALL_HEAD = """# quads, uvs, normals, negative indices, a material library
mtllib small.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
v 1 0 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 0 -1
vn 0.6 0 0.8
usemtl lamp
f 1/1/1 2/2/1 3/3/1 4/4/1
usemtl shiny
f -1/-1/-2 -2/-2/-2 -4/-4/-2
"""
SMALL_OBJ = {
    # every corner has a uv and a normal: file normals, flipped uvs
    "full": SMALL_HEAD + "f 1/1/3 5/2/3 6/3/3 2/4/3\nusemtl missing\nf 2/1/-1 6/2/-1 3/3/-1\n",
    # corners without uv or normal: smooth normals, zero uvs
    "partial": SMALL_HEAD + "f 1//1 5//1 6//1 2//1\nusemtl missing\nf 2 6 3\n",
}

SMALL_MTL = """newmtl lamp
Kd 0.5 0.5 0.5
Ke 4 3 2
d 1.0
newmtl shiny
Kd 0.9 0.1 0.1
Ks 0.5 0.5 0.5
Ns 100
Pm 1
Tr 0.25
"""


@pytest.fixture(params=sorted(SMALL_OBJ))
def small_obj(tmp_path, request):
    (tmp_path / "small.mtl").write_text(SMALL_MTL)
    path = tmp_path / "small.obj"
    path.write_text(SMALL_OBJ[request.param])
    return str(path)


ROT = jobj.rotation_matrix((0.3, 1.0, -0.2), 1.1)


@pytest.mark.parametrize("normal_mode", ["reference", "inverse_transpose"])
@pytest.mark.parametrize("transform", [
    dict(translation=(1, 2, 3), scale=2.5),
    dict(model_matrix=jobj.compose_model_matrix((5, -1, 0), 1.7, ROT)),
    dict(model_matrix=jobj.compose_model_matrix(scale=(1.0, 4.0, 1.0))),
], ids=["scale", "rotation", "shear"])
def test_small_obj_equal(small_obj, normal_mode, transform):
    got, ref = obj.load_obj(small_obj), jobj.load_obj(small_obj)
    assert got.faces.shape == (6, 3)  # two quads (fanned into four) and two triangles
    assert_meshes_equal(got, ref)
    assert_arrays_equal(obj.obj_to_arrays(got, normal_mode=normal_mode, **transform),
                        jobj.obj_to_arrays(ref, normal_mode=normal_mode, **transform))


def test_small_obj_scene_equal(small_obj):
    room = procedural.cornell_walls()
    got = obj.load_obj_scene(small_obj, scale=2.0, extra=room, build_bvh=False)
    ref = jobj.load_obj_scene(small_obj, scale=2.0, extra=jproc.cornell_walls(),
                              build_bvh=False)
    assert got.num_lights == 4  # the room's light quad and the emissive OBJ quad
    assert_scenes_equal(scene_to_numpy(got), scene_to_numpy(ref))


def test_model_matrix_helpers_equal():
    np.testing.assert_array_equal(obj.rotation_matrix((1, 2, 3), 0.7),
                                  jobj.rotation_matrix((1, 2, 3), 0.7))
    np.testing.assert_array_equal(obj.compose_model_matrix((1, 2, 3), (2, 3, 4), ROT),
                                  jobj.compose_model_matrix((1, 2, 3), (2, 3, 4), ROT))
    with pytest.raises(ValueError):
        obj.obj_to_arrays(obj.ObjMesh(np.zeros((0, 3)), np.zeros((0, 3, 3)), np.zeros((0, 3, 2)),
                                      np.zeros((0, 3), np.int64)), normal_mode="other")


def test_load_obj_scene_with_bvh_raises(small_obj):
    """The default build_bvh=True no longer raises: it builds the SAH BVH
    and leaf-ordered triangles equal to the JAX loader's."""
    room = procedural.cornell_walls()
    got = obj.load_obj_scene(small_obj, scale=2.0, extra=room)
    ref = jobj.load_obj_scene(small_obj, scale=2.0, extra=jproc.cornell_walls())
    assert got.bvh is not None and got.bvh.num_nodes == ref.bvh.num_nodes
    assert_scenes_equal(scene_to_numpy(got), scene_to_numpy(ref))


@pytest.mark.parametrize("subdivisions", [0, 2, 4])
def test_sphere_mesh_scene_equal(subdivisions):
    np.testing.assert_array_equal(procedural.icosphere(2.0, (1, 2, 3), subdivisions),
                                  jproc.icosphere(2.0, (1, 2, 3), subdivisions))
    assert_scenes_equal(scene_to_numpy(procedural.sphere_mesh_scene(subdivisions)),
                        scene_to_numpy(jproc.sphere_mesh_scene(subdivisions)))


def assert_cells_equal(got, ref_clusters, ref_dup, ref_dup_positions):
    for f in ("bmin", "bmax", "prim_start", "prim_count"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref_clusters, f)), err_msg=f)
    np.testing.assert_array_equal(got.dup_map.numpy(), ref_dup)
    p = ref_dup_positions
    want = np.concatenate([p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]], axis=1)
    np.testing.assert_array_equal(got.members.numpy(), want)


def assert_partition(clusters, num_tris):
    """test_kdgrid.py:26-41: cells never overlap (sampled) and membership
    covers every triangle."""
    bmin, bmax = clusters.bmin.numpy(), clusters.bmax.numpy()
    pts = np.random.default_rng(0).uniform(bmin.min(0), bmax.max(0), (2048, 3)).astype(np.float32)
    inside = ((pts[:, None, :] > bmin[None]) & (pts[:, None, :] < bmax[None])).all(-1)
    assert (inside.sum(1) <= 1).all()
    assert set(clusters.dup_map.tolist()) == set(range(num_tris))


@pytest.mark.parametrize("max_tris,rule", [(128, "midpoint"), (128, "median"), (128, "hybrid")])
def test_kd_build_equal_sphere_mesh(max_tris, rule):
    pos = procedural.sphere_mesh_scene(4).positions()
    got = build_kd_clusters(pos, max_tris=max_tris, rule=rule)
    assert_cells_equal(got, *jax_build_kd(pos, max_tris=max_tris, rule=rule))
    assert_partition(got, pos.shape[0])


def test_kd_build_equal_blob(blob_scenes):
    pos = blob_scenes[0].positions()
    got = build_kd_clusters(pos, max_tris=1024, rule="hybrid")
    assert (got.num_clusters, got.num_members) == (157, 95894)
    assert_cells_equal(got, *jax_build_kd(pos, max_tris=1024, rule="hybrid"))
    assert_partition(got, pos.shape[0])


def test_kd_build_rejects_unknown_rule():
    with pytest.raises(ValueError, match="rule"):
        build_kd_clusters(procedural.icosphere(subdivisions=1), rule="sah")


@pytest.mark.parametrize("name", ["mesh512", "multihost1024"])
def test_mesh_preset_matches_jax(name):
    """More than 4096 triangles: both packages give the preset KD cells
    (presets.py:94-106), over the same triangles in the same order."""
    got = presets.build_preset_scene(presets.get_preset(name))
    ref = jpresets.build_preset_scene(jpresets.get_preset(name), to_device=False)
    assert got.clusters is not None and got.num_tris > presets.KD_MIN_TRIS
    assert_scenes_equal(scene_to_numpy(got), scene_to_numpy(ref))
    assert {f"clusters.{f}" for f in CLUSTER_FIELDS} <= set(scene_to_numpy(got))


def test_small_preset_stays_on_brute():
    scene = presets.build_preset_scene(presets.get_preset("cornell64"))
    assert scene.clusters is None
    assert presets.build_preset_scene(presets.get_preset("glass512")).clusters is None


def test_kd_scene_round_trip_and_move():
    """A JAX KD scene carried across with Scene.from_numpy gets the same
    cells and member table as the port's own build; Scene.to moves them."""
    from pathtrace_tpu_torch.models.scene import Scene
    js = jproc.sphere_mesh_scene(4).with_kd_binned(max_tris=128)
    carried = Scene.from_numpy(scene_to_numpy(js))
    own = procedural.sphere_mesh_scene(4).with_kd_binned(max_tris=128)
    for f in ("bmin", "bmax", "prim_start", "prim_count", "dup_map", "members"):
        assert torch.equal(getattr(carried.clusters, f), getattr(own.clusters, f)), f
    moved = own.to("meta")
    assert moved.clusters.members.device.type == "meta"


def test_cli_renders_mesh_preset_on_cpu(tmp_path):
    """`cli render --preset mesh512` builds the KD scene and renders through
    it (megakernel engine, the plain KD search). The default wavefront
    engine traces all of its 65,536 lanes through the plain search, minutes
    of CPU under a parallel test run: chip_smoke.py runs that CLI call on
    the card, and test_torch_kd.py holds the wavefront through KD cells
    here."""
    out = tmp_path / "out.png"
    proc = subprocess.run([sys.executable, "-m", "pathtrace_tpu_torch.cli", "render",
                           "--preset", "mesh512", "--width", "8", "--height", "8", "--spp", "1",
                           "--engine", "megakernel", "--device", "cpu", "--out", str(out)],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_fused_kernel_rejects_mesh_preset():
    """The fused engine's bounce kernel holds the triangle table in shared
    memory; mesh512's 82k triangles exceed it, so `cli render --engine
    fused` on the card keeps raising (on the CPU the fused entry runs the
    plain wavefront, which takes the KD cells)."""
    from pathtrace_tpu_torch.ops.cuda import bounce_kernel as bk
    scene = presets.build_preset_scene(presets.get_preset("mesh512"))
    with pytest.raises(ValueError, match="shared memory"):
        bk.build_fused_pack(scene)
