"""Pixel-slice sharding of the port (parallel/mesh.py), held against the
JAX package and against the whole render.

- A slice against JAX: the port's wavefront over pixel slice 1 of 2 and 3
  of 4 of Cornell + spheres at 16x16 @ 4 spp against JAX's
  `_run_wavefront(..., pix_offset, num_pix_local, num_pix_total)`, at the
  golden bars of tests/test_torch_render.py (99.9% of pixels within 5e-3,
  mean within 1e-3), path counts exact. The two packages search and round
  differently, so bit-equality is not the bar here.
- Slices against the whole render, bit for bit: the N = 2 and 4 shard
  bodies, concatenated, equal the 1-shard film exactly (the same paths,
  the same per-slot sums) for the wavefront, the fused engine's plain
  version, the lockstep render and the wavetape records; the 1-shard film
  equals the unsharded engines'.
- Grads across slice counts: render_grad and the record/replay step summed
  over 2 shards equal 1 shard at rtol 1e-5 (only the sum over shards
  reorders).
- C5: the wavetape step's grads equal the replay step's at spp = 4, rtol
  1e-4 (per-path sums taken in another order: chunks sorted by length).
- Two processes under gloo (tools/torch_multihost_worker.py, file://
  rendezvous): the six sharded entry points at world size 2 equal world
  size 1 in this process: images bit for bit, ray counts exactly, losses
  and grads at rtol 1e-5. distributed.initialize() is a no-op alone and
  joins the group that torchrun's variables describe.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from pathtrace_tpu.integrator.config import IntegratorConfig as JConfig  # noqa: E402
from pathtrace_tpu.integrator.wavefront import _run_wavefront as jax_run_wavefront  # noqa: E402
from pathtrace_tpu.models import procedural as jproc  # noqa: E402
from pathtrace_tpu.utils import rng as jrng  # noqa: E402
from pathtrace_tpu_torch.diff.grad import MAT_FIELDS  # noqa: E402
from pathtrace_tpu_torch.diff.wavetape import record_paths_wavefront  # noqa: E402
from pathtrace_tpu_torch.integrator.config import IntegratorConfig  # noqa: E402
from pathtrace_tpu_torch.integrator.render import render  # noqa: E402
from pathtrace_tpu_torch.integrator.wavefront import render_wavefront_stats  # noqa: E402
from pathtrace_tpu_torch.models import procedural  # noqa: E402
from pathtrace_tpu_torch.ops.cuda.bounce_kernel import render_wavefront_fused  # noqa: E402
from pathtrace_tpu_torch.parallel import distributed  # noqa: E402
from pathtrace_tpu_torch.parallel import mesh as M  # noqa: E402
from pathtrace_tpu_torch.utils import rng  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import torch_multihost_worker as worker  # noqa: E402

W, SPP, LANES = 16, 4, 256
CFG = IntegratorConfig()
SLICES = [(1, 2), (3, 4)]


@pytest.fixture(scope="module")
def scene():
    return procedural.cornell_box_scene(include_spheres=True)


@pytest.fixture(scope="module")
def jax_slices():
    """JAX's wavefront over each slice of SLICES (one compile each)."""
    js = jproc.cornell_box_scene(include_spheres=True)
    cam = jproc.default_camera(W, W)
    out = {}
    for shard, n in SLICES:
        npl = W * W // n
        run = jax.jit(lambda s, k, shard=shard, n=n, npl=npl: jax_run_wavefront(
            s, cam, SPP, k, JConfig(), LANES // n, pix_offset=shard * npl,
            num_pix_local=npl, num_pix_total=W * W))
        film, rays = run(js, jrng.make_key(3))
        out[(shard, n)] = (np.asarray(film), int(rays))
    return out


@pytest.fixture(scope="module")
def whole(scene):
    """The 1-shard wavefront film and rays at 16x16 @ 4 spp."""
    return M.render_wavefront_shard(scene, procedural.default_camera(W, W), SPP,
                                    rng.make_key(3), 0, 1, CFG, LANES)


@pytest.mark.parametrize("shard,n", SLICES)
def test_slice_matches_jax(scene, jax_slices, shard, n):
    ref, ref_rays = jax_slices[(shard, n)]
    film, rays = M.render_wavefront_shard(scene, procedural.default_camera(W, W), SPP,
                                          rng.make_key(3), shard, n, CFG, LANES // n)
    film = film.numpy()
    assert film.shape == ref.shape == (W * W // n, 3)
    close = np.isclose(film, ref, rtol=5e-3, atol=5e-3)
    assert close.mean() > 0.999, f"pixel agreement {close.mean()}"
    assert abs(film.mean() - ref.mean()) / ref.mean() < 1e-3
    assert rays == ref_rays


def test_one_shard_is_the_unsharded_render(scene, whole):
    cam = procedural.default_camera(W, W)
    img, rays = render_wavefront_stats(scene, cam, SPP, rng.make_key(3), CFG, LANES,
                                       device="cpu")
    assert torch.equal(whole[0].reshape(W, W, 3), img) and whole[1] == rays
    fused, frays = render_wavefront_fused(scene, cam, SPP, rng.make_key(3), CFG, LANES,
                                          chunk_spp=SPP, device="cpu")
    assert torch.equal(fused, img) and frays == rays


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("body", [M.render_wavefront_shard, M.render_fused_shard])
def test_slices_equal_whole_render(scene, whole, body, n):
    cam = procedural.default_camera(W, W)
    parts = [body(scene, cam, SPP, rng.make_key(3), i, n, CFG, LANES // n) for i in range(n)]
    assert torch.equal(torch.cat([p[0] for p in parts]), whole[0])
    assert sum(p[1] for p in parts) == whole[1]


@pytest.mark.parametrize("n", [2, 4])
def test_lockstep_slices_equal_whole_render(scene, n):
    cam = procedural.default_camera(8, 8)
    one = render(scene, cam, 2, rng.make_key(7), CFG, device="cpu").reshape(64, 3)
    assert torch.equal(M.render_shard(scene, cam, 2, rng.make_key(7), 0, 1, CFG), one)
    parts = [M.render_shard(scene, cam, 2, rng.make_key(7), i, n, CFG) for i in range(n)]
    assert torch.equal(torch.cat(parts), one)


@pytest.mark.parametrize("n", [2, 4])
def test_wavetape_record_slices_equal_whole(scene, n):
    """Slot (i, sample * num_pix_local + p) of shard s is slot (i, sample *
    num_pix + s * num_pix_local + p) of the whole recording."""
    cam, spp, lanes = procedural.default_camera(8, 8), 2, 64
    rec, film = record_paths_wavefront(scene, cam, spp, rng.make_key(5), CFG, lanes)
    mi = CFG.max_iters
    npl = 64 // n
    recs, films = [], []
    for s in range(n):
        r, f = record_paths_wavefront(scene, cam, spp, rng.make_key(5), CFG, lanes // n,
                                      pix_offset=s * npl, num_pix_local=npl)
        recs.append(r.reshape(mi, spp, npl))
        films.append(f)
    assert torch.equal(torch.cat(recs, dim=2).reshape(mi, spp * 64), rec)
    assert torch.equal(torch.cat(films), film)


def _sum_shards(outs):
    """Loss and grads of N shard bodies summed in shard order (the
    all-reduce's sum)."""
    loss = sum(o[0] for o in outs)
    grads = [[sum(getattr(o[1][k], f) for o in outs) for f in MAT_FIELDS] for k in (0, 1)]
    return loss, grads


def _assert_grads_close(a, b, rtol):
    for ga, gb in zip(a, b):
        for f, x, y in zip(MAT_FIELDS, ga, gb):
            x, y = torch.as_tensor(x), torch.as_tensor(y)
            scale = max(float(y.abs().max()), 1e-12)
            assert float((x - y).abs().max()) <= rtol * scale, f"{f}: {x} vs {y}"


@pytest.fixture(scope="module")
def train_setup(scene):
    cam = procedural.default_camera(8, 8)
    target = torch.from_numpy(worker.train_target(8))
    return scene, cam, target


def _grads(step):
    return [[getattr(step[1][k], f) for f in MAT_FIELDS] for k in (0, 1)]


@pytest.mark.parametrize("body", [M.render_grad_shard, M.train_step_replay_shard])
def test_grads_across_slice_counts(train_setup, body):
    scene, cam, target = train_setup
    one = body(scene, cam, target, 2, rng.make_key(9), 0, 1, CFG)
    two = [body(scene, cam, target, 2, rng.make_key(9), i, 2, CFG) for i in range(2)]
    loss2, grads2 = _sum_shards(two)
    assert float(one[0]) == pytest.approx(float(loss2), rel=1e-5)
    _assert_grads_close(grads2, _grads(one), 1e-5)
    if body is M.train_step_replay_shard:
        assert torch.equal(torch.cat([t[2] for t in two]), one[2])


def test_wavetape_step_equals_replay_step_c5(train_setup):
    """The sharded wavetape step divides its cotangent by spp (ROADMAP C5):
    its grads are the replay step's at spp = 4, where JAX's are 4x larger
    (mesh.py:339)."""
    scene, cam, target = train_setup
    mesh1 = M.make_ray_mesh("cpu")
    w_loss, w_grads, w_img = M.train_step_wavetape_sharded(scene, cam, target, 4,
                                                           rng.make_key(9), mesh1, CFG, 64, 64)
    r_loss, r_grads, r_img = M.train_step_replay_sharded(scene, cam, target, 4,
                                                         rng.make_key(9), mesh1, CFG)
    _assert_grads_close(_grads((w_loss, w_grads)), _grads((r_loss, r_grads)), 1e-4)
    assert float(w_loss) == pytest.approx(float(r_loss), rel=1e-4)
    np.testing.assert_allclose(w_img.numpy(), r_img.numpy(), rtol=1e-4, atol=1e-5)
    # one rank is the one-device step
    o_loss, o_grads, o_img = M.train_step_wavetape(scene, cam, target, 4, rng.make_key(9),
                                                   CFG, 64, 64, device="cpu")
    assert torch.equal(o_img, w_img) and torch.equal(o_loss, w_loss)
    _assert_grads_close(_grads((o_loss, o_grads)), _grads((w_loss, w_grads)), 0.0)


def test_sharded_entry_points_one_rank(train_setup):
    """On a mesh of one process each entry point is its shard body over the
    whole image, reshaped; the fused engine checks the slice's lanes."""
    scene, cam, target = train_setup
    mesh1 = M.make_ray_mesh("cpu")
    assert (mesh1.world_size, mesh1.rank, mesh1.group) == (1, 0, None)
    img = M.render_sharded(scene, cam, 2, rng.make_key(7), mesh1, CFG)
    assert torch.equal(img, render(scene, cam, 2, rng.make_key(7), CFG, device="cpu"))
    f_img, f_rays = M.render_fused_sharded(scene, cam, 2, rng.make_key(7), mesh1, CFG, 64)
    w_img, w_rays = M.render_wavefront_sharded(scene, cam, 2, rng.make_key(7), mesh1, CFG, 64)
    assert f_img.shape == (8, 8, 3) and torch.equal(f_img, w_img) and f_rays == w_rays
    with pytest.raises(ValueError, match="lanes"):
        M.render_fused_shard(scene, cam, 2, rng.make_key(7), 1, 2, CFG, 24)
    loss, grads = M.render_grad_sharded(scene, cam, target, 2, rng.make_key(9), mesh1, CFG)
    ref = M.render_grad_shard(scene, cam, target, 2, rng.make_key(9), 0, 1, CFG)
    assert torch.equal(loss, ref[0])
    _assert_grads_close(_grads((loss, grads)), _grads(ref), 0.0)


def test_initialize_is_a_noop_alone(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    distributed.initialize(device="cpu")
    assert not torch.distributed.is_initialized()
    assert distributed.process_info() == {"process_index": 0, "process_count": 1,
                                          "local_devices": 1, "global_devices": 1}
    assert distributed.global_ray_mesh("cpu").world_size == 1
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.local_device("cuda") == torch.device("cuda", 3)
    assert distributed.local_device("cpu") == torch.device("cpu")


def test_two_processes_gloo_equal_one(tmp_path):
    """World size 2 over gloo equals world size 1: the gathered image bit
    for bit, the ray count exactly, loss and grads at rtol 1e-5."""
    out = tmp_path / "rank0.npz"
    init = tmp_path / "rendezvous"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tools",
                                                            "torch_multihost_worker.py"),
                               str(r), "2", str(init), str(out), "cpu"],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-3000:]}"
    got = np.load(out)
    assert int(got["process_count"]) == 2 and int(got["global_devices"]) == 2

    ref = worker.run(M.make_ray_mesh("cpu"))
    np.testing.assert_array_equal(got["img"], ref["img"])
    assert int(got["rays"]) == int(ref["rays"])
    np.testing.assert_array_equal(got["train_img"], ref["train_img"])
    assert float(got["loss"]) == pytest.approx(float(ref["loss"]), rel=1e-5)
    for key in ref:
        if key.startswith(("tri.", "sph.")):
            scale = max(float(np.abs(ref[key]).max()), 1e-12)
            assert float(np.abs(got[key] - ref[key]).max()) <= 1e-5 * scale, key
    # all six entry points: every image, count, loss and grad
    assert {k for k in got.files if k not in ("process_count", "global_devices")} == set(ref)
    verdict = worker.compare(got, ref)
    assert verdict["pass"], verdict


def test_initialize_from_the_torchrun_environment(tmp_path):
    """initialize() without arguments joins the group that torchrun's
    variables describe (env:// rendezvous); one rank of gloo here."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    out = tmp_path / "rank0.npz"
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "torch_multihost_worker.py"),
                           str(out), "cpu"], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = np.load(out)
    assert int(got["process_count"]) == 1 and got["img"].shape == (W, W, 3)
