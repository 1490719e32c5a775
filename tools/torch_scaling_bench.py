"""Weak and strong scaling of the port's sharded paths over cards (port of
tools/scaling_bench.py).

One call runs the sweep N = 1, 2, 4. The launcher builds the kernels once,
holds kernels B1, B2 and B3 against their plain versions on every card it
will use from this one process when it uses more than one (the device
guard of each wrapper, seen by the kernel library's own CUDA runtime), then
starts `torchrun
--nproc_per_node=N` for each N: one process a card on the first N cards,
NCCL between them (gloo with --device cpu). It fails when the machine has
fewer cards than asked for; it never shrinks the sweep and never runs a
rank on the CPU when a card was asked for.

Each rank, for each N:
  - holds B1 on its slice of the main sweep's image, B2 on 65,536 blob82k
    camera rays and B3 on 65,536 Cornell camera rays against their plain
    versions, bit for bit (on the card only: on the CPU the wrappers are
    the plain versions);
  - runs the six sharded entry points at tools/torch_multihost_worker.py's
    sizes, on the mesh of this rank's card and on a mesh whose device is
    the index-less "cuda"; rank 0 holds both against its one-process call
    (images bit-equal, rays exact, losses and grads at rtol 1e-5);
  - for each sweep: a check pass at 4 spp held the same way against rank
    0's one-process call of the same camera, lanes and spp (for the train
    step at N > 1 also, beside the bar, the one-process step against
    itself with another replay chunking and the N shard bodies summed in
    one process against the all-reduced grads); the rank's
    shard body alone, timed (its own seconds, process CPU seconds and rays:
    contiguous pixel bands of the Cornell box carry paths of unequal
    length, and JAX slices the same way); then the entry point, each call
    timed between a barrier and torch.cuda.synchronize(), with the kernel
    launch counts set to 0 before the first call and read after it; last the collectives
    alone on tensors of the entry point's shapes (the all-gather of a
    (num_pix_local, 3) f32 slice, the all-reduce of the int64 ray count and,
    for the train sweep, of the flat loss-and-grads buffer), mean of 20,
    CUDA events on the card.

The entry point is timed REPEATS times (once with --smoke); a row's
`seconds` is the median over those calls of the slowest rank's seconds
(`repeat_seconds` holds each call's); rays_per_sec_per_chip
= rays / seconds / N, efficiency_vs_1 = rays_per_sec_per_chip over the
N = 1 row's (the JAX tool's keys and formula). Weak mode keeps the tile
and the lane pool of one card fixed (camera (W, H * N), lanes LANES * N);
strong mode splits one image N ways. The sweeps (per card in weak mode):

  main       fused, Cornell + spheres, weak, 256x256 @ 1024 spp, lanes 65,536 (B1)
  reference  fused, Cornell + spheres, strong, 1080x2400, one pass of 1024 spp
             keyed iter_key(make_key(0), 1000), 2,592,000 lanes in all (B1)
  mesh       wavefront, blob82k with KD cells, weak, 256x256 @ 64 spp,
             lanes 65,536 (B2)
  train      train_step_wavetape_sharded, Cornell + spheres against a zero
             target, weak, 128x128 @ 64 spp, recording lanes 1,048,576,
             replay chunks 262,144 (B3)
  job        at N = 4 only: the reference's whole job (tools/
             torch_reference_frame.py), 1080x2400 @ 8 passes x 1024 spp, pass
             p keyed iter_key(make_key(0), 1000 + p), one render_fused_sharded
             a pass; its rays equal, and its image mean and channel sums
             within 1e-5 relative of, docs/torch_reference_frame.json's.

    python tools/torch_scaling_bench.py                 # the five sweeps, 4 cards
    python tools/torch_scaling_bench.py --smoke --sizes 1   # chip_smoke.py phase 9
    SCALE_ENGINE=fused SCALE_MODE=strong python tools/torch_scaling_bench.py
    python tools/torch_scaling_bench.py --device cpu --sizes 1,2 --smoke   # gloo
    # the train sweep again, in place of its rows in the committed report:
    python tools/torch_scaling_bench.py --only train --merge docs/torch_scaling_bench.json

Any of SCALE_MODE (weak | strong), SCALE_ENGINE (wavefront | fused),
SCALE_SIDE (tile side, 64), SCALE_SPP (8) or SCALE_LANES (lanes a card,
4096) set runs the JAX tool's one sweep on Cornell + spheres with those
values instead. On the card the result goes to docs/torch_scaling_bench.json
(--json to write elsewhere; on the CPU only with --json); the last line of
standard output is {"rows": ..., "mode": ..., "platform": ...}.

A rank is started as
    torch_scaling_bench.py --worker PLAN.json OUT.json [RANK WORLD INIT_FILE]
(torchrun's environment, or an explicit file:// rendezvous as the CPU tests
start it).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

CHECK_SPP = 4
GRAD_RTOL = 1e-5  # the sums over ranks are taken in another order
JOB_RTOL = 1e-5  # the job's image statistics: one launch a pass against chunks of 256 spp
COLLECTIVE_RUNS = 20
REPEATS = 3  # timed calls of each row's entry point: the host-bound rows vary from call to call
KERNEL_CHECK_SIDE = 256  # 65,536 rays / pixels a rank

SWEEPS = [
    {"name": "main", "engine": "fused", "scene": "cornell", "mode": "weak", "width": 256,
     "height": 256, "spp": 1024, "lanes": 65536, "key_pass": 0, "kernel": "B1"},
    {"name": "reference", "engine": "fused", "scene": "cornell", "mode": "strong", "width": 1080,
     "height": 2400, "spp": 1024, "lanes": 2592000, "key_pass": 0, "kernel": "B1"},
    {"name": "mesh", "engine": "wavefront", "scene": "blob82k", "mode": "weak", "width": 256,
     "height": 256, "spp": 64, "lanes": 65536, "key_pass": None, "kernel": "B2"},
    {"name": "train", "engine": "train", "scene": "cornell", "mode": "weak", "width": 128,
     "height": 128, "spp": 64, "lanes": 1048576, "chunk": 262144, "key_pass": None,
     "kernel": "B3"},
]
JOB = {"name": "job", "n_devices": 4, "width": 1080, "height": 2400, "passes": 8, "spp": 1024,
       "lanes": 2592000, "reference": "docs/torch_reference_frame.json"}
# chip_smoke.py phase 9: each path at small depth
SMOKE = [
    dict(SWEEPS[0], spp=64),
    dict(SWEEPS[2], width=64, height=64, spp=4, lanes=4096),
    dict(SWEEPS[3], width=32, height=32, spp=8, lanes=8192, chunk=8192),
]


def env_sweep(env) -> dict | None:
    """The JAX tool's one sweep from SCALE_* (its defaults), or None when no
    SCALE_* variable is set."""
    names = ("SCALE_MODE", "SCALE_ENGINE", "SCALE_SIDE", "SCALE_SPP", "SCALE_LANES")
    if not any(n in env for n in names):
        return None
    engine = env.get("SCALE_ENGINE", "wavefront")
    if engine not in ("wavefront", "fused"):
        raise ValueError(f"SCALE_ENGINE={engine!r}: wavefront or fused")
    mode = env.get("SCALE_MODE", "weak")
    if mode not in ("weak", "strong"):
        raise ValueError(f"SCALE_MODE={mode!r}: weak or strong")
    side = int(env.get("SCALE_SIDE", 64))
    return {"name": f"{engine}_{mode}", "engine": engine, "scene": "cornell", "mode": mode,
            "width": side, "height": side, "spp": int(env.get("SCALE_SPP", 8)),
            "lanes": int(env.get("SCALE_LANES", 4096)), "key_pass": None,
            "kernel": "B1" if engine == "fused" else "B3"}


def sweep_shape(sweep: dict, n: int) -> tuple[int, int, int]:
    """(width, height, lanes in all) of `sweep` over n ranks: weak mode grows
    the image's height and the lanes with n (JAX scaling_bench.py:76-82)."""
    if sweep["mode"] == "weak":
        return sweep["width"], sweep["height"] * n, sweep["lanes"] * n
    return sweep["width"], sweep["height"], sweep["lanes"]


def efficiency(rows: list) -> None:
    """rays_per_sec, rays_per_sec_per_chip and efficiency_vs_1 of each row, in
    place, from its rays and seconds (JAX scaling_bench.py:94-104)."""
    for r in rows:
        r["rays_per_sec"] = r["rays"] / r["seconds"]
        r["rays_per_sec_per_chip"] = r["rays_per_sec"] / r["n_devices"]
        r["paths_per_sec"] = r["paths"] / r["seconds"]
        r["paths_per_sec_per_chip"] = r["paths_per_sec"] / r["n_devices"]
    base = next(r for r in rows if r["n_devices"] == 1)["rays_per_sec_per_chip"]
    for r in rows:
        r["efficiency_vs_1"] = r["rays_per_sec_per_chip"] / base


# ---------------------------------------------------------------------------
# the work of one rank
# ---------------------------------------------------------------------------

def _scene(name: str, dev):
    from pathtrace_tpu_torch.models import procedural

    if name == "cornell":
        return procedural.cornell_box_scene(include_spheres=True).to(dev)
    if name == "blob82k":
        return procedural.blob_mesh_scene().with_kd_binned(max_tris=1024).to(dev)
    raise ValueError(f"no scene {name!r}")


def _key(sweep: dict):
    from pathtrace_tpu_torch.utils import rng

    base = rng.make_key(0)
    return base if sweep.get("key_pass") is None else rng.iter_key(base, 1000 + sweep["key_pass"])


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _kernels() -> dict:
    """The kernel wrappers by name; each counts its launches in LAUNCHES."""
    from pathtrace_tpu_torch.ops.cuda import bounce_kernel, kd_raycast, mt_closest

    return {"B1": bounce_kernel, "B2": kd_raycast, "B3": mt_closest}


def _counts() -> dict:
    return {name: wrapper.LAUNCHES for name, wrapper in _kernels().items()}


def _zero_counts() -> None:
    for wrapper in _kernels().values():
        wrapper.LAUNCHES = 0


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def kernel_checks(dev, shard: int = 0, n_shards: int = 1, scenes: dict | None = None) -> dict:
    """B1, B2 and B3 on `dev` against their plain versions, bit for bit: B1
    on pixel slice `shard` of n_shards of Cornell + spheres at 256 x (256 *
    n_shards) @ 4 spp with 65,536 lanes (the main sweep's check pass)
    against the wavefront through mt_closest_plain; B2 on 65,536 blob82k
    camera rays against kd_closest_plain and B3 on 65,536 Cornell camera
    rays against mt_closest_plain, both modes. Each kernel must launch."""
    from pathtrace_tpu_torch.integrator.config import IntegratorConfig
    from pathtrace_tpu_torch.integrator.wavefront import _run_wavefront
    from pathtrace_tpu_torch.models import procedural
    from pathtrace_tpu_torch.ops import kd_raycast as kd
    from pathtrace_tpu_torch.ops import mt_closest as mt
    from pathtrace_tpu_torch.parallel import mesh as M

    scenes = {} if scenes is None else scenes
    cornell = scenes["cornell"] if "cornell" in scenes else _scene("cornell", dev)
    blob = scenes["blob82k"] if "blob82k" in scenes else _scene("blob82k", dev)
    side, cfg, key = KERNEL_CHECK_SIDE, IntegratorConfig(), _key(SWEEPS[0])
    out = {"device": str(dev)}
    before = _counts()

    cam = procedural.default_camera(side, side * n_shards)
    pix0, npl = M.pixel_slice(cam, shard, n_shards)
    k_img, k_rays = M.render_fused_shard(cornell, cam, CHECK_SPP, key, shard, n_shards, cfg,
                                         side * side)
    p_img, p_rays = _run_wavefront(cornell, cam, CHECK_SPP, key, cfg, side * side,
                                   pix_offset=pix0, num_pix_local=npl,
                                   search=mt.mt_closest_plain)
    out["B1"] = {"what": f"slice {shard} of {n_shards} of {side}x{side * n_shards}@{CHECK_SPP}spp",
                 "bit_equal": bool(torch.equal(k_img, p_img)), "rays_equal": k_rays == p_rays,
                 "on_device": k_img.device == dev}

    cam = procedural.default_camera(side, side)
    for name, scene in (("B2", blob), ("B3", cornell)):
        args = kd.probe_rays(scene, cam, side * side, seed=3)["camera"]
        equal = True
        for mode in kd.MODES:
            if name == "B2":  # every field of every ray
                k = kd.kd_closest(scene.clusters, *args, mode)
                p = kd.kd_closest_plain(scene.clusters, *args, mode)
                equal &= all(torch.equal(a, b) for a, b in zip(k, p))
            else:  # hit and idx, and t/u/v where hit (as chip_smoke.py holds B3)
                k_hit, *k = mt.mt_closest(scene.tris, *args, mode)
                p_hit, *p = mt.mt_closest_plain(scene.tris, *args, mode)
                equal &= bool(torch.equal(k_hit, p_hit)) and all(
                    torch.equal(a[p_hit], b[p_hit]) for a, b in zip(k, p))
        out[name] = {"what": f"{args[0].shape[0]} camera rays, closest and shadow",
                     "bit_equal": bool(equal), "on_device": args[0].device == dev}
    after = _counts()
    for name in ("B1", "B2", "B3"):
        out[name]["launches"] = after[name] - before[name]
    out["pass"] = all(out[k]["bit_equal"] and out[k]["on_device"] and out[k]["launches"] > 0
                      and out[k].get("rays_equal", True) for k in ("B1", "B2", "B3"))
    return out


def _entry(sweep: dict, scene, cam, key, cfg, lanes: int, target):
    """The sweep's entry point as f(mesh, spp, chunk=the sweep's) -> (image,
    rays or None, (loss, grads) or None) and its shard body as g(shard, n,
    spp) -> rays or None (chunk: the train step's replay chunk). `lanes` is
    the lanes in all: the entry point and the shard body of each rank both
    take lanes // (world size), the fused and wavefront entry points through
    their own split (mesh._local_lanes), the train step here, since its
    `lanes` are a rank's."""
    from pathtrace_tpu_torch.parallel import mesh as M

    engine = sweep["engine"]
    if engine in ("fused", "wavefront"):
        sharded = M.render_fused_sharded if engine == "fused" else M.render_wavefront_sharded
        shard_body = M.render_fused_shard if engine == "fused" else M.render_wavefront_shard

        def entry(m, spp, chunk=None):
            img, rays = sharded(scene, cam, spp, key, m, cfg, lanes)
            return img, rays, None

        def body(shard, n, spp):
            return shard_body(scene, cam, spp, key, shard, n, cfg, lanes // n)[1]
    elif engine == "train":
        def entry(m, spp, chunk=sweep.get("chunk")):
            loss, grads, img = M.train_step_wavetape_sharded(
                scene, cam, target, spp, key, m, cfg, lanes // m.world_size, chunk)
            return img, None, (loss, grads)

        def body(shard, n, spp):
            M.train_step_wavetape_shard(scene, cam, target, spp, key, shard, n, cfg,
                                        lanes // n, sweep["chunk"])
            return None
    else:
        raise ValueError(f"no engine {engine!r}")
    return entry, body


def _grad_rel(a, b) -> dict:
    """max |a - b| / max |b| of each loss and grad field of two (loss,
    (g_tri, g_sph)) steps, b the reference (the worker's `compare`)."""
    import torch_multihost_worker as six

    return six.compare(six.grad_arrays("", *a), six.grad_arrays("", *b))["grads_rel_err"]


def _barrier(ray_mesh):
    """A barrier over the mesh's ranks as a function (nothing for one
    process without a group)."""
    import torch.distributed as dist

    if ray_mesh.group is None:
        return lambda: None
    dev = ray_mesh.device
    ids = [dev.index if dev.index is not None else torch.cuda.current_device()] \
        if dev.type == "cuda" else None
    return lambda: dist.barrier(group=ray_mesh.group, device_ids=ids)


def _timed(fn, dev, group_barrier) -> tuple:
    """(result, wall seconds, process CPU seconds) of fn() started after a
    barrier and ended by a synchronize."""
    group_barrier()
    _sync(dev)
    t0, c0 = time.perf_counter(), time.process_time()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0, time.process_time() - c0


def _collective_ms(fn, dev, group_barrier) -> float:
    """Mean milliseconds of COLLECTIVE_RUNS calls of fn() after a warm-up:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    group_barrier()
    _sync(dev)
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(COLLECTIVE_RUNS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / COLLECTIVE_RUNS
    t0 = time.perf_counter()
    for _ in range(COLLECTIVE_RUNS):
        fn()
    return (time.perf_counter() - t0) * 1e3 / COLLECTIVE_RUNS


def run_sweep(sweep: dict, ray_mesh, scenes: dict, repeats: int = 1) -> dict:
    """This rank's part of one sweep at the mesh's size (module docstring),
    the entry point timed `repeats` times; rank 0's dict also holds the
    check against its one-process call."""
    import torch.distributed as dist

    from pathtrace_tpu_torch.diff.grad import MAT_FIELDS
    from pathtrace_tpu_torch.integrator.config import IntegratorConfig
    from pathtrace_tpu_torch.models import procedural
    from pathtrace_tpu_torch.parallel import mesh as M

    dev, n, rank = ray_mesh.device, ray_mesh.world_size, ray_mesh.rank
    barrier = _barrier(ray_mesh)
    if sweep["scene"] not in scenes:
        scenes[sweep["scene"]] = _scene(sweep["scene"], dev)
    scene = scenes[sweep["scene"]]
    w, h, lanes = sweep_shape(sweep, n)
    cam, key, cfg = procedural.default_camera(w, h), _key(sweep), IntegratorConfig()
    target = torch.zeros((h, w, 3), device=dev)
    entry, body = _entry(sweep, scene, cam, key, cfg, lanes, target)
    out = {"rank": rank, "device": str(dev)}

    # the check pass against rank 0's one-process call of the same job
    img, rays, grads = entry(ray_mesh, CHECK_SPP)
    if rank == 0:
        one = M.RayMesh(1, 0, None, dev)
        o_img, o_rays, o_grads = entry(one, CHECK_SPP)
        check = {"spp": CHECK_SPP, "bit_equal": bool(torch.equal(img, o_img)),
                 "rays_equal": rays == o_rays}
        if grads is not None:
            check["grads_rel_err"] = _grad_rel(grads, o_grads)
            check["grads_max_rel_err"] = max(check["grads_rel_err"].values())
        if grads is not None and n > 1:
            # beside the bar, what float32 summation order alone does at this
            # size: the one-process step again with its replay in chunks of a
            # quarter of its paths, and the N shard bodies summed in rank order
            # in this process (the sum the all-reduce takes in its own order)
            chunk = w * h * CHECK_SPP // 4
            check["reorder_rel_err"] = _grad_rel(entry(one, CHECK_SPP, chunk)[2], o_grads)
            check["reorder_chunk"] = chunk
            parts = [M.train_step_wavetape_shard(scene, cam, target, CHECK_SPP, key, i, n, cfg,
                                                 lanes // n, sweep["chunk"])[:2]
                     for i in range(n)]
            summed = (sum(p[0] for p in parts), tuple(
                type(g)(**{f: sum(getattr(p[1][t], f) for p in parts) for f in MAT_FIELDS})
                for t, g in enumerate(parts[0][1])))
            check["shard_sum_rel_err"] = _grad_rel(grads, summed)
        check["pass"] = (check["bit_equal"] and check["rays_equal"]
                         and check.get("grads_max_rel_err", 0.0) <= GRAD_RTOL)
        out["check"] = check
        del o_img, o_grads
    del img, grads

    # the rank's own work: its shard body alone
    npl = M.pixel_slice(cam, rank, n)[1]
    b_rays, out["body_seconds"], out["body_cpu_seconds"] = _timed(
        lambda: body(rank, n, sweep["spp"]), dev, barrier)
    if b_rays is None:  # the train step's rays: its recording sweep's, the wavefront's
        b_rays = M.render_wavefront_shard(scene, cam, sweep["spp"], key, rank, n,
                                          lanes=lanes // n)[1]
    out["body_rays"] = b_rays

    # the entry point `repeats` times, with the launch counts of exactly the first call
    out["seconds"], out["cpu_seconds"] = [], []
    _zero_counts()
    for i in range(repeats):
        (img, rays, grads), seconds, cpu = _timed(lambda: entry(ray_mesh, sweep["spp"]), dev,
                                                  barrier)
        out["seconds"].append(seconds)
        out["cpu_seconds"].append(cpu)
        if i == 0:
            out["launches"] = _counts()
    out["finite"] = bool(torch.isfinite(img).all())
    out["rays"] = rays  # every rank's sum (None for the train step)
    if rank == 0:
        out["image_sha256"], out["image_mean"] = _sha(img), img.mean().item()
        if grads is not None:
            out["loss"] = grads[0].item()
        out["image"] = img.cpu().numpy()
    del img, grads

    # the collectives alone, on tensors of the entry point's shapes
    if ray_mesh.group is not None:
        part = torch.rand((npl, 3), device=dev)
        parts = [torch.empty_like(part) for _ in range(n)]
        count = torch.ones((1,), dtype=torch.int64, device=dev)
        coll = {"slice_shape": [npl, 3],
                "all_gather_ms": _collective_ms(
                    lambda: dist.all_gather(parts, part, group=ray_mesh.group), dev, barrier),
                "all_reduce_rays_ms": _collective_ms(
                    lambda: dist.all_reduce(count, group=ray_mesh.group), dev, barrier)}
        if sweep["engine"] == "train":
            size = 1 + sum(getattr(m, f).numel() for m in (scene.mat, scene.spheres.mat)
                           for f in MAT_FIELDS)
            flat = torch.rand((size,), device=dev)
            coll["grad_buffer_floats"] = size
            coll["all_reduce_grads_ms"] = _collective_ms(
                lambda: dist.all_reduce(flat, group=ray_mesh.group), dev, barrier)
        out["collectives"] = coll
    return out


def run_job(job: dict, ray_mesh, scene) -> dict:
    """The reference's whole job through render_fused_sharded: rank 0's
    summary (wall, pass seconds, rays, image mean and channel sums, as
    tools/torch_reference_frame.py reports them) with this rank's B1
    launches."""
    from pathtrace_tpu_torch.integrator.config import IntegratorConfig
    from pathtrace_tpu_torch.models import procedural
    from pathtrace_tpu_torch.parallel import mesh as M
    from pathtrace_tpu_torch.utils import rng

    dev = ray_mesh.device
    cam, cfg = procedural.default_camera(job["width"], job["height"]), IntegratorConfig()
    base = rng.make_key(0)
    accum = torch.zeros((job["height"], job["width"], 3), device=dev)
    rays, pass_seconds = 0, []
    _zero_counts()
    _barrier(ray_mesh)()
    _sync(dev)
    t0 = time.perf_counter()
    for p in range(job["passes"]):
        tp = time.perf_counter()
        img, n = M.render_fused_sharded(scene, cam, job["spp"], rng.iter_key(base, 1000 + p),
                                        ray_mesh, cfg, job["lanes"])
        accum = accum + img
        rays += n
        _sync(dev)
        pass_seconds.append(time.perf_counter() - tp)
    final = accum / job["passes"]
    _sync(dev)
    wall = time.perf_counter() - t0
    paths = job["width"] * job["height"] * job["passes"] * job["spp"]
    return {"wall_seconds": wall, "pass_seconds": pass_seconds, "rays": rays,
            "camera_paths": paths, "paths_per_sec": paths / wall, "rays_per_sec": rays / wall,
            "image_mean": final.mean().item(),
            "channel_sums": [float(x) for x in final.double().sum(dim=(0, 1)).tolist()],
            "finite": bool(torch.isfinite(final).all()), "b1_launches": _counts()["B1"]}


def entry_point_checks(ray_mesh) -> dict:
    """The six sharded entry points (tools/torch_multihost_worker.py) on
    this rank's mesh and, on the card, on make_ray_mesh("cuda") (a device
    without an index); rank 0 holds each against its one-process call."""
    import torch_multihost_worker as six

    from pathtrace_tpu_torch.parallel import mesh as M

    dev = ray_mesh.device
    meshes = {"mesh": ray_mesh}
    if dev.type == "cuda":
        meshes["indexless_mesh"] = M.make_ray_mesh("cuda")
    got = {name: six.run(m) for name, m in meshes.items()}
    if ray_mesh.rank != 0:
        return {}
    ref = six.run(M.RayMesh(1, 0, None, dev))
    out = {name: dict(six.compare(arrays, ref), mesh_device=str(meshes[name].device))
           for name, arrays in got.items()}
    out["pass"] = all(v["pass"] for v in out.values())
    return out


def worker(plan: dict, out_path: str, rank=None, world=None, init_file=None) -> int:
    """One rank: join the group (torchrun's environment, or a file://
    rendezvous), run the plan, and on rank 0 write every rank's report to
    out_path."""
    import torch.distributed as dist

    from pathtrace_tpu_torch.parallel import distributed

    device = plan["device"]
    if rank is None:
        distributed.initialize(device=device)
    else:
        distributed.initialize(f"file://{init_file}", world, rank, device=device)
    if not dist.is_initialized():
        raise RuntimeError("a rank needs a process group: start it under torchrun or with "
                           "RANK WORLD INIT_FILE")
    try:
        ray_mesh = distributed.global_ray_mesh(device)
        dev, n, rank = ray_mesh.device, ray_mesh.world_size, ray_mesh.rank
        say = (lambda msg: print(f"[scale n={n}] {msg}", file=sys.stderr, flush=True)) \
            if rank == 0 else (lambda msg: None)
        mine = {"rank": rank, "device": str(dev), "backend": dist.get_backend(),
                "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else None}
        scenes = {}
        if dev.type == "cuda":
            scenes = {name: _scene(name, dev) for name in ("cornell", "blob82k")}
            mine["kernel_checks"] = kernel_checks(dev, rank, n, scenes)
            say(f"kernel checks rank 0: pass {mine['kernel_checks']['pass']}")
        if plan.get("six", True):
            mine["entry_points"] = entry_point_checks(ray_mesh)
            say(f"six entry points: {mine['entry_points'].get('pass')}")
        mine["sweeps"] = []
        for sweep in plan["sweeps"]:
            t0 = time.perf_counter()
            mine["sweeps"].append(run_sweep(sweep, ray_mesh, scenes, plan.get("repeats", 1)))
            say(f"sweep {sweep['name']} in {time.perf_counter() - t0:.2f} s")
        job = plan.get("job")
        if job and job["n_devices"] == n:
            scene = scenes["cornell"] if "cornell" in scenes else _scene("cornell", dev)
            mine["job"] = run_job(job, ray_mesh, scene)
            say(f"job wall {mine['job']['wall_seconds']:.3f} s")
        images = {s["name"]: r.pop("image") for s, r in zip(plan["sweeps"], mine["sweeps"])
                  if "image" in r}
        reports = [None] * n
        dist.all_gather_object(reports, mine)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump({"n_devices": n, "ranks": reports}, f)
            if plan.get("keep_images"):
                np.savez(out_path + ".npz", **images)
    finally:
        dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def check_cards(device: str, sizes: list) -> None:
    """Raise unless the sweep can run as asked: a card for every rank of the
    largest N when device is cuda."""
    if torch.device(device).type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but torch.cuda.is_available() is "
                           "False; pass --device cpu to run the ranks on the CPU (gloo)")
    have = torch.cuda.device_count()
    if max(sizes) > have:
        raise RuntimeError(f"the sweep needs {max(sizes)} cards, this machine has {have}; "
                           "pass --sizes to ask for fewer")


def build_once() -> float:
    """The kernel library and the native BVH builder, built once before the
    ranks start (each rank would otherwise run its own nvcc). Seconds."""
    from pathtrace_tpu_torch import native
    from pathtrace_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.build()
    native.get_lib()
    return time.perf_counter() - t0


def device_guard(count: int) -> list:
    """kernel_checks on cuda:0 .. cuda:count-1 from this one process, with
    cuda:0 the current device throughout: each wrapper's torch.cuda.device
    guard must reach the kernel library's own CUDA runtime."""
    current = torch.cuda.current_device()
    cornell, blob = _scene("cornell", "cpu"), _scene("blob82k", "cpu")
    out = []
    for k in range(count):
        dev = torch.device("cuda", k)
        try:
            row = kernel_checks(dev, 0, 1, {"cornell": cornell.to(dev),
                                            "blob82k": blob.to(dev)})
        except RuntimeError as e:  # a launch the card refused: recorded, the sweep goes on
            row = {"device": str(dev), "error": str(e), "pass": False}
        row["current_device"] = torch.cuda.current_device()
        row["pass"] = row["pass"] and row["current_device"] == current
        out.append(row)
        torch.cuda.empty_cache()
    return out


def start_ranks(n: int, plan_path: str, out_path: str, timeout: float) -> None:
    """torchrun --nproc_per_node=n of this file's worker, its output passed
    on to standard error; raises when it fails or passes `timeout` seconds
    (then every process it started is killed). The ranks run with one
    intra-op thread each at every n (torchrun's own default from n = 2), so
    the rows compare like with like."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}", os.path.abspath(__file__), "--worker", plan_path, out_path]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    sys.stderr.flush()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=sys.stderr, start_new_session=True)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if rc is None:
        raise RuntimeError(f"the {n}-rank run passed its {timeout:.0f} s limit")
    if rc != 0:
        raise RuntimeError(f"the {n}-rank run failed (exit {rc})")


def assemble(plan: dict, runs: dict) -> dict:
    """The report of the sweep from each N's rank reports: a row per sweep
    and N, the job, the checks; "pass" when every check passed."""
    sweeps = []
    for i, sweep in enumerate(plan["sweeps"]):
        rows = []
        for n, run in sorted(runs.items()):
            ranks = [r["sweeps"][i] for r in run["ranks"]]
            w, h, lanes = sweep_shape(sweep, n)
            r0 = ranks[0]
            row = {"n_devices": n, "camera": [w, h], "lanes": lanes, "spp": sweep["spp"],
                   "paths": w * h * sweep["spp"], "rays": sum(r["body_rays"] for r in ranks),
                   # each timed call's slowest rank, and their median
                   "repeat_seconds": [max(t) for t in zip(*(r["seconds"] for r in ranks))],
                   "rank_seconds": [statistics.median(r["seconds"]) for r in ranks],
                   "rank_cpu_seconds": [statistics.median(r["cpu_seconds"]) for r in ranks],
                   "rank_body_seconds": [r["body_seconds"] for r in ranks],
                   "rank_body_cpu_seconds": [r["body_cpu_seconds"] for r in ranks],
                   "rank_body_rays": [r["body_rays"] for r in ranks],
                   "rank_launches": [r["launches"] for r in ranks],
                   "check": r0["check"], "finite": all(r["finite"] for r in ranks),
                   "entry_rays": r0["rays"],
                   "image_sha256": r0["image_sha256"], "image_mean": r0["image_mean"]}
            row["seconds"] = statistics.median(row["repeat_seconds"])
            row["body_imbalance"] = max(row["rank_body_seconds"]) / min(row["rank_body_seconds"])
            if "loss" in r0:
                row["loss"] = r0["loss"]
            if "collectives" in r0:
                row["collectives"] = {"rank0": r0["collectives"],
                                      "max_over_ranks": {
                                          k: max(r["collectives"][k] for r in ranks)
                                          for k in r0["collectives"] if k.endswith("_ms")}}
            rows.append(row)
        efficiency(rows)
        entry = dict(sweep, rows=rows)
        if sweep["mode"] == "strong":
            entry["images_bit_equal_across_n"] = len({r["image_sha256"] for r in rows}) == 1
        sweeps.append(entry)

    report = {"sweeps": sweeps, "runs": []}
    for n, run in sorted(runs.items()):
        ranks = run["ranks"]
        report["runs"].append({
            "n_devices": n, "backend": ranks[0]["backend"],
            "devices": [r["device"] for r in ranks], "cards": [r["card"] for r in ranks],
            "kernel_checks": [r.get("kernel_checks") for r in ranks],
            "entry_points": ranks[0].get("entry_points"), "wall_seconds": run["wall_seconds"]})
        if "job" in ranks[0]:
            report["job"] = dict(plan["job"], **ranks[0]["job"],
                                 rank_b1_launches=[r["job"]["b1_launches"] for r in ranks])
    return report


def job_against_reference(job: dict) -> dict:
    """The job's rays, image mean and channel sums against the one-card
    artifact's (docs/torch_reference_frame.json)."""
    with open(os.path.join(REPO, job["reference"])) as f:
        ref = json.load(f)
    rel = lambda a, b: abs(a - b) / abs(b)
    out = {"one_card_wall_seconds": ref["wall_seconds"], "one_card_rays": ref["rays"],
           "rays_equal": job["rays"] == ref["rays"],
           "image_mean_rel_diff": rel(job["image_mean"], ref["image_mean"]),
           "channel_sums_max_rel_diff": max(rel(a, b) for a, b in
                                            zip(job["channel_sums"], ref["channel_sums"])),
           "same_job": (ref["resolution"] == [job["width"], job["height"]]
                        and (ref["passes"], ref["spp_per_pass"]) == (job["passes"], job["spp"]))}
    out["pass"] = (out["same_job"] and out["rays_equal"] and job["finite"]
                   and out["image_mean_rel_diff"] <= JOB_RTOL
                   and out["channel_sums_max_rel_diff"] <= JOB_RTOL)
    return out


def merge(old: dict, new: dict) -> dict:
    """`old` with the sweeps (and the job) of `new` in place of its own of
    the same name, each marked with its call; the rest of `new` (its runs,
    device guard, card, versions, seconds and verdict) under merged_calls."""
    calls = old.get("merged_calls", [])
    tag = f"merged_calls[{len(calls)}]"
    ran = {s["name"]: dict(s, call=tag) for s in new["sweeps"]}
    out = dict(old, sweeps=[ran.pop(s["name"], s) for s in old["sweeps"]])
    out["sweeps"] += list(ran.values())
    if new.get("job"):
        out["job"] = dict(new["job"], call=tag)
    call = {k: v for k, v in new.items() if k not in ("sweeps", "job")}
    call["ran"] = [s["name"] for s in new["sweeps"]] + (["job"] if new.get("job") else [])
    out["merged_calls"] = calls + [call]
    return out


def verdict(report: dict, on_card: bool) -> bool:
    """Every check of the report: each row's check pass and finite image,
    each rank's launches of the sweep's kernel on the card, the strong
    sweeps' images across N, the kernel checks, the six entry points, the
    device guard (of every merged call too) and the job."""
    ok = True
    for sweep in report["sweeps"]:
        ok &= sweep.get("images_bit_equal_across_n", True)
        for row in sweep["rows"]:
            ok &= row["check"]["pass"] and row["finite"]
            ok &= row["entry_rays"] in (None, row["rays"])  # the all-reduced count
            if on_card:
                ok &= all(c[sweep["kernel"]] > 0 for c in row["rank_launches"])
    for call in [report] + report.get("merged_calls", []):
        for run in call["runs"]:
            ok &= run["entry_points"] is None or run["entry_points"]["pass"]  # None: not asked
            if on_card:
                ok &= all(k is not None and k["pass"] for k in run["kernel_checks"])
        ok &= all(row["pass"] for row in call.get("device_guard", []))
    if report.get("job"):
        ok &= report["job"]["against_one_card"]["pass"]
    return bool(ok)


def nccl_version() -> str:
    v = torch.cuda.nccl.version()
    return ".".join(map(str, v)) if isinstance(v, tuple) else str(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="1,2,4", help="rank counts N, comma-separated")
    ap.add_argument("--smoke", action="store_true",
                    help="main 256x256@64, mesh 64x64@4, train 32x32@8 (chip_smoke.py)")
    ap.add_argument("--device", default="cuda", help="cuda (NCCL, a card a rank) or cpu (gloo)")
    ap.add_argument("--json", default=None, help="report file (default on the card: "
                    "docs/torch_scaling_bench.json; on the CPU: none)")
    ap.add_argument("--timeout", type=float, default=1800.0, help="seconds for each N's run")
    ap.add_argument("--only", default=None,
                    help="what to run, comma-separated, of main, reference, mesh, train, job "
                    "and six (the six entry points against one process); default: all. The "
                    "kernel checks always run")
    ap.add_argument("--merge", default=None,
                    help="a report of this tool: write it with the sweeps of this call in place "
                    "of its own of the same name, this call's runs and checks under "
                    "merged_calls")
    ap.add_argument("--worker", nargs="+", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.worker:
        with open(args.worker[0]) as f:
            plan = json.load(f)
        extra = args.worker[2:]
        if extra:
            return worker(plan, args.worker[1], int(extra[0]), int(extra[1]), extra[2])
        return worker(plan, args.worker[1])

    sizes = sorted({int(s) for s in args.sizes.split(",")})
    if sizes[0] != 1:
        raise ValueError(f"--sizes {args.sizes}: the sweep starts at N = 1 (efficiency_vs_1)")
    check_cards(args.device, sizes)
    on_card = torch.device(args.device).type == "cuda"
    custom = env_sweep(os.environ)
    plan = {"device": args.device,
            "sweeps": [custom] if custom else (SMOKE if args.smoke else SWEEPS),
            "job": None if custom or args.smoke else JOB,
            "repeats": 1 if args.smoke else REPEATS}
    if args.only:
        names = set(args.only.split(","))
        unknown = names - {s["name"] for s in plan["sweeps"]} - {"job", "six"}
        if unknown:
            raise ValueError(f"--only: nothing named {sorted(unknown)} here")
        plan["sweeps"] = [s for s in plan["sweeps"] if s["name"] in names]
        plan["job"] = plan["job"] if "job" in names else None
        plan["six"] = "six" in names

    from pathtrace_tpu_torch import bench

    t_all = time.perf_counter()
    report = {"tool": "tools/torch_scaling_bench.py", "sizes": sizes,
              "smoke": args.smoke, "env_sweep": custom is not None,
              **bench.card_fields("cuda:0" if on_card else args.device),
              "cpu_count": os.cpu_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "nccl": nccl_version() if on_card else None,
              "nvidia_smi": bench._run(["nvidia-smi", "--query-gpu=name,power.limit",
                                        "--format=csv,noheader"]).splitlines()
              if on_card else None,
              "check_spp": CHECK_SPP, "grad_rtol": GRAD_RTOL}
    if on_card:
        report["build_seconds"] = build_once()
        t0 = time.perf_counter()
        # on one card the only card is the current one: nothing to guard
        report["device_guard"] = device_guard(max(sizes)) if max(sizes) > 1 else []
        report["device_guard_seconds"] = time.perf_counter() - t0
        for row in report["device_guard"]:
            print(f"[scale] device guard {row['device']} (current device "
                  f"{row['current_device']}): pass {row['pass']} {row.get('error', '')}",
                  file=sys.stderr, flush=True)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        plan_path = os.path.join(tmp, "plan.json")
        with open(plan_path, "w") as f:
            json.dump(plan, f)
        for n in reversed(sizes):  # the largest first: what only several cards show, first
            out_path = os.path.join(tmp, f"n{n}.json")
            t0 = time.perf_counter()
            start_ranks(n, plan_path, out_path, args.timeout)
            with open(out_path) as f:
                runs[n] = json.load(f)
            runs[n]["wall_seconds"] = time.perf_counter() - t0
    report.update(assemble(plan, runs))
    if "job" in report:
        report["job"]["against_one_card"] = job_against_reference(report["job"])
    report["seconds"] = time.perf_counter() - t_all
    report["pass"] = verdict(report, on_card)
    if args.merge:
        with open(args.merge) as f:
            report = merge(json.load(f), report)
        report["pass"] = verdict(report, on_card)

    out = args.json or (os.path.join(REPO, "docs", "torch_scaling_bench.json")
                        if on_card else None)
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=2)
    for sweep in report["sweeps"]:
        for row in sweep["rows"]:
            print(json.dumps({"sweep": sweep["name"], "mode": sweep["mode"],
                              **{k: row[k] for k in ("n_devices", "seconds", "rays_per_sec",
                                                     "rays_per_sec_per_chip",
                                                     "efficiency_vs_1")}}), flush=True)
    if "job" in report:
        job = report["job"]
        print(json.dumps({"sweep": "job", "n_devices": job["n_devices"],
                          "wall_seconds": job["wall_seconds"], "rays": job["rays"],
                          **{k: job["against_one_card"][k] for k in
                             ("one_card_wall_seconds", "rays_equal", "image_mean_rel_diff",
                              "channel_sums_max_rel_diff")}}), flush=True)
    print(json.dumps({"rows": sum(len(s["rows"]) for s in report["sweeps"]),
                      "mode": ",".join(sorted({s["mode"] for s in report["sweeps"]})),
                      "platform": "gpu" if on_card else "cpu", "pass": report["pass"]}))
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
