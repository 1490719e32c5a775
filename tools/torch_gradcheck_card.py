"""Gradient checks and the backward's cost on the card (the JAX package's
tools/gradcheck_tpu.py, with tools/replay_memory.py's question folded in).

  1. replay-backward grads (diff/replay.py) against scan-AD grads
     (diff/grad.py), Cornell + spheres 24x24 @ 8 spp: per field of both
     material tables, max |a - b| / max |scan-AD| below 1e-3;
  2. forward mode (grad.material_jvp) against reverse mode on a random probe
     direction over the six material fields, 24x24 @ 4 spp: relative error
     below 1e-3; the forward render's kernel B3 launches;
  3. seconds per step of train_step_replay_sharded and
     train_step_wavetape_sharded at 128x128 @ 64 spp, world size 1;
  4. the tapes' bytes per lane and iteration (the lockstep record and the
     wavetape) and the peak memory of scan-AD, replay and wavetape grads
     at 64x64 @ 4 spp (torch.cuda.max_memory_allocated above what was held);
  5. mesh gradients: blob82k with KD cells of 1024, 32x32 @ 4 spp, the
     wavetape (diff/wavetape.py) against scan-AD: per field below 1e-3, the
     primals within 1e-3; every search through kernel B2 (its launches).

    python tools/torch_gradcheck_card.py          # on the card, ~5 min
    python tools/torch_gradcheck_card.py --device cpu --quick

Prints one JSON object; on the card it also writes
docs/torch_gradcheck_card.json (--json to write elsewhere). --quick runs
sections 1, 2 and 5 at 8x8 @ 2 spp on sphere_mesh_scene(2) with cells of 64.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pathtrace_tpu_torch import bench  # noqa: E402
from pathtrace_tpu_torch.diff import (material_grads, material_grads_replay,  # noqa: E402
                                      material_grads_wavetape, record_paths,
                                      record_paths_wavefront)
from pathtrace_tpu_torch.diff.grad import MAT_FIELDS, material_jvp, render_with_params  # noqa: E402
from pathtrace_tpu_torch.integrator.config import IntegratorConfig  # noqa: E402
from pathtrace_tpu_torch.models import procedural  # noqa: E402
from pathtrace_tpu_torch.models.scene import Material  # noqa: E402
from pathtrace_tpu_torch.ops.kd_raycast import kd_closest_plain  # noqa: E402
from pathtrace_tpu_torch.ops.mt_closest import mt_closest_plain  # noqa: E402
from pathtrace_tpu_torch.ops.cuda import kd_raycast as kd_kernel  # noqa: E402
from pathtrace_tpu_torch.ops.cuda import mt_closest as mt_kernel  # noqa: E402
from pathtrace_tpu_torch.parallel.mesh import (make_ray_mesh,  # noqa: E402
                                               train_step_replay_sharded,
                                               train_step_wavetape_sharded)
from pathtrace_tpu_torch.utils import rng  # noqa: E402
from pathtrace_tpu_torch.utils.device import resolve_device  # noqa: E402

TOL = 1e-3
# the same call through a kernel and through its plain search takes the same
# winners, so the same primal and forward-mode numbers bit for bit; reverse
# mode's gradients sum a gather's cotangents with atomics, in no fixed order
PLAIN_GRAD_TOL = 1e-5


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rel_err(ref: torch.Tensor, x: torch.Tensor) -> float:
    """max |ref - x| / max(max |ref|, 1e-6), as the JAX tool takes it."""
    ref, x = ref.detach().double().cpu(), x.detach().double().cpu()
    return float((ref - x).abs().max() / max(ref.abs().max().item(), 1e-6))


def field_errors(ref: Material, mine: Material) -> dict:
    return {f: rel_err(getattr(ref, f), getattr(mine, f)) for f in MAT_FIELDS}


def replay_vs_scan(device="cuda", side: int = 24, spp: int = 8) -> dict:
    """Section 1."""
    dev = resolve_device(device)
    scene = procedural.cornell_box_scene(include_spheres=True).to(dev)
    cam, cfg, key = procedural.default_camera(side, side), IntegratorConfig(), rng.make_key(11)
    g_tri_r, g_sph_r, img_r = material_grads_replay(scene, cam, spp, key, cfg, device=dev)
    g_tri_s, g_sph_s, _ = material_grads(scene, cam, spp, key, cfg=cfg, device=dev)
    with torch.no_grad():
        img_s = render_with_params(scene, scene.mat, scene.spheres.mat, cam, spp, key, cfg,
                                   device=dev)
    tri, sph = field_errors(g_tri_s, g_tri_r), field_errors(g_sph_s, g_sph_r)
    return {"scene": "cornell+spheres", "resolution": [side, side], "spp": spp,
            "tri_max_rel_err": tri, "sphere_max_rel_err": sph,
            "primal_max_abs_diff": (img_r - img_s).abs().max().item(),
            "pass": max([*tri.values(), *sph.values()]) < TOL}


def forward_vs_reverse(device="cuda", side: int = 24, spp: int = 4, scene=None,
                       against_plain=None) -> dict:
    """Section 2: the directional derivative of sum(image) along a random
    tangent of the triangle materials' six fields, by forward mode and as
    the reverse mode's gradient dotted with the tangent. against_plain
    (default: on the card) runs the forward mode once more through the
    plain all-triangles search (mt_closest_plain), which must give the same
    loss and derivative bit for bit and launch no kernel."""
    dev = resolve_device(device)
    scene = (procedural.cornell_box_scene(include_spheres=True) if scene is None
             else scene).to(dev)
    cam, cfg, key = procedural.default_camera(side, side), IntegratorConfig(), rng.make_key(11)
    g = np.random.default_rng(0)
    tangent = Material(*[torch.from_numpy(g.normal(size=tuple(getattr(scene.mat, f).shape))
                                          .astype(np.float32)).to(dev) for f in MAT_FIELDS])
    mt_kernel.LAUNCHES = kd_kernel.LAUNCHES = 0
    _sync(dev)
    t0 = time.perf_counter()
    loss_f, d_fwd = material_jvp(scene, cam, spp, key, tangent, cfg=cfg, device=dev)
    _sync(dev)
    fwd_s = time.perf_counter() - t0
    launches = {"b3": mt_kernel.LAUNCHES, "b2": kd_kernel.LAUNCHES}
    t0 = time.perf_counter()
    g_tri, _, loss_r = material_grads(scene, cam, spp, key, cfg=cfg, device=dev)
    _sync(dev)
    rev_s = time.perf_counter() - t0
    d_rev = sum((getattr(g_tri, f).double() * getattr(tangent, f).double()).sum().item()
                for f in MAT_FIELDS)
    rel = abs(d_fwd.item() - d_rev) / max(abs(d_fwd.item()), 1e-9)
    plain = None
    if (dev.type == "cuda") if against_plain is None else against_plain:
        mt_kernel.LAUNCHES = kd_kernel.LAUNCHES = 0
        loss_p, d_plain = material_jvp(scene, cam, spp, key, tangent, cfg=cfg,
                                       search=mt_closest_plain, device=dev)
        plain = {"jvp": d_plain.item(), "loss": loss_p.item(),
                 "launches": mt_kernel.LAUNCHES + kd_kernel.LAUNCHES,
                 "equal": bool(torch.equal(loss_p, loss_f) and torch.equal(d_plain, d_fwd))}
    return {"resolution": [side, side], "spp": spp, "jvp": d_fwd.item(), "vjp_dot": d_rev,
            "rel_err": rel, "loss_forward": loss_f.item(), "loss_reverse": loss_r.item(),
            "forward_seconds": fwd_s, "reverse_seconds": rev_s,
            "forward_launches": launches, "plain_search": plain,
            "pass": bool(rel < TOL and (plain is None or (plain["equal"]
                                                          and plain["launches"] == 0)))}


def train_steps(device="cuda", side: int = 128, spp: int = 64, runs: int = 2) -> dict:
    """Section 3: each step once at 4 spp to warm up, then `runs` steps with
    fresh keys; mean seconds a step."""
    dev = resolve_device(device)
    scene, cam, target, cfg, _ = bench.train_problem(dev, side, side)
    mesh = make_ray_mesh(dev)
    paths = side * side * spp
    steps = {
        "train_step_replay": lambda n, k: train_step_replay_sharded(scene, cam, target, n, k,
                                                                    mesh, cfg),
        "train_step_wavetape": lambda n, k: train_step_wavetape_sharded(
            scene, cam, target, n, k, mesh, cfg, min(bench.TRAIN_LANES, side * side * n),
            min(bench.TRAIN_CHUNK, side * side * n)),
    }
    out = {}
    for name, step in steps.items():
        step(4, rng.make_key(99))
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(runs):
            loss, grads, img = step(spp, rng.make_key(100 + i))
        _sync(dev)
        dt = (time.perf_counter() - t0) / runs
        bench.check_train_output(loss, grads, img)
        out[name] = {"resolution": [side, side], "spp": spp, "world_size": mesh.world_size,
                     "runs": runs, "seconds_per_step": dt, "paths_per_sec": paths / dt,
                     "loss": loss.item()}
    return out


def tape_and_memory(device="cuda", side: int = 64, spp: int = 4) -> dict:
    """Section 4."""
    dev = resolve_device(device)
    scene = procedural.cornell_box_scene(include_spheres=True).to(dev)
    cam, cfg, key = procedural.default_camera(side, side), IntegratorConfig(), rng.make_key(0)
    r = 4096
    org = torch.tensor([[0.0, 20.0, 50.0]], device=dev).expand(r, 3)
    dirs = torch.tensor([[0.0, 0.0, -1.0]], device=dev).expand(r, 3)
    _, recs = record_paths(scene, org, dirs, torch.arange(r, device=dev), key, cfg)
    lock_bytes = sum(t.numel() * t.element_size() for t in recs.values())
    paths = side * side * spp
    tape, _ = record_paths_wavefront(scene, cam, spp, key, cfg, paths)
    out = {"lockstep_record": {"lanes": r, "max_iters": cfg.max_iters, "bytes": lock_bytes,
                               "bytes_per_lane_per_iter": lock_bytes / r / cfg.max_iters},
           "wavetape": {"paths": paths, "max_iters": cfg.max_iters,
                        "bytes": tape.numel() * tape.element_size(),
                        "bytes_per_path_per_iter": tape.element_size()}}
    del tape, recs
    peaks = {}
    for name, fn in (
            ("scan_ad", lambda: material_grads(scene, cam, spp, key, cfg=cfg, device=dev)),
            ("replay", lambda: material_grads_replay(scene, cam, spp, key, cfg, device=dev)),
            ("wavetape", lambda: material_grads_wavetape(scene, cam, spp, key, cfg,
                                                         lanes=paths, chunk=paths,
                                                         device=dev))):
        if dev.type != "cuda":
            peaks[name] = None  # not measured: no device allocator on the CPU
            continue
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        fn()
        torch.cuda.synchronize(dev)
        peaks[name] = torch.cuda.max_memory_allocated(dev) - held
    out["peak_backward_bytes"] = {"resolution": [side, side], "spp": spp, **peaks}
    return out


def mesh_grads(device="cuda", scene=None, side: int = 32, spp: int = 4,
               against_plain=None) -> dict:
    """Section 5: wavetape against scan-AD on a KD-cell scene (blob82k with
    cells of 1024 by default), 4,096 recording lanes and replay paths.
    against_plain (default: on the card) runs both once more through the
    plain KD search (kd_closest_plain): the same primals bit for bit, the
    grads within PLAIN_GRAD_TOL, and no kernel launched."""
    dev = resolve_device(device)
    scene = (procedural.blob_mesh_scene().with_kd_binned(max_tris=1024) if scene is None
             else scene).to(dev)
    cam, cfg, key = procedural.default_camera(side, side), IntegratorConfig(), rng.make_key(5)
    paths = side * side * spp
    kd_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    g_w, _, img_w = material_grads_wavetape(scene, cam, spp, key, cfg, lanes=min(4096, paths),
                                            chunk=min(4096, paths), device=dev)
    g_s, _, loss_s = material_grads(scene, cam, spp, key, cfg=cfg, device=dev)
    _sync(dev)
    seconds = time.perf_counter() - t0
    launches = kd_kernel.LAUNCHES
    plain = None
    if (dev.type == "cuda") if against_plain is None else against_plain:
        kd_kernel.LAUNCHES = mt_kernel.LAUNCHES = 0
        g_wp, _, img_wp = material_grads_wavetape(scene, cam, spp, key, cfg,
                                                  lanes=min(4096, paths), chunk=min(4096, paths),
                                                  search=kd_closest_plain, device=dev)
        g_sp, _, loss_sp = material_grads(scene, cam, spp, key, cfg=cfg,
                                          search=kd_closest_plain, device=dev)
        errs_p = {"wavetape": field_errors(g_wp, g_w), "scan_ad": field_errors(g_sp, g_s)}
        worst = max(max(e.values()) for e in errs_p.values())
        plain = {"max_rel_err": errs_p, "launches": kd_kernel.LAUNCHES + mt_kernel.LAUNCHES,
                 "primal_equal": bool(torch.equal(img_wp, img_w) and torch.equal(loss_sp, loss_s)),
                 "pass": False}
        plain["pass"] = bool(plain["primal_equal"] and worst <= PLAIN_GRAD_TOL
                             and plain["launches"] == 0)
    with torch.no_grad():
        img_s = render_with_params(scene, scene.mat, scene.spheres.mat, cam, spp, key, cfg,
                                   device=dev)
    errs = field_errors(g_s, g_w)
    primal = (img_w - img_s).abs().max().item()
    finite = all(bool(torch.isfinite(getattr(g, f)).all()) for g in (g_w, g_s)
                 for f in MAT_FIELDS)
    return {"scene": f"{scene.num_tris} triangles, {scene.clusters.num_clusters} KD cells",
            "resolution": [side, side], "spp": spp,
            "wavetape_vs_scan_ad_max_rel_err": errs, "primal_max_abs_diff": primal,
            "b2_launches": launches, "seconds": seconds, "plain_search": plain,
            "pass": bool(finite and max(errs.values()) < TOL and primal < TOL
                         and (launches > 0 or dev.type != "cuda")
                         and (plain is None or plain["pass"]))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="sections 1, 2 and 5 at 8x8 @ 2 spp on a small mesh")
    ap.add_argument("--json", default=None, help="report file (default on the card: "
                    "docs/torch_gradcheck_card.json; on the CPU: none)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    out = bench.card_fields(dev)
    if args.quick:
        small = procedural.sphere_mesh_scene(2).with_kd_binned(max_tris=64)
        out["replay_vs_scan_ad"] = replay_vs_scan(dev, 8, 2)
        out["forward_vs_reverse"] = forward_vs_reverse(dev, 8, 2)
        out["mesh_grads"] = mesh_grads(dev, small, 8, 2)
    else:
        out["replay_vs_scan_ad"] = replay_vs_scan(dev)
        print("replay vs scan-AD:", json.dumps(out["replay_vs_scan_ad"]), file=sys.stderr,
              flush=True)
        out["forward_vs_reverse"] = forward_vs_reverse(dev)
        print("forward vs reverse:", json.dumps(out["forward_vs_reverse"]), file=sys.stderr,
              flush=True)
        out.update(train_steps(dev))
        print("train steps:", out["train_step_replay"], out["train_step_wavetape"],
              file=sys.stderr, flush=True)
        out["tapes_and_memory"] = tape_and_memory(dev)
        print("tapes and memory:", json.dumps(out["tapes_and_memory"]), file=sys.stderr,
              flush=True)
        out["mesh_grads"] = mesh_grads(dev)
    out["wall_seconds_total"] = time.perf_counter() - t0
    out["pass"] = bool(out["replay_vs_scan_ad"]["pass"] and out["forward_vs_reverse"]["pass"]
                       and out["mesh_grads"]["pass"])
    path = args.json or (os.path.join(REPO, "docs", "torch_gradcheck_card.json")
                         if out["card"] and not args.quick else None)
    if path:
        with open(path, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out))
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
