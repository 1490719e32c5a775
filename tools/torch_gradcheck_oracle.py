"""The strong gradient oracle at its own configuration (the JAX package's
tools/gradcheck_oracle.py): production material gradients against
frozen-sampling finite differences at 1e-3.

Cornell box with both spheres at 24x24 @ 16 spp, IntegratorConfig(
rr_bounce=99, detach_sampling=True): Russian roulette off (its survival
test would flip as h moves), the sampling-side materials frozen at the
base values (diff/fd.py::make_frozen_sampler), so central differences
measure the detached-sampling derivative that autograd computes. Each FD
check halves h from h0 until two estimates agree to 1e-3, then takes the
Richardson extrapolation (diff/fd.py::fd_material_grad_auto). Eight FD
checks on the walls, the light and the spheres, and the transparent
sphere's IOR (specular[1, 0]), which FD cannot probe (the refract/TIR
branch flips densely in eta), by forward mode (grad.material_jvp) against
reverse mode. A check passes at |ad - fd| / max(|fd|, |ad|, 1) <= 1e-3.

    python tools/torch_gradcheck_oracle.py            # on the card, ~2 min
    python tools/torch_gradcheck_oracle.py --device cpu --side 8 --spp 2 --checks 2

Prints one JSON object; on the card (at the full configuration) it also
writes docs/torch_gradcheck_oracle.json (--json to write elsewhere).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from pathtrace_tpu_torch import bench  # noqa: E402
from pathtrace_tpu_torch.diff import fd_material_grad_auto, material_grads  # noqa: E402
from pathtrace_tpu_torch.diff.fd import make_frozen_sampler  # noqa: E402
from pathtrace_tpu_torch.diff.grad import MAT_FIELDS, material_jvp  # noqa: E402
from pathtrace_tpu_torch.integrator.config import IntegratorConfig  # noqa: E402
from pathtrace_tpu_torch.models import procedural  # noqa: E402
from pathtrace_tpu_torch.models.scene import Material  # noqa: E402
from pathtrace_tpu_torch.utils import rng  # noqa: E402
from pathtrace_tpu_torch.utils.device import resolve_device  # noqa: E402

TOL = 1e-3
LIGHT = "light"  # stands for the first light's triangle id in an index
# (target, field, index, h0): the JAX tool's checks. The metallic sphere's
# specular gradient is zero by construction (metallic = 1 lerps the
# reflectivity fully to the albedo), so its metallic is checked instead.
FD_CHECKS = (
    ("tris", "albedo", (0, 0), 2e-2),
    ("tris", "albedo", (2, 1), 2e-2),
    ("tris", "emittance", (LIGHT, 0), 5e-2),
    ("tris", "roughness", (2,), 1e-2),
    ("tris", "specular", (4, 0), 1e-2),
    ("spheres", "albedo", (0, 0), 2e-2),
    ("spheres", "roughness", (0,), 1e-2),
    ("spheres", "metallic", (0,), 2e-3),
)


def _rel(ad: float, ref: float) -> float:
    return abs(ad - ref) / max(abs(ref), abs(ad), 1.0)


def run_oracle(device="cuda", side: int = 24, spp: int = 16, checks: int = len(FD_CHECKS),
               ior: bool = True) -> dict:
    """The report of the first `checks` FD checks and, with ior, the
    refractive IOR's forward-against-reverse check."""
    dev = resolve_device(device)
    scene = procedural.cornell_box_scene(include_spheres=True).to(dev)
    camera = procedural.default_camera(side, side)
    cfg, key = IntegratorConfig(rr_bounce=99, detach_sampling=True), rng.make_key(0)
    frozen = make_frozen_sampler(scene)
    light = int(scene.lights[0])
    t0 = time.perf_counter()
    g_tri, g_sph, loss = material_grads(scene, camera, spp, key, cfg=cfg, device=dev)
    out = []
    for target, field, idx, h0 in FD_CHECKS[:checks]:
        idx = tuple(light if i == LIGHT else i for i in idx)
        fd, h_used, conv = fd_material_grad_auto(
            scene, camera, spp, key, target, field, idx, h0=h0, h_min=1e-4, agree=0.001,
            richardson=True, cfg=cfg, sample_mat_fn=frozen, device=dev)
        ad = float(getattr(g_tri if target == "tris" else g_sph, field)[idx])
        rel = _rel(ad, fd)
        out.append({"param": f"{target}.{field}{list(idx)}", "autodiff": ad, "fd": fd,
                    "fd_h": h_used, "fd_converged": conv, "rel_err": rel, "ok": rel <= TOL})
        print(f"{out[-1]['param']:>28}: ad={ad:+.6g} fd={fd:+.6g} rel={rel:.2e} h={h_used:g}",
              file=sys.stderr, flush=True)
    if ior:
        tangent = Material(*[torch.zeros_like(getattr(scene.spheres.mat, f))
                             for f in MAT_FIELDS])
        tangent.specular[1, 0] = 1.0
        zero_tri = Material(*[torch.zeros_like(getattr(scene.mat, f)) for f in MAT_FIELDS])
        _, jv = material_jvp(scene, camera, spp, key, zero_tri, tangent, cfg=cfg, device=dev)
        rev = float(g_sph.specular[1, 0])
        rel = _rel(rev, jv.item())
        out.append({"param": "spheres.specular[1, 0] (refractive IOR)", "autodiff": rev,
                    "fd": jv.item(), "fd_h": 0.0, "fd_converged": True, "rel_err": rel,
                    "ok": rel <= TOL,
                    "note": "forward mode against reverse mode (FD is ill-posed here: the "
                            "refract/TIR branch flips densely in eta)"})
    return {
        "config": {"scene": "cornell+spheres", "width": side, "height": side, "spp": spp,
                   "cfg": "rr_bounce=99 detach_sampling=True (production)",
                   "loss": "sum(image), float64 host reduction",
                   "oracle": "frozen-sampling adaptive central differences + Richardson"},
        "tolerance": TOL, "loss": float(loss),
        "max_rel_err": max(c["rel_err"] for c in out), "checks": out,
        "pass": all(c["ok"] for c in out), "seconds": time.perf_counter() - t0,
        **bench.card_fields(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--side", type=int, default=24)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--checks", type=int, default=len(FD_CHECKS), help="FD checks to run")
    ap.add_argument("--json", default=None, help="report file (default on the card at the "
                    "full configuration: docs/torch_gradcheck_oracle.json; else none)")
    args = ap.parse_args(argv)
    report = run_oracle(args.device, args.side, args.spp, args.checks)
    full = (args.side, args.spp, args.checks) == (24, 16, len(FD_CHECKS))
    path = args.json or (os.path.join(REPO, "docs", "torch_gradcheck_oracle.json")
                         if report["card"] and full else None)
    if path:
        with open(path, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report))
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
