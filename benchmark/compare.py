"""How `correct` is decided: what the timed path produced, compared with the
plain reference (benchmark/reference/) on the same raw inputs, once the
window has closed.

- "pixels" (renders): `units` images drawn from the seed among those the
  window completed and, in each, `pixels` pixels drawn from the seed,
  spread evenly over the ranks' pixel bands. The reference traces every
  sample of those pixels with the image's own key and sums them in the
  program's order. pixel_gap is the largest |program - reference| /
  (|reference| + 0.01) over the pixels' channels.
- "train" (steps): `units` steps drawn from the seed; the reference runs
  the whole step (every path of the film) by autograd. loss_gap is the
  relative gap of the losses; image_gap the pixel gap over the whole image;
  grad_gap the worst leaf's gap between the program's gradient norm and
  the reference's, over the larger of the reference's norm of that leaf and
  of the median leaf. A leaf whose reference gradient is under a thousandth
  of the median leaf's (nought to rounding, such as the emission of a
  surface that emits nothing) is left out.

Each number is held to the limit the traffic file states; `correct` needs
every number at or under its limit.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import core, tracer

FLOOR = 0.01  # radiance below which a pixel's gap is taken as absolute


def reference_setup(ctx):
    """The reference's scene, camera and settings, on the run's device."""
    cam = ctx.config["camera"]
    tr = ctx.traffic
    scene = core.Scene.from_arrays(ctx.arrays, ctx.device)
    camera = core.Camera.from_rotation(cam["pos"], cam["rotation_deg"], cam["fovy_deg"],
                                       tr["width"], tr["height"])
    cfg = tracer.Config(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in ctx.config["integrator"].items()})
    return scene, camera, cfg


def draw(seed: int, n: int, k: int, salt: int) -> list:
    """k distinct indices of range(n), drawn from the seed."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, salt])
    return sorted(int(i) for i in rng.choice(n, size=min(k, n), replace=False))


def pixel_sample(seed: int, num_pix: int, count: int, bands: int, salt: int) -> torch.Tensor:
    """count pixels, an equal share from each of `bands` contiguous bands."""
    per = num_pix // bands
    return torch.tensor([b * per + i for b in range(bands)
                         for i in draw(seed, per, count // bands, salt * 64 + b)],
                        dtype=torch.int64)


def pixel_gap(got, ref) -> float:
    return float(((got - ref).abs() / (ref.abs() + FLOOR)).max())


def norm_gaps(got: dict, ref: dict) -> float:
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    med = float(np.median(list(norms.values())))
    gaps = [abs(float(torch.linalg.vector_norm(got[k].double().cpu())) - n) / max(n, med)
            for k, n in norms.items() if n >= 1e-3 * med]
    return max(gaps)


def check(ctx, outputs: list, keys: list, seed: int, substitute=None) -> dict:
    """{name: (number, limit)} for the units the window completed.
    outputs[p] is unit p's output (with the "spp" it ran at), keys[p] its
    key. substitute(unit p, pixels) replaces the program's answers (the
    control, benchmark/control.py)."""
    spec = ctx.traffic["check"]
    scene, camera, cfg = reference_setup(ctx)
    units = draw(seed, len(outputs), spec["units"], 1)
    nums = {}
    if spec["kind"] == "pixels":
        gaps = []
        for u in units:
            pix = pixel_sample(seed, camera.num_pix, spec["pixels"], ctx.world, 2 + u)
            spp = outputs[u]["spp"]
            ref = tracer.pixel_sums(scene, camera, cfg, keys[u], pix, spp,
                                    min(spp, ctx.traffic["chunk_spp"]))
            got = (outputs[u]["image"].reshape(-1, 3)[pix] if substitute is None
                   else substitute(u, pix))
            gaps.append(pixel_gap(got.float().to(ref.device), ref.float()))
        nums["pixel_gap"] = max(gaps)
    elif spec["kind"] == "train":
        tr = ctx.traffic
        for u in units:
            target = torch.zeros((tr["height"], tr["width"], 3), device=ctx.device)
            loss, (g_tri, g_sph), img = tracer.train_step(scene, camera, cfg, keys[u],
                                                          outputs[u]["spp"], target,
                                                          spec["chunk_paths"])
            ref = {f"{side}.{f}": getattr(g, f).detach() for side, g in (("tri", g_tri),
                                                                       ("sph", g_sph))
                   for f in core.MAT_FIELDS}
            got = outputs[u] if substitute is None else substitute(u, None)
            lr = float(loss)
            cur = {"loss_gap": abs(float(got["loss"]) - lr) / abs(lr),
                   "image_gap": pixel_gap(got["image"].float().to(img.device), img.float()),
                   "grad_gap": norm_gaps(got["grads"], ref)}
            for k, v in cur.items():
                nums[k] = max(nums.get(k, 0.0), v)
    else:
        raise ValueError(f"unknown check kind {spec['kind']!r}")
    return {k: (v, float(spec["limits"][k])) for k, v in nums.items()}


def correct(nums: dict) -> bool:
    return all(np.isfinite(v) and v <= lim for v, lim in nums.values())
