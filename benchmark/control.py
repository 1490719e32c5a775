"""The readings a cell's limits are set from (benchmark/compare.py), on the
card at the cell's own size, many seeds in one process:

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 --control-seeds 4,5,6

- program: for each of --seeds, the program's first unit of the traffic
  (keyed as a run keys it), then the run's own comparison with the plain
  reference: the lower readings.
- control: for each of --control-seeds, the reference computed in the
  nearest precision below the configuration's (bfloat16 for float32; the
  tracer has no matrix product, so TF32 changes nothing) is put in the
  program's place for the answers a run compares, and compared in the same
  way: the upper readings. It needs no program, so a four-chip cell's
  control runs on one card, with the pixel sample drawn over its four bands.
- half_batch: for each of --fault-seeds, the same with the reference over
  half of the unit's samples, the mean taken over them (a step or image
  that leaves half of its batch out): a training cell's upper reading is
  also held against this fault.

One JSON line a reading: {"workload", "seed", "side", "checks"}. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import compare, harness, scenes
from benchmark.reference import core, tracer

LOWER = {"float32": torch.bfloat16}


def control_answers(ctx, keys, spp, dtype=None):
    """substitute(u, pixels) for compare.check: the reference's answers over
    `spp` samples, computed in `dtype`, by default the precision below the
    configuration's."""
    low = dtype or LOWER[ctx.config["precision"]]

    def substitute(u, pix):
        prev = torch.get_default_dtype()
        torch.set_default_dtype(low)
        try:
            scene, camera, cfg = compare.reference_setup(ctx)
            if pix is not None:
                return tracer.pixel_sums(scene, camera, cfg, keys[u], pix, spp,
                                         min(spp, ctx.traffic["chunk_spp"])).float()
            tr = ctx.traffic
            target = torch.zeros((tr["height"], tr["width"], 3), device=ctx.device)
            loss, (g_tri, g_sph), img = tracer.train_step(scene, camera, cfg, keys[u], spp,
                                                          target, tr["check"]["chunk_paths"])
            grads = {f"{side}.{f}": getattr(g, f).detach().float()
                     for side, g in (("tri", g_tri), ("sph", g_sph)) for f in core.MAT_FIELDS}
            return {"loss": loss.detach().float(), "image": img.float(), "grads": grads}
        finally:
            torch.set_default_dtype(prev)

    return substitute


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    fseeds = [int(s) for s in args.fault_seeds.split(",") if s]
    cell = harness.load_cell(args.workload)
    dev = torch.device(args.device)
    ctx = harness.Ctx(cell.config, cell.traffic, scenes.scene_arrays(cell.config), dev, 0,
                      cell.chips)
    spp = cell.traffic["spp"]
    if seeds:
        if cell.chips > 1:
            raise SystemExit("program readings of a multi-chip cell come from its runs")
        unit = harness.load_module("entries", cell.traffic["entry"]).setup(ctx)
    for seed in seeds:
        key = harness.unit_key(seed, 0)
        t0 = time.perf_counter()
        out = harness.keep(unit(key, spp), spp, 0)
        nums = compare.check(ctx, [out], [key], seed)
        print(json.dumps({"workload": args.workload, "seed": seed, "side": "program",
                          "seconds": time.perf_counter() - t0,
                          "checks": {k: v for k, (v, _) in nums.items()}}), flush=True)
    sides = [("control", s, spp, None) for s in cseeds]
    sides += [("half_batch", s, spp // 2, torch.float32) for s in fseeds]
    for side, seed, n, dtype in sides:
        key = harness.unit_key(seed, 0)
        t0 = time.perf_counter()
        nums = compare.check(ctx, [{"spp": spp}], [key], seed,
                             substitute=control_answers(ctx, [key], n, dtype))
        print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                          "seconds": time.perf_counter() - t0,
                          "checks": {k: v for k, (v, _) in nums.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
