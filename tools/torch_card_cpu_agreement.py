"""The port's renders on the card against the committed CPU goldens (the JAX
package's tools/tpu_cpu_agreement.py, at its rows and bars).

The goldens in tests/golden/ are JAX renders on the CPU. Five rows:
Cornell 32x32 @ 8 spp, seed 123, through the lockstep render, the
wavefront (1,024 lanes) and the fused engine (kernel B1, 1,024 lanes);
glass 24x24 @ 8 spp, seed 7, lockstep, at 0.97 / 5e-3 (glass transport is
chaotic: last-ulp differences fork a few paths); blob82k 48x48 @ 4 spp,
seed 11, through the wavefront and the KD raycast (kernel B2), at 0.995. A
row passes when the share of values within 5e-3 (rtol and atol) exceeds its
bar and the image means differ by less than its relative bar. A row that
misses is reported, not retried.

    python tools/torch_card_cpu_agreement.py           # on the card, ~1 min
    python tools/torch_card_cpu_agreement.py --device cpu

Prints one JSON object; on the card it also writes
docs/torch_card_cpu_agreement.json (--json to write elsewhere).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from pathtrace_tpu_torch import bench  # noqa: E402
from pathtrace_tpu_torch.integrator.render import render  # noqa: E402
from pathtrace_tpu_torch.integrator.wavefront import render_wavefront  # noqa: E402
from pathtrace_tpu_torch.models import procedural  # noqa: E402
from pathtrace_tpu_torch.ops.cuda import bounce_kernel as bk  # noqa: E402
from pathtrace_tpu_torch.utils import rng  # noqa: E402
from pathtrace_tpu_torch.utils.device import resolve_device  # noqa: E402

GOLDEN = os.path.join(REPO, "tests", "golden")


def compare(name: str, img, golden: str, min_agree: float = 0.999,
            max_mean_rel: float = 1e-3) -> dict:
    """One row: img against tests/golden/<golden> at the JAX tool's bars."""
    ref = np.load(os.path.join(GOLDEN, golden))
    img = img.detach().cpu().numpy() if hasattr(img, "detach") else np.asarray(img)
    agree = float(np.isclose(img, ref, rtol=5e-3, atol=5e-3).mean())
    mean_rel = float(abs(img.mean() - ref.mean()) / ref.mean())
    return {"run": name, "golden": golden, "pixel_agreement": agree,
            "mean_rel_diff": mean_rel, "max_abs_diff": float(np.abs(img - ref).max()),
            "min_agree": min_agree, "max_mean_rel": max_mean_rel,
            "ok": bool(agree > min_agree and mean_rel < max_mean_rel)}


def agreement_rows(device="cuda", blob=None) -> list:
    """The five rows on `device`; blob: the blob82k scene with KD cells, if
    the caller holds it already."""
    dev = resolve_device(device)
    tag = "card" if dev.type == "cuda" else str(dev)
    cornell = procedural.cornell_box_scene().to(dev)
    cam32, key = procedural.default_camera(32, 32), rng.make_key(123)
    gold = "cornell_32x32_8spp_seed123.npy"
    rows = [compare(f"{tag}-megakernel", render(cornell, cam32, 8, key, device=dev), gold),
            compare(f"{tag}-wavefront", render_wavefront(cornell, cam32, 8, key, lanes=1024,
                                                         device=dev), gold),
            compare(f"{tag}-fused", bk.render_wavefront_fused(cornell, cam32, 8, key, lanes=1024,
                                                              chunk_spp=8, device=dev)[0], gold)]
    glass = procedural.glass_scene().to(dev)
    rows.append(compare(f"{tag}-megakernel-glass",
                        render(glass, procedural.default_camera(24, 24), 8, rng.make_key(7),
                               device=dev),
                        "glass_24x24_8spp_seed7.npy", min_agree=0.97, max_mean_rel=5e-3))
    blob = procedural.blob_mesh_scene().with_kd_binned() if blob is None else blob
    rows.append(compare(f"{tag}-wavefront-kd-mesh",
                        render_wavefront(blob.to(dev), procedural.default_camera(48, 48), 4,
                                         rng.make_key(11), lanes=2304, device=dev),
                        "blob82k_48x48_4spp_seed11.npy", min_agree=0.995))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None, help="report file (default on the card: "
                    "docs/torch_card_cpu_agreement.json; on the CPU: none)")
    args = ap.parse_args(argv)
    rows = agreement_rows(args.device)
    for r in rows:
        print(json.dumps(r), file=sys.stderr, flush=True)
    report = {**bench.card_fields(resolve_device(args.device)), "results": rows,
              "pass": all(r["ok"] for r in rows)}
    out = args.json or (os.path.join(REPO, "docs", "torch_card_cpu_agreement.json")
                        if report["card"] else None)
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps({"pass": report["pass"], "card": report["card"],
                      "power_limit": report["power_limit"]}))
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
