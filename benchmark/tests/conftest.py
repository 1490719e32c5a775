"""CPU tests of the benchmark. They import neither JAX nor the JAX package,
so this directory has its own conftest (tests/conftest.py sets JAX up)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


REFJOB = {"name": "cornell.refjob4", "config": "cornell_spheres", "traffic": "refjob1080x2400",
          "chips": 4, "why": "the reference's job over pixel bands"}


def bench_with_refjob(tmp_path) -> str:
    """A BENCHMARK.json holding the repository's cells and the four-card
    sharded cell, whether or not the repository's file lists it."""
    import json

    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    if all(w["name"] != REFJOB["name"] for w in bench["workloads"]):
        bench["workloads"].append(REFJOB)
    path = os.path.join(str(tmp_path), "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return path
