"""What the benchmark may import: nothing of JAX or the JAX package
(pathtrace_tpu) anywhere, and nothing of the program (pathtrace_tpu_torch)
in the plain reference. Top-level module names are compared whole, since
the port's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "pathtrace_tpu"}


def imported_tops(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def py_files(top: str) -> list:
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(top) for f in fs if f.endswith(".py"))


def test_no_module_imports_jax_or_the_jax_package():
    files = py_files(BENCH)
    assert len(files) > 20
    bad = {f: imported_tops(f) & FORBIDDEN for f in files}
    assert not {f: b for f, b in bad.items() if b}


def test_the_top_level_name_is_compared_whole():
    assert "pathtrace_tpu_torch" not in FORBIDDEN
    assert "pathtrace_tpu_torch".split(".")[0] != "pathtrace_tpu"


def test_the_reference_imports_nothing_of_the_program():
    for f in py_files(os.path.join(BENCH, "reference")):
        assert "pathtrace_tpu_torch" not in imported_tops(f), f


def test_a_cpu_rehearsal_leaves_jax_out_of_sys_modules():
    code = (
        "import time, sys\n"
        "from benchmark import harness\n"
        "ov = dict(width=8, height=8, spp=2, chunk_spp=2, lanes=64, warmup_spp=1,\n"
        "          check={'kind': 'pixels', 'units': 1, 'pixels': 8, 'limits': {'pixel_gap': 1e-3}})\n"
        "res, _ = harness.run('cornell.image256', 3000000011, 0.01, False, t_start=time.perf_counter(),\n"
        "                     device='cpu', traffic_overrides=ov)\n"
        "assert res['correct'], res\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
