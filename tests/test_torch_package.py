"""Package-level contracts of the PyTorch port (no GPU, no nvcc needed).

- No module of pathtrace_tpu_torch, not chip_smoke.py and not the port's
  tools (tools/torch_*.py) imports jax or the JAX package.
- chip_smoke.py without a GPU, alone in a directory, exits non-zero and
  prints no result.
- The package imports without nvcc, triton or a GPU, and building the
  CUDA library never happens at import.
- The nvcc commands target sm_90a, keep IEEE rounding (-fmad=false, no
  fast math) and compile only the package's own csrc sources.
- Without a GPU, asking for CUDA fails instead of rendering on the CPU.
- The fused engine rejects uniform hemisphere sampling.
- The same-card A/B tools (tools/torch_bounce_ab.py, tools/torch_kd_ab.py)
  refuse to run without a card.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from pathtrace_tpu_torch.integrator.config import IntegratorConfig
from pathtrace_tpu_torch.models import procedural
from pathtrace_tpu_torch.ops.cuda import bounce_kernel as bk
from pathtrace_tpu_torch.ops.cuda import build
from pathtrace_tpu_torch.utils import rng

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "pathtrace_tpu_torch"
MODULES = (sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
           + sorted((REPO / "tools").glob("torch_*.py")))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "pathtrace_tpu"), f"{path}: imports {n}"


def test_imports_without_nvcc_triton_or_build(tmp_path):
    """Import every module in a fresh interpreter whose PATH holds no
    nvcc; nothing may build, load the library, or pull in jax/triton."""
    code = f"""
import importlib, os, pkgutil, sys
jax_before = "jax" in sys.modules
import pathtrace_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pathtrace_tpu_torch.__path__, "pathtrace_tpu_torch.")]
for n in names:
    importlib.import_module(n)
from pathtrace_tpu_torch.ops.cuda import build
assert build._lib is None
assert "triton" not in sys.modules
assert jax_before or "jax" not in sys.modules
print(len(names))
"""
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)  # an empty directory: no nvcc to find
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    before = sorted(os.listdir(build.BUILD_DIR)) if os.path.isdir(build.BUILD_DIR) else []
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15
    after = sorted(os.listdir(build.BUILD_DIR)) if os.path.isdir(build.BUILD_DIR) else []
    assert before == after


def test_nvcc_command_flags():
    """One compile command per csrc/*.cu (run concurrently), one link."""
    srcs = build.sources()
    assert {pathlib.Path(s).name for s in srcs} == {"bounce_kernel.cu", "kd_raycast.cu",
                                                   "mt_closest.cu"}
    assert all(pathlib.Path(s).parent == PKG / "csrc" for s in srcs)
    for src in srcs:
        cmd = build.compile_command("nvcc", src, "/x/a.o")
        line = " ".join(cmd)
        assert "arch=compute_90a,code=sm_90a" in line
        assert "-fmad=false" in cmd and "-O3" in cmd and "-c" in cmd and cmd[-1] == src
        assert "fast_math" not in line and "fast-math" not in line
    link = build.link_command("nvcc", ["/x/a.o", "/x/b.o"], "/x/lib.so")
    assert "-shared" in link and "arch=compute_90a,code=sm_90a" in " ".join(link)
    assert build.BUILD_DIR == str(PKG / "_build")
    assert os.path.basename(build.library_path()).startswith("libpathtrace_")


def test_find_nvcc_raises_without_toolkit(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def _needs_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU failure path cannot be shown")


def test_fused_cuda_without_gpu_raises():
    _needs_no_gpu()
    scene = procedural.cornell_box_scene()
    with pytest.raises(RuntimeError, match="cuda"):
        bk.render_wavefront_fused(scene, procedural.default_camera(8, 8), 1,
                                  rng.make_key(0), lanes=64)


def test_cli_default_device_without_gpu_exits_nonzero(tmp_path):
    _needs_no_gpu()
    out_png = tmp_path / "out.png"
    proc = subprocess.run(
        [sys.executable, "-m", "pathtrace_tpu_torch.cli", "render", "--preset", "cornell64",
         "--width", "8", "--height", "8", "--spp", "1", "--engine", "fused",
         "--out", str(out_png)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "cuda" in proc.stderr and not out_png.exists()


def test_cli_cpu_render_writes_png_and_npy(tmp_path):
    import numpy as np
    out_png, out_npy = tmp_path / "out.png", tmp_path / "out.npy"
    proc = subprocess.run(
        [sys.executable, "-m", "pathtrace_tpu_torch.cli", "render", "--preset", "cornell64",
         "--width", "8", "--height", "8", "--spp", "2", "--passes", "2",
         "--engine", "megakernel", "--device", "cpu", "--out", str(out_png),
         "--out-npy", str(out_npy)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert out_png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    img = np.load(out_npy)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.mean() > 0


def test_fused_rejects_uniform_hemisphere():
    cfg = IntegratorConfig(hemisphere="uniform")
    with pytest.raises(ValueError, match="cosine"):
        bk.render_wavefront_fused(procedural.cornell_box_scene(),
                                  procedural.default_camera(8, 8), 1, rng.make_key(0),
                                  cfg, lanes=64, device="cpu")


def test_launch_rejects_cpu_tensors(monkeypatch):
    """The wrapper launches only on CUDA tensors; it checks before it
    loads (or builds) the library."""
    def no_build():
        raise AssertionError("launch reached the library on CPU tensors")

    monkeypatch.setattr(build, "load_library", no_build)
    scene = procedural.cornell_box_scene(include_spheres=True)
    pack = bk.build_fused_pack(scene)
    params = bk.make_params(procedural.default_camera(8, 8), IntegratorConfig(),
                            rng.make_key(0), pack, 64, 1, 0)
    with pytest.raises(ValueError, match="CUDA"):
        bk.launch(pack, params)


def test_fused_pack_layout():
    scene = procedural.cornell_box_scene(include_spheres=True)
    pack = bk.build_fused_pack(scene)
    t = scene.num_tris
    assert pack.tri_geo.shape == (t, bk.GEO_STRIDE)
    assert pack.tri_attr.shape == (t, bk.ATTR_STRIDE)
    assert torch.equal(pack.tri_geo[:, 3:6], scene.tris.v1 - scene.tris.v0)
    assert torch.equal(pack.tri_attr[:, 27:30], scene.mat.emittance)
    assert pack.spheres.shape == (2, bk.SPHERE_STRIDE)
    assert torch.equal(pack.spheres[:, 3], scene.spheres.radius)
    assert pack.lights.shape == (scene.num_lights, bk.LIGHT_STRIDE)
    assert torch.equal(pack.lights[:, 13].long(), scene.lights.long())
    assert pack.smem_bytes == 4 * (12 * t + 16 * 2 + 16 * scene.num_lights)


def test_fused_pack_rejects_tables_beyond_shared_memory():
    import numpy as np
    from pathtrace_tpu_torch.models.scene import Material, Scene, Triangles
    n = bk.MAX_SMEM_BYTES // (4 * bk.GEO_STRIDE) + 1
    pos = np.random.default_rng(0).random((n, 3, 3)).astype(np.float32)
    normals = np.broadcast_to(np.float32([0, 1, 0]), (n, 3, 3))
    scene = Scene.build(Triangles.from_vertices(pos, normals), Material.make(n))
    with pytest.raises(ValueError, match="shared memory"):
        bk.build_fused_pack(scene)


@pytest.mark.parametrize("num_pix", [65536, 4096, 2304, 240 * 540, 100])
def test_auto_fused_config_tiles_the_film(num_pix):
    lanes = bk.auto_fused_config(num_pix)
    assert lanes % num_pix == 0 or num_pix % lanes == 0
    assert lanes <= max(65536, num_pix)


def test_chip_smoke_without_gpu_prints_no_result(tmp_path):
    script = tmp_path / "chip_smoke.py"
    script.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("tool", ["torch_bounce_ab.py", "torch_kd_ab.py"])
def test_ab_tools_refuse_without_gpu(tool, tmp_path):
    """The same-card A/B tools need a card: without one they exit non-zero
    before building anything and print no result."""
    out = subprocess.run([sys.executable, str(REPO / "tools" / tool), "--variant",
                          f"x={tmp_path}"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and "torch.cuda.is_available() is False" in out.stderr
    assert "{" not in out.stdout
