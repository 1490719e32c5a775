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
- Every module of the JAX package has its counterpart in the port, or is in
  NOT_PORTED with its reason (ROADMAP.md's "Not to port" list); every tool
  of tools/ has its tools/torch_<name>.py counterpart, or is in
  TOOLS_NOT_PORTED with its reason.
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
from pathtrace_tpu_torch import native
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
from pathtrace_tpu_torch import native
assert build._lib is None and native._lib is None
assert "triton" not in sys.modules
assert jax_before or "jax" not in sys.modules
print(len(names))
"""
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)  # an empty directory: no nvcc to find
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    def cuda_build_files():
        # the BVH builder's library (native/) may appear meanwhile: other test
        # files build it at first use; the subprocess checks native._lib
        names = os.listdir(build.BUILD_DIR) if os.path.isdir(build.BUILD_DIR) else []
        return sorted(n for n in names if not n.startswith(native.LIB_PREFIX))

    before = cuda_build_files()
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15
    assert before == cuda_build_files()


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


# Modules of the JAX package that the port does not carry over, each with
# its reason: ROADMAP.md's "Not to port" list, as far as it names modules.
NOT_PORTED = {
    "ops/compact.py": "a TPU stream compaction that only test_compact.py calls",
    "ops/mt_matmul.py": "the MXU matmul form of Möller-Trumbore (Scene.with_mt), a TPU "
                        "workaround; ops/mt_closest.py keeps its contract",
    "utils/pytree.py": "registers dataclasses as JAX pytrees; the port's dataclasses "
                       "hold tensors and need no registration",
}
# Counterparts under another name: the Pallas kernels became CUDA kernels.
RENAMED = {
    "ops/pallas/__init__.py": "ops/cuda/__init__.py",
    "ops/pallas/bounce_kernel.py": "ops/cuda/bounce_kernel.py",
    "ops/pallas/bsdf_t.py": "csrc/bsdf.cuh",
    "ops/pallas/intersect_kernel.py": "ops/cuda/mt_closest.py",
    "ops/pallas/pair_kernel.py": "ops/cuda/kd_raycast.py",
}


def test_every_jax_module_has_a_counterpart():
    """Walks pathtrace_tpu/ by path (nothing of it is imported): each
    module and native source has a file of the same relative path in
    pathtrace_tpu_torch/ (or its RENAMED counterpart), or is in NOT_PORTED;
    nothing in NOT_PORTED is ported after all."""
    jax_pkg = REPO / "pathtrace_tpu"
    modules = sorted(str(p.relative_to(jax_pkg)) for p in jax_pkg.rglob("*")
                     if p.suffix in (".py", ".cpp") and "__pycache__" not in p.parts)
    assert len(modules) >= 45
    missing = [m for m in modules
               if m not in NOT_PORTED and not (PKG / RENAMED.get(m, m)).is_file()]
    assert missing == [], f"JAX modules without a counterpart in the port: {missing}"
    assert set(NOT_PORTED) <= set(modules)
    assert not any((PKG / m).exists() for m in NOT_PORTED)


# JAX tools whose counterpart has another name or was folded into another tool.
TOOLS_RENAMED = {
    "tpu_cpu_agreement.py": "torch_card_cpu_agreement.py",
    "gradcheck_tpu.py": "torch_gradcheck_card.py",
    "replay_memory.py": "torch_gradcheck_card.py",  # its section 4: peak backward memory
}
# JAX tools the port does not carry over, each with its reason (ROADMAP.md's
# "Not to port" list and tools queue).
_TPU_PROFILE = ("a jax.profiler trace of the JAX package on the TPU; the port's "
                "profile_main.py traces the card with torch.profiler")
_MOSAIC = "probes which shape casts Mosaic (the TPU kernel compiler) accepts"
TOOLS_NOT_PORTED = {
    "tpu_profile.py": _TPU_PROFILE,
    "tpu_profile_fused.py": _TPU_PROFILE,
    "tpu_profile_mesh.py": _TPU_PROFILE,
    "tpu_profile_mesh_bounce.py": _TPU_PROFILE,
    "tpu_profile_mesh_bounce2.py": _TPU_PROFILE,
    "tpu_profile_mesh_render.py": _TPU_PROFILE,
    "parse_trace.py": "aggregates jax.profiler traces; torch.profiler's key_averages do it "
                      "for the port (profile_main.py)",
    "mosaic_probe.py": _MOSAIC,
    "mosaic_probe2.py": _MOSAIC,
    "mosaic_probe3.py": _MOSAIC,
    "fused_ablate.py": "times the Pallas bounce kernel with sections ablated by its TPU-only "
                       "`ablate` switches, which the port does not carry",
    "hlo_collectives.py": "reads XLA's compiled HLO for async collectives on the TPU's ICI",
    "layout_microbench.py": "times the TPU's (8, 128) vector-tile layouts of the Pallas kernel",
    "lobe_sort_bench.py": "lobe-sorted against branchless shading under XLA's static shapes "
                          "on the TPU",
    "binned_profile.py": "stage times of the v1 binned traversal, which the port does not "
                         "carry (ROADMAP: Not to port)",
    "mesh_dispatch_bench.py": "candidate primitives of the v2/v3 pair dispatch (top_k, "
                              "scatter-min), TPU workarounds the port does not carry",
    "mesh_dispatch_bench2.py": "reduce chains of the v2/v3 pair dispatch, TPU workarounds the "
                               "port does not carry",
    "mesh_kernel_bench.py": "the v1 and v2 mesh raycasts on the TPU; the port's KD raycast has "
                            "its A/B tool, tools/torch_kd_ab.py",
    "fused_microbench.py": "one Pallas step in a lax.fori_loop on the TPU; the port's B1 has "
                           "its A/B tool, tools/torch_bounce_ab.py",
    "fused_sweep.py": "the Pallas kernel's (lanes, block_r, steps) grid on the TPU; B1 has no "
                      "block_r and takes its lanes from auto_fused_config",
    "gen_mesh_asset.py": "wrote assets/blob82k.obj once; the asset is in the repo and both "
                         "packages load it",
}


def test_every_jax_tool_has_a_counterpart():
    """Walks tools/ by path: each JAX tool (a tools/*.py not named
    torch_*) has tools/torch_<name>.py (or its TOOLS_RENAMED counterpart),
    or is in TOOLS_NOT_PORTED; nothing in TOOLS_NOT_PORTED is ported after
    all."""
    tools = REPO / "tools"
    jax_tools = sorted(p.name for p in tools.glob("*.py") if not p.name.startswith("torch_"))
    assert len(jax_tools) >= 30
    missing = [t for t in jax_tools if t not in TOOLS_NOT_PORTED
               and not (tools / TOOLS_RENAMED.get(t, f"torch_{t}")).is_file()]
    assert missing == [], f"JAX tools without a counterpart in the port: {missing}"
    assert set(TOOLS_NOT_PORTED) <= set(jax_tools) and set(TOOLS_RENAMED) <= set(jax_tools)
    assert not any((tools / f"torch_{t}").exists() for t in TOOLS_NOT_PORTED)
    assert not set(TOOLS_RENAMED) & set(TOOLS_NOT_PORTED)
