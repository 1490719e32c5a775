"""The material gather and its gradient (ops/mat_gather.py, csrc/mat_gather.cu).

On the CPU (tier-1): Material.gather and the light emittance gather keep
plain indexing on CPU tensors, under grad mode, torch.no_grad and
forward-mode AD, with values, gradients and tangents bit-equal to
`field[idx.long()]`; MatGather's plain version passes gradcheck, reverse and
forward mode, in float64; the wrapper's layout, tiling and refusals.

On the card (marker `gpu`, skipped without one; run
`python -m pytest tests/test_torch_mat_gather.py --noconftest -q -m gpu`),
against the plain version on the card:
- forward bit-equal (a copy);
- backward within RTOL of the sum of the terms' magnitudes, entry by entry:
  both sides add the same float32 terms in different orders (PyTorch's
  index backward walks each run of equal indices serially; the kernel sums
  in warp groups, warp copies, tiles and blocks), and reordering float32
  sums of up to 262,144 terms moves them by far less than 1e-4 of their
  magnitude;
- the backward bit-identical from run to run, one tile or many;
- forward-mode tangents and no-grad gathers through the kernel, bit-equal;
- a replay chunk of the Cornell scene: the film bit-equal, the gradients
  within 1e-4 of the field's largest;
- the counters: gathers and backwards in the train step, gathers alone in
  a no-grad render.
This file imports no JAX.
"""

import ctypes

import pytest
import torch
from torch.autograd import forward_ad

from pathtrace_tpu_torch.diff.grad import MAT_FIELDS
from pathtrace_tpu_torch.models import procedural
from pathtrace_tpu_torch.models.scene import Material
from pathtrace_tpu_torch.ops import mat_gather
from pathtrace_tpu_torch.ops.cuda import mat_gather as mg_kernel

RTOL = 1e-4
COUNTERS = ("GATHER_LAUNCHES", "SCATTER_LAUNCHES")


def counters() -> tuple:
    return tuple(getattr(mg_kernel, c) for c in COUNTERS)


def random_material(k: int, seed: int, dtype=torch.float32, device="cpu") -> Material:
    g = torch.Generator().manual_seed(seed)
    return Material(*[torch.rand((k, 3) if f in ("emittance", "albedo", "specular") else (k,),
                                 generator=g, dtype=dtype).to(device) for f in MAT_FIELDS])


def leaves(mat: Material) -> Material:
    return Material(*[getattr(mat, f).detach().clone().requires_grad_(True) for f in MAT_FIELDS])


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def no_matgather(monkeypatch):
    """Fail if MatGather is applied: the plain path must be taken."""
    def refuse(*args):
        raise AssertionError("MatGather.apply called on the plain path")
    monkeypatch.setattr(mat_gather.MatGather, "apply", refuse)


@pytest.mark.parametrize("grad_mode", ["no_grad", "grad"])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_material_gather_plain_on_cpu(no_matgather, grad_mode, idx_dtype):
    """CPU tensors keep field[idx.long()]: values, and under grad mode
    gradients, bit-equal to plain indexing; no counter moves."""
    mat = leaves(random_material(38, 1))
    idx = torch.randint(0, 38, (1000,), generator=torch.Generator().manual_seed(2),
                        dtype=idx_dtype)
    before = counters()
    with torch.set_grad_enabled(grad_mode == "grad"):
        got = mat.gather(idx)
        want = [getattr(mat, f)[idx.long()] for f in MAT_FIELDS]
    for f, w in zip(MAT_FIELDS, want):
        assert torch.equal(getattr(got, f), w), f
    if grad_mode == "grad":
        cot = [torch.randn_like(w) for w in want]
        g_got = torch.autograd.grad([getattr(got, f) for f in MAT_FIELDS],
                                    [getattr(mat, f) for f in MAT_FIELDS], cot)
        g_want = torch.autograd.grad(want, [getattr(mat, f) for f in MAT_FIELDS], cot)
        assert all(torch.equal(a, b) for a, b in zip(g_got, g_want))
    assert counters() == before


def test_forward_ad_takes_plain_path(no_matgather):
    """Dual tensors (diff/grad.py::material_jvp) gather by plain indexing:
    primal and tangent bit-equal to field[idx.long()]'s."""
    mat, tan = random_material(38, 3), random_material(38, 4)
    idx = torch.randint(0, 38, (500,), generator=torch.Generator().manual_seed(5),
                        dtype=torch.int32)
    with forward_ad.dual_level():
        dual = Material(*[forward_ad.make_dual(getattr(mat, f), getattr(tan, f))
                          for f in MAT_FIELDS])
        got = dual.gather(idx)
        (emit,) = mat_gather.gather((dual.emittance,), idx)
        for f in MAT_FIELDS:
            p, t = forward_ad.unpack_dual(getattr(got, f))
            assert torch.equal(p, getattr(mat, f)[idx.long()])
            assert torch.equal(t, getattr(tan, f)[idx.long()])
        assert torch.equal(forward_ad.unpack_dual(emit).tangent, tan.emittance[idx.long()])


def test_matgather_plain_tangents():
    """MatGather's plain version under forward-mode AD: a dual table's
    outputs carry its tangent gathered, bit-equal to plain indexing; a
    table without a tangent gives its output a zero tangent."""
    mat, tan = random_material(38, 3), random_material(38, 4)
    idx = torch.randint(0, 38, (500,), generator=torch.Generator().manual_seed(6),
                        dtype=torch.int32)
    with forward_ad.dual_level():
        emit = forward_ad.make_dual(mat.emittance, tan.emittance)
        out = mat_gather.MatGather.apply(idx, emit, mat.opacity)
        (e_p, e_t), (o_p, o_t) = (forward_ad.unpack_dual(o) for o in out)
    assert torch.equal(e_p, mat.emittance[idx.long()])
    assert torch.equal(e_t, tan.emittance[idx.long()])
    assert torch.equal(o_p, mat.opacity[idx.long()])
    assert torch.equal(o_t, torch.zeros(500))


@pytest.mark.parametrize("k_rows", [1, 2, 38])
@pytest.mark.parametrize("fields", ["one", "all"])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_matgather_plain_gradcheck(k_rows, fields, idx_dtype):
    """MatGather's plain version (CPU tensors) in float64: gradcheck of the
    backward and of the forward-mode tangents, with repeated indices and
    every row of the table reached or not."""
    mat = random_material(k_rows, 7, torch.float64)
    tables = [getattr(mat, f).requires_grad_(True)
              for f in (MAT_FIELDS if fields == "all" else ("emittance",))]
    idx = torch.randint(0, k_rows, (40,), generator=torch.Generator().manual_seed(8),
                        dtype=idx_dtype)
    assert torch.autograd.gradcheck(lambda *ts: mat_gather.MatGather.apply(idx, *ts), tables,
                                    check_forward_ad=True)


def test_matgather_plain_unused_outputs():
    """A gathered field the loss does not reach gets no gradient (None),
    the others their index_add_ sums; the plain version's forward is the
    plain gather."""
    mat = leaves(random_material(5, 9))
    idx = torch.tensor([0, 4, 4, 1, 0, 0], dtype=torch.int32)
    tables = [getattr(mat, f) for f in MAT_FIELDS]
    out = mat_gather.MatGather.apply(idx, *tables)
    assert all(torch.equal(o, t[idx.long()]) for o, t in zip(out, tables))
    g = torch.autograd.grad(out[1].sum() + out[4].sum(), tables, allow_unused=True)
    assert [x is None for x in g] == [True, False, True, True, False, True]
    assert torch.equal(g[1], torch.tensor([[3.0] * 3, [1.0] * 3, [0.0] * 3, [0.0] * 3,
                                           [2.0] * 3]))
    assert torch.equal(g[4], torch.tensor([3.0, 1.0, 0.0, 0.0, 2.0]))


@pytest.mark.parametrize("k_rows,cols,tile,ranges", [
    (1, 12, 128, 264), (38, 12, 128, 264), (128, 12, 128, 264), (129, 12, 128, 132),
    (81920, 12, 128, 1), (512, 3, 512, 264), (513, 3, 512, 132), (2, 18, 85, 264),
])
def test_tiles_follow_k(k_rows, cols, tile, ranges):
    """Tiles of the gradient table as its warp copies fit shared memory
    (both Cornell tables one tile, the mesh's 81,920 rows 640), and the
    MAX_BLOCKS blocks of a scatter shared by the tiles."""
    assert mg_kernel.tile_rows(cols) == tile
    assert mg_kernel.scatter_ranges(k_rows, cols) == ranges


def test_matfields_layout():
    """The ctypes struct mirrors pt::MatFields (6 + 6 pointers, 6 + 6 ints,
    count, cols), and packing sets widths and first columns."""
    assert ctypes.sizeof(mg_kernel.MatFields) == 152
    assert mg_kernel.MatFields.count.offset == 144
    mat = random_material(3, 10)
    tables = [getattr(mat, f) for f in MAT_FIELDS]
    f = mg_kernel._fields(tables, tables)
    assert (f.count, f.cols) == (6, 12)
    assert list(f.width) == [3, 3, 3, 1, 1, 1] and list(f.col) == [0, 3, 6, 9, 10, 11]
    with pytest.raises(ValueError, match="fields"):
        mg_kernel._fields(tables + tables[:1], tables + tables[:1])


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches or raises: CPU tensors never reach a launch."""
    mat = random_material(3, 11)
    idx = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        mg_kernel.gather([mat.albedo], idx)
    with pytest.raises(ValueError, match="CUDA"):
        mg_kernel.scatter(idx, [torch.zeros((4, 3))], 3)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def replay_tri(cuda):
    """The replay's own safe_tri: the second bounce's triangle ids of the
    train scene's taped paths (64x64 @ 64 spp, 262,144 paths), 0 where the
    path hit a sphere or nothing (diff/replay.py::_replay_hit)."""
    from pathtrace_tpu_torch import bench
    from pathtrace_tpu_torch.diff.wavetape import record_paths_wavefront, unpack_rec

    scene, camera, _, cfg, key = bench.train_problem(cuda, 64, 64)
    records, _ = record_paths_wavefront(scene, camera, 64, key, cfg, lanes=262144)
    rec = unpack_rec(records[1])
    return torch.where(rec["hit"] & ~rec["sph"], rec["pid"], torch.zeros_like(rec["pid"]))


K_ROWS = [1, 2, 38, 128, 129, 81920]   # 128: the largest one-tile K of a Material
ROWS = [1, 1000, 262144]
PATTERNS = ["one_row", "uniform", "replay"]


def make_idx(pattern: str, k_rows: int, rows: int, replay_tri, seed: int = 0):
    if pattern == "one_row":
        return torch.full((rows,), k_rows - 1, dtype=torch.int32, device="cuda")
    if pattern == "uniform":
        g = torch.Generator().manual_seed(seed)
        return torch.randint(0, k_rows, (rows,), generator=g, dtype=torch.int32).cuda()
    return (replay_tri[:rows] % k_rows).contiguous()


def grad_rows(k_rows: int, rows: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((rows, 3) if f in ("emittance", "albedo", "specular") else (rows,),
                        generator=g).cuda() for f in MAT_FIELDS]


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("k_rows", K_ROWS)
def test_card_forward_bit_equal(cuda, replay_tri, k_rows, rows, pattern):
    tables = [getattr(random_material(k_rows, 12, device=cuda), f) for f in MAT_FIELDS]
    idx = make_idx(pattern, k_rows, rows, replay_tri)
    got = mg_kernel.gather(tables, idx)
    want = mat_gather.gather_plain(tables, idx)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("k_rows", K_ROWS)
def test_card_backward_matches_index_backward(cuda, replay_tri, k_rows, rows, pattern):
    """MatGather's gradients against PyTorch's index backward on the same
    cotangents: within RTOL of each entry's sum of |terms|; one backward
    a call."""
    mat = leaves(random_material(k_rows, 13, device=cuda))
    tables = [getattr(mat, f) for f in MAT_FIELDS]
    idx = make_idx(pattern, k_rows, rows, replay_tri)
    cot = grad_rows(k_rows, rows, 14)
    before = counters()
    got = torch.autograd.grad(mat_gather.gather(tables, idx), tables, cot)
    assert tuple(a - b for a, b in zip(counters(), before)) == (1, 1)
    want = torch.autograd.grad([t[idx.long()] for t in tables], tables, cot)
    mags = mat_gather.scatter_plain(idx, [c.abs().double() for c in cot], k_rows)
    for f, a, b, m in zip(MAT_FIELDS, got, want, mags):
        err = (a.double() - b.double()).abs()
        assert bool((err <= RTOL * m).all()), (f, err.max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("k_rows", K_ROWS)
def test_card_backward_bit_identical(cuda, replay_tri, k_rows, pattern):
    """Two runs on the same inputs give the same bits, one tile or 640."""
    idx = make_idx(pattern, k_rows, 262144, replay_tri)
    cot = grad_rows(k_rows, 262144, 15)
    first = mg_kernel.scatter(idx, cot, k_rows)
    second = mg_kernel.scatter(idx, cot, k_rows)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_card_one_field(cuda, idx_dtype):
    """The light emittance gather (one (K, 3) field), int32 and int64
    indices: forward bit-equal, backward within RTOL."""
    emit = torch.rand((38, 3), device=cuda, requires_grad=True)
    idx = torch.randint(0, 38, (65536,), device=cuda, dtype=idx_dtype)
    (got,) = mat_gather.gather((emit,), idx)
    assert torch.equal(got, emit[idx.long()])
    cot = torch.randn_like(got)
    (g,) = torch.autograd.grad(got, emit, cot)
    (w,) = torch.autograd.grad(emit[idx.long()], emit, cot)
    mag = mat_gather.scatter_plain(idx, [cot.abs()], 38)[0]
    assert bool(((g - w).abs() <= RTOL * mag).all())


@pytest.mark.gpu
def test_card_no_grad_and_tangents(cuda):
    """Under torch.no_grad the gather runs the kernel, bit-equal; dual
    tables (material_jvp) get their tangents gathered by the kernel,
    bit-equal, and a table without one a zero tangent."""
    mat, tan = random_material(38, 16, device=cuda), random_material(38, 17, device=cuda)
    tables = [getattr(mat, f) for f in MAT_FIELDS]
    idx = torch.randint(0, 38, (65536,), device=cuda, dtype=torch.int32)
    before = counters()
    with torch.no_grad():
        got = mat.gather(idx)
    assert counters()[0] == before[0] + 1
    assert all(torch.equal(getattr(got, f), t[idx.long()]) for f, t in zip(MAT_FIELDS, tables))
    with forward_ad.dual_level():
        dual = [forward_ad.make_dual(t, getattr(tan, f)) for f, t in zip(MAT_FIELDS[:5], tables)]
        out = mat_gather.gather(dual + tables[5:], idx)
        pairs = [forward_ad.unpack_dual(o) for o in out]
    for f, t, (p, d) in zip(MAT_FIELDS, tables, pairs):
        assert torch.equal(p, t[idx.long()]), f
        want = getattr(tan, f)[idx.long()] if f != MAT_FIELDS[5] else torch.zeros_like(p)
        assert torch.equal(d, want), f


@pytest.mark.gpu
def test_card_replay_chunk_matches_plain_gather(cuda, monkeypatch):
    """One replay chunk of the Cornell scene (32x32 @ 8 spp, 8,192 paths in
    one chunk) through the kernels and through plain indexing: the film
    bit-equal (the forward is a copy), the gradients within 1e-4 of each
    field's largest."""
    from pathtrace_tpu_torch.diff.wavetape import material_grads_wavetape
    from pathtrace_tpu_torch.integrator.config import IntegratorConfig
    from pathtrace_tpu_torch.utils import rng

    scene = procedural.cornell_box_scene(include_spheres=True)
    cam, cfg, key = procedural.default_camera(32, 32), IntegratorConfig(), rng.make_key(3)
    run = lambda: material_grads_wavetape(scene, cam, 8, key, cfg, lanes=8192, chunk=8192,
                                          device="cuda")
    launches = mg_kernel.SCATTER_LAUNCHES
    g_tri, g_sph, film = run()
    assert mg_kernel.SCATTER_LAUNCHES > launches
    with monkeypatch.context() as m:
        m.setattr(mat_gather, "gather", mat_gather.gather_plain)
        r_tri, r_sph, r_film = run()
    assert torch.equal(film, r_film)
    for a, b in ((g_tri, r_tri), (g_sph, r_sph)):
        for f in MAT_FIELDS:
            x, y = getattr(a, f).double(), getattr(b, f).double()
            assert (x - y).abs().max().item() <= 1e-4 * y.abs().max().clamp(min=1e-12).item(), f


@pytest.mark.gpu
def test_card_counters_train_step_and_render(cuda):
    """The train step gathers and sums through the kernels; a render (no
    grad) gathers through them and runs no backward."""
    from pathtrace_tpu_torch import bench
    from pathtrace_tpu_torch.integrator.wavefront import render_wavefront_chunked

    step = bench.make_train_step(cuda, 32, 32)
    before = counters()
    step(4)
    torch.cuda.synchronize()
    gathers, scatters = (a - b for a, b in zip(counters(), before))
    assert gathers > 0 and scatters > 0
    scene, camera, _, cfg, key = bench.train_problem(cuda, 32, 32)
    before = counters()
    render_wavefront_chunked(scene, camera, 4, key, cfg, lanes=4096, chunk_spp=4,
                             device="cuda")
    torch.cuda.synchronize()
    gathers, scatters = (a - b for a, b in zip(counters(), before))
    assert gathers > 0 and scatters == 0
