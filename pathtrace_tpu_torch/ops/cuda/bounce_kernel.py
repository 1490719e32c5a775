"""Fused wavefront render on the CUDA bounce kernel (csrc/bounce_kernel.cu).

Port of pathtrace_tpu/ops/pallas/bounce_kernel.py: the scene pack, the
kernel's wrapper, the chunked driver `render_wavefront_fused` and
`auto_fused_config`. The kernel traces every path of a chunk in one
launch, one thread per lane; its plain version is the static strided
wavefront (integrator/wavefront.py), which the wrapper runs when the
scene's tensors lie on the CPU. On a CUDA device the wrapper launches the
kernel or raises; it never falls back.

The kernel library is built by nvcc at first launch (ops/cuda/build.py);
importing this module needs neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from pathtrace_tpu_torch.core.camera import Camera
from pathtrace_tpu_torch.integrator.config import IntegratorConfig
from pathtrace_tpu_torch.integrator.wavefront import (_run_wavefront, accumulate_chunks,
                                                      check_lanes)
from pathtrace_tpu_torch.models.scene import Scene
from pathtrace_tpu_torch.ops.cuda import build
from pathtrace_tpu_torch.utils import rng
from pathtrace_tpu_torch.utils.device import resolve_device
from pathtrace_tpu_torch.utils.profiling import span

# Kernel launches made by `launch` in this process. chip_smoke.py resets it
# before driving the main path and reads it after.
LAUNCHES = 0

# Row widths of the packed tables; csrc/bounce_kernel.cu has the same.
GEO_STRIDE, ATTR_STRIDE, SPHERE_STRIDE, LIGHT_STRIDE = 12, 40, 16, 16
# Dynamic shared memory a block may use on sm_90 (232,448 bytes).
MAX_SMEM_BYTES = 232448


class PtParams(ctypes.Structure):
    """Mirror of `struct PtParams` in csrc/bounce_kernel.cu."""

    _fields_ = [
        ("base_path", ctypes.c_longlong), ("total_paths", ctypes.c_longlong),
        ("cam_pos", ctypes.c_float * 3), ("cam_forward", ctypes.c_float * 3),
        ("cam_up", ctypes.c_float * 3), ("cam_right", ctypes.c_float * 3),
        ("tan_x", ctypes.c_float), ("tan_y", ctypes.c_float),
        ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("num_pix", ctypes.c_int), ("lanes", ctypes.c_int), ("k_pix", ctypes.c_int),
        ("num_pix_total", ctypes.c_int), ("pix_offset", ctypes.c_int),
        ("num_tris", ctypes.c_int), ("num_spheres", ctypes.c_int),
        ("num_lights", ctypes.c_int),
        ("key0", ctypes.c_uint), ("key1", ctypes.c_uint),
        ("max_bounce", ctypes.c_int), ("rr_bounce", ctypes.c_int),
        ("refract_cap", ctypes.c_int), ("nee", ctypes.c_int),
        ("rr_stop_prob", ctypes.c_float), ("pdf_clamp", ctypes.c_float),
        ("miss", ctypes.c_float * 3),
    ]


@dataclasses.dataclass(frozen=True)
class FusedPack:
    """Device tables the kernel reads.

    tri_geo  (T, 12): v0 e1 e2 pad - the search table, staged in shared memory
    tri_attr (T, 40): n0 n1 n2 t0 t1 t2 b0 b1 b2 emittance albedo specular
                      opacity roughness metallic pad - read at the winner
    spheres  (S, 16): center radius emittance albedo specular opacity
                      roughness metallic
    lights   (L, 16): v0 v1 v2 area normal (Scene.light_pack) tri_id pad pad
    """

    tri_geo: torch.Tensor
    tri_attr: torch.Tensor
    spheres: torch.Tensor
    lights: torch.Tensor

    @property
    def smem_bytes(self) -> int:
        return 4 * (self.tri_geo.numel() + self.spheres.numel() + self.lights.numel())


def build_fused_pack(scene: Scene) -> FusedPack:
    """Pack the scene's tables on the scene's device. Raises when the
    search table does not fit one block's shared memory."""
    tr, mat, sp = scene.tris, scene.mat, scene.spheres
    dev = scene.device
    t, s, nl = scene.num_tris, scene.num_spheres, scene.num_lights
    geo = torch.zeros((t, GEO_STRIDE), device=dev)
    geo[:, 0:3], geo[:, 3:6], geo[:, 6:9] = tr.v0, tr.e1, tr.e2
    attr = torch.zeros((t, ATTR_STRIDE), device=dev)
    for j, f in enumerate(("n0", "n1", "n2", "t0", "t1", "t2", "b0", "b1", "b2")):
        attr[:, 3 * j:3 * j + 3] = getattr(tr, f)
    attr[:, 27:30], attr[:, 30:33], attr[:, 33:36] = mat.emittance, mat.albedo, mat.specular
    attr[:, 36], attr[:, 37], attr[:, 38] = mat.opacity, mat.roughness, mat.metallic
    sph = torch.zeros((s, SPHERE_STRIDE), device=dev)
    if s:
        sph[:, 0:3], sph[:, 3] = sp.center, sp.radius
        sph[:, 4:7], sph[:, 7:10], sph[:, 10:13] = (sp.mat.emittance, sp.mat.albedo,
                                                    sp.mat.specular)
        sph[:, 13], sph[:, 14], sph[:, 15] = sp.mat.opacity, sp.mat.roughness, sp.mat.metallic
    lights = torch.zeros((nl, LIGHT_STRIDE), device=dev)
    if nl:
        lights[:, 0:13] = scene.light_pack[:nl]
        lights[:, 13] = scene.lights[:nl].to(torch.float32)  # ids < 2**24: exact
    pack = FusedPack(tri_geo=geo, tri_attr=attr, spheres=sph, lights=lights)
    if pack.smem_bytes > MAX_SMEM_BYTES:
        raise ValueError(
            f"scene needs {pack.smem_bytes} bytes of shared memory for its "
            f"{t} triangles, {s} spheres and {nl} lights; the fused kernel "
            f"holds at most {MAX_SMEM_BYTES} (large meshes take the mesh path, "
            "ROADMAP A7-A8)")
    return pack


def make_params(camera: Camera, cfg: IntegratorConfig, base_key, pack: FusedPack,
                lanes: int, spp: int, sample_offset: int, *, pix_offset: int = 0,
                num_pix_local=None) -> PtParams:
    """The launch's parameters over local path ids [sample_offset * num_pix,
    (sample_offset + spp) * num_pix) of the pixel slice [pix_offset,
    pix_offset + num_pix) (num_pix = num_pix_local, the whole image by
    default) of the camera's image, whose pixel count is num_pix_total:
    the kernel keys RNG streams and camera rays by global path id, as
    wavefront._make_to_global."""
    npt = camera.width * camera.height
    num_pix = npt if num_pix_local is None else num_pix_local
    if pix_offset < 0 or pix_offset + num_pix > npt:
        raise ValueError(f"pixel slice [{pix_offset}, {pix_offset + num_pix}) outside the "
                         f"image's {npt} pixels")
    k0, k1 = rng.key_words(base_key)
    tx, ty = camera.tan_half_fov()
    vec = lambda a: (ctypes.c_float * 3)(*(float(x) for x in a))
    return PtParams(
        base_path=sample_offset * num_pix, total_paths=spp * num_pix,
        cam_pos=vec(camera.pos), cam_forward=vec(camera.forward),
        cam_up=vec(camera.up), cam_right=vec(camera.right), tan_x=tx, tan_y=ty,
        width=camera.width, height=camera.height, num_pix=num_pix, lanes=lanes,
        k_pix=check_lanes(lanes, num_pix), num_pix_total=npt, pix_offset=pix_offset,
        num_tris=pack.tri_geo.shape[0], num_spheres=pack.spheres.shape[0],
        num_lights=pack.lights.shape[0], key0=k0, key1=k1,
        max_bounce=cfg.max_bounce, rr_bounce=cfg.rr_bounce,
        refract_cap=cfg.refract_cap, nee=int(cfg.nee),
        rr_stop_prob=cfg.rr_stop_prob, pdf_clamp=cfg.pdf_clamp,
        miss=vec(cfg.miss_radiance))


def _check(name: str, x: torch.Tensor, cols: int, dtype=torch.float32):
    if x.device.type != "cuda" or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} CUDA tensor, got "
                         f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})")
    if x.dim() != 2 or x.shape[1] != cols:
        raise ValueError(f"{name}: need shape (N, {cols}), got {tuple(x.shape)}")


def render_fn_of(lib: ctypes.CDLL):
    """The launcher `pt_bounce_render` of a built kernel library, after
    checking that the library's struct and table layouts are the ones this
    module packs."""
    strides = (ctypes.c_int * 4)()
    lib.pt_bounce_strides.argtypes = [ctypes.c_void_p]
    lib.pt_bounce_strides.restype = ctypes.c_int
    size = lib.pt_bounce_strides(ctypes.addressof(strides))
    want = (GEO_STRIDE, ATTR_STRIDE, SPHERE_STRIDE, LIGHT_STRIDE)
    if tuple(strides) != want or size != ctypes.sizeof(PtParams):
        raise RuntimeError(f"kernel library layout {tuple(strides)}/{size} bytes does not "
                           f"match the wrapper's {want}/{ctypes.sizeof(PtParams)} bytes")
    fn = lib.pt_bounce_render
    fn.argtypes = [ctypes.POINTER(PtParams)] + [ctypes.c_void_p] * 7
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _render_fn():
    """This package's launcher, checked once per process."""
    return render_fn_of(build.load_library())


def occupancy(pack: FusedPack) -> dict:
    """The kernel as built and as the current card holds it with this
    pack's shared memory: registers and local-memory bytes (stack frame and
    spills) a thread, resident blocks and warps per SM, threads a block,
    SMs, and the lanes of one full wave (blocks x SMs x threads)."""
    lib = build.load_library()
    out = (ctypes.c_int * 4)()
    lib.pt_bounce_occupancy.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.pt_bounce_occupancy.restype = ctypes.c_int
    err = lib.pt_bounce_occupancy(pack.smem_bytes, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"bounce kernel occupancy query failed: cudaError {err}")
    regs, local, blocks, block = out
    sms = torch.cuda.get_device_properties(pack.tri_geo.device).multi_processor_count
    return {"registers": regs, "local_bytes": local, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * block // 32, "block": block, "sms": sms,
            "wave_lanes": blocks * sms * block}


def launch(pack: FusedPack, params: PtParams):
    """One kernel launch on the current stream: returns the film slots
    (k_pix * lanes, 3) and the per-lane ray counts (lanes,) int64."""
    global LAUNCHES
    for name, x, cols in (("tri_geo", pack.tri_geo, GEO_STRIDE),
                          ("tri_attr", pack.tri_attr, ATTR_STRIDE),
                          ("spheres", pack.spheres, SPHERE_STRIDE),
                          ("lights", pack.lights, LIGHT_STRIDE)):
        _check(name, x, cols)
    dev = pack.tri_geo.device
    if any(x.device != dev for x in (pack.tri_attr, pack.spheres, pack.lights)):
        raise ValueError("pack tensors must share one CUDA device")
    if pack.tri_attr.shape[0] != pack.tri_geo.shape[0]:
        raise ValueError("tri_geo and tri_attr must have one row per triangle")
    if (params.num_tris, params.num_spheres, params.num_lights) != (
            pack.tri_geo.shape[0], pack.spheres.shape[0], pack.lights.shape[0]):
        raise ValueError("params do not describe this pack")
    render_fn = _render_fn()
    with torch.cuda.device(dev):
        film = torch.empty((params.k_pix * params.lanes, 3), device=dev)
        rays = torch.empty((params.lanes,), dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with span("b1.launch", lanes=params.lanes, spp=params.total_paths // params.num_pix):
            err = render_fn(ctypes.byref(params), pack.tri_geo.data_ptr(),
                            pack.tri_attr.data_ptr(), pack.spheres.data_ptr(),
                            pack.lights.data_ptr(), film.data_ptr(), rays.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bounce kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return film, rays


def fused_chunk(pack: FusedPack, camera: Camera, spp: int, sample_offset: int, base_key,
                cfg: IntegratorConfig, lanes: int, *, pix_offset: int = 0, num_pix_local=None,
                launch_events=None):
    """((H, W, 3) mean image, rays traced) of one kernel launch over path ids
    [sample_offset*num_pix, (sample_offset+spp)*num_pix); on a pixel slice
    (make_params' keywords) the flat (num_pix_local, 3) slice instead. With
    a list as launch_events, the (start, end) CUDA events recorded around
    the launch are appended to it."""
    params = make_params(camera, cfg, base_key, pack, lanes, spp, sample_offset,
                         pix_offset=pix_offset, num_pix_local=num_pix_local)
    num_pix = params.num_pix
    rng.check_path_ids(params.num_pix_total, spp, sample_offset)
    if launch_events is None:
        film, rays = launch(pack, params)
    else:
        stream = torch.cuda.current_stream(pack.tri_geo.device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(stream)
        film, rays = launch(pack, params)
        end.record(stream)
        launch_events.append((start, end))
    # film slot k*lanes + i belongs to pixel (i + k*lanes) % num_pix
    if num_pix >= lanes:
        film_pix = film
    else:
        film_pix = film.reshape(lanes // num_pix, num_pix, 3).sum(dim=0)
    if num_pix_local is not None:
        img = film_pix / spp
    else:
        img = film_pix.reshape(camera.height, camera.width, 3) / spp
    with span("fused.read_rays"):
        return img, int(rays.sum())


def auto_fused_config(num_pix: int, target_lanes: int = 65536) -> int:
    """Lane count for the fused engine: the film mapping needs
    lanes % num_pix == 0 or num_pix % lanes == 0. Power-of-two pixel
    counts get target_lanes; otherwise the nearest multiple of num_pix at
    or below target_lanes (at least num_pix). The JAX engine's extra
    1024-lane alignment was a Pallas block constraint and is not needed."""
    if target_lanes % num_pix == 0 or num_pix % target_lanes == 0:
        return target_lanes
    return num_pix * max(1, target_lanes // num_pix)


def render_wavefront_fused(scene: Scene, camera: Camera, spp: int, base_key,
                           cfg: IntegratorConfig = None, lanes: int = 65536,
                           chunk_spp: int = 64, *, sample_offset: int = 0, pix_offset: int = 0,
                           num_pix_local=None, launch_events=None, device="cuda"):
    """Fused-engine render -> ((H, W, 3) image on `device`, rays traced).

    Same estimator as render_wavefront; spp is chunked like
    render_wavefront_chunked (film += chunk_image * chunk_spp). On CUDA each
    chunk is one kernel launch; on the CPU it is the plain wavefront. Only
    cosine hemisphere sampling exists in the kernel (as in the JAX fused
    engine, whose bsdf_t has no uniform lobe): hemisphere="uniform" raises.
    The samples are [sample_offset, sample_offset + spp). pix_offset and
    num_pix_local render one pixel slice (the shard body
    of parallel/mesh.py::render_fused_sharded), keyed by global path ids,
    and return its flat (num_pix_local, 3) image. launch_events: as in
    fused_chunk (on the CPU no launch records any).
    """
    cfg = IntegratorConfig() if cfg is None else cfg
    if cfg.hemisphere != "cosine":
        raise ValueError("the fused engine samples the cosine hemisphere only; "
                         f"got hemisphere={cfg.hemisphere!r}")
    dev = resolve_device(device)
    npt = camera.width * camera.height
    check_lanes(lanes, npt if num_pix_local is None else num_pix_local)
    rng.check_path_ids(npt, spp, sample_offset)
    with span("fused.render"):
        scene = scene.to(dev)
        sliced = dict(pix_offset=pix_offset, num_pix_local=num_pix_local)
        if dev.type == "cpu":
            def run_chunk(n, offset):
                return _run_wavefront(scene, camera, n, base_key, cfg, lanes,
                                      sample_offset + offset, **sliced)
        elif dev.type == "cuda":
            with span("fused.pack"):
                pack = build_fused_pack(scene)

            def run_chunk(n, offset):
                return fused_chunk(pack, camera, n, sample_offset + offset, base_key, cfg,
                                   lanes, launch_events=launch_events, **sliced)
        else:
            raise ValueError(f"no fused engine for device {dev}")
        return accumulate_chunks(run_chunk, camera, spp, chunk_spp, dev, num_pix_local)
