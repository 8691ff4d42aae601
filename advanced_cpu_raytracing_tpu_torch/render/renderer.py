"""Image rendering: stratified multisampling with Gaussian
reconstruction and per-camera orchestration, through the megakernel or the
wavefront integrator.

Counterpart of the JAX package's ``render/renderer.py``.  A scene inside
the megakernel's envelope (``ops/megakernel.py::mega_missing`` names
nothing) renders through it: pixel coordinates come from an on-device
arange, each of the n_cells^2 stratified samples is one kernel launch over
every pixel (over a scene of more than one 128-face chunk, the launch of
the instantiation that walks the tree), samples accumulate with the 2D
Gaussian filter (sigma = 1/6 pixel, src/gaussian.h:3-21; weights on the
jitter offsets, main.cpp:79-100), and the u8 clamp happens on the device.  Scenes that
draw randoms in the kernel (path tracing, mesh and area lights, roughness,
motion blur) draw them from Philox keyed by (seed, sample index), so a
frame on the CPU and one on the card draw the same numbers; the thin lens
of a DoF camera is sampled here, outside the kernel, from the render's
generator (renderer.py:150-156 in the JAX package).  Any other scene (two
environment lights, textures with a BRDF or motion, depth above the
kernels' 10, ...) renders through the wavefront integrator
(``render/integrator.py``) in lane tiles (``_auto_tile``), as the JAX
package renders every scene outside its fused kernel; its jitter, lens,
time and shading draws come from Philox keyed by (seed, sample) and each
ray's index in the frame, so the tile size changes no pixel.
"""

from __future__ import annotations

import math
import weakref

import numpy as np
import torch

from advanced_cpu_raytracing_tpu_torch.ops import megakernel as mk
from advanced_cpu_raytracing_tpu_torch.ops import rng
from advanced_cpu_raytracing_tpu_torch.ops.megakernel import (
    build_mega,
    mega_missing,
    mega_trace,
)
from advanced_cpu_raytracing_tpu_torch.render.camera import (
    build_camera,
    generate_rays,
)
from advanced_cpu_raytracing_tpu_torch.render.integrator import (
    RR_DEPTH_FLOOR,
    RenderOptions,
    branches,
    trace_radiance,
)
from advanced_cpu_raytracing_tpu_torch.scene.pack import ScenePack, pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.types import CameraCfg, SceneConfig
from advanced_cpu_raytracing_tpu_torch.utils.device import resolve_device
from advanced_cpu_raytracing_tpu_torch.utils.profiling import span


DEFAULT_TILE = 1 << 21  # the wavefront's lane tile, at most


def options_for_camera(cfg: SceneConfig, cam_cfg: CameraCfg) -> RenderOptions:
    rp = cam_cfg.renderer_params
    return RenderOptions(
        path_tracing=rp.path_tracing,
        importance_sampling=rp.importance_sampling,
        next_event_estimation=rp.next_event_estimation,
        russian_roulette=rp.russian_roulette,
        max_depth=cfg.max_recursion_depth,
        # path-traced renders sample one dielectric child per hit (a flat
        # ray population) instead of splitting; Whitted renders keep the
        # reference's deterministic split
        stochastic_dielectric=rp.path_tracing)


def _gaussian_multisample(trace_fn, px, py, n_cells: int, jitter=None,
                          generator=None):
    """n_cells^2 stratified samples per pixel, Gaussian weighted (sigma =
    1/6).  ``jitter`` (S, R, 2) in [0, 1) gives the in-cell offsets
    explicitly (tests feed the JAX package's draws), or is a function of
    the sample index that returns them; otherwise each sample draws (R, 2)
    uniforms from ``generator``.  ``trace_fn(px, py, s)`` gets the sample
    index ``s``."""
    if n_cells <= 1:
        with span("renderer.sample"):
            return trace_fn(px, py, 0)
    r = px.shape[0]
    sigma = 1.0 / 6.0
    inv_2s2 = 1.0 / (2.0 * sigma * sigma)
    c1 = 1.0 / (2.0 * math.pi * sigma * sigma)
    acc = torch.zeros((r, 3), dtype=torch.float32, device=px.device)
    wacc = torch.zeros(r, dtype=torch.float32, device=px.device)
    for s in range(n_cells * n_cells):
        with span("renderer.sample"):
            row, col = divmod(s, n_cells)
            if callable(jitter):
                psi = jitter(s)
            elif jitter is not None:
                psi = jitter[s].to(device=px.device, dtype=torch.float32)
            else:
                psi = torch.rand((r, 2), generator=generator,
                                 device=px.device)
            sx = (col + psi[:, 0]) / n_cells
            sy = (row + psi[:, 1]) / n_cells
            colr = trace_fn(px + sx, py + sy, s)
            dx = sx - 0.5
            dy = sy - 0.5
            wgt = c1 * torch.exp(-(dx * dx + dy * dy) * inv_2s2)
            acc = acc + colr * wgt[:, None]
            wacc = wacc + wgt
    return acc / wacc[:, None]


def _render_image_mega(mc, tri_tab, chunk_tab, cam, n_cells: int, w: int,
                       h: int, as_ldr: bool, generator=None, jitter=None,
                       seed: int = 0, lo: int = 0, hi: int | None = None):
    """Whole image through the kernel: (w*h, 3) in scanline order, f32
    radiance or, with ``as_ldr``, the u8 clamp ((int)c clamped to [0,255],
    src/helperMath.cpp:140-152) done on the device; or only the pixels
    ``lo``..``hi`` of the scanline order (a shard, ``parallel/``).  Sample
    ``s`` draws its randoms from Philox keyed by (``seed``, ``s``) over the
    rays in launch order (the tile order where tiles are used)."""
    dev = tri_tab.device
    hi = w * h if hi is None else hi
    # For divergent scenes, trace rays in 32x32 pixel tiles so that rays of
    # one deep object share thread blocks (analytic index arithmetic, no
    # stored permutation), then put the result back in scanline order.
    tiled = (mc.has_dielectric and mc.max_depth > 2 and n_cells <= 1
             and (lo, hi) == (0, w * h))
    if tiled:
        tw = 32
        ntx, nty = -(-w // tw), -(-h // tw)
        i = torch.arange(ntx * nty * tw * tw, device=dev)
        tile, within = i // (tw * tw), i % (tw * tw)
        px = ((tile % ntx) * tw + within % tw).to(torch.float32)
        py = ((tile // ntx) * tw + within // tw).to(torch.float32)
        p = torch.arange(w * h, device=dev)
        xx, yy = p % w, p // w
        unperm = ((yy // tw) * ntx + xx // tw) * (tw * tw) \
            + (yy % tw) * tw + (xx % tw)
    else:
        idx = torch.arange(lo, hi, device=dev)
        px = (idx % w).to(torch.float32)
        py = (idx // w).to(torch.float32)

    def trace(px2, py2, sample):
        lens = None
        if cam.use_dof:
            lens = torch.rand((px2.shape[0], 2), generator=generator,
                              device=dev) * 2.0 - 1.0
        o, d = generate_rays(cam, px2, py2, lens, dof=cam.use_dof)
        # the replace_background decal samples at the pixel UV of the
        # jittered sample (texture.h:49-52)
        pix_uv = (torch.stack((px2 * (1.0 / w), py2 * (1.0 / h)), -1)
                  if mc.bg_tex >= 0 else None)
        return mega_trace(mc, tri_tab, chunk_tab, o.contiguous(),
                          d.contiguous(), seed=seed, sample=sample,
                          pix_uv=pix_uv)

    col = _gaussian_multisample(trace, px, py, n_cells, jitter=jitter,
                                generator=generator)
    if tiled:
        col = col[unperm]
    if as_ldr:
        col = torch.nan_to_num(col).clamp(0.0, 255.0).to(torch.uint8)
    return col


# build_mega reads every table back to the host (and, past the forward
# route's threshold, builds the K1e tree into mc.tree); cache it per (pack,
# opts, device, threshold).  Keyed by id() with a weakref guard: packs are
# not changed after pack_scene, so identity is the right key.
_MEGA_CACHE: dict = {}


def _mega_build_cached(pack: ScenePack, opts: RenderOptions, dev):
    """The forward route's tables: the tree past FWD_FLAT_MAX_FACES work
    items, a scene of more than one chunk."""
    flat_max = mk.FWD_FLAT_MAX_FACES
    key = (id(pack), opts, str(dev), flat_max)
    ent = _MEGA_CACHE.get(key)
    if ent is not None and ent[0]() is pack:
        return ent[1]
    built = build_mega(pack, opts, device=dev, flat_max=flat_max)
    _MEGA_CACHE[key] = (weakref.ref(pack), built)
    return built


def _auto_tile(total: int, opts: RenderOptions, pack: ScenePack,
               requested: int | None) -> int:
    """The wavefront's lane tile (JAX renderer.py:37-55): as large as
    possible while the per-lane ray stack stays within a fixed budget, or
    ``requested``."""
    if requested:
        return requested
    depth_total = opts.max_depth + (RR_DEPTH_FLOOR if opts.russian_roulette
                                    else 0)
    k = max(branches(pack.static, opts) - 1, 1) * max(depth_total, 1) + 4
    bytes_per_lane = k * 64 + 256  # stack entries + working set
    tile = min(DEFAULT_TILE, max((4 << 30) // bytes_per_lane, 1 << 14))
    return min(tile, max(total, 1))


def _render_tile(pack, cam, px, py, seed: int, ray0: int, opts: RenderOptions,
                 n_cells: int):
    """One lane tile through the wavefront integrator (JAX
    renderer.py:95-102): px, py (R,) the integer pixel coordinates of rays
    ``ray0``.. of the frame, every sample's draws from Philox keyed by
    (``seed``, sample) at the rays' indices in the frame."""
    r = px.shape[0]

    def draws(s):
        return rng.PhiloxDraws(seed, sample=s, ray0=ray0, device=px.device)

    def jitter(s):
        return draws(s).uniform(-1, rng.SITE_JITTER, r, 2)

    return _gaussian_multisample(
        lambda px2, py2, s: trace_radiance(pack, cam, px2, py2, draws(s), opts),
        px, py, n_cells, jitter=jitter)


def _render_image_wavefront(pack, cam, opts: RenderOptions, n_cells: int,
                            w: int, h: int, seed: int, tile_size, lo: int = 0,
                            hi: int | None = None):
    """Whole image through the wavefront, tile by tile (JAX
    renderer.py:298-319): (w*h, 3) f32 radiance in scanline order; or only
    the pixels ``lo``..``hi``, the same values as in the whole image."""
    dev = cam.position.device
    hi = w * h if hi is None else hi
    tile = _auto_tile(hi - lo, opts, pack, tile_size)
    idx = torch.arange(lo, hi, device=dev)
    px_all = (idx % w).to(torch.float32)
    py_all = (idx // w).to(torch.float32)
    out = torch.empty((hi - lo, 3), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for a in range(0, hi - lo, tile):
            b = min(a + tile, hi - lo)
            out[a:b] = _render_tile(pack, cam, px_all[a:b], py_all[a:b], seed,
                                    lo + a, opts, n_cells)
    return out


@span("renderer.frame")
def render_camera(pack: ScenePack, cfg: SceneConfig, cam_cfg: CameraCfg,
                  seed: int = 0, spp: int | None = None, ldr: bool = False,
                  device=None, jitter=None,
                  tile_size: int | None = None) -> np.ndarray:
    """Render one camera to an (H, W, 3) image on ``device`` (default
    ``cuda``): f32 radiance, or with ``ldr=True`` the u8 clamp done on the
    device.  A scene inside the megakernel's envelope goes through it
    (``jitter`` (S, H*W, 2) then replaces the stratified jitter draws, see
    ``_gaussian_multisample``); any other through the wavefront integrator
    in lane tiles of ``tile_size`` rays (default ``_auto_tile``)."""
    dev = resolve_device(device)
    opts = options_for_camera(cfg, cam_cfg)
    w, h = cam_cfg.width, cam_cfg.height
    spp = cam_cfg.num_samples if spp is None else spp
    n_cells = max(int(math.isqrt(max(spp, 1))), 1)
    cam = build_camera(cam_cfg, device=dev)
    if mega_missing(pack.static, opts, pack):
        img = _render_image_wavefront(pack, cam, opts, n_cells, w, h, seed,
                                      tile_size)
        if ldr:
            img = torch.nan_to_num(img).clamp(0.0, 255.0).to(torch.uint8)
        with span("renderer.to_host"):
            return img.reshape(h, w, 3).cpu().numpy()
    mc, tri_tab, chunk_tab = _mega_build_cached(pack, opts, dev)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    img = _render_image_mega(mc, tri_tab, chunk_tab, cam, n_cells, w, h,
                             ldr, generator=generator, jitter=jitter,
                             seed=seed)
    with span("renderer.to_host"):
        return img.reshape(h, w, 3).cpu().numpy()


def ldr_from_radiance(img: np.ndarray) -> np.ndarray:
    """Clamp path for non-tonemapped cameras: (int)c clamped to [0,255]
    (clamp(), src/helperMath.cpp:140-152; applied at main.cpp:121)."""
    return np.clip(np.nan_to_num(img).astype(np.int32), 0, 255).astype(np.uint8)


def render_scene(path_or_cfg, seed: int = 0, spp: int | None = None,
                 device=None):
    """Render every camera of a scene on ``device`` (default ``cuda``);
    returns a list of (camera_cfg, radiance_image) tuples."""
    dev = resolve_device(device)
    if isinstance(path_or_cfg, SceneConfig):
        cfg = path_or_cfg
    else:
        from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene

        cfg = load_scene(path_or_cfg)
    pack = pack_scene(cfg, device=dev)
    return [(cam_cfg, render_camera(pack, cfg, cam_cfg, seed=seed, spp=spp,
                                    device=dev))
            for cam_cfg in cfg.cameras]
