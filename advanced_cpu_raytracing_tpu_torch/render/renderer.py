"""Image rendering: stratified multisampling with Gaussian
reconstruction and per-camera orchestration through the megakernel.

Counterpart of the JAX package's ``render/renderer.py`` (its fused-kernel
route): pixel coordinates come from an on-device arange, each of the
n_cells^2 stratified samples is one kernel launch over every pixel, samples
accumulate with the 2D Gaussian filter (sigma = 1/6 pixel,
src/gaussian.h:3-21; weights on the jitter offsets, main.cpp:79-100), and
the u8 clamp happens on the device.  Scenes that draw randoms in the
kernel (path tracing, mesh and area lights, roughness, motion blur) draw
them from Philox keyed by (seed, sample index), so a frame on the CPU and
one on the card draw the same numbers; the thin lens of a DoF camera is
sampled here, outside the kernel, from the render's generator
(renderer.py:150-156 in the JAX package).  Scenes outside the kernels'
envelope raise ``NotImplementedError``: the port has no wavefront
integrator yet.
"""

from __future__ import annotations

import math
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from advanced_cpu_raytracing_tpu_torch.ops.megakernel import (
    build_mega,
    mega_missing,
    mega_trace,
)
from advanced_cpu_raytracing_tpu_torch.render.camera import (
    build_camera,
    generate_rays,
)
from advanced_cpu_raytracing_tpu_torch.scene.pack import ScenePack, pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.types import CameraCfg, SceneConfig
from advanced_cpu_raytracing_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class RenderOptions:
    """The render settings of one camera (the JAX package's RenderOptions
    without its wavefront and differentiable switches)."""

    path_tracing: bool = False
    importance_sampling: bool = False
    next_event_estimation: bool = False
    russian_roulette: bool = False
    max_depth: int = 5


def options_for_camera(cfg: SceneConfig, cam_cfg: CameraCfg) -> RenderOptions:
    rp = cam_cfg.renderer_params
    return RenderOptions(
        path_tracing=rp.path_tracing,
        importance_sampling=rp.importance_sampling,
        next_event_estimation=rp.next_event_estimation,
        russian_roulette=rp.russian_roulette,
        max_depth=cfg.max_recursion_depth)


def _gaussian_multisample(trace_fn, px, py, n_cells: int, jitter=None,
                          generator=None):
    """n_cells^2 stratified samples per pixel, Gaussian weighted (sigma =
    1/6).  ``jitter`` (S, R, 2) in [0, 1) gives the in-cell offsets
    explicitly (tests feed the JAX package's draws); otherwise each sample
    draws (R, 2) uniforms from ``generator``.  ``trace_fn(px, py, s)`` gets
    the sample index ``s``."""
    if n_cells <= 1:
        return trace_fn(px, py, 0)
    r = px.shape[0]
    sigma = 1.0 / 6.0
    inv_2s2 = 1.0 / (2.0 * sigma * sigma)
    c1 = 1.0 / (2.0 * math.pi * sigma * sigma)
    acc = torch.zeros((r, 3), dtype=torch.float32, device=px.device)
    wacc = torch.zeros(r, dtype=torch.float32, device=px.device)
    for s in range(n_cells * n_cells):
        row, col = divmod(s, n_cells)
        if jitter is not None:
            psi = jitter[s].to(device=px.device, dtype=torch.float32)
        else:
            psi = torch.rand((r, 2), generator=generator, device=px.device)
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
                       seed: int = 0):
    """Whole image through the kernel: (w*h, 3) in scanline order, f32
    radiance or, with ``as_ldr``, the u8 clamp ((int)c clamped to [0,255],
    src/helperMath.cpp:140-152) done on the device.  Sample ``s`` draws its
    randoms from Philox keyed by (``seed``, ``s``) over the rays in launch
    order (the tile order where tiles are used)."""
    dev = tri_tab.device
    # For divergent scenes, trace rays in 32x32 pixel tiles so that rays of
    # one deep object share thread blocks (analytic index arithmetic, no
    # stored permutation), then put the result back in scanline order.
    tiled = mc.has_dielectric and mc.max_depth > 2 and n_cells <= 1
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
        idx = torch.arange(w * h, device=dev)
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


# build_mega reads every table back to the host (and, past FLAT_MAX_FACES
# work items, builds the K1e tree into mc.tree); cache it per (pack, opts,
# device).  Keyed by id() with a weakref guard: packs are not changed after
# pack_scene, so identity is the right key.
_MEGA_CACHE: dict = {}


def _mega_build_cached(pack: ScenePack, opts: RenderOptions, dev):
    key = (id(pack), opts, str(dev))
    ent = _MEGA_CACHE.get(key)
    if ent is not None and ent[0]() is pack:
        return ent[1]
    built = build_mega(pack, opts, device=dev)
    _MEGA_CACHE[key] = (weakref.ref(pack), built)
    return built


def render_camera(pack: ScenePack, cfg: SceneConfig, cam_cfg: CameraCfg,
                  seed: int = 0, spp: int | None = None, ldr: bool = False,
                  device=None, jitter=None) -> np.ndarray:
    """Render one camera to an (H, W, 3) image on ``device`` (default
    ``cuda``): f32 radiance, or with ``ldr=True`` the u8 clamp done on the
    device.  ``jitter`` (S, H*W, 2) replaces the stratified jitter draws
    (see ``_gaussian_multisample``)."""
    dev = resolve_device(device)
    opts = options_for_camera(cfg, cam_cfg)
    missing = mega_missing(pack.static, opts, pack)
    if missing:
        raise NotImplementedError(
            "scene outside the megakernel's envelope: "
            + ", ".join(missing))
    w, h = cam_cfg.width, cam_cfg.height
    spp = cam_cfg.num_samples if spp is None else spp
    n_cells = max(int(math.isqrt(max(spp, 1))), 1)
    mc, tri_tab, chunk_tab = _mega_build_cached(pack, opts, dev)
    cam = build_camera(cam_cfg, device=dev)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    img = _render_image_mega(mc, tri_tab, chunk_tab, cam, n_cells, w, h,
                             ldr, generator=generator, jitter=jitter,
                             seed=seed)
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
