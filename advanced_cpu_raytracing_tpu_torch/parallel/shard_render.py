"""Sharded rendering: pixels split over the ranks of a ``tiles`` mesh, the
scene replicated (the JAX package's ``parallel/shard_render.py``).

The reference's only parallel axis is row blocks over 8 pthreads
(main.cpp:38-39).  The JAX package shards the flat pixel batch over a
device mesh under ``shard_map`` and jit.  Here each rank is a process with
a card of its own (``parallel/mesh.py``): it renders its contiguous range
of the flat pixel list (``shard_bounds``) through the same routes as the
single-card renderer, and the collectives are only the joins: an
all-gather of the image parts, and an all-reduce (sum) of the loss and of
every parameter's gradient.

Each rank's part is a plain function of its rank and the world size
(``shard_image``, ``shard_batch``, ``shard_loss_and_grads``,
``shard_diff_step``), so the parts of several ranks can be computed and
joined in one process.

Draws.  The fused kernels' ranks draw from Philox keyed by ``seed +
RANK_SEED * rank`` (JAX shard_render.py:87), rank 0 exactly what the
single-card renderer draws, so at world size 1 the images and steps are
those of ``render_camera`` and ``make_diff_render``; at other world sizes
the same estimator with other samples.  The wavefront's draws are keyed by
each ray's index in the frame, so its sharded image equals the unsharded
one at any world size.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from advanced_cpu_raytracing_tpu_torch.ops import rng
from advanced_cpu_raytracing_tpu_torch.ops.megabwd import (
    bwd_missing,
    make_diff_render,
)
from advanced_cpu_raytracing_tpu_torch.ops.megakernel import mega_missing
from advanced_cpu_raytracing_tpu_torch.parallel.mesh import (
    all_gather,
    mesh_ranks,
    shard_bounds,
)
from advanced_cpu_raytracing_tpu_torch.render.camera import (
    build_camera,
    generate_rays,
)
from advanced_cpu_raytracing_tpu_torch.render.integrator import (
    RenderOptions,
    trace_radiance,
)
from advanced_cpu_raytracing_tpu_torch.render.renderer import (
    _mega_build_cached,
    _render_image_mega,
    _render_image_wavefront,
    options_for_camera,
)
from advanced_cpu_raytracing_tpu_torch.utils.device import resolve_device

RANK_SEED = 9973  # the seed offset of a rank (JAX shard_render.py:87)


def _all_reduce(loss: torch.Tensor, grads: dict, group):
    """Sum the loss and every gradient over the ranks, in place."""
    for x in (loss, *grads.values()):
        dist.all_reduce(x, group=group)
    return loss, grads


def _n_cells(cam_cfg, spp) -> int:
    spp = cam_cfg.num_samples if spp is None else spp
    return max(int(math.isqrt(max(spp, 1))), 1)


def shard_image(pack, cfg, cam_cfg, rank: int, world: int, seed: int = 0,
                spp: int | None = None, tile_size: int | None = None,
                device=None) -> torch.Tensor:
    """Rank ``rank``'s part (hi - lo, 3) f32 of the frame's radiance in
    scanline order, zero past the last pixel: through K1 when
    ``mega_missing`` names nothing, with the Gaussian multisample's jitter
    and lens from a generator seeded, and K1's Philox keyed, by ``seed +
    RANK_SEED * rank``; else through the wavefront in lane tiles of
    ``tile_size``, its draws keyed by (``seed``, sample) at each ray's
    index in the frame."""
    dev = resolve_device(device)
    opts = options_for_camera(cfg, cam_cfg)
    w, h = cam_cfg.width, cam_cfg.height
    lo, hi = shard_bounds(w * h, world, rank)
    end = min(hi, w * h)
    out = torch.zeros((hi - lo, 3), dtype=torch.float32, device=dev)
    if end <= lo:
        return out
    n_cells = _n_cells(cam_cfg, spp)
    cam = build_camera(cam_cfg, device=dev)
    if not mega_missing(pack.static, opts, pack):
        mc, tri_tab, chunk_tab = _mega_build_cached(pack, opts, dev)
        rank_seed = seed + RANK_SEED * rank
        generator = torch.Generator(device=dev)
        generator.manual_seed(rank_seed)
        out[:end - lo] = _render_image_mega(
            mc, tri_tab, chunk_tab, cam, n_cells, w, h, False,
            generator=generator, seed=rank_seed, lo=lo, hi=end)
    else:
        out[:end - lo] = _render_image_wavefront(
            pack, cam, opts, n_cells, w, h, seed, tile_size, lo=lo, hi=end)
    return out


def _gather_frame(part, cam_cfg, world, group) -> np.ndarray:
    w, h = cam_cfg.width, cam_cfg.height
    return all_gather(part, world, group)[:w * h].reshape(h, w, 3).cpu().numpy()


def render_camera_sharded_mega(pack, cfg, cam_cfg, mesh=None, seed: int = 0,
                               spp: int | None = None,
                               device=None) -> np.ndarray:
    """The frame through the fused kernel K1 on every rank's shard of the
    pixels, joined by an all-gather; every rank returns the (H, W, 3) f32
    radiance (JAX shard_render.py:35-117).  At 1 spp with no draws it
    equals ``render_camera``'s image at any world size; with draws, at
    world size 1; otherwise it is the same estimator with other samples.
    A scene outside K1 raises."""
    dev = resolve_device(device)
    missing = mega_missing(pack.static, options_for_camera(cfg, cam_cfg), pack)
    if missing:
        raise NotImplementedError(f"outside the megakernel: {missing}")
    group, rank, world = mesh_ranks(mesh, dev)
    part = shard_image(pack, cfg, cam_cfg, rank, world, seed, spp,
                       device=dev)
    return _gather_frame(part, cam_cfg, world, group)


def render_camera_sharded(pack, cfg, cam_cfg, mesh=None, seed: int = 0,
                          spp: int | None = None,
                          tile_size: int | None = None,
                          device=None) -> np.ndarray:
    """The production render (stratified multisampling and the Gaussian
    filter included) with the pixels sharded over the ranks (JAX
    shard_render.py:120-172): K1 when ``mega_missing`` names nothing
    (``render_camera_sharded_mega``), else the wavefront on every shard,
    whose image equals ``render_camera``'s at any world size."""
    dev = resolve_device(device)
    group, rank, world = mesh_ranks(mesh, dev)
    part = shard_image(pack, cfg, cam_cfg, rank, world, seed, spp, tile_size,
                       device=dev)
    return _gather_frame(part, cam_cfg, world, group)


def _pixels(px, py, dev):
    f32 = torch.float32
    return (torch.as_tensor(px, dtype=f32, device=dev),
            torch.as_tensor(py, dtype=f32, device=dev))


def shard_batch(pack, cam, px, py, seed: int, opts: RenderOptions, rank: int,
                world: int) -> torch.Tensor:
    """Rank ``rank``'s part (hi - lo, 3) of the wavefront's radiance of the
    flat batch px, py (R,), its draws keyed by (``seed``, 0) at each ray's
    index in the batch."""
    dev = cam.position.device
    px, py = _pixels(px, py, dev)
    lo, hi = shard_bounds(px.shape[0], world, rank)
    end = min(hi, px.shape[0])
    out = torch.zeros((hi - lo, 3), dtype=torch.float32, device=dev)
    if end > lo:
        with torch.no_grad():
            out[:end - lo] = trace_radiance(
                pack, cam, px[lo:end], py[lo:end],
                rng.PhiloxDraws(seed, ray0=lo, device=dev), opts)
    return out


def render_sharded(pack, cam, px, py, seed: int, opts: RenderOptions,
                   mesh=None) -> np.ndarray:
    """The wavefront's radiance (R, 3) of a flat batch of pixel
    coordinates px, py (R,) that every rank holds, each rank tracing its
    shard on the camera's device (JAX shard_render.py:175-191); equal to
    ``trace_radiance`` with ``PhiloxDraws(seed)`` at any world size."""
    group, rank, world = mesh_ranks(mesh, cam.position.device)
    part = shard_batch(pack, cam, px, py, seed, opts, rank, world)
    return all_gather(part, world, group)[:len(px)].cpu().numpy()


def _zero_grads(params: dict) -> dict:
    return {k: torch.zeros_like(v) for k, v in params.items()}


def shard_loss_and_grads(pack, cam, px, py, seed: int, opts: RenderOptions,
                         target, param_extract, param_inject, rank: int,
                         world: int):
    """Rank ``rank``'s part of ``loss_and_grads``: the sum of squared
    errors of its shard over 3 * R, and its gradient with respect to
    ``param_extract(pack)`` by autograd through the wavefront."""
    dev = cam.position.device
    px, py = _pixels(px, py, dev)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    params = {k: torch.as_tensor(v, device=dev).detach().clone()
              .requires_grad_(True) for k, v in param_extract(pack).items()}
    n = px.shape[0]
    lo, hi = shard_bounds(n, world, rank)
    end = min(hi, n)
    if end <= lo:
        return torch.zeros((), device=dev), _zero_grads(params)
    img = trace_radiance(param_inject(pack, params), cam, px[lo:end],
                         py[lo:end], rng.PhiloxDraws(seed, ray0=lo, device=dev),
                         opts)
    loss = ((img - target[lo:end]) ** 2).sum() / (3.0 * n)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(params.items(), grads)}


def loss_and_grads(pack, cam, px, py, seed: int, opts: RenderOptions, target,
                   param_extract, param_inject, mesh=None):
    """Sharded differentiable step through the wavefront (JAX
    shard_render.py:194-222): the mean squared error of the render of the
    flat batch px, py (R,) against ``target`` (R, 3), and its gradient
    with respect to ``param_extract(pack)``, on every rank.  Each rank runs
    torch autograd on its shard (``opts.differentiable`` as the caller
    sets it); the loss and every gradient are then summed over the ranks.
    Returns (loss, name -> gradient)."""
    group, rank, world = mesh_ranks(mesh, cam.position.device)
    loss, grads = shard_loss_and_grads(pack, cam, px, py, seed, opts, target,
                                       param_extract, param_inject, rank,
                                       world)
    return _all_reduce(loss, grads, group)


def shard_diff_step(render, cam, params: dict, px, py, target, rank: int,
                    world: int, seed: int = 0, step: int = 0):
    """Rank ``rank``'s part of a ``make_sharded_diff_step`` step: the sum
    of squared errors of ``render`` (``make_diff_render``) on its shard of
    the primary rays through px, py (R,) over 3 * R, and its gradient with
    respect to ``params``; the fused kernels' draws from Philox keyed by
    (``seed + RANK_SEED * rank``, ``step``)."""
    dev = cam.position.device
    px, py = _pixels(px, py, dev)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    leaves = {k: torch.as_tensor(v, device=dev).detach().requires_grad_(True)
              for k, v in params.items()}
    n = px.shape[0]
    lo, hi = shard_bounds(n, world, rank)
    end = min(hi, n)
    if end <= lo:
        return torch.zeros((), device=dev), _zero_grads(leaves)
    o, d = generate_rays(cam, px[lo:end], py[lo:end])
    img = render(leaves, o, d, seed=seed + RANK_SEED * rank, step=step)
    loss = ((img - target[lo:end]) ** 2).sum() / (3.0 * n)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), grads)}


def make_sharded_diff_step(pack, opts, cam, mesh=None, device=None):
    """Sharded differentiable step through the fused fwd+bwd kernels
    (``ops/megabwd.py::make_diff_render``, JAX shard_render.py:225-285):
    each rank runs them on its shard of the pixels with the seed ``seed +
    RANK_SEED * rank`` and the same ``step``; the loss and every
    parameter's gradient are summed over the ranks.

    Returns ``step(params, px, py, target, seed=0, step=0) -> (loss,
    grads)``: ``params`` a dict of the parameter tables (see
    ``make_diff_render``), px, py (R,) and ``target`` (R, 3) the same on
    every rank, the loss the mean squared error.  At world size 1 it is one
    step of the unsharded ``make_diff_render``.  A scene outside the
    kernels (``bwd_missing``) raises."""
    dev = resolve_device(device)
    missing = bwd_missing(pack.static, opts, pack)
    if missing:
        raise NotImplementedError(f"outside the fused fwd+bwd kernels: "
                                  f"{missing}")
    group, rank, world = mesh_ranks(mesh, dev)
    render = make_diff_render(pack, opts, device=dev)

    def sharded_step(params, px, py, target, seed: int = 0, step: int = 0):
        loss, grads = shard_diff_step(render, cam, params, px, py, target,
                                      rank, world, seed, step)
        return _all_reduce(loss, grads, group)

    return sharded_step
