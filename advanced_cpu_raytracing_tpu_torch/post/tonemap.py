"""Reinhard photographic tonemapping (Tonemapper, src/tonemapper.h:28-121).

Two passes over the image tensor:
  1. statistics — log-average luminance (delta = 0.01, Rec.709 weights) and
     the burn percentile taken over the *sorted flat channel values* (the
     reference sorts all W*H*3 channel samples, tonemapper.h:33-52);
  2. per-pixel mapping — Reinhard with optional L_white burnout, saturation
     exponent on channel ratios, inverse-gamma encode, floor to 8-bit.

``reinhard_tonemap_sharded`` splits the pixels over the ranks of a
``parallel/mesh.py`` mesh (the JAX package's ``reinhard_tonemap_sharded``):
the log-mean is an all-reduce of the float64 sum of logs and of the pixel
count, the percentile an all-gather of the channel values and one sort,
so every rank takes the same threshold, and the mapped shards are joined
by an all-gather.
"""

from __future__ import annotations

import numpy as np
import torch

from advanced_cpu_raytracing_tpu_torch.utils.device import resolve_device
from advanced_cpu_raytracing_tpu_torch.utils.math3d import luminance

_DELTA = 0.01


def _log_lum(hdr: torch.Tensor) -> torch.Tensor:
    """log(delta + L) of each pixel, in float64."""
    return torch.log(_DELTA + luminance(hdr).double())


def _burn_value(sorted_values: torch.Tensor, n_values: int,
                burn_percent: float) -> torch.Tensor:
    """The channel value at the (100 - burn_percent) percentile of the
    first ``n_values`` of ``sorted_values``."""
    last = n_values - 1
    return sorted_values[min(int((100.0 - burn_percent) / 100.0 * last), last)]


def _reinhard_map(hdr: torch.Tensor, avg_lum: torch.Tensor, thresh,
                  key_value: float, saturation: float,
                  gamma: float) -> torch.Tensor:
    """Pass 2 on (..., 3) radiance: u8, given the log-average luminance
    and the burn threshold (``None``: no burn)."""
    lum = luminance(hdr)
    l_scaled = key_value * lum / avg_lum
    if thresh is not None:
        lw2 = thresh * thresh
        y_o = (l_scaled * (1.0 + l_scaled / lw2)) / (1.0 + l_scaled)
    else:
        y_o = l_scaled / (1.0 + l_scaled)

    lum_safe = torch.where(lum == 0, torch.full_like(lum, 1e-20), lum)
    ratios = hdr / lum_safe[..., None]
    rgb = torch.clamp(y_o[..., None] * torch.pow(torch.clamp(ratios, min=0.0),
                                                 saturation), 0.0, 1.0)
    enc = torch.floor(torch.clamp(255.0 * torch.pow(rgb, 1.0 / gamma),
                                  max=255.0))
    return enc.to(torch.uint8)


def reinhard_tonemap_tensor(hdr: torch.Tensor, key_value: float = 0.18,
                            burn_percent: float = 1.0,
                            saturation: float = 1.0,
                            gamma: float = 2.2) -> torch.Tensor:
    """hdr: (H,W,3) f32 tensor -> (H,W,3) uint8 tensor on the same device."""
    log_lum = _log_lum(hdr)
    # the sum over the count, as the sharded tonemap takes it
    avg_lum = torch.exp(log_lum.sum() / log_lum.numel()).float()
    thresh = None
    if burn_percent > 0.01:
        flat = torch.sort(hdr.reshape(-1)).values
        thresh = (_burn_value(flat, flat.shape[0], burn_percent) * key_value
                  / avg_lum)
    return _reinhard_map(hdr, avg_lum, thresh, key_value, saturation, gamma)


def _as_tensor(hdr, dev) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(hdr, np.float32) if isinstance(
        hdr, np.ndarray) else hdr, device=dev).to(torch.float32)
    return torch.nan_to_num(t, nan=0.0)


def reinhard_tonemap(hdr, key_value: float = 0.18, burn_percent: float = 1.0,
                     saturation: float = 1.0, gamma: float = 2.2,
                     device=None) -> np.ndarray:
    """(H,W,3) radiance (numpy or tensor) -> (H,W,3) uint8 numpy, computed
    on ``device`` (default ``cuda``); NaN radiance counts as 0."""
    dev = resolve_device(device)
    return reinhard_tonemap_tensor(
        _as_tensor(hdr, dev), key_value=key_value, burn_percent=burn_percent,
        saturation=saturation, gamma=gamma).cpu().numpy()


# ---- the sharded tonemap: each rank's part is a plain function of its
# rank, so the parts of several ranks can be joined in one process ----

def tonemap_shard_stats(flat: torch.Tensor, rank: int, world: int):
    """Rank ``rank``'s statistics of the (N,3) radiance ``flat``: the
    float64 sum of log(delta + L) and the pixel count over its pixels
    (``parallel/mesh.py::shard_bounds``), and its channel values (3*(hi -
    lo),), padded with +inf (they sort last and are never indexed)."""
    from advanced_cpu_raytracing_tpu_torch.parallel.mesh import shard_bounds

    lo, hi = shard_bounds(flat.shape[0], world, rank)
    part = flat[lo:hi]
    values = torch.full((3 * (hi - lo),), float("inf"), dtype=torch.float32,
                        device=flat.device)
    values[:part.numel()] = part.reshape(-1)
    log_sum = _log_lum(part).sum()
    return log_sum, torch.tensor(float(part.shape[0]), dtype=torch.float64,
                                 device=flat.device), values


def tonemap_constants(log_sum, count, values, key_value: float = 0.18,
                      burn_percent: float = 1.0):
    """The log-average luminance and the burn threshold (``None``: no
    burn) from every rank's summed statistics and gathered values."""
    avg_lum = torch.exp(log_sum / count).float()
    if burn_percent <= 0.01:
        return avg_lum, None
    flat = torch.sort(values).values
    return avg_lum, (_burn_value(flat, 3 * int(count), burn_percent)
                     * key_value / avg_lum)


def tonemap_shard_map(flat: torch.Tensor, rank: int, world: int, avg_lum,
                      thresh, key_value: float = 0.18,
                      saturation: float = 1.0,
                      gamma: float = 2.2) -> torch.Tensor:
    """Rank ``rank``'s u8 pixels (hi - lo, 3) of the (N,3) radiance, zero
    past N."""
    from advanced_cpu_raytracing_tpu_torch.parallel.mesh import shard_bounds

    lo, hi = shard_bounds(flat.shape[0], world, rank)
    out = torch.zeros((hi - lo, 3), dtype=torch.uint8, device=flat.device)
    part = flat[lo:hi]
    out[:part.shape[0]] = _reinhard_map(part, avg_lum, thresh, key_value,
                                        saturation, gamma)
    return out


def reinhard_tonemap_sharded(hdr, mesh=None, key_value: float = 0.18,
                             burn_percent: float = 1.0,
                             saturation: float = 1.0, gamma: float = 2.2,
                             device=None) -> np.ndarray:
    """``reinhard_tonemap`` of the (H,W,3) radiance that every rank holds,
    its pixels split over ``mesh``'s ranks (default: every rank of the
    process group, which must exist: ``parallel/mesh.py::mesh_ranks``) on
    ``device``
    (default ``cuda``).  Every rank returns the (H,W,3) uint8 image; it
    equals ``reinhard_tonemap`` but for the order of the float64 log sum
    (JAX post/tonemap.py:110-135)."""
    import torch.distributed as dist

    from advanced_cpu_raytracing_tpu_torch.parallel.mesh import (
        all_gather,
        mesh_ranks,
    )

    dev = resolve_device(device)
    group, rank, world = mesh_ranks(mesh, dev)
    t = _as_tensor(hdr, dev)
    h, w, _ = t.shape
    flat = t.reshape(-1, 3)
    log_sum, count, values = tonemap_shard_stats(flat, rank, world)
    for x in (log_sum, count):
        dist.all_reduce(x, group=group)
    avg_lum, thresh = tonemap_constants(
        log_sum, count, all_gather(values, world, group) if burn_percent
        > 0.01 else None, key_value, burn_percent)
    part = tonemap_shard_map(flat, rank, world, avg_lum, thresh, key_value,
                             saturation, gamma)
    out = all_gather(part, world, group)[:h * w]
    return out.reshape(h, w, 3).cpu().numpy()
