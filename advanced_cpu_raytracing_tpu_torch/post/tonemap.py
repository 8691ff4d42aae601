"""Reinhard photographic tonemapping (Tonemapper, src/tonemapper.h:28-121).

Two passes over the image tensor:
  1. statistics — log-average luminance (delta = 0.01, Rec.709 weights) and
     the burn percentile taken over the *sorted flat channel values* (the
     reference sorts all W*H*3 channel samples, tonemapper.h:33-52);
  2. per-pixel mapping — Reinhard with optional L_white burnout, saturation
     exponent on channel ratios, inverse-gamma encode, floor to 8-bit.
"""

from __future__ import annotations

import numpy as np
import torch

from advanced_cpu_raytracing_tpu_torch.utils.device import resolve_device
from advanced_cpu_raytracing_tpu_torch.utils.math3d import luminance


def reinhard_tonemap_tensor(hdr: torch.Tensor, key_value: float = 0.18,
                            burn_percent: float = 1.0,
                            saturation: float = 1.0,
                            gamma: float = 2.2) -> torch.Tensor:
    """hdr: (H,W,3) f32 tensor -> (H,W,3) uint8 tensor on the same device."""
    delta = 0.01
    lum = luminance(hdr)
    avg_lum = torch.exp(torch.log(delta + lum.double()).mean()).float()
    l_scaled = key_value * lum / avg_lum

    if burn_percent > 0.01:
        flat = torch.sort(hdr.reshape(-1)).values
        last = flat.shape[0] - 1
        idx = min(int((100.0 - burn_percent) / 100.0 * last), last)
        thresh = flat[idx] * key_value / avg_lum
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


def reinhard_tonemap(hdr, key_value: float = 0.18, burn_percent: float = 1.0,
                     saturation: float = 1.0, gamma: float = 2.2,
                     device=None) -> np.ndarray:
    """(H,W,3) radiance (numpy or tensor) -> (H,W,3) uint8 numpy, computed
    on ``device`` (default ``cuda``); NaN radiance counts as 0."""
    dev = resolve_device(device)
    t = torch.as_tensor(np.asarray(hdr, np.float32) if isinstance(
        hdr, np.ndarray) else hdr, device=dev).to(torch.float32)
    t = torch.nan_to_num(t, nan=0.0)
    return reinhard_tonemap_tensor(
        t, key_value=key_value, burn_percent=burn_percent,
        saturation=saturation, gamma=gamma).cpu().numpy()
