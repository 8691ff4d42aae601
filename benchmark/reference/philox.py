"""A frozen copy of Philox4x32-10 (Salmon et al., SC'11; the Random123
algorithm) in int64 torch ops, and the two ways the program keys it that
the benchmark's cells reach: the progressive pass's sub-pixel jitter and
the differentiable render's dielectric branch uniforms.

A draw is word w of the block at counter (c0, c1, c2, c3) under key (k0,
k1), its top 23 bits as a uniform in [0, 1).  The reference computes the
draws again from the seed that the benchmark hands to both sides.
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF
SITE_JITTER = 2  # the wavefront's site of the sub-pixel jitter
LIGHTS_PER_SITE = 256


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x, with m split into 16-bit limbs so
    that no partial product leaves the int64 range."""
    p_lo = x * (m & 0xFFFF)
    p_hi = x * (m >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & MASK


def philox(c0, c1, c2, c3, k0: int, k1: int):
    """The four words (int64 in [0, 2**32)) of counters c0..c3 (int64
    tensors, broadcastable) under the key (k0, k1)."""
    k0, k1 = int(k0) & MASK, int(k1) & MASK
    for r in range(10):
        if r:
            k0 = (k0 + W0) & MASK
            k1 = (k1 + W1) & MASK
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform(bits: torch.Tensor) -> torch.Tensor:
    return (bits >> 9).to(torch.float32) * (1.0 / (1 << 23))


def pass_jitter(seed: int, pass_index: int, pixels: torch.Tensor):
    """(P, 2) sub-pixel offsets of a progressive pass at pixel indices
    ``pixels`` (int64): key (seed, pass), counter (pixel, 0, site * 256, 0),
    words 0 and 1."""
    z = torch.zeros_like(pixels)
    w = philox(pixels, z, z + SITE_JITTER * LIGHTS_PER_SITE, z, seed,
               pass_index)
    return torch.stack([uniform(w[0]), uniform(w[1])], 1)


def branch_uniforms(seed: int, step: int, n_rays: int, depth: int,
                    device=None) -> torch.Tensor:
    """(depth, n_rays) branch uniforms of the differentiable render's
    dielectric legs: key (seed, step), counter (ray, segment, 0, 0), word
    0."""
    ray = torch.arange(n_rays, dtype=torch.int64, device=device)[None, :]
    seg = torch.arange(depth, dtype=torch.int64, device=device)[:, None]
    shape = (depth, n_rays)
    z = torch.zeros(shape, dtype=torch.int64, device=device)
    return uniform(philox(ray.expand(shape), seg.expand(shape), z, z, seed,
                          step)[0])
