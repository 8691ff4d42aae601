"""Random draws of the megakernel's stochastic paths (K1b): Philox4x32-10
and the draw table.

The JAX kernel draws ``rnd(it, slot)``, one uniform per ray for node
iteration ``it`` and draw slot ``slot`` (``ops/pallas/megakernel.py:959``):
on the TPU from the chip's own generator, in interpret mode from a host
table ``(max_iters * n_draws, R)`` indexed by ``min(it, max_iters - 1) *
n_draws + slot``.  The port keeps both sources behind the same index:

* table mode: the caller hands that table to the kernel or the plain
  version (tests fill it with the JAX package's own draws);
* counter mode: Philox4x32-10 (Salmon et al., SC'11; the Random123
  algorithm) with key ``(seed, sample)`` and counter ``(ray, it, slot // 4,
  0)``; word ``slot % 4`` of the block gives the draw ``(x >> 9) * 2**-23``,
  23 bits as the JAX kernel makes them.  The CUDA kernel computes it in
  place; ``philox_table`` computes the same words with int64 torch ops on
  any device (torch has no unsigned 32-bit multiply-high), so the plain
  version reproduces counter mode bit for bit.

Draw slots (the JAX ``build_mega`` layout, megakernel.py:667-679): 0 Russian
roulette, 1-2 the GI direction, 3 + 3 l .. 5 + 3 l the mesh light l (face,
two barycentrics); area lights, environment candidates, roughness and
motion time append after them.
"""

from __future__ import annotations

import torch

PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
PHILOX_ROUNDS = 10
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for a constant m < 2**32 and x holding
    uint32 values in int64: m is split into 16-bit limbs so that no partial
    product leaves the non-negative int64 range."""
    p_lo = x * (m & 0xFFFF)  # < 2**48
    p_hi = x * (m >> 16)  # < 2**48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2**49
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = PHILOX_ROUNDS):
    """Philox4x32 with ``rounds`` rounds on counters of uint32 values held
    in int64 tensors (broadcastable) and a key (k0, k1) of Python ints or
    int64 tensors.  Returns the four output words, int64 in [0, 2**32)."""
    k0 = k0 & _MASK32
    k1 = k1 & _MASK32
    for r in range(rounds):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform_from_bits(x: torch.Tensor) -> torch.Tensor:
    """The top 23 bits of uint32 words as f32 uniforms in [0, 1)."""
    return (x >> 9).to(torch.float32) * (1.0 / (1 << 23))


def philox_table(seed: int, sample: int, n_rays: int, max_iters: int,
                 n_draws: int, device=None) -> torch.Tensor:
    """The draw table ``(max_iters * n_draws, n_rays)`` f32 that counter mode
    draws: row ``it * n_draws + slot``, column ``ray``."""
    if n_draws <= 0 or max_iters <= 0:
        return torch.zeros((0, n_rays), dtype=torch.float32, device=device)
    n_blocks = (n_draws + 3) // 4
    ray = torch.arange(n_rays, dtype=torch.int64, device=device)[None, None, :]
    it = torch.arange(max_iters, dtype=torch.int64, device=device)[:, None, None]
    blk = torch.arange(n_blocks, dtype=torch.int64, device=device)[None, :, None]
    shape = (max_iters, n_blocks, n_rays)
    words = philox4x32(ray.expand(shape), it.expand(shape), blk.expand(shape),
                       torch.zeros(shape, dtype=torch.int64, device=device),
                       int(seed), int(sample))
    # (max_iters, n_blocks, 4, R) -> slots in block-word order, cut to n_draws
    draws = uniform_from_bits(torch.stack(words, dim=2))
    return draws.reshape(max_iters, n_blocks * 4, n_rays)[:, :n_draws] \
        .reshape(max_iters * n_draws, n_rays).contiguous()


def rnd(table: torch.Tensor, it: int, slot: int, max_iters: int,
        n_draws: int) -> torch.Tensor:
    """Draw ``slot`` of node iteration ``it`` for every ray of the table."""
    return table[min(it, max_iters - 1) * n_draws + slot]
