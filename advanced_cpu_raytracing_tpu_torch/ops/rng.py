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

The wavefront's draw source, ``PhiloxDraws``, makes its uniforms on a CUDA
device with one launch of ``csrc/philox_draws.cu`` (``LAUNCHES`` counts
them), and on the CPU with the int64 twin, its plain version: the same
words bit for bit.

Draw slots (the JAX ``build_mega`` layout, megakernel.py:667-679): 0 Russian
roulette, 1-2 the GI direction, 3 + 3 l .. 5 + 3 l the mesh light l (face,
two barycentrics), then 2 per area light (the point on its square), then
48 environment candidates (in environment scenes), then 4 for roughness
(the reflection's and the refraction's psi pairs), then the motion time,
last: drawn once per primary ray, at iteration 0, from slot
``n_draws - 1`` (megakernel.py:1776-1779).
"""

from __future__ import annotations

import ctypes

import torch

PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
PHILOX_ROUNDS = 10
_MASK32 = 0xFFFFFFFF
LIBRARY = "philox_draws"
# launches of the CUDA kernel (only those count)
LAUNCHES = {"philox_draws": 0}


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


# ---------------------------------------------------------------------------
# the wavefront integrator's draw source
# ---------------------------------------------------------------------------

# Draw sites of the wavefront integrator (render/integrator.py,
# render/lights.py, render/renderer.py).  Iteration -1 holds the draws made
# once per primary ray, before the loop: the motion time, the lens sample,
# the sub-pixel jitter.
(SITE_TIME, SITE_LENS, SITE_JITTER, SITE_GI, SITE_RR, SITE_AREA,
 SITE_ML_FACE, SITE_ML_BARY, SITE_ENV, SITE_ROUGH_M, SITE_COIN, SITE_ROUGH_T,
 SITE_REFL, SITE_ROUGH_F) = range(14)
_LIGHTS_PER_SITE = 256


def _scale(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Uniforms in [0, 1) to [lo, hi) as ``jax.random.uniform`` maps its
    floats: u * (hi - lo) + lo, then max with lo."""
    if lo == 0.0 and hi == 1.0:
        return u
    return torch.maximum(u * (hi - lo) + lo, torch.tensor(lo, device=u.device))


class PhiloxDraws:
    """The integrator's default draw source: Philox4x32-10 keyed by (seed,
    sample), counter (the ray's index in the frame, iteration + 1, site *
    256 + light, block); the four words of a block are four draws.  The
    ray's index counts from ``ray0``, the index of a tile's first ray, so a
    tile size changes no draw; the CPU and the card draw the same
    numbers: on a CUDA device by one launch of ``csrc/philox_draws.cu``,
    on the CPU by the int64 twin."""

    def __init__(self, seed: int = 0, sample: int = 0, ray0: int = 0,
                 device=None):
        self.seed, self.sample, self.ray0 = int(seed), int(sample), int(ray0)
        self.device = device

    def to(self, device) -> "PhiloxDraws":
        """The same draws, made on ``device``."""
        return PhiloxDraws(self.seed, self.sample, self.ray0, device)

    def _raw(self, it: int, site: int, r: int, n: int, light: int):
        """The twin: (r, n) uniforms in [0, 1) by int64 torch ops."""
        device = self.device
        n_blocks = (n + 3) // 4
        ray = torch.arange(self.ray0, self.ray0 + r, dtype=torch.int64,
                           device=device)[:, None].expand(r, n_blocks)
        blk = torch.arange(n_blocks, dtype=torch.int64,
                           device=device)[None, :].expand(r, n_blocks)
        fill = torch.full((r, n_blocks), 0, dtype=torch.int64, device=device)
        words = philox4x32(ray, fill + (it + 1), fill + (
            site * _LIGHTS_PER_SITE + light), blk, self.seed, self.sample)
        return uniform_from_bits(torch.stack(words, dim=2)).reshape(
            r, n_blocks * 4)[:, :n]

    def _launch(self, c1: int, c2: int, r: int, n: int, lo: float,
                hi: float) -> torch.Tensor:
        """The kernel: (r, n) uniforms in [lo, hi) on the CUDA device."""
        from advanced_cpu_raytracing_tpu_torch.ops import _build

        out = torch.empty((r, n), dtype=torch.float32, device=self.device)
        if r == 0:
            return out
        lib = _build.load(LIBRARY)
        scale = not (lo == 0.0 and hi == 1.0)
        with torch.cuda.device(out.device):
            stream = ctypes.c_void_p(
                torch.cuda.current_stream(out.device).cuda_stream)
            rc = lib.philox_draws_launch(
                ctypes.c_void_p(out.data_ptr()), r, n, self.ray0, c1, c2,
                self.seed & _MASK32, self.sample & _MASK32, int(scale),
                hi - lo, lo, stream)
        if rc != 0:
            err = lib.philox_draws_error_string(rc).decode()
            raise RuntimeError(f"philox_draws launch failed: CUDA error {rc} "
                               f"({err})")
        LAUNCHES["philox_draws"] += 1
        return out

    def _draw(self, it: int, site: int, r: int, n: int, light: int,
              lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        c1, c2 = it + 1, site * _LIGHTS_PER_SITE + light
        if n < 1:
            raise ValueError(f"PhiloxDraws: n = {n}, needs at least 1 draw")
        if not (0 <= self.ray0 and self.ray0 + r <= 1 << 32
                and 0 <= c1 <= _MASK32 and 0 <= c2 <= _MASK32):
            raise ValueError(
                f"PhiloxDraws: counter words outside 32 bits (rays "
                f"{self.ray0}..{self.ray0 + r}, iteration {it}, site {site}, "
                f"light {light})")
        if self.device is not None and torch.device(self.device).type == "cuda":
            return self._launch(c1, c2, r, n, lo, hi)
        return _scale(self._raw(it, site, r, n, light), lo, hi)

    def uniform(self, it: int, site: int, r: int, n: int = 1, light: int = 0,
                lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        """(r, n) f32 uniforms in [lo, hi) of iteration ``it``, ``site`` and
        ``light``."""
        return self._draw(it, site, r, n, light, lo, hi)

    def randint(self, it: int, site: int, r: int, hi: int,
                light: int = 0) -> torch.Tensor:
        """(r,) int64 uniform in [0, hi)."""
        u = self._draw(it, site, r, 1, light)[:, 0]
        return torch.clamp((u * hi).to(torch.int64), max=hi - 1)


class TableDraws:
    """A draw source that reads a table: ``table[(it, site, light)]`` is an
    (R, n) array of uniforms in [0, 1) (mapped to [lo, hi) as
    ``jax.random.uniform`` maps them) or, for ``randint``, an (R,) array of
    integers.  The port's tests fill it with the JAX wavefront's own draws,
    so the two integrators take the same randoms ray for ray."""

    def __init__(self, table: dict, device=None):
        self.table, self.device = table, device

    def to(self, device) -> "TableDraws":
        return TableDraws(self.table, device)

    def _get(self, it, site, r, light):
        x = self.table[(it, site, light)]
        if len(x) != r:
            raise ValueError(f"draw table: {len(x)} rays, asked for {r}")
        return torch.as_tensor(x, device=self.device)

    def uniform(self, it: int, site: int, r: int, n: int = 1, light: int = 0,
                lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        u = self._get(it, site, r, light).to(torch.float32)
        return _scale(u.reshape(r, n), lo, hi)

    def randint(self, it: int, site: int, r: int, hi: int,
                light: int = 0) -> torch.Tensor:
        return self._get(it, site, r, light).to(torch.int64).reshape(r)
