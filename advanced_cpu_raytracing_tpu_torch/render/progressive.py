"""Progressive rendering with checkpoint/resume (the JAX package's
``render/progressive.py``).

The reference has no checkpointing: a render is all-or-nothing per camera
(SURVEY.md section 5).  Here samples accumulate one full-image pass at a
time in a float64 (H*W, 3) sum on the device; ``save`` copies it to the
host and writes an ``.npz`` checkpoint, and a later run resumes from the
last completed pass.  Pass ``s`` takes its draws from Philox keyed by
(seed, s) at each ray's index in the frame (``ops/rng.py``), so a resumed
run continues exactly where it stopped, and the tile size changes no
pixel.  Also gives progressive previews (``image``).

A pass goes the way ``render_camera`` goes (``render/renderer.py``): a
scene inside the megakernel's envelope (``mega_missing`` names nothing)
through one launch of K1 over every pixel, any other through the wavefront
integrator in lane tiles of ``tile_size`` rays, whose closest hits go
through K3.  (The JAX class traces every pass through its wavefront.)  The
checkpoint keeps the JAX format, so a checkpoint written by either package
loads in the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from advanced_cpu_raytracing_tpu_torch.ops import rng
from advanced_cpu_raytracing_tpu_torch.ops.megakernel import (
    mega_missing,
    mega_trace,
)
from advanced_cpu_raytracing_tpu_torch.render.camera import (
    build_camera,
    generate_rays,
)
from advanced_cpu_raytracing_tpu_torch.render.integrator import trace_radiance
from advanced_cpu_raytracing_tpu_torch.render.renderer import (
    DEFAULT_TILE,
    _mega_build_cached,
    options_for_camera,
)
from advanced_cpu_raytracing_tpu_torch.utils.device import resolve_device
from advanced_cpu_raytracing_tpu_torch.utils.logging import get_logger

CKPT_VERSION = 1

_log = get_logger("acrt.progressive")


class ProgressiveRenderer:
    """Accumulates spp one sample pass at a time on ``device`` (default
    ``cuda``), checkpointable."""

    def __init__(self, pack, cfg, cam_cfg, seed: int = 0,
                 tile_size: int = DEFAULT_TILE, device=None):
        self.dev = resolve_device(device)
        self.pack = pack
        self.cfg = cfg
        self.cam_cfg = cam_cfg
        self.cam = build_camera(cam_cfg, device=self.dev)
        self.opts = options_for_camera(cfg, cam_cfg)
        self.seed = seed
        self.tile_size = tile_size
        w, h = cam_cfg.width, cam_cfg.height
        self.acc = torch.zeros((h * w, 3), dtype=torch.float64,
                               device=self.dev)
        self.samples_done = 0
        idx = torch.arange(h * w, device=self.dev)
        self._px = (idx % w).to(torch.float32)
        self._py = (idx // w).to(torch.float32)
        # K1's tables, or None for the wavefront route
        self._mega = (None if mega_missing(pack.static, self.opts, pack)
                      else _mega_build_cached(pack, self.opts, self.dev))

    def _pass(self, s: int, lo: int, hi: int) -> torch.Tensor:
        """Pass ``s``'s radiance (hi-lo, 3) f32 of the pixels lo..hi: at
        the integer pixel coordinates in pass 0, jittered by a uniform in
        [0, 1) after it (the JAX class's jitter, progressive.py:56-71)."""
        r = hi - lo
        draws = rng.PhiloxDraws(self.seed, sample=s, ray0=lo, device=self.dev)
        px, py = self._px[lo:hi], self._py[lo:hi]
        if s > 0:
            jit = draws.uniform(-1, rng.SITE_JITTER, r, 2)
            px, py = px + jit[:, 0], py + jit[:, 1]
        if self._mega is None:
            return trace_radiance(self.pack, self.cam, px, py, draws,
                                  self.opts)
        mc, tri_tab, chunk_tab = self._mega
        cam = self.cam
        # the thin lens from the wavefront's lens site, so that a resumed
        # pass draws the same sample
        lens = (draws.uniform(-1, rng.SITE_LENS, r, 2, lo=-1.0, hi=1.0)
                if cam.use_dof else None)
        o, d = generate_rays(cam, px, py, lens, dof=cam.use_dof)
        w, h = self.cam_cfg.width, self.cam_cfg.height
        pix_uv = (torch.stack((px * (1.0 / w), py * (1.0 / h)), -1)
                  if mc.bg_tex >= 0 else None)
        return mega_trace(mc, tri_tab, chunk_tab, o.contiguous(),
                          d.contiguous(), seed=self.seed, sample=s,
                          pix_uv=pix_uv)

    def step(self) -> None:
        """Render one full-image sample pass and accumulate: one K1 launch
        over every pixel, or the wavefront tile by tile."""
        s = self.samples_done
        total = self._px.shape[0]
        tile = total if self._mega is not None else self.tile_size
        with torch.no_grad():
            for lo in range(0, total, tile):
                hi = min(lo + tile, total)
                self.acc[lo:hi] += self._pass(s, lo, hi).to(torch.float64)
        self.samples_done += 1
        _log.debug("pass %d done", s)

    @property
    def image(self) -> np.ndarray:
        h, w = self.cam_cfg.height, self.cam_cfg.width
        n = max(self.samples_done, 1)
        return (self.acc / n).reshape(h, w, 3).to(torch.float32).cpu().numpy()

    # ---- checkpointing ----

    def save(self, path: str) -> None:
        """Write the sum and the pass count to ``path`` (``.npz``): first to
        ``path + ".tmp.npz"``, then moved over ``path``."""
        tmp = path + ".tmp"
        np.savez_compressed(
            tmp, version=CKPT_VERSION, acc=self.acc.cpu().numpy(),
            samples_done=self.samples_done, seed=self.seed,
            width=self.cam_cfg.width, height=self.cam_cfg.height,
        )
        os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)
        _log.info("checkpoint %s: %d passes", path, self.samples_done)

    def load(self, path: str) -> bool:
        """Resume from ``path``; False (and nothing changed) when there is
        no such file or it was written for another version, size or
        seed."""
        if not os.path.exists(path):
            return False
        with np.load(path) as data:
            if int(data["version"]) != CKPT_VERSION:
                return False
            if (int(data["width"]) != self.cam_cfg.width
                    or int(data["height"]) != self.cam_cfg.height
                    or int(data["seed"]) != self.seed):
                return False
            self.acc = torch.as_tensor(np.asarray(data["acc"], np.float64),
                                       device=self.dev)
            self.samples_done = int(data["samples_done"])
        _log.info("resumed %s: %d passes", path, self.samples_done)
        return True

    def render(self, spp: int, checkpoint: str | None = None,
               checkpoint_every: int = 8) -> np.ndarray:
        """Passes until ``spp`` are done, resuming from ``checkpoint`` and
        saving it every ``checkpoint_every`` passes and at the end; the
        (H, W, 3) f32 mean."""
        if checkpoint:
            self.load(checkpoint)
        while self.samples_done < spp:
            self.step()
            if checkpoint and self.samples_done % checkpoint_every == 0:
                self.save(checkpoint)
        if checkpoint:
            self.save(checkpoint)
        return self.image
