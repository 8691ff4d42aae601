"""Faults planted in the timed path, to show that the check catches them.

Each fault is a context manager that breaks the program (or the part of
the benchmark that stands for the user's code around it) while it is
entered; ``harness.execute(run, program_patch=...)`` enters it around the
program's set-up, window and answers alone, so the reference runs
unbroken.  ``FAULTS[runner]`` names the faults a cell of that runner can
have; none of these cells exchanges anything between chips.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from unittest import mock

import torch

SCALE = 1.01  # an answer altered where it is produced: 1% more radiance


@contextmanager
def frames_answer_altered():
    from advanced_cpu_raytracing_tpu_torch.render import renderer

    real = renderer.mega_trace
    with mock.patch.object(renderer, "mega_trace",
                           lambda *a, **k: real(*a, **k) * SCALE):
        yield


@contextmanager
def frames_half_batch():
    """Half of each pixel's stratified samples left out, the Gaussian mean
    taken over the rest."""
    from advanced_cpu_raytracing_tpu_torch.render import renderer

    def half(trace_fn, px, py, n_cells, jitter=None, generator=None):
        sigma = 1.0 / 6.0
        inv_2s2 = 1.0 / (2.0 * sigma * sigma)
        c1 = 1.0 / (2.0 * math.pi * sigma * sigma)
        acc = torch.zeros((px.shape[0], 3), device=px.device)
        wacc = torch.zeros(px.shape[0], device=px.device)
        for s in range(n_cells * n_cells):
            psi = torch.rand((px.shape[0], 2), generator=generator,
                             device=px.device)
            if s % 2:
                continue
            row, col = divmod(s, n_cells)
            sx = (col + psi[:, 0]) / n_cells
            sy = (row + psi[:, 1]) / n_cells
            colr = trace_fn(px + sx, py + sy, s)
            wgt = c1 * torch.exp(-((sx - 0.5) ** 2 + (sy - 0.5) ** 2) * inv_2s2)
            acc = acc + colr * wgt[:, None]
            wacc = wacc + wgt
        return acc / wacc[:, None]

    with mock.patch.object(renderer, "_gaussian_multisample", half):
        yield


@contextmanager
def progressive_state_unchanged():
    """A pass that counts itself and adds nothing to the sum."""
    from advanced_cpu_raytracing_tpu_torch.render import progressive

    def step(self):
        self.samples_done += 1

    with mock.patch.object(progressive.ProgressiveRenderer, "step", step):
        yield


@contextmanager
def progressive_answer_altered():
    from advanced_cpu_raytracing_tpu_torch.render import progressive

    real = progressive.mega_trace
    with mock.patch.object(progressive, "mega_trace",
                           lambda *a, **k: real(*a, **k) * SCALE):
        yield


@contextmanager
def progressive_half_batch():
    """Every odd pass left out: it traces the even pass before it again,
    so the mean is taken over the even passes."""
    from advanced_cpu_raytracing_tpu_torch.render import progressive

    real = progressive.ProgressiveRenderer._pass

    def _pass(self, s, lo, hi):
        return real(self, s - s % 2, lo, hi)

    with mock.patch.object(progressive.ProgressiveRenderer, "_pass", _pass):
        yield


@contextmanager
def train_state_unchanged():
    """Adam's step returns with the parameters and its state unchanged."""
    with mock.patch.object(torch.optim.Adam, "step", lambda self, *a: None):
        yield


@contextmanager
def train_half_batch():
    """The loss's mean taken over the first half of the grid's rays."""
    from benchmark.runners import train

    def loss_of(img, target, norm):
        n = img.shape[0] // 2
        return torch.mean(((img[:n] - target[:n]) / norm) ** 2)

    with mock.patch.object(train, "loss_of", loss_of):
        yield


@contextmanager
def train_answer_altered():
    """The differentiable render's radiance 1% high where it is made."""
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd

    real = megabwd.make_diff_render

    def make(*a, **k):
        f = real(*a, **k)

        def g(*b, **kw):
            return f(*b, **kw) * SCALE

        g.bc, g.tables = f.bc, f.tables
        return g

    with mock.patch.object(megabwd, "make_diff_render", make):
        yield


FAULTS = {
    "frames": {"answer_altered": frames_answer_altered,
               "half_batch": frames_half_batch},
    "progressive": {"state_unchanged": progressive_state_unchanged,
                    "answer_altered": progressive_answer_altered,
                    "half_batch": progressive_half_batch},
    "train": {"state_unchanged": train_state_unchanged,
              "half_batch": train_half_batch,
              "answer_altered": train_answer_altered},
}
