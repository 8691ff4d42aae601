"""Profiling helpers: wall-clock stage timers, device profiler traces and a
block on pending device work (the JAX package's ``utils/profiling.py``).

``StageTimer`` is the JAX module's.  ``device_trace`` wraps a section in
``torch.profiler`` (CPU activity, and CUDA where a card is present) and
writes a Chrome trace into ``logdir`` (viewable in Perfetto or
TensorBoard), where JAX started ``jax.profiler``.  ``block`` takes the
place of ``jax.block_until_ready``: torch returns before the card has run
the work it was given, so a timing boundary synchronises.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class StageTimer:
    """Accumulating per-stage wall-clock timer."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = [
            f"{name:>24s}: {self.totals[name]:8.3f}s x{self.counts[name]}"
            for name in sorted(self.totals, key=self.totals.get, reverse=True)
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` trace around a section, each op with its input
    shapes; yields the profiler (its ``key_averages()`` and ``events()``
    hold the section's ops and kernels) and writes
    ``<host>_<pid>.<ns>.pt.trace.json`` into ``logdir`` at the end."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=True,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))) as prof:
        yield prof


def _devices(tree, found: set) -> None:
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _devices(v, found)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _devices(v, found)


def block(tree):
    """Wait for the work that makes the tensors of ``tree`` (nested tuples,
    lists and dicts): one ``torch.cuda.synchronize`` per CUDA device among
    them.  Returns ``tree``."""
    found: set = set()
    _devices(tree, found)
    for dev in sorted(found, key=str):
        torch.cuda.synchronize(dev)
    return tree
