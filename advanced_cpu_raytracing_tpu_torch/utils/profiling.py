"""Profiling helpers: the program's spans, device profiler traces and a
block on pending device work (the JAX package's ``utils/profiling.py``).

``span(name)`` marks a layer's work: a context manager, or a decorator of
a whole function.  Every name is declared in ``SPANS``; an undeclared one
raises.  Spans are off unless ``record_spans`` is open; off, a span tests
one module global and hands back one shared object per name that does
nothing (no clock read, no ``record_function``, nothing allocated).  On,
each span appends ``(name, parent, thread, t0_ns, t1_ns)`` to the open
log, on every thread: the enclosing span on the same thread is the parent,
and both times are ``time.time_ns()``, the clock of the profiler's events,
so the spans and the device's operations share one timeline.  While a
``torch.profiler`` records, a span that is on is also a
``record_function`` range of its name.

``device_trace`` wraps a section in ``torch.profiler`` (CPU activity, and
CUDA where a card is present), the spans on with it, and writes a Chrome
trace into ``logdir`` (viewable in Perfetto or TensorBoard), where JAX
started ``jax.profiler``.  ``block`` takes the place of
``jax.block_until_ready``: torch returns before the card has run the work
it was given, so a timing boundary synchronises.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch

# every span of the program: name -> what it covers
SPANS = {
    "renderer.frame": "render_camera: one camera's frame, to the image on "
                      "the host",
    "renderer.sample": "one stratified sample of a frame: jitter, rays, "
                       "the kernel, the Gaussian weight and the sums",
    "renderer.to_host": "the frame's copy to the host, the wait for the "
                        "card included",
    "progressive.pass": "ProgressiveRenderer.step: one full-image pass "
                        "into the sum",
    "progressive.image": "ProgressiveRenderer.image: the mean, the cast and "
                         "the copy to the host",
    "progressive.draws": "a pass's Philox jitter and lens draws (the torch "
                         "twin, ops/rng.py)",
    "k1.launch": "mega_trace on the card: the checks, the arguments and "
                 "K1's launch",
    "diff.tables": "make_diff_render's call: the parameter tables and "
                   "their contiguous copies",
    "diff.forward": "_Render.forward: the primal",
    "diff.backward": "_Render.backward: the cotangents (on autograd's "
                     "device thread on the card)",
    "k2.prepare": "_Launch: the checks, the refit and the K1-layout tables "
                  "of one K2 call",
    "k2.refit": "refit: the boxes of the call's vertices",
    "k2.launch": "_Launch._run: one K2 launch",
    "tables.mega": "build_mega: the forward kernel's tables and tree",
    "tables.bwd": "build_bwd_consts: the differentiable kernels' tables",
    "kernels.load": "_build.load of a library not loaded yet: nvcc where it "
                    "is not built, then dlopen",
    "wavefront.stack": "the wavefront's stack pushes and pops",
    "wavefront.lights": "the wavefront's direct lighting and env-light "
                        "lookups",
}

_log: list | None = None  # the open record_spans log
_profiling = torch.autograd._profiler_enabled
_local = threading.local()


class _Idle:
    """A span that records nothing: one per declared name, shared."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def __call__(self, fn):
        """``fn`` inside ``span(name)`` on every call."""
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


class _Span(_Idle):
    """A recording span: its times, its parent and thread into ``log``;
    a ``record_function`` range while a profiler records."""

    __slots__ = ("log", "parent", "rf", "t0")

    def __init__(self, name: str, log):
        self.name, self.log, self.rf = name, log, None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        if _profiling():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _local.stack.pop()
        self.log.append((self.name, self.parent, threading.get_ident(),
                         self.t0, t1))
        return None


class _Declared(dict):
    def __missing__(self, name):
        raise KeyError(f"span {name!r} is not declared in "
                       "utils/profiling.py::SPANS")


_IDLE = _Declared({name: _Idle(name) for name in SPANS})


def span(name: str):
    """The span ``name`` (declared in ``SPANS``): a context manager, or a
    decorator of a whole function."""
    idle = _IDLE[name]
    if _log is None:
        return idle
    return _Span(name, _log)


@contextlib.contextmanager
def record_spans():
    """Spans on, on every thread, for the section: yields the list they
    append ``(name, parent, thread, t0_ns, t1_ns)`` to as they close."""
    global _log
    prev, log = _log, []
    _log = log
    try:
        yield log
    finally:
        _log = prev


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` trace around a section, each op with its input
    shapes; yields the profiler (its ``key_averages()`` and ``events()``
    hold the section's ops, kernels and the program's spans, on for the
    section) and writes ``<host>_<pid>.<ns>.pt.trace.json`` into
    ``logdir`` at the end."""
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
        with record_spans():
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
