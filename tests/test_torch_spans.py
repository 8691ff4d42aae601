"""The port's spans (``utils/profiling.py``): off, a span is one shared
object per name that calls no ``record_function`` and reads no clock, also
while a profiler records; on, spans nest with their parents on every
thread and land on the profiler's clock; every span the package opens is
declared and every declared one is opened; a render, a progressive pass
and a differentiable render open theirs on the CPU; and on the card
(``-m cuda``) the spans and the kernels they launch share one timeline.

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_spans.py -m cuda
"""

from __future__ import annotations

import collections
import re
import threading

import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu_torch.utils import profiling
from test_torch_common import REPO, coarse_slice_scene

PACKAGE = REPO / "advanced_cpu_raytracing_tpu_torch"


def _refuse(*args, **kwargs):
    raise AssertionError("called with spans off")


def test_span_off_is_one_shared_object_that_does_nothing(monkeypatch):
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    monkeypatch.setattr(profiling.time, "time_ns", _refuse)
    monkeypatch.setattr(profiling.threading, "get_ident", _refuse)
    s = profiling.span("k1.launch")
    assert s is profiling.span("k1.launch")
    assert s is not profiling.span("k2.launch")
    with s, s:  # reentrant: it holds no state
        pass

    @profiling.span("renderer.frame")
    def f(x, y=1):
        """doc"""
        return x + y

    assert f(2, y=3) == 5 and f.__name__ == "f" and f.__doc__ == "doc"


def test_a_profiler_alone_leaves_the_spans_off(monkeypatch):
    """A profiler that records with no ``record_spans`` open, as a traced
    benchmark run's: the spans stay the shared idle objects and add no
    range to its trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        monkeypatch.setattr(torch.autograd.profiler, "record_function",
                            _refuse)
        monkeypatch.setattr(profiling.time, "time_ns", _refuse)
        s = profiling.span("progressive.pass")
        with s, profiling.span("progressive.draws"):
            torch.ones(4).sum()
        monkeypatch.undo()
    assert s is profiling.span("progressive.pass")
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "aten::sum" in names
    assert not names & set(profiling.SPANS)


def test_undeclared_span_raises_on_and_off():
    with pytest.raises(KeyError, match="not declared"):
        profiling.span("renderer.nothing")
    with profiling.record_spans():
        with pytest.raises(KeyError, match="not declared"):
            profiling.span("no.such")


def test_spans_nest_with_their_parents_and_times():
    @profiling.span("k1.launch")
    def launch():
        pass

    with profiling.record_spans() as log:
        with profiling.span("renderer.frame"):
            for _ in range(2):
                with profiling.span("renderer.sample"):
                    launch()
            with profiling.span("renderer.to_host"):
                pass
    me = threading.get_ident()
    assert [(n, p, t) for n, p, t, _, _ in log] == [
        ("k1.launch", "renderer.sample", me),
        ("renderer.sample", "renderer.frame", me),
        ("k1.launch", "renderer.sample", me),
        ("renderer.sample", "renderer.frame", me),
        ("renderer.to_host", "renderer.frame", me),
        ("renderer.frame", None, me)]
    frame = log[-1]
    for _, _, _, t0, t1 in log:
        assert frame[3] <= t0 <= t1 <= frame[4]
    # closed: spans are off again
    assert profiling.span("renderer.frame") is profiling.span("renderer.frame")


def test_a_span_that_raises_is_recorded_and_unwinds_its_parent():
    with profiling.record_spans() as log:
        with pytest.raises(ValueError):
            with profiling.span("diff.forward"):
                with profiling.span("k2.prepare"):
                    raise ValueError
        with profiling.span("diff.backward"):
            pass
    assert [(n, p) for n, p, *_ in log] == [
        ("k2.prepare", "diff.forward"), ("diff.forward", None),
        ("diff.backward", None)]


def test_a_span_on_another_thread_is_recorded_with_its_thread():
    seen = []

    def work():
        seen.append(threading.get_ident())
        with profiling.span("diff.backward"):
            with profiling.span("k2.launch"):
                pass

    with profiling.record_spans() as log:
        with profiling.span("diff.forward"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    other = seen[0]
    assert other != threading.get_ident()
    assert [(n, p, th) for n, p, th, _, _ in log] == [
        ("k2.launch", "diff.backward", other),
        ("diff.backward", None, other),
        ("diff.forward", None, threading.get_ident())]


def _opened_in_package() -> collections.Counter:
    found = collections.Counter()
    for path in PACKAGE.rglob("*.py"):
        for name in re.findall(r"\bspan\(\s*\"([^\"]+)\"", path.read_text()):
            found[name] += 1
    return found


def test_every_span_opened_is_declared_and_every_declared_one_opened():
    opened = _opened_in_package()
    assert set(opened) == set(profiling.SPANS)
    for name, what in profiling.SPANS.items():
        assert re.fullmatch(r"[a-z0-9_]+\.[a-z0-9_]+", name), name
        assert what.strip(), name


def test_spans_share_the_profilers_clock():
    """Under a profiler each span is also a ``record_function`` range of
    its name, and its ``time.time_ns()`` start lies within 1 ms of that
    range's ``start_ns()``; the spans land in the log that is open."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(64, 64)
    with profiling.record_spans() as log:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            # a profiler's first range sets itself up (about 2 ms on a CPU)
            with torch.profiler.record_function("warm-up"):
                pass
            for _ in range(3):
                with profiling.span("renderer.sample"):
                    x = (x @ x).tanh()
                with profiling.span("renderer.to_host"):
                    x.numpy()
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        events[e.name()].append(e.start_ns())
    assert len(log) == 6
    for name in ("renderer.sample", "renderer.to_host"):
        mine = sorted(t0 for n, _, _, t0, _ in log if n == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs) == 3
        for a, b in zip(mine, theirs):
            assert abs(a - b) < 1_000_000


def test_record_spans_nests_and_restores_the_log_it_found():
    with profiling.record_spans() as outer:
        with profiling.span("diff.forward"):
            with profiling.record_spans() as inner:
                with profiling.span("k2.prepare"):
                    pass
        with profiling.span("diff.backward"):
            pass
    assert profiling._log is None
    assert [(n, p) for n, p, *_ in inner] == [("k2.prepare", "diff.forward")]
    assert [(n, p) for n, p, *_ in outer] == [("diff.forward", None),
                                              ("diff.backward", None)]


def test_device_trace_turns_the_spans_on(tmp_path):
    with profiling.device_trace(str(tmp_path)) as prof:
        s = profiling.span("tables.mega")
        with s:
            torch.ones(4).sum()
    assert s is not profiling.span("tables.mega")
    assert any(e.name() == "tables.mega"
               for e in prof.profiler.kineto_results.events())
    assert list(tmp_path.glob("*.pt.trace.json"))


def test_a_cpu_frame_opens_its_spans_and_builds_its_tables_once(tmp_path):
    from advanced_cpu_raytracing_tpu_torch.render.renderer import (
        render_camera,
    )
    from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene

    cfg = load_scene(coarse_slice_scene(tmp_path, 6, 4))
    pack = pack_scene(cfg, device="cpu")
    with profiling.record_spans() as log:
        img = render_camera(pack, cfg, cfg.cameras[0], spp=4, device="cpu")
    assert img.shape == (4, 6, 3)
    assert collections.Counter(n for n, *_ in log) == {
        "renderer.frame": 1, "tables.mega": 1, "renderer.sample": 4,
        "renderer.to_host": 1}
    parents = {n: p for n, p, *_ in log}
    assert parents["tables.mega"] == "renderer.frame"
    assert parents["renderer.sample"] == "renderer.frame"
    with profiling.record_spans() as log:
        render_camera(pack, cfg, cfg.cameras[0], spp=4, device="cpu")
    # the tables are cached; no kernel on the CPU
    assert collections.Counter(n for n, *_ in log) == {
        "renderer.frame": 1, "renderer.sample": 4, "renderer.to_host": 1}


def test_a_progressive_pass_opens_its_draws_and_image(tmp_path):
    from advanced_cpu_raytracing_tpu_torch.render.progressive import (
        ProgressiveRenderer,
    )
    from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene

    cfg = load_scene(coarse_slice_scene(tmp_path, 6, 4))
    pack = pack_scene(cfg, device="cpu")
    r = ProgressiveRenderer(pack, cfg, cfg.cameras[0], device="cpu")
    with profiling.record_spans() as log:
        for _ in range(3):
            r.step()
            img = r.image
    assert np.isfinite(img).all()
    # pass 0 is unjittered: no draws
    assert collections.Counter(n for n, *_ in log) == {
        "progressive.pass": 3, "progressive.draws": 2, "progressive.image": 3}
    assert {p for n, p, *_ in log if n == "progressive.draws"} == \
        {"progressive.pass"}


def test_a_cpu_diff_render_opens_its_spans_and_builds_its_consts(tmp_path):
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb
    from advanced_cpu_raytracing_tpu_torch.render.camera import (
        build_camera,
        generate_rays,
    )
    from advanced_cpu_raytracing_tpu_torch.render.renderer import (
        options_for_camera,
    )
    from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import (
        gauge_scene_xml,
    )
    from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene

    cfg = load_scene(gauge_scene_xml(tmp_path, REPO / "scenes", coarse=True,
                                     glass=False))
    pack = pack_scene(cfg, device="cpu")
    with profiling.record_spans() as log:
        f = mb.make_diff_render(pack, options_for_camera(cfg, cfg.cameras[0]),
                                device="cpu")
    assert [n for n, *_ in log] == ["tables.mega", "tables.bwd"]
    cam = build_camera(cfg.cameras[0], device="cpu")
    px = torch.tensor([100.0, 400.0, 700.0])
    o, d = generate_rays(cam, px, px)
    params = {"mat_diffuse": pack.mat_diffuse.clone().requires_grad_(True)}
    with profiling.record_spans() as log:
        f(params, o.contiguous(), d.contiguous()).sum().backward()
    assert float(params["mat_diffuse"].grad.abs().sum()) > 0
    # the plain version on the CPU: no K2 call prepared, no kernel launched
    assert [n for n, *_ in log] == ["diff.tables", "diff.forward",
                                    "diff.backward"]


# the host's CUDA calls that launch device work (cudaLaunchKernel,
# cuLaunchKernelEx, cudaMemcpyAsync, ...): a device operation carries the
# correlation id of the call that launched it
RUNTIME = re.compile(r"cu(da)?[A-Z]")


@pytest.mark.cuda
def test_spans_and_kernels_share_one_timeline_on_the_card(tmp_path):
    """A frame and a differentiable update traced on the card: each span
    starts within 1 ms of its mirrored profiler range; every K1 kernel was
    launched inside a ``k1.launch`` span and started after it opened, and
    nothing else was launched there; K2's kernels inside ``k2.launch`` or
    ``k2.refit``; an update prepares two K2 calls, and its backward runs on
    autograd's device thread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb
    from advanced_cpu_raytracing_tpu_torch.render.camera import (
        build_camera,
        generate_rays,
    )
    from advanced_cpu_raytracing_tpu_torch.render.renderer import (
        options_for_camera,
        render_camera,
    )
    from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import (
        gauge_scene_xml,
    )
    from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene

    dev = torch.device("cuda")
    (tmp_path / "frame").mkdir()
    cfg = load_scene(coarse_slice_scene(tmp_path / "frame", 48, 48))
    pack = pack_scene(cfg, device=dev)
    gcfg = load_scene(gauge_scene_xml(tmp_path, REPO / "scenes", coarse=True,
                                      glass=False))
    gpack = pack_scene(gcfg, device=dev)
    f = mb.make_diff_render(gpack, options_for_camera(gcfg, gcfg.cameras[0]),
                            device=dev)
    px = torch.linspace(10.0, 790.0, 2048, device=dev)
    o, d = generate_rays(build_camera(gcfg.cameras[0], device=dev), px,
                         px.flip(0))
    params = {"mat_diffuse": gpack.mat_diffuse.clone().requires_grad_(True)}

    def work():
        render_camera(pack, cfg, cfg.cameras[0], spp=4, device=dev)
        f(params, o.contiguous(), d.contiguous()).square().sum().backward()
        torch.cuda.synchronize()

    work()  # builds and loads the kernels
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("warm-up"):
            pass
        with profiling.record_spans() as log:
            work()
    names = collections.Counter(n for n, *_ in log)
    assert names["k1.launch"] == 4 and names["renderer.sample"] == 4
    assert names["k2.prepare"] == 2 and names["diff.backward"] == 1
    back = [th for n, _, th, *_ in log if n == "diff.backward"]
    assert back[0] != threading.get_ident()

    ranges = collections.defaultdict(list)
    ops, calls = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((e.name(), e.start_ns(), e.correlation_id()))
        elif e.name() in names:
            ranges[e.name()].append(e.start_ns())
        elif RUNTIME.match(e.name()):
            calls[e.correlation_id()] = e.start_ns()
    for name in names:
        mine = sorted(t0 for n, _, _, t0, _ in log if n == name)
        theirs = sorted(ranges[name])
        assert len(mine) == len(theirs), name
        assert max(abs(a - b) for a, b in zip(mine, theirs)) < 1_000_000

    def opened_at(t, wanted):
        return [s for s in log if s[0] in wanted and s[3] <= t <= s[4]]

    k1 = [op for op in ops if "mega_whitted" in op[0]]
    k2 = [op for op in ops if "mega_bwd" in op[0]]
    assert len(k1) == 4 and len(k2) >= 3
    for op in ops:
        name, start, corr = op
        launched = (opened_at(calls[corr], ("k1.launch",))
                    if corr in calls else [])
        if op in k1:
            assert len(launched) == 1, name
            assert start >= launched[0][3]
        else:
            assert not launched, name
    for _, start, corr in k2:
        assert len(opened_at(calls[corr], ("k2.launch", "k2.refit"))) == 1
