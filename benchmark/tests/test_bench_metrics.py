"""The metric arithmetic on synthetic windows: a rate over the whole
window, a 95th percentile over every frame, the device's idle share as the
union of its operations' intervals, and a stall in the window moving each
of them."""

from __future__ import annotations

import pytest

from bench_tiny import ROOT  # noqa: F401  (puts the repo on sys.path)
from benchmark import harness

LAYOUT = harness.Layout()


def read(name, r):
    return LAYOUT.module("metrics", name).read(r)


def frames_readings(times, window_s=None, trace=None):
    run = harness.Run(LAYOUT, LAYOUT.cell("conductors.frame16"), {}, {}, 0,
                      1.0, trace is not None, device="cpu")
    w = sum(times) if window_s is None else window_s
    work = {"units": len(times), "unit": "frame", "times": times,
            "paths": len(times) * 800 * 800 * 16}
    return harness.Readings(run, setup_s=3.0, window_s=w, work=work,
                            trace=trace)


def test_rate_is_all_work_over_all_the_window():
    r = frames_readings([0.05] * 100)
    assert read("paths_per_s", r) == pytest.approx(
        100 * 800 * 800 * 16 / 5.0 / 1e6)
    # a 1 s stall between frames lowers the rate, though no frame is slower
    stalled = frames_readings([0.05] * 100, window_s=6.0)
    assert read("paths_per_s", stalled) == pytest.approx(
        read("paths_per_s", r) * 5.0 / 6.0)


def test_p95_is_over_every_frame():
    times = [0.040] * 95 + [0.100] * 5
    r = frames_readings(times)
    assert read("frame_ms_p95", r) == pytest.approx(
        harness.quantile(times, 0.95) * 1e3)
    assert 40.0 < read("frame_ms_p95", r) <= 100.0
    # six slow frames in a hundred: the tail moves, the median does not
    slow = frames_readings([0.040] * 94 + [0.100] * 6)
    assert read("frame_ms_p95", slow) > read("frame_ms_p95", r)
    assert read("frame_ms_p95", frames_readings([0.040] * 100)) == \
        pytest.approx(40.0)


def trace_of(device, window=(0.0, 1.0), host=()):
    return harness.Trace(window, list(device), list(host))


def test_idle_is_the_union_of_device_intervals():
    # two overlapping kernels and one apart: busy 0.1..0.4 and 0.6..0.7
    tr = trace_of([("k1", 0.1, 0.3), ("copy", 0.2, 0.4), ("k1", 0.6, 0.7)])
    assert tr.busy_s() == pytest.approx(0.4)
    r = frames_readings([0.5, 0.5], trace=tr)
    assert read("idle_pct.render", r) == pytest.approx(60.0)
    # a stall: the same work in a longer window reads more idle
    stalled = frames_readings([0.5, 0.5], trace=trace_of(
        tr.device, window=(0.0, 2.0)))
    assert read("idle_pct.render", stalled) == pytest.approx(80.0)


def test_gaps_are_named_by_the_host_span_open():
    host = [("window", 0.0, 1.0), ("frame", 0.0, 0.5), ("loss_read", 0.5, 1.0)]
    tr = trace_of([("k", 0.1, 0.3), ("k", 0.6, 0.9)], host=host)
    gaps = tr.breakdown()["idle_gaps"]
    assert gaps[0] == ["frame", pytest.approx(0.3)]
    assert [g[0] for g in gaps] == ["frame", "frame", "loss_read"]
    assert tr.breakdown()["device_ops"] == [["k", pytest.approx(0.5)]]


def test_layer_time_is_wall_minus_kernel_time():
    tr = trace_of([("mega_whitted_tree_kernel", 0.0, 0.4),
                   ("mega_whitted_tree_kernel", 0.5, 0.9)])
    r = frames_readings([0.5, 0.5], trace=tr)
    assert read("k1_ms", r) == pytest.approx(400.0)
    assert read("renderer_ms.frame", r) == pytest.approx(100.0)
    r.roofline["k1"] = 0.04
    assert read("k1_roofline", r) == pytest.approx(10.0)
    # without a trace, or without the kernel in it, the reader is silent
    assert read("k1_ms", frames_readings([0.5])) is None
    assert read("k1_roofline", frames_readings(
        [0.5], trace=trace_of([("other", 0.0, 0.1)]))) is None


def test_preview_and_frame_readers_each_read_their_own_unit():
    tr = trace_of([("mega_whitted_tree_kernel", 0.0, 0.4),
                   ("mega_whitted_tree_kernel", 0.5, 0.9)])
    frames = frames_readings([0.5, 0.5], trace=tr)
    passes = frames_readings([0.5, 0.5], trace=tr)
    passes.work = {**passes.work, "unit": "pass",
                   "paths": 2 * 800 * 800}
    passes.roofline["k1"] = frames.roofline["k1"] = 0.04
    for name in ("k1_ms", "k1_roofline", "idle_pct"):
        preview = name.split("_ms")[0] + "_ms.preview" if name == "k1_ms" \
            else name + ".preview"
        frame = name if name != "idle_pct" else "idle_pct.render"
        assert read(preview, passes) == pytest.approx(read(frame, frames))
        assert read(preview, frames) is None
        assert read(frame, passes) is None
    assert read("preview_paths_per_s", passes) == pytest.approx(1.28)
    assert read("preview_paths_per_s", frames) is None
    assert read("paths_per_s", passes) is None
