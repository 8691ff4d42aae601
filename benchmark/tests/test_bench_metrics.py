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


# A recorded window of 1 s and 2 units: K1a's kernel twice, K2a's primal
# and reverse, and a K1 kernel that a configuration may name instead.
NAMED = {"k1_kernel": "mega_ext_tree"}
RECORDED = [("mw::mega_whitted_tree_kernel", 0.0, 0.3),
            ("mw::mega_whitted_tree_kernel", 0.4, 0.6),
            ("mb::mega_bwd_primal_tree_kernel", 0.6, 0.7),
            ("mb::mega_bwd_rev_kernel", 0.7, 0.75),
            ("mp::mega_ext_tree_kernel", 0.8, 0.9)]
K1_LEAST, K2_LEAST = 0.01, 0.015  # the rooflines' least seconds


def _k1(s, n):  # (k1_ms, k1_roofline, layer ms a unit) of s over n launches
    return s / n * 1e3, 100.0 * K1_LEAST / (s / n), (1.0 - s) / 2 * 1e3


def _k2(s):  # (k2_ms, k2_roofline, layer ms a unit) of s over 2 updates
    return s / 2 * 1e3, 100.0 * K2_LEAST / (s / 2), (1.0 - s) / 2 * 1e3


# reader, cell, which of its kernel's three numbers, as configured today
# (mega_whitted: 0.3 + 0.2 s in 2 launches; mega_bwd: 0.1 + 0.05 s), with
# NAMED (mega_ext_tree: 0.1 s in 1; the K2 readers read every mega_bwd*
# kernel, K2b's and K2c's too, whatever the configuration names)
READERS = [
    ("k1_ms", "conductors.frame16", 0, _k1(0.5, 2), _k1(0.1, 1)),
    ("k1_roofline", "conductors.frame16", 1, _k1(0.5, 2), _k1(0.1, 1)),
    ("renderer_ms.frame", "conductors.frame16", 2, _k1(0.5, 2), _k1(0.1, 1)),
    ("k1_ms.preview", "conductors.progressive", 0, _k1(0.5, 2), _k1(0.1, 1)),
    ("k1_roofline.preview", "conductors.progressive", 1, _k1(0.5, 2),
     _k1(0.1, 1)),
    ("progressive_ms.pass", "conductors.progressive", 2, _k1(0.5, 2),
     _k1(0.1, 1)),
    ("k2_ms.update", "gauge.appearance", 0, _k2(0.15), _k2(0.15)),
    ("k2_roofline", "gauge.appearance", 1, _k2(0.15), _k2(0.15)),
    ("optimizer_ms.update", "gauge.appearance", 2, _k2(0.15), _k2(0.15)),
]
UNIT = {"conductors.frame16": "frame", "conductors.progressive": "pass",
        "gauge.appearance": "update"}


@pytest.mark.parametrize("reader,cell,i,today,named", READERS,
                         ids=[r[0] for r in READERS])
def test_kernel_readers_read_the_configured_kernel(reader, cell, i, today,
                                                   named):
    """Each of the nine readers of a kernel's time reads, under the cell's
    configuration as it stands, what it read when its kernel was fixed;
    under a configuration that names another K1 kernel, the six K1
    readers read that kernel and the three K2 readers read as before."""
    config = LAYOUT.config(LAYOUT.cell(cell)["config"])
    assert not set(NAMED) & set(config)
    for cfg, want in ((config, today[i]), ({**config, **NAMED}, named[i])):
        run = harness.Run(LAYOUT, LAYOUT.cell(cell), cfg, {}, 0, 1.0, True,
                          device="cpu")
        r = harness.Readings(run, setup_s=3.0, window_s=1.0,
                             work={"units": 2, "unit": UNIT[cell]},
                             trace=trace_of(RECORDED),
                             roofline={"k1": K1_LEAST, "k2": K2_LEAST})
        assert read(reader, r) == pytest.approx(want)
