"""Kernel K4's window rule on the host (``ops/bigtex_gather.py::
gather_plan_ref``: each group of 1,024 lanes served through a shared-memory
window or directly), the wrapper on CPU tensors with its ``window_bytes``
and ``paths`` options, the probe's ``traffic`` with the windows' bytes, and
the design tool's source edits.  No JAX; the CUDA kernel itself is held to
the same rule on the card (``tests/test_torch_cuda.py``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu_torch.ops import bigtex_gather as k4
from advanced_cpu_raytracing_tpu_torch.tools import k4_design, probe_bigtex

G = k4.GROUP
W = k4.WINDOW_BYTES


def _brute_plan(idx, n_tab, window_bytes):
    """The rule written out group by group with numpy."""
    flat = np.asarray(idx).reshape(idx.shape[0], -1).astype(np.int64)
    spans, window = [], []
    for g0 in range(0, flat.shape[1], G):
        v = flat[:, g0:g0 + G].reshape(-1)
        v = v[(v >= 0) & (v < n_tab)]
        if v.size == 0:
            spans.append(0)
            window.append(False)
            continue
        span = 4 * (((int(v.max()) + 4) // 4 * 4) - (int(v.min()) // 4 * 4))
        spans.append(span)
        window.append(span <= window_bytes and flat.shape[0] <= 4)
    return spans, window


def _plan(idx, n_tab, window_bytes=W):
    plan = k4.gather_plan_ref(torch.as_tensor(idx), n_tab, window_bytes)
    return plan["span"].tolist(), plan["window"].tolist(), plan["counts"]


def test_one_group_inside_a_window():
    idx = np.random.default_rng(0).integers(101, 199, (2, G)).astype(np.int32)
    idx[0, 0], idx[1, 5] = 101, 198
    span, window, counts = _plan(idx, 1000)
    # entries 100..199 after rounding out to 16 bytes
    assert span == [4 * (200 - 100)] and window == [True]
    assert counts == (1, 0)


@pytest.mark.parametrize("extra,served", [(0, True), (16, False)])
def test_a_span_of_the_window_and_16_bytes_more(extra, served):
    hi = (W + extra) // 4 - 1
    idx = np.random.default_rng(1).integers(0, hi + 1, (4, G)).astype(np.int32)
    idx[0, 0], idx[3, G - 1] = 0, hi
    span, window, counts = _plan(idx, 10**6)
    assert span == [W + extra] and window == [served]
    assert counts == ((1, 0) if served else (0, 1))
    # the alignment of the lowest entry counts: the same span from entry 2
    # rounds out to 16 bytes more
    span2, window2, _ = _plan(idx + 2, 10**6)
    assert span2 == [W + extra + 16] and window2 == [False]


def test_a_partial_last_group():
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 64, (3, 2 * G + 100)).astype(np.int32)
    idx[:, 2 * G:] += 50_000
    span, window, counts = _plan(idx, 10**6)
    assert len(span) == 3 and counts == (3, 0)
    lo = int(idx[:, 2 * G:].min()) // 4 * 4
    hi = (int(idx[:, 2 * G:].max()) + 4) // 4 * 4
    assert span[2] == 4 * (hi - lo)
    # the padding of the last group reads as outside the table: it widens
    # no span
    assert _brute_plan(idx, 10**6, W)[0] == span


def test_indices_outside_the_table_are_left_out_of_the_span():
    n_tab = 5000
    idx = np.full((2, G), 1000, dtype=np.int32)
    idx[0, :10] = np.arange(1000, 1010)
    idx[0, 20], idx[1, 21], idx[1, 22] = -5, n_tab, 2**31 - 1
    idx[0, 23] = -2**31
    span, window, _ = _plan(idx, n_tab)
    assert span == [4 * (1012 - 1000)] and window == [True]


def test_a_group_with_no_index_in_the_table_goes_direct():
    idx = np.full((2, 2 * G), -1, dtype=np.int32)
    idx[:, G:] = 7
    idx[1, :G] = 10**6
    span, window, counts = _plan(idx, 1000)
    assert span == [0, 16] and window == [False, True]
    assert counts == (1, 1)


def test_window_zero_and_more_than_four_taps_go_direct():
    idx = np.random.default_rng(3).integers(0, 100, (4, 3 * G)).astype(
        np.int32)
    assert _plan(idx, 1000, 0)[2] == (0, 3)
    assert _plan(idx, 1000)[2] == (3, 0)
    five = np.concatenate([idx, idx[:1]])
    assert _plan(five, 1000)[1] == [False] * 3


@pytest.mark.parametrize("cfg,blocks", [
    *((c, 8) for c, _ in probe_bigtex.ASSERTED),
    *((c, 8) for c in probe_bigtex.SWEEP),
    (probe_bigtex.FRAME, 64)])
def test_counts_on_the_probe_configurations(cfg, blocks):
    """The probe's groups are its TPU blocks: windows of ``spread`` rows of
    512 bytes, through the window up to 64 rows (32 KB)."""
    idx, tab = probe_bigtex.make_inputs(cfg["n_rows"], cfg["taps"],
                                        cfg["spread"], blocks, seed=4,
                                        device="cpu")
    span, window, counts = _plan(idx, tab.numel())
    assert (span, window) == _brute_plan(idx.numpy(), tab.numel(), W)
    assert len(span) == blocks
    assert max(span) <= 512 * cfg["spread"]
    want = (blocks, 0) if 512 * cfg["spread"] <= W else (0, blocks)
    assert counts == want


def test_gather_sum_on_cpu_tensors_adds_the_plan_counts():
    idx, tab = probe_bigtex.make_inputs(8192, 4, 16, 3, seed=5, device="cpu")
    paths = torch.zeros(2, dtype=torch.int32)
    before = dict(k4.LAUNCHES)
    got = k4.gather_sum(idx, tab, paths=paths)
    assert k4.LAUNCHES == before
    assert torch.equal(got, k4.gather_sum_ref(idx, tab))
    assert paths.tolist() == [3, 0]
    assert torch.equal(k4.gather_sum(idx, tab, 0, paths), got)
    assert paths.tolist() == [3, 3]
    # a table off 16 bytes goes direct
    shifted = tab.reshape(-1)[1:]
    assert shifted.data_ptr() % 16
    paths.zero_()
    torch.testing.assert_close(k4.gather_sum(idx, shifted, paths=paths),
                               k4.gather_sum_ref(idx, shifted), rtol=0,
                               atol=0, equal_nan=True)
    assert paths.tolist() == [0, 3]


@pytest.mark.parametrize("window_bytes", [-16, 8, 32769])
def test_gather_sum_refuses_a_window_not_a_multiple_of_16(window_bytes):
    idx, tab = probe_bigtex.make_inputs(64, 1, 4, 1, seed=6, device="cpu")
    with pytest.raises(ValueError, match="window_bytes"):
        k4.gather_sum(idx, tab, window_bytes)


def test_gather_sum_refuses_a_paths_buffer_of_another_shape():
    idx, tab = probe_bigtex.make_inputs(64, 1, 4, 1, seed=6, device="cpu")
    for bad in (torch.zeros(3, dtype=torch.int32), torch.zeros(2)):
        with pytest.raises(ValueError, match="paths"):
            k4.gather_sum(idx, tab, paths=bad)


@pytest.mark.parametrize("cfg,blocks", [(probe_bigtex.SWEEP[2], 6),
                                        (probe_bigtex.FRAME, 64)])
def test_traffic_counts_the_windows_bytes(cfg, blocks):
    idx, tab = probe_bigtex.make_inputs(cfg["n_rows"], cfg["taps"],
                                        cfg["spread"], blocks, seed=7,
                                        device="cpu")
    tr = probe_bigtex.traffic(idx, tab.numel())
    assert tr["window_bytes"] == sum(_brute_plan(idx.numpy(), tab.numel(),
                                                 W)[0])
    # the bound stays the touched sectors'
    sectors = len(np.unique(idx.numpy().reshape(-1) // 8))
    lanes = idx[0].numel()
    assert tr["sectors"] == sectors
    assert tr["bytes"] == 4 * cfg["taps"] * lanes + 4 * lanes + 32 * sectors
    assert tr["window_bytes"] >= 32 * sectors - 32 * blocks
    assert probe_bigtex.traffic(idx) == tr


def test_the_design_tools_edits_apply_to_the_kernel_source():
    """tools/k4_design.py builds its variants by editing
    csrc/bigtex_gather.cu: every edit must find its text."""
    for name in k4_design.EDITS:
        src = k4_design.variant_source(name)
        assert "bigtex_gather_launch" in src and src != (
            k4_design._build.CSRC / "bigtex_gather.cu").read_text()
