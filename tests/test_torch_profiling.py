"""The port's ``utils/profiling.py``: ``block`` hands its tree back, and
``device_trace`` writes a trace into its directory on the CPU (its spans and
counters: ``test_torch_spans.py``)."""

from __future__ import annotations

import json

import torch

from advanced_cpu_raytracing_tpu_torch.utils import profiling


def test_block_returns_its_tree_unchanged_on_cpu_tensors():
    a, b, c = torch.ones(3), torch.zeros(2, 2), torch.arange(4)
    tree = {"x": (a, [b, {"y": c}]), "n": 3, "s": "text"}
    assert profiling.block(tree) is tree
    assert tree["x"][0] is a and tree["x"][1][0] is b
    assert tree["x"][1][1]["y"] is c
    assert profiling.block(a) is a
    assert profiling.block([]) == []


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        y = (x @ x).relu()
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    assert y.shape == (64, 64)


def test_device_trace_records_input_shapes(tmp_path):
    x = torch.randn(8, 16)
    with profiling.device_trace(str(tmp_path)) as prof:
        x @ x.T
    rows = [r for r in prof.key_averages(group_by_input_shape=True)
            if r.key == "aten::mm"]
    assert [r.input_shapes for r in rows] == [[[8, 16], [16, 8]]]
