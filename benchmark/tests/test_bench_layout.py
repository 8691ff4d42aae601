"""The benchmark's files: every cell's found by name from BENCHMARK.json,
the file held to the contract's names, units and limits, and a cell added
as new files and an entry alone."""

from __future__ import annotations

import copy
import hashlib
import json
import re

import pytest

from bench_tiny import ROOT, run_of
from benchmark import harness

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
END_TO_END = ("setup_s", "paths_per_s", "frame_ms_p95", "preview_paths_per_s",
              "train_rays_per_s", "train_peak_mib")
PER_LAYER = ("tables_s", "renderer_ms.frame", "progressive_ms.pass",
             "optimizer_ms.update", "k1_ms", "k1_roofline", "k1_ms.preview",
             "k1_roofline.preview", "k2_ms.update", "k2_roofline",
             "idle_pct.render", "idle_pct.preview", "idle_pct.train")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (SPEC["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["config"] for w in SPEC["workloads"]]
    names += [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in SPEC[group]]
        assert len(got) == len(set(got)), group
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in [c["why"] for c in SPEC["configs"] + SPEC["workloads"]] + \
            [c["source"] for c in SPEC["configs"]] + \
            [m["layer"] for m in SPEC["per_layer"]] + SPEC["command"]:
        assert LINE.match(text), text


def test_entries_have_just_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_named_metrics_and_cells():
    assert tuple(m["name"] for m in SPEC["end_to_end"]) == END_TO_END
    assert tuple(m["name"] for m in SPEC["per_layer"]) == PER_LAYER
    assert {c["name"] for c in SPEC["configs"]} == {"conductors", "gauge"}
    assert [w["name"] for w in SPEC["workloads"]] == [
        "conductors.frame16", "gauge.appearance", "conductors.progressive"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    layout = harness.Layout()
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        got = [m["name"] for m in layout.metrics(w["name"], False)]
        assert "setup_s" in got and len(got) >= 2
        assert layout.metrics(w["name"], True)
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", [w["name"] for w in SPEC["workloads"]]):
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)
    assert {c["name"] for c in SPEC["configs"]} == \
        {w["config"] for w in SPEC["workloads"]}


def test_every_cells_files_are_found_by_name():
    layout = harness.Layout()
    for w in layout.spec["workloads"]:
        cfg = layout.config(w["config"])
        assert (cfg["_dir"] / cfg["scene"]).exists()
        tr = layout.traffic(w["traffic"])
        runner = layout.module("runners", tr["runner"])
        for fn in ("setup", "window", "answers", "reference_answers",
                   "compare", "checked", "counts"):
            assert callable(getattr(runner, fn)), (w["name"], fn)
        limits = layout.limits(w["name"])
        assert limits and all(v >= 0 for v in limits.values())
        for k in tr["rooflines"]:
            assert callable(layout.module("rooflines", k).least_s)
        for m in layout.metrics(w["name"], False) + \
                layout.metrics(w["name"], True):
            assert callable(layout.module("metrics", m["name"]).read)
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/configs/")


def _digest(root):
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(root)).encode() + p.read_bytes())
    return h.hexdigest()


def test_a_cell_added_as_files_and_an_entry(tmp_path):
    """A configuration, a traffic mix, a cell with its limits and a metric,
    each a new file under another root and an entry in the spec; no file
    of the benchmark changes, and the run reports the new metric."""
    before = _digest(harness.BENCH_DIR)
    extra = tmp_path / "extra"
    for d in ("configs", "traffic", "limits", "metrics"):
        (extra / d).mkdir(parents=True)
    cfg = json.loads((harness.BENCH_DIR / "configs" / "conductors.json")
                     .read_text())
    (extra / "configs" / "conductors_small.json").write_text(json.dumps(
        {**cfg, "width": 10, "height": 10}))
    (extra / "traffic" / "frame4.json").write_text(json.dumps(
        {"runner": "frames", "spp": 4, "check_pixels": 32,
         "rooflines": ["k1"]}))
    (extra / "limits" / "conductors_small.frame4.json").write_text(
        (harness.BENCH_DIR / "limits" / "conductors.frame16.json").read_text())
    (extra / "metrics" / "frames_done.py").write_text(
        "def read(r):\n    return r.work['units']\n")
    spec = copy.deepcopy(SPEC)
    spec["configs"].append({"name": "conductors_small", "source": "x",
                            "file": "benchmark/configs/conductors_small.json",
                            "reduced": ["width", "height"], "why": "test"})
    spec["workloads"].append({"name": "conductors_small.frame4",
                              "config": "conductors_small",
                              "traffic": "frame4", "chips": 1, "why": "t"})
    spec["end_to_end"].append({"name": "frames_done", "unit": "frames",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["conductors_small.frame4"]})
    for m in spec["end_to_end"]:  # the entry lists the cell where it reports
        if m["name"] == "paths_per_s":
            m["workloads"].append("conductors_small.frame4")
    layout = harness.Layout(roots=[extra], spec=spec)
    run = run_of("conductors_small.frame4", tmp_path, layout=layout,
                 width=10, height=10, spp=4, pixels=16)
    out = harness.execute(run)
    assert out["correct"]
    assert out["metrics"]["frames_done"]["value"] >= 1
    assert set(out["metrics"]) == {"setup_s", "paths_per_s", "frames_done"}
    assert _digest(harness.BENCH_DIR) == before


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_metrics_not_listed_for_a_cell_are_not_reported(cell):
    layout = harness.Layout()
    listed = {m["name"] for m in layout.metrics(cell, False)}
    for m in SPEC["end_to_end"]:
        if cell not in m.get("workloads", [cell]):
            assert m["name"] not in listed
