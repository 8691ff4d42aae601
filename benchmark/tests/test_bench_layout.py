"""The benchmark's files: every cell's found by name from BENCHMARK.json,
the file held to the contract's names, units and limits and to the
entries already accepted, and a cell, a configuration and a metric added
as new files and entries alone."""

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
# The entries the benchmark has accepted.  Each stands, in this order, at
# the head of its list in BENCHMARK.json: a later change appends entries
# and removes, renames or reorders none of these.
ACCEPTED_END_TO_END = ("setup_s", "paths_per_s", "frame_ms_p95",
                       "preview_paths_per_s", "train_rays_per_s",
                       "train_peak_mib")
ACCEPTED_PER_LAYER = ("tables_s", "renderer_ms.frame", "progressive_ms.pass",
                      "optimizer_ms.update", "k1_ms", "k1_roofline",
                      "k1_ms.preview", "k1_roofline.preview", "k2_ms.update",
                      "k2_roofline", "idle_pct.render", "idle_pct.preview",
                      "idle_pct.train")
ACCEPTED_CONFIGS = ("conductors", "gauge")
ACCEPTED_CELLS = ("conductors.frame16", "gauge.appearance",
                  "conductors.progressive")
# the accepted cells each accepted metric reports in: its list may grow
_FRAMES, _TRAIN, _PREVIEW = ((c,) for c in ACCEPTED_CELLS)
ACCEPTED_REPORTS = {
    "setup_s": ACCEPTED_CELLS, "tables_s": ACCEPTED_CELLS,
    **dict.fromkeys(("paths_per_s", "frame_ms_p95", "renderer_ms.frame",
                     "k1_ms", "k1_roofline", "idle_pct.render"), _FRAMES),
    **dict.fromkeys(("train_rays_per_s", "train_peak_mib",
                     "optimizer_ms.update", "k2_ms.update", "k2_roofline",
                     "idle_pct.train"), _TRAIN),
    **dict.fromkeys(("preview_paths_per_s", "progressive_ms.pass",
                     "k1_ms.preview", "k1_roofline.preview",
                     "idle_pct.preview"), _PREVIEW),
}
MAX_CELLS = 24


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


def contract_faults(spec: dict) -> list[str]:
    """Where ``spec`` breaks the append-only contract: an accepted entry
    removed, renamed or moved, more than MAX_CELLS cells, or an accepted
    metric no longer reported in a cell it was accepted in."""
    out = []
    for group, accepted in (("end_to_end", ACCEPTED_END_TO_END),
                            ("per_layer", ACCEPTED_PER_LAYER),
                            ("configs", ACCEPTED_CONFIGS),
                            ("workloads", ACCEPTED_CELLS)):
        head = tuple(x["name"] for x in spec[group][:len(accepted)])
        if head != accepted:
            out.append(f"{group} begins {head}, not {accepted}")
    cells = [w["name"] for w in spec["workloads"]]
    if len(cells) > MAX_CELLS:
        out.append(f"{len(cells)} cells, over {MAX_CELLS}")
    for m in spec["end_to_end"] + spec["per_layer"]:
        lost = set(ACCEPTED_REPORTS.get(m["name"], ())) - set(
            m.get("workloads", cells))
        if lost:
            out.append(f"{m['name']} no longer reports in {sorted(lost)}")
    return out


def with_cells(spec: dict, n: int) -> dict:
    """``spec`` with copies of its first cell appended up to ``n`` cells."""
    spec = copy.deepcopy(spec)
    first = spec["workloads"][0]
    for i in range(n - len(spec["workloads"])):
        spec["workloads"].append({**first, "name": f"{first['name']}_{i}"})
    return spec


def test_named_metrics_and_cells():
    assert contract_faults(SPEC) == []
    assert contract_faults(with_cells(SPEC, MAX_CELLS)) == []


def _remove(items):
    del items[1]


def _rename(items):
    items[1]["name"] += "_v2"


def _reorder(items):
    items[0], items[1] = items[1], items[0]


def _shrink_reports(spec):
    for m in spec["end_to_end"]:
        if m["name"] == "paths_per_s":
            m["workloads"] = ["gauge.appearance"]


BREAKS = [pytest.param(lambda s, g=g, f=f: f(s[g]),
                       id=f"{g}-{f.__name__[1:]}")
          for g in ("workloads", "configs", "end_to_end", "per_layer")
          for f in (_remove, _rename, _reorder)]
BREAKS += [pytest.param(lambda s: s.update(with_cells(s, MAX_CELLS + 1)),
                        id="25th_cell"),
           pytest.param(_shrink_reports, id="reports_shrunk")]


@pytest.mark.parametrize("breaks", BREAKS)
def test_the_contract_refuses(breaks):
    spec = copy.deepcopy(SPEC)
    breaks(spec)
    assert contract_faults(spec)


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


# a reference of its own: every call handed to ``whitted``, and counted
STUB_REFERENCE = '''
from benchmark.reference import whitted

CALLS = []


def _counted(name):
    def call(*a, **k):
        CALLS.append(name)
        return getattr(whitted, name)(*a, **k)
    return call


for _name in ("load", "tables", "frame_jitter", "multisample", "to_u8",
              "progressive_mean"):
    globals()[_name] = _counted(_name)
'''
K1_NAMED = "mega_ext_tree"


def _extra_configuration(extra):
    """The files of a configuration ``room`` under the root ``extra``: its
    scene, which reads its torus from an asset of its own, its reference,
    its kernel, and the limits, a metric and the entries of a frames cell
    and a progressive cell of it; returns the spec."""
    from bench_tiny import torus_ply

    for d in ("configs", "limits", "metrics", "reference"):
        (extra / d).mkdir(parents=True)
    bench = harness.BENCH_DIR
    cfg = json.loads((bench / "configs" / "conductors.json").read_text())
    (extra / "configs" / "room.json").write_text(json.dumps(
        {**cfg, "scene": "room.xml", "reference": "stub_ref",
         "k1_kernel": K1_NAMED, "assets": ["room_torus.ply"]}))
    xml = (bench / "configs" / "conductors.xml").read_text()
    assert xml.count('plyFile="torus_32768.ply"') == 1
    (extra / "configs" / "room.xml").write_text(xml.replace(
        'plyFile="torus_32768.ply"', 'plyFile="room_torus.ply"'))
    torus_ply(extra / "configs" / "room_torus.ply", nu=6, nv=4)
    (extra / "reference" / "stub_ref.py").write_text(STUB_REFERENCE)
    for traffic, like in (("frame16", "conductors.frame16"),
                          ("progressive", "conductors.progressive")):
        (extra / "limits" / f"room.{traffic}.json").write_text(
            (bench / "limits" / f"{like}.json").read_text())
    (extra / "metrics" / "room_tables_s.py").write_text(
        "def read(r):\n    return r.run.spans.total('tables') or None\n")
    spec = copy.deepcopy(SPEC)
    spec["configs"].append({"name": "room", "source": "x",
                            "file": "benchmark/configs/room.json",
                            "reduced": [], "why": "test"})
    spec["workloads"] += [
        {"name": "room.frame16", "config": "room", "traffic": "frame16",
         "chips": 1, "why": "t"},
        {"name": "room.progressive", "config": "room",
         "traffic": "progressive", "chips": 1, "why": "t"}]
    spec["per_layer"].append({"name": "room_tables_s", "unit": "s",
                              "better": "lower", "source": "host_clock",
                              "layer": "Ingest and tables",
                              "moves": "setup_s",
                              "workloads": ["room.frame16",
                                            "room.progressive"]})
    adds = {"paths_per_s": "room.frame16", "renderer_ms.frame": "room.frame16",
            "preview_paths_per_s": "room.progressive",
            "progressive_ms.pass": "room.progressive"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in adds:
            m["workloads"].append(adds[m["name"]])
    return spec


@pytest.mark.parametrize("cell,layer,calls", [
    ("room.frame16", "renderer_ms.frame",
     {"load", "tables", "frame_jitter", "multisample", "to_u8"}),
    ("room.progressive", "progressive_ms.pass",
     {"load", "tables", "progressive_mean"})])
def test_a_configuration_added_as_files_and_entries(cell, layer, calls,
                                                    tmp_path, monkeypatch):
    """A configuration that names its own reference, kernel and asset, a
    frames and a progressive cell of it and a per-layer metric, each a new
    file under another root and an entry appended to the spec: the cell
    runs correct against that reference, its layer metric reads the named
    kernel from the trace, the contract holds, and no file of the
    benchmark changes."""
    before = _digest(harness.BENCH_DIR)
    extra = tmp_path / "extra"
    spec = _extra_configuration(extra)
    assert contract_faults(spec) == []
    layout = harness.Layout(roots=[extra], spec=spec)
    # the trace as the card would give it: the named kernel beside K1a's
    trace = harness.Trace((0.0, 1.0), [
        ("mw::mega_whitted_tree_kernel", 0.0, 0.4),
        (f"mp::{K1_NAMED}_kernel", 0.5, 0.7),
        (f"mp::{K1_NAMED}_kernel", 0.7, 0.8)], [])
    monkeypatch.setattr(harness, "read_trace", lambda prof: trace)
    run = run_of(cell, tmp_path / "scenes", trace=True, seconds=0.3,
                 layout=layout)
    assert run.scene_path().name == "room.xml"
    out = harness.execute(run)
    assert out["correct"], out["checks"]
    # every call of the runner's interface went to the named reference
    assert set(layout.module("reference", "stub_ref").CALLS) == calls
    assert set(out["metrics"]) == {"tables_s", layer, "room_tables_s"}
    assert out["metrics"][layer]["value"] == pytest.approx(
        (1.0 - 0.3) / out["attempted"] * 1e3)
    assert _digest(harness.BENCH_DIR) == before


def test_the_training_runner_refuses_another_reference(tmp_path):
    """The training runner's reference chain works on whitted's tables
    alone, so a training configuration that names another reference is
    refused, not judged against a mix of the two."""
    extra = tmp_path / "extra"
    (extra / "configs").mkdir(parents=True)
    (extra / "limits").mkdir()
    bench = harness.BENCH_DIR
    cfg = json.loads((bench / "configs" / "gauge.json").read_text())
    (extra / "configs" / "gauge2.json").write_text(
        json.dumps({**cfg, "reference": "stub_ref"}))
    (extra / "limits" / "gauge2.appearance.json").write_text(
        (bench / "limits" / "gauge.appearance.json").read_text())
    spec = copy.deepcopy(SPEC)
    spec["configs"].append({"name": "gauge2", "source": "x",
                            "file": "benchmark/configs/gauge2.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "gauge2.appearance",
                              "config": "gauge2", "traffic": "appearance",
                              "chips": 1, "why": "t"})
    layout = harness.Layout(roots=[extra], spec=spec)
    run = run_of("gauge2.appearance", tmp_path / "scenes", layout=layout)
    with pytest.raises(ValueError, match="stub_ref"):
        layout.module("runners", "train").setup(run)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_metrics_not_listed_for_a_cell_are_not_reported(cell):
    layout = harness.Layout()
    listed = {m["name"] for m in layout.metrics(cell, False)}
    for m in SPEC["end_to_end"]:
        if cell not in m.get("workloads", [cell]):
            assert m["name"] not in listed
