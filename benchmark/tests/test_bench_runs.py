"""Whole runs of each cell at a small size on the CPU, through the
program's plain versions: a sound run comes out correct; the control (the
reference in bfloat16 put in the program's place) and every planted fault
that the cell can have come out not correct under the cell's own limits;
and the command's own refusals."""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from bench_tiny import ROOT, run_of
from benchmark import calibrate, faults, harness

LAYOUT = harness.Layout()
CELLS = [w["name"] for w in LAYOUT.spec["workloads"]]
FAULT_CASES = [(c, f) for c in CELLS
               for f in faults.FAULTS[LAYOUT.traffic(
                   LAYOUT.cell(c)["traffic"])["runner"]]]


def _fails(out: dict) -> bool:
    return not out["correct"] and any(
        v["value"] > v["limit"] for v in out["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tmp_path):
    run = run_of(cell, tmp_path, trace=True, seconds=0.3, layout=LAYOUT)
    out = harness.execute(run)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert "tables_s" in out["metrics"]
    assert out["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell,fault", FAULT_CASES)
def test_planted_fault_is_not_correct(cell, fault, tmp_path):
    kind = LAYOUT.traffic(LAYOUT.cell(cell)["traffic"])["runner"]
    # a pass that repeats the one before it shows only in a window of two
    # passes or more: a shorter window, on a busy CPU, runs again twice as
    # long
    seconds = 0.5
    while True:
        run = run_of(cell, tmp_path, seconds=seconds, layout=LAYOUT)
        out = harness.execute(run, program_patch=faults.FAULTS[kind][fault])
        if out["attempted"] >= 2:
            break
        seconds *= 2
    assert _fails(out), out["checks"]
    assert out["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, tmp_path):
    """The reference in the next lower precision, in the program's place,
    fails one of the cell's numbers under its limits."""
    run = run_of(cell, tmp_path, layout=LAYOUT)
    runner = LAYOUT.module("runners", run.traffic["runner"])
    st = runner.setup(run)
    work = runner.window(run, st)
    prog = runner.answers(run, st, work)
    ref = runner.reference_answers(run, prog)
    control = runner.reference_answers(run, prog, calibrate.CONTROL_DTYPE)
    numbers = runner.compare(control, ref)
    limits = LAYOUT.limits(cell)
    assert any(numbers[k] > limits[k] for k in numbers), numbers
    assert set(numbers) == set(limits)


TRAIN_CELLS = [c for c in CELLS if LAYOUT.traffic(
    LAYOUT.cell(c)["traffic"])["runner"] == "train"]


def _reset_keeping_adams_state(st):
    with torch.no_grad():
        for k, v in st["u"].items():
            v.copy_(st["u0"][k])
    st["step"] = 0
    st["job"] = []


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_a_window_job_is_checked(cell, tmp_path):
    """The check reads a job that started in the window, besides set-up's:
    a reset between jobs that keeps Adam's state comes out not correct."""
    from unittest import mock

    from benchmark.runners import train

    run = run_of(cell, tmp_path, seconds=0.5, layout=LAYOUT)
    runner = LAYOUT.module("runners", run.traffic["runner"])
    st = runner.setup(run)
    prog = runner.answers(run, st, runner.window(run, st))
    assert prog["window_job"] and len(prog["jobs"]) == 2
    assert runner.checked(prog) == 2 * train.CHECKED_UPDATES

    run = run_of(cell, tmp_path, seconds=0.5, layout=LAYOUT)
    out = harness.execute(run, program_patch=lambda: mock.patch.object(
        train, "_reset", _reset_keeping_adams_state))
    assert _fails(out), out["checks"]


# shape recovery (the vertices moved too, the loss read each update): no
# cell of BENCHMARK.json runs it yet, and a later one can be added as
# these two data files and an entry
SHAPE_TRAFFIC = {
    "runner": "train", "fields": ["mat_diffuse", "pl_intensity", "verts"],
    "grids": 1, "jitter": "pixel", "normalized": False, "norm": 1.0,
    "rates": {"mat_diffuse": 0.005, "pl_intensity": 400.0,
              "verts": 1.0 / 6000.0},
    "start": {"mat_diffuse": [0.7, 1.1], "pl_intensity": [1.2, 1.2],
              "verts": 0.01},
    "steps_per_job": 150, "rooflines": ["k2"]}
SHAPE_LIMITS = {"loss_rel_gap": 0.005, "grad_norm_gap": 0.004,
                "change_norm_gap": 0.01}


@pytest.mark.parametrize("fault", [None, "half_batch", "reset"])
def test_a_shape_cell_added_as_data(fault, tmp_path):
    from unittest import mock

    from benchmark.runners import train

    extra = tmp_path / "extra"
    for d in ("traffic", "limits"):
        (extra / d).mkdir(parents=True)
    (extra / "traffic" / "shape.json").write_text(json.dumps(SHAPE_TRAFFIC))
    (extra / "limits" / "gauge.shape.json").write_text(
        json.dumps(SHAPE_LIMITS))
    spec = copy.deepcopy(LAYOUT.spec)
    spec["workloads"].append({"name": "gauge.shape", "config": "gauge",
                              "traffic": "shape", "chips": 1, "why": "t"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "gauge.appearance" in m.get("workloads", []):
            m["workloads"].append("gauge.shape")
    layout = harness.Layout(roots=[extra], spec=spec)
    run = run_of("gauge.shape", tmp_path, seconds=0.5, layout=layout)
    patch = {None: None, "half_batch": faults.train_half_batch,
             "reset": lambda: mock.patch.object(
                 train, "_reset", _reset_keeping_adams_state)}[fault]
    out = harness.execute(run, program_patch=patch)
    if fault is None:
        assert out["correct"], out["checks"]
        assert {"setup_s", "train_rays_per_s"} <= set(out["metrics"])
    else:
        assert _fails(out), out["checks"]


def test_a_traced_window_is_cut_to_the_trace_length(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.05)
    run = run_of("conductors.frame16", tmp_path, trace=True, seconds=30.0)
    out = harness.execute(run)
    assert out["correct"] and out["device"]["window_s"] < 10.0


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "sys.path.insert(0, %r)\n"
        "import bench_tiny, pathlib\n"
        "from benchmark import harness\n"
        "out = harness.execute(bench_tiny.run_of('conductors.frame16', "
        "pathlib.Path(%r)))\n"
        "print(json.dumps([out['correct'], harness.loaded(harness.FORBIDDEN),"
        " 'advanced_cpu_raytracing_tpu_torch' in {m.split('.')[0] for m in "
        "sys.modules}]))"
        % (str(ROOT), str(ROOT / "benchmark" / "tests"), str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=600)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, [], True]


def _cli(cwd, *extra):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "conductors.frame16",
         "--seed", "2147483999", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, env=env, timeout=600)


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = _cli(ROOT)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_cli_fails_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files
    gives no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(tmp_path)
    assert p.returncode != 0
    assert not p.stdout.strip().startswith("{")
