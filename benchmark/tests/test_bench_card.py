"""The benchmark on the card (marked ``cuda``; skipped without one): a
short run of each cell through the command comes out correct, and the
control at a cell's own size does not.

    python -m pytest benchmark/tests -m cuda
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from bench_tiny import ROOT
from benchmark import calibrate, harness

LAYOUT = harness.Layout()
CELLS = [w["name"] for w in LAYOUT.spec["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_on_the_card_is_correct(card, cell):
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483001", "--seconds", "6", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert p.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.cuda
def test_control_at_the_cells_size_is_not_correct(card):
    cell = LAYOUT.cell("conductors.frame16")
    r = calibrate.one(LAYOUT, cell, 2147483002, 1.0, control=True)
    limits = LAYOUT.limits(cell["name"])
    assert any(v > limits[k] for k, v in r["numbers"].items()), r
