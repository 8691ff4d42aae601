"""Read the numbers that ``correct`` compares, to set their limits: the
program's on many seeds, the control's (the reference in the next lower
precision put in the program's place) and the planted faults', each at
the cell's own size, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--faults 7,8,9] [--seconds 6]

Prints one JSON line per reading: {"kind": "program" | "control" |
<fault>, "seed", "numbers", "check_s"}.  A short window serves: the
numbers are read from the answers the window produced, as in a run (a
training window has to outlast a job, about 2 s, to check one of its
own).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import nullcontext
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import faults, harness  # noqa: E402

CONTROL_DTYPE = torch.bfloat16  # the configurations state float32


def _ints(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x]


def one(layout, cell, seed, seconds, patch=None, control=False,
        overrides=None) -> dict:
    run = harness.Run(layout, cell, layout.config(cell["config"]),
                      layout.traffic(cell["traffic"]), seed, seconds, False,
                      device="cuda" if torch.cuda.is_available() else "cpu",
                      overrides=overrides or {})
    runner = layout.module("runners", run.traffic["runner"])
    run.t_start = time.perf_counter()
    with (patch() if patch else nullcontext()):
        st = runner.setup(run)
        work = runner.window(run, st)
        prog = runner.answers(run, st, work)
    t0 = time.perf_counter()
    ref = runner.reference_answers(run, prog)
    check_s = time.perf_counter() - t0
    if control:
        prog = runner.reference_answers(run, prog, CONTROL_DTYPE)
    return {"numbers": runner.compare(prog, ref), "check_s": check_s,
            "units": work["units"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    layout = harness.Layout()
    cell = layout.cell(args.workload)
    kind = layout.traffic(cell["traffic"])["runner"]
    jobs = [("program", s, None) for s in _ints(args.seeds)]
    jobs += [("control", s, None) for s in _ints(args.control_seeds)]
    for s in _ints(args.faults):
        # a state left unchanged reads 1 by the change's measure: no run
        jobs += [(name, s, p) for name, p in faults.FAULTS[kind].items()
                 if name != "state_unchanged"]
    for name, seed, patch in jobs:
        r = one(layout, cell, seed, args.seconds, patch, name == "control")
        print(json.dumps({"cell": cell["name"], "kind": name, "seed": seed,
                          **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
