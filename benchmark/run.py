"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds the program
(``advanced_cpu_raytracing_tpu_torch``), on a machine with the CUDA cards
the cell asks for.  With ``--trace 0`` the result line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics read from a
``torch.profiler`` trace of the window.  The last lines on standard error,
and the ``checks`` key that ends the result line, give each number that
decided ``correct`` beside its limit.  It exits with 2, printing no
result, without enough cards, and with 1 if the run fails or a module of
JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import os
import sys
import time

# glibc's allocator with a fixed mmap threshold.  Left to its dynamic
# threshold, some processes spend system time at every step and
# others do not, from run to run (on an H100 host a progressive preview
# read 48-64 Mpaths/s with about a second of system time in ten, or
# 91-105 with none; with these tunables every run read the latter).  The
# tunables are read at start, so the first image sets them and starts
# again, and set-up counts from the first start.
TUNABLES = ("glibc.malloc.mmap_threshold=16777216:"
            "glibc.malloc.trim_threshold=67108864")
if TUNABLES not in os.environ.get("GLIBC_TUNABLES", ""):
    os.environ["BENCHMARK_T_START"] = repr(time.perf_counter())
    os.environ["GLIBC_TUNABLES"] = ":".join(
        t for t in (os.environ.get("GLIBC_TUNABLES"), TUNABLES) if t)
    sys.stdout.flush()
    os.execv(sys.executable, [sys.executable] + sys.argv)

T_START = float(os.environ.pop("BENCHMARK_T_START", time.perf_counter()))

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the program inside the checkout, at
# fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    bad = harness.loaded(harness.FORBIDDEN)
    if bad:
        print(f"run.py: modules loaded at start: {', '.join(bad)}",
              file=sys.stderr)
        return 1
    import torch

    layout = harness.Layout()
    cell = layout.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    run = harness.Run(layout, cell, layout.config(cell["config"]),
                      layout.traffic(cell["traffic"]), args.seed,
                      args.seconds, bool(args.trace), t_start=T_START)
    out = harness.execute(run)
    bad = harness.loaded(harness.FORBIDDEN)
    if bad:
        print(f"run.py: modules loaded in the run: {', '.join(bad)}",
              file=sys.stderr)
        return 1
    sys.stdout.flush()
    print("\n".join(harness.check_lines(out["checks"])), file=sys.stderr,
          flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
