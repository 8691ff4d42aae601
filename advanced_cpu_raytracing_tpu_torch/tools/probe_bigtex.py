"""The big-texture gather probe on the card: the port of the repo's
``tools/probe_bigtex.py``.

    python -m advanced_cpu_raytracing_tpu_torch.tools.probe_bigtex \\
        [--device cuda|cpu] [--n-rows N --taps T --spread S --blocks B \\
         --iters I]

Per lane, the sum of ``taps`` entries gathered by flat index from an
(n_rows, 128) f32 table (kernel K4, ``ops/bigtex_gather.py``): the access
of a bilinear texture lookup into a megapixel table.  Each block of 8 x 128
lanes draws a base row, and each tap a row within ``spread`` rows of it and
a random lane, so ``spread`` sets the coherence of a block's reads.  The
table and the indices come from a ``torch.Generator`` seeded by ``seed`` on
the run's device.  ``run`` checks the kernel against the numpy oracle of
the JAX probe (``tab.flat[idx].sum(axis=0)``), times ``iters`` launches back
to back (the JAX probe's loop, so a table that fits in L2 stays there),
prints the JAX probe's line, and returns it with the least time the card
needs for the bytes (``traffic``) and the time of one PyTorch call that
computes the same sums (``embedding_bag``, timed the same way; a yardstick
only).

Without size options it runs the JAX probe's ``__main__``: two configurations
held to its asserts, the sweep of ``spread`` over 8, 64 and 256, and one
configuration at a frame's size (``FRAME``).  The JAX probe's ``wn``, the
number of table rows its TPU kernel copies into VMEM per DMA, becomes K4's
window in bytes (``ops/bigtex_gather.py::WINDOW_BYTES``): a group of 1,024
lanes whose taps span at most that much of the table is served from one
copy of it in shared memory, a wider one directly.  Runs on the card
unless given ``--device cpu`` (the plain version; use small sizes there).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from advanced_cpu_raytracing_tpu_torch.ops.bigtex_gather import (
    gather_plan_ref,
    gather_sum,
)
from advanced_cpu_raytracing_tpu_torch.utils import profiling
from advanced_cpu_raytracing_tpu_torch.utils.device import resolve_device

ROWS, LANES = 8, 128
# H100 SXM device memory bandwidth (NVIDIA data sheet)
PEAK_BYTES_S = 3.35e12
# the JAX probe's __main__: two configurations with its error bounds, then
# the sweep over spread
ASSERTED = ((dict(n_rows=512, taps=1, spread=4, blocks=64, iters=5), 1e-6),
            (dict(n_rows=8192, taps=4, spread=16, blocks=512), 1e-5))
SWEEP = tuple(dict(n_rows=8192, taps=4, spread=s, blocks=512)
              for s in (8, 64, 256))
# a frame's lanes (800 x 800 pixels x 16 spp = 10,240,000 = 10,000 blocks),
# a bilinear tap's 4 texels, and the JAX megakernel's per-image texel limit
# (_BIG_MAX_TEXELS = 2^24) in 3 channel rows: a 201 MB table, past L2
FRAME = dict(n_rows=3 * (1 << 24) // LANES, taps=4, spread=64, blocks=10000)
# __main__'s list: (configuration, error bound or None)
CONFIGS = (*ASSERTED, *((c, None) for c in SWEEP), (FRAME, None))


def make_inputs(n_rows: int, taps: int, spread: int, blocks: int,
                seed: int, device):
    """(idx (taps, blocks, 8, 128) int32, tab (n_rows, 128) f32): the JAX
    probe's pattern (a base row per block, a row within ``spread`` of it
    and a random lane per tap), drawn from one generator on ``device``."""
    if n_rows < spread + 2:
        raise ValueError(f"n_rows {n_rows} needs to exceed spread + 1")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tab = torch.rand((n_rows, LANES), generator=gen, device=device)
    shape = (taps, blocks, ROWS, LANES)
    base = torch.randint(0, n_rows - spread - 1, (blocks, 1, 1), generator=gen,
                         device=device)
    rows = base[None] + torch.randint(0, spread, shape, generator=gen,
                                      device=device)
    lane = torch.randint(0, LANES, shape, generator=gen, device=device)
    return (rows * LANES + lane).to(torch.int32), tab


def traffic(idx, n_tab=None) -> dict:
    """The bytes a gather-sum must move: each index read once, each output
    written once, and each distinct 32-byte sector of the table that the
    indices touch read once; the least time for them at the card's rate.
    Beside it ``window_bytes``, what K4's windows would copy: each group's
    span of in-range indices (``gather_plan_ref``; every index >= 0 counts
    as in range without ``n_tab``), summed over the groups."""
    taps, lanes = idx.shape[0], idx[0].numel()
    sectors = int(torch.unique(idx.reshape(-1) // 8).numel())
    n_bytes = 4 * taps * lanes + 4 * lanes + 32 * sectors
    spans = gather_plan_ref(idx, 2**31 if n_tab is None else n_tab, 0)["span"]
    return {"sectors": sectors, "bytes": n_bytes,
            "bound_ms": n_bytes / PEAK_BYTES_S * 1e3, "bound_by": "bytes",
            "window_bytes": int(spans.sum())}


def _back_to_back_s(fn, iters: int) -> float:
    profiling.block(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    profiling.block(out)
    return (time.perf_counter() - t0) / iters


def run(n_rows=8192, taps=4, spread=64, blocks=512, iters=20, seed=0,
        device=None, log=print) -> dict:
    """One configuration (see the module docstring): K4 is launched once
    for the check, once to warm up and ``iters`` times in the timed loop."""
    dev = resolve_device(device)
    idx, tab = make_inputs(n_rows, taps, spread, blocks, seed, dev)
    out = gather_sum(idx, tab)
    # the JAX probe's oracle, on the host
    want = tab.cpu().numpy().reshape(-1)[idx.cpu().numpy()].sum(axis=0)
    err = float(np.abs(out.cpu().numpy() - want).max())
    dt = _back_to_back_s(lambda: gather_sum(idx, tab), iters)
    bags = idx.reshape(taps, -1).T.contiguous()
    column = tab.reshape(-1, 1)

    def library():
        return torch.nn.functional.embedding_bag(bags, column, mode="sum")

    lib_err = float((library()[:, 0] - out.reshape(-1)).abs().max())
    lib_dt = _back_to_back_s(library, iters)
    lanes = blocks * ROWS * LANES
    log(f"n_rows={n_rows} taps={taps} spread={spread} blocks={blocks}: "
        f"err={err:.2e} {dt * 1e3:.3f} ms = {lanes / dt / 1e6:.1f} "
        f"Mlane-samples/s (back to back)")
    return {"n_rows": n_rows, "taps": taps, "spread": spread,
            "blocks": blocks, "lanes": lanes, "iters": iters, "seed": seed,
            "device": str(dev), "err": err, "ms": dt * 1e3,
            "mlane_samples_per_s": lanes / dt / 1e6,
            **traffic(idx, tab.numel()),
            "library_ms": lib_dt * 1e3, "library_max_abs_err": lib_err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The big-texture gather probe (the repo's "
                    "tools/probe_bigtex.py) through kernel K4.")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain version)")
    for name in ("n-rows", "taps", "spread", "blocks", "iters"):
        ap.add_argument(f"--{name}", type=int, default=None,
                        help="run this one configuration (the others at "
                             "run's defaults) in place of the JAX probe's "
                             "list")
    args = ap.parse_args(argv)
    one = {k: v for k, v in vars(args).items()
           if k in ("n_rows", "taps", "spread", "blocks", "iters")
           and v is not None}
    results = []
    for cfg, tol in ((one, None),) if one else CONFIGS:
        res = run(**cfg, device=args.device,
                  log=lambda s: print(s, flush=True))
        if tol is not None and not res["err"] < tol:
            raise AssertionError(f"{cfg}: err {res['err']} >= {tol}")
        results.append(res)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
