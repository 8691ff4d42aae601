"""Kernel K4's plain version (``ops/bigtex_gather.py::gather_sum_ref``, the
gather-sum of the big-texture probe) against the Pallas kernel of the
repo's ``tools/probe_bigtex.py`` (``_kernel``, loaded by path) in TPU
interpret mode, and against that probe's numpy oracle; the wrapper on CPU
tensors, lanes with indices outside the table, and the port's probe tool
(``tools/probe_bigtex.py``) on the CPU.  Every sum is taken left to right
in tap order on both sides, so every comparison is exact."""

from __future__ import annotations

import functools
import importlib.util
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from advanced_cpu_raytracing_tpu_torch.ops import bigtex_gather as k4
from advanced_cpu_raytracing_tpu_torch.tools import probe_bigtex
from test_torch_common import REPO

ROWS, LANES = 8, 128


def _jax_probe():
    """The repo's tools/probe_bigtex.py, loaded by path (tools/ is not a
    package)."""
    spec = importlib.util.spec_from_file_location(
        "probe_bigtex_jax", REPO / "tools" / "probe_bigtex.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(n_rows, taps, spread, blocks, seed):
    """The JAX probe's index pattern (run, lines 74-81), from numpy."""
    g = np.random.default_rng(seed)
    tab = g.uniform(0.0, 1.0, (n_rows, LANES)).astype(np.float32)
    base = g.integers(0, n_rows - spread - 1, (blocks, 1, 1))
    rows = base[None] + g.integers(0, spread, (taps, blocks, ROWS, LANES))
    lane = g.integers(0, LANES, (taps, blocks, ROWS, LANES))
    return (rows * LANES + lane).astype(np.int32), tab


def _jax_kernel(idx, tab, wn):
    """The JAX ``_kernel`` in a pl.pallas_call with the specs of the JAX
    probe's run (lines 84-97), in TPU interpret mode."""
    taps, blocks = idx.shape[:2]
    n_rows = tab.shape[0]
    f = pl.pallas_call(
        functools.partial(_jax_probe()._kernel, wn=wn, n_rows=n_rows,
                          taps=taps),
        grid=(blocks,),
        in_specs=[
            pl.BlockSpec((taps, 1, ROWS, LANES), lambda i: (0, i, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=pl.BlockSpec((1, ROWS, LANES), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((blocks, ROWS, LANES), jnp.float32),
        scratch_shapes=[pltpu.VMEM((wn, LANES), jnp.float32),
                        pltpu.SemaphoreType.DMA(())],
        interpret=pltpu.InterpretParams(),
    )
    return np.asarray(f(jnp.asarray(idx), jnp.asarray(tab)))


# (taps, spread, wn, n_rows, blocks)
JAX_CASES = [(1, 4, 8, 64, 2), (2, 16, 8, 128, 3), (4, 64, 16, 512, 4)]


@pytest.mark.parametrize("taps,spread,wn,n_rows,blocks", JAX_CASES)
def test_plain_version_equals_the_jax_kernel(taps, spread, wn, n_rows, blocks):
    idx, tab = _inputs(n_rows, taps, spread, blocks, seed=taps)
    want = _jax_kernel(idx, tab, wn)
    got = k4.gather_sum_ref(torch.as_tensor(idx), torch.as_tensor(tab))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("taps,spread,n_rows,blocks",
                         [(1, 4, 512, 64), (3, 16, 1024, 8), (4, 256, 8192, 16)])
def test_plain_version_equals_the_numpy_oracle(taps, spread, n_rows, blocks):
    """The JAX probe's oracle (line 107): numpy's sum over the tap axis,
    which adds the taps in order."""
    idx, tab = _inputs(n_rows, taps, spread, blocks, seed=10 + taps)
    want = tab.reshape(-1)[idx].sum(axis=0)
    got = k4.gather_sum_ref(torch.as_tensor(idx), torch.as_tensor(tab))
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_sum_on_cpu_tensors_runs_the_plain_version():
    idx, tab = _inputs(256, 4, 16, 3, seed=5)
    idx, tab = torch.as_tensor(idx), torch.as_tensor(tab)
    before = dict(k4.LAUNCHES)
    got = k4.gather_sum(idx, tab)
    assert k4.LAUNCHES == before  # no kernel launched on the CPU
    assert got.shape == (3, ROWS, LANES) and got.dtype == torch.float32
    assert torch.equal(got, k4.gather_sum_ref(idx, tab))
    # lanes of any shape; the table read flat
    flat = k4.gather_sum(idx.reshape(4, -1), tab.reshape(-1))
    assert torch.equal(flat, got.reshape(-1))
    with pytest.raises(ValueError, match="tap axis"):
        k4.gather_sum(idx[:0], tab)
    with pytest.raises(ValueError, match="empty table"):
        k4.gather_sum(idx, tab[:0])


def test_edge_lanes_and_indices_outside_the_table():
    """Index 0, the last index and a tap repeated in one lane are summed
    exactly; a lane with any index outside the table is NaN (the JAX
    kernel's loop never serves it)."""
    n_rows = 64
    n = n_rows * LANES
    tab = torch.as_tensor(
        np.random.default_rng(3).uniform(0, 1, (n_rows, LANES)).astype(
            np.float32))
    flat = tab.reshape(-1)
    last = n - 1
    idx = torch.tensor([[0, last, 7, 7, -1, n, 5, 2**31 - 1, -2**31],
                        [last, 0, 7, 9, 3, 4, n + 200, 6, 0]],
                       dtype=torch.int32)
    got = k4.gather_sum(idx, tab)
    want_in = [flat[0] + flat[last], flat[last] + flat[0], flat[7] + flat[7],
               flat[7] + flat[9]]
    assert torch.equal(got[:4], torch.stack(want_in))
    assert torch.isnan(got[4:]).all()


def test_make_inputs_follows_the_probe_pattern():
    idx, tab = probe_bigtex.make_inputs(300, 3, 20, 5, seed=1, device="cpu")
    assert idx.shape == (3, 5, ROWS, LANES) and idx.dtype == torch.int32
    assert tab.shape == (300, LANES) and tab.dtype == torch.float32
    rows = idx // LANES
    lo = rows.amin(dim=(0, 2, 3))
    hi = rows.amax(dim=(0, 2, 3))
    assert (lo >= 0).all() and (hi < 300).all() and (hi - lo < 20).all()
    again, _ = probe_bigtex.make_inputs(300, 3, 20, 5, seed=1, device="cpu")
    assert torch.equal(idx, again)


def test_traffic_counts_the_touched_sectors():
    idx = torch.tensor([[0, 7, 8, 100], [1, 15, 16, 100]], dtype=torch.int32)
    tr = probe_bigtex.traffic(idx)
    # sectors of 8 floats: 0, 1, 2 and 12
    assert tr["sectors"] == 4
    assert tr["bytes"] == 4 * 2 * 4 + 4 * 4 + 32 * 4
    assert tr["bound_by"] == "bytes"
    assert tr["bound_ms"] == pytest.approx(tr["bytes"] / 3.35e12 * 1e3)


def test_run_on_the_cpu_matches_the_oracle_and_prints_the_probe_line():
    lines = []
    res = probe_bigtex.run(n_rows=512, taps=4, spread=16, blocks=4, iters=2,
                           device="cpu", log=lines.append)
    assert res["err"] == 0.0
    assert res["library_max_abs_err"] < 1e-6
    assert res["lanes"] == 4 * ROWS * LANES and res["device"] == "cpu"
    for key in ("ms", "mlane_samples_per_s", "bound_ms", "library_ms",
                "sectors", "bytes"):
        assert res[key] > 0, key
    assert len(lines) == 1
    assert lines[0].startswith("n_rows=512 taps=4 spread=16 blocks=4: "
                               "err=0.00e+00 ")
    assert lines[0].endswith(" Mlane-samples/s (back to back)")


def test_the_cli_runs_one_small_configuration(capsys):
    assert probe_bigtex.main(["--device", "cpu", "--n-rows", "256", "--taps",
                              "2", "--spread", "8", "--blocks", "2",
                              "--iters", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])
    assert len(summary) == 1 and summary[0]["err"] == 0.0
    assert summary[0]["taps"] == 2 and out[0].startswith("n_rows=256 taps=2")


def test_the_default_list_is_the_jax_probes_main_and_a_frame():
    assert [c for c, _ in probe_bigtex.ASSERTED] == [
        dict(n_rows=512, taps=1, spread=4, blocks=64, iters=5),
        dict(n_rows=8192, taps=4, spread=16, blocks=512)]
    assert [t for _, t in probe_bigtex.ASSERTED] == [1e-6, 1e-5]
    assert [c["spread"] for c in probe_bigtex.SWEEP] == [8, 64, 256]
    assert probe_bigtex.CONFIGS == (
        *probe_bigtex.ASSERTED, *((c, None) for c in probe_bigtex.SWEEP),
        (probe_bigtex.FRAME, None))
    frame = probe_bigtex.FRAME
    assert frame["blocks"] * ROWS * LANES == 800 * 800 * 16
    assert frame["n_rows"] * LANES == 3 * 2**24
