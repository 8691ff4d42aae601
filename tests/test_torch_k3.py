"""Kernel K3's plain version (``ops/tri_intersect.py::
tri_closest_hit_ref``, the dense closest hit of the wavefront's brute-force
strategy) against the JAX package's Pallas kernel
``tri_closest_hit_pallas`` in interpret mode, on seeded rays and item
tables: 1, 7, 64 and 300 items, rays that miss everything, exact ties
(duplicated items: the lowest index wins), det = 0 items, and ray counts
that are not a multiple of the TPU kernel's 1,024-ray block.  The item
index must agree exactly and t, beta, gamma within rtol 1e-6, atol 1e-6.
XLA's CPU backend contracts the kernel's products into FMAs where the CPU
has them, which moves beta and gamma by up to 1.5e-4 relative where
Cramer's numerators cancel; so the JAX kernel runs in a subprocess of its
own with ``--xla_cpu_max_isa=SSE4_2`` (no FMA instructions), where it
computes the kernel's arithmetic as written.

The motion extension (a motion row per item, a time per ray: the origin
of each test is o + motion * time) against the JAX jnp route that takes
motion scenes (``ops/traverse.py::_brute_tri_best``'s (W, R) broadcast),
whose Cramer expansion rounds otherwise: the index equal, t, beta, gamma
within rtol 1e-5, atol 1e-5.
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu.ops.intersect import ray_triangle
from advanced_cpu_raytracing_tpu_torch.ops import tri_intersect as k3
from test_torch_common import REPO

CASES = [(1, 1000, False), (7, 1500, False), (64, 1031, False),
         (300, 2049, False), (64, 700, True)]

# the JAX kernel in interpret mode on the CPU without FMA instructions:
# reads the cases' inputs from argv[1], writes its outputs to argv[2]
_JAX_KERNEL = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from advanced_cpu_raytracing_tpu.ops.pallas.tri_intersect import (
    tri_closest_hit_pallas)
src = np.load(sys.argv[1])
out = {}
for k in range(len(src.files) // 5):
    args = [jnp.asarray(src[f"{n}{k}"]) for n in ("o", "d", "v0", "v1", "v2")]
    for n, x in zip("tibg", tri_closest_hit_pallas(*args, interpret=True)):
        out[f"{n}{k}"] = np.asarray(x)
np.savez(sys.argv[2], **out)
"""


def _table(w: int, seed: int):
    """Triangles around the origin: every 5th det = 0 (v1 = v0), every 7th
    a copy of item 0 (exact ties)."""
    g = np.random.default_rng(seed)
    v0 = g.uniform(-1.0, 1.0, (w, 3)).astype(np.float32)
    v1 = (v0 + g.uniform(-0.6, 0.6, (w, 3))).astype(np.float32)
    v2 = (v0 + g.uniform(-0.6, 0.6, (w, 3))).astype(np.float32)
    v1[4::5] = v0[4::5]
    for v in (v0, v1, v2):
        v[6::7] = v[0]
    return v0, v1, v2


def _rays(r: int, seed: int, table, miss: bool = False):
    """Rays from near (0, 0, 3) toward points of random items at
    barycentrics in [0, 0.7)^2, some outside the item (or, with ``miss``,
    away from them)."""
    g = np.random.default_rng(seed)
    v0, v1, v2 = table
    k = g.integers(0, len(v0), r)
    b, c = g.uniform(0.0, 0.7, (2, r, 1))
    target = v0[k] + b * (v1[k] - v0[k]) + c * (v2[k] - v0[k])
    o = (g.uniform(-0.3, 0.3, (r, 3)) + [0.0, 0.0, 3.0]).astype(np.float32)
    d = (target - o) * (-1.0 if miss else 1.0)
    return o, d.astype(np.float32)


def _port(o, d, v0, v1, v2, motion=None, time=None):
    t = (lambda x: None if x is None else torch.tensor(x))
    return [x.numpy() for x in k3.tri_closest_hit(
        t(o), t(d), t(v0), t(v1), t(v2), t(motion), t(time))]


def _case(k):
    w, r, miss = CASES[k]
    v0, v1, v2 = _table(w, w)
    o, d = _rays(r, w + 1, (v0, v1, v2), miss)
    return o, d, v0, v1, v2


@pytest.fixture(scope="module")
def jax_kernel(tmp_path_factory):
    """The JAX kernel's (t, idx, beta, gamma) on every case, from one
    subprocess."""
    tmp = tmp_path_factory.mktemp("k3")
    src = {f"{n}{k}": x for k in range(len(CASES))
           for n, x in zip(("o", "d", "v0", "v1", "v2"), _case(k))}
    np.savez(tmp / "in.npz", **src)
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _JAX_KERNEL, str(tmp / "in.npz"),
                           str(tmp / "out.npz")], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = np.load(tmp / "out.npz")
    return [tuple(out[f"{n}{k}"] for n in "tibg") for k in range(len(CASES))]


@pytest.mark.parametrize("k", range(len(CASES)))
def test_plain_version_matches_the_jax_kernel(jax_kernel, k):
    w, r, miss = CASES[k]
    o, d, v0, v1, v2 = _case(k)
    t, idx, beta, gamma = _port(o, d, v0, v1, v2)
    jt, jidx, jbeta, jgamma = jax_kernel[k]
    np.testing.assert_array_equal(idx, jidx)
    hit = idx >= 0
    if miss:
        assert not hit.any()
    else:
        assert 0.2 < hit.mean() < 1.0
    assert np.isinf(t[~hit]).all() and np.isinf(jt[~hit]).all()
    for a, b in ((t, jt), (beta, jbeta), (gamma, jgamma)):
        np.testing.assert_allclose(a[hit], b[hit], rtol=1e-6, atol=1e-6)
    if w >= 7 and not miss:  # ties: no winner is a later copy of item 0
        assert not np.isin(idx, np.arange(6, w, 7)).any()
        assert (idx == 0).any()


def test_det_zero_items_never_win():
    v0, v1, v2 = _table(64, 3)
    o, d = _rays(512, 4, (v0, v1, v2))
    v1[:] = v0  # every item degenerate
    t, idx, beta, gamma = _port(o, d, v0, v1, v2)
    assert (idx == -1).all() and np.isinf(t).all()
    assert (beta == 0).all() and (gamma == 0).all()


@pytest.mark.parametrize("w", [7, 300])
def test_motion_matches_the_jax_broadcast(w):
    """K3's motion rows against the JAX jnp route's origin offset and
    argmin (traverse.py:122-144)."""
    v0, v1, v2 = _table(w, 10 + w)
    o, d = _rays(1200, 11, (v0, v1, v2))
    g = np.random.default_rng(12)
    motion = g.normal(0.0, 0.3, (w, 3)).astype(np.float32)
    time = g.uniform(0.0, 1.0, 1200).astype(np.float32)
    t, idx, beta, gamma = _port(o, d, v0, v1, v2, motion, time)
    ow = jnp.asarray(o)[None] + jnp.asarray(motion)[:, None] * jnp.asarray(
        time)[None, :, None]
    jt, jb, jg, valid = ray_triangle(
        ow, jnp.asarray(d)[None], jnp.asarray(v0)[:, None],
        jnp.asarray(v1)[:, None], jnp.asarray(v2)[:, None])
    jt = jnp.where(valid, jt, jnp.inf)
    best = np.asarray(jnp.argmin(jt, axis=0))
    cols = np.arange(1200)
    jt, jb, jg = (np.asarray(x)[best, cols] for x in (jt, jb, jg))
    hit = np.isfinite(jt)
    np.testing.assert_array_equal(idx, np.where(hit, best, -1))
    assert 0.1 < hit.mean() < 1.0
    for a, b in ((t, jt), (beta, jb), (gamma, jg)):
        np.testing.assert_allclose(a[hit], b[hit], rtol=1e-5, atol=1e-5)
    # no motion: the same as the static table
    still = _port(o, d, v0, v1, v2, np.zeros_like(motion), time)
    for a, b in zip(still, _port(o, d, v0, v1, v2)):
        np.testing.assert_array_equal(a, b)


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    table = _table(7, 1)
    v0, v1, v2 = (torch.tensor(x) for x in table)
    o, d = (torch.tensor(x) for x in _rays(64, 2, table))
    before = dict(k3.LAUNCHES)
    got = k3.tri_closest_hit(o, d, v0, v1, v2)
    ref = k3.tri_closest_hit_ref(o, d, v0, v1, v2)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert k3.LAUNCHES == before  # the plain version counts no launch
    with pytest.raises(ValueError, match="go together"):
        k3.tri_closest_hit(o, d, v0, v1, v2, motion=v0)


@pytest.mark.parametrize("motion", [False, True])
def test_item_table_is_the_jax_kernels_subtractions(motion):
    """The kernel's 16-float rows (v0, e1, e2, the motion row, four zeros)
    hold bit for bit what the JAX kernel computes per item
    (tri_intersect.py:58-63: e1 = v0 - v1, e2 = v0 - v2, in f32), on the
    2,048-item random table with det = 0 items and exact ties."""
    v0, v1, v2 = _table(2048, 27)
    mo = (np.random.default_rng(3).normal(0, 0.2, (2048, 3)).astype(np.float32)
          if motion else None)
    tab = k3.item_table(*(torch.tensor(x) for x in (v0, v1, v2)),
                        None if mo is None else torch.tensor(mo)).numpy()
    assert tab.shape == (2048, k3.ITEM_COLS) and tab.dtype == np.float32
    want = [np.asarray(v0), np.asarray(jnp.asarray(v0) - jnp.asarray(v1)),
            np.asarray(jnp.asarray(v0) - jnp.asarray(v2)),
            np.zeros((2048, 3), np.float32) if mo is None else mo,
            np.zeros((2048, 4), np.float32)]
    np.testing.assert_array_equal(tab.view(np.uint32), np.concatenate(
        want, axis=1).view(np.uint32))
    k = np.arange(2048)
    zero = (k % 5 == 4) & (k % 7 != 6)  # the det = 0 items (not ties): e1 = 0
    assert (tab[zero, 3:6] == 0).all()
