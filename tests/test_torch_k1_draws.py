"""The K1b-K1d kernels' draws by the Philox block, on this host's CPU.

The kernels make a node's draws through a cursor that keeps the last
Philox4x32-10 block (ray, iteration, slot // 4) it computed and computes
another only when a slot leaves it (``csrc/mega_pt.cu::Draws``).  The
plain version counts, in the kernel's order, the draws the kernel makes
(``draws``: one Philox evaluation each before the cursor) and the blocks
the cursor computes for them (``philox_blocks``).  These tests hold both
counts to hand counts on rays whose nodes are known: ``scenes/feat_pt.xml``
at depth 0 (one node, the mesh light's three draws) and the env scenes
whose candidates start at each word of a block
(``scene/feature_scenes.py::env_aligned_xml``: the area and mesh lights'
draws, then the env candidates until one lies in the unit ball above the
floor, replayed here from the draw table).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu_torch.ops import megakernel as mk
from advanced_cpu_raytracing_tpu_torch.ops.rng import philox_table
from advanced_cpu_raytracing_tpu_torch.render.renderer import (
    _mega_build_cached,
    options_for_camera,
)
from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import (
    ENV_ALIGNED_LIGHTS,
    env_aligned_xml,
    k1d_scenes,
)
from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from test_torch_common import REPO

CPU = torch.device("cpu")


def _tables(path):
    cfg = load_scene(str(path))
    pack = pack_scene(cfg, device=CPU)
    return _mega_build_cached(pack, options_for_camera(cfg, cfg.cameras[0]),
                              CPU)


def _down_rays(n, y, x_span, z_span, seed):
    """``n`` rays straight down from height ``y`` over a box of x and z."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(*x_span, n), np.full(n, y),
                  rng.uniform(*z_span, n)], -1).astype(np.float32)
    d = np.tile(np.float32([0.0, -1.0, 0.0]), (n, 1))
    return torch.from_numpy(o), torch.from_numpy(d)


def blocks_of(slots) -> int:
    """The Philox blocks a cursor computes for draws ``slots`` made in
    that order: one each time a slot leaves the block of the one before."""
    blk, n = -1, 0
    for s in slots:
        if s >> 2 != blk:
            blk, n = s >> 2, n + 1
    return n


def test_blocks_of_counts_block_changes():
    assert blocks_of([]) == 0
    assert blocks_of([1, 2, 3, 4, 5]) == 2
    assert blocks_of([5, 6, 3, 4, 5, 8]) == 4
    assert blocks_of(range(3, 51)) == 13


def test_feat_pt_depth_0_draws_three_words_from_two_blocks(tmp_path):
    """At depth 0 a floor hit of feat_pt.xml draws the mesh light's face
    and barycentrics (slots 3, 4, 5) and no GI pair: blocks 0 and 1."""
    path = tmp_path / "feat_pt_d0.xml"
    path.write_text((REPO / "scenes" / "feat_pt.xml").read_text().replace(
        "<MaxRecursionDepth>4</MaxRecursionDepth>",
        "<MaxRecursionDepth>0</MaxRecursionDepth>"))
    mc, tab, ctab = _tables(path)
    assert mc.kernel == "mega_pt" and mc.pt and mc.pt_nee
    n = 96
    o, d = _down_rays(n, 5.0, (-4.0, 4.0), (-4.0, 4.0), seed=1)
    stats: dict = {}
    rad = mk.mega_trace_ref(mc, tab, ctab, o, d, stats=stats, draws=philox_table(
        3, 1, n, mc.max_iters, mc.n_draws))
    assert stats["traces"] == n and stats.get("gi_traces", 0) == 0
    assert stats["draws"] == 3 * n and stats["philox_blocks"] == 2 * n
    assert bool((rad.sum(dim=1) > 0).all())


def test_feat_pt_paths_need_fewer_blocks_than_draws(tmp_path):
    """On feat_pt.xml's depth-4 paths a node with a GI pair and the mesh
    light draws slots 1-5 from blocks 0 and 1: the cursor computes at most
    half as many blocks as a Philox per draw would, and at least one per
    node that draws."""
    mc, tab, ctab = _tables(REPO / "scenes" / "feat_pt.xml")
    n = 128
    o, d = _down_rays(n, 5.0, (-4.0, 4.0), (-4.0, 4.0), seed=2)
    stats: dict = {}
    mk.mega_trace_ref(mc, tab, ctab, o, d, stats=stats, draws=philox_table(
        5, 0, n, mc.max_iters, mc.n_draws))
    assert stats["traces"] <= stats["philox_blocks"] <= stats["draws"] / 2
    # a GI pair (blocks 0) and the mesh light (0, 1) on each GI ray's node
    # but the last, where only the light draws
    assert stats["philox_blocks"] >= 2 * stats["gi_traces"]


def _replay_env(draws, base_env, n):
    """Each ray's env candidates on the floor (normal +y) from the draw
    table: the number tried (the first in the unit ball with y > 0, else
    all 16) and whether none was taken."""
    k = np.full(n, 16)
    found = np.zeros(n, bool)
    for ci in range(16):
        c = [2.0 * draws[base_env + 3 * ci + j] - 1.0 for j in range(3)]
        ok = ((c[0] * c[0] + c[1] * c[1] + c[2] * c[2] <= 1.0)
              & (c[1] > 0.0)).numpy() & ~found
        k[ok] = ci + 1
        found |= ok
    return k, ~found


@pytest.mark.parametrize("align", sorted(ENV_ALIGNED_LIGHTS))
@pytest.mark.parametrize("exhaust", [False, True], ids=["philox", "exhausted"])
def test_env_draws_at_every_alignment(tmp_path, align, exhaust):
    """A floor hit of the env scene whose candidates start at word
    ``align`` of a block: the area lights' pairs, the mesh light's three
    draws, then three per env candidate; the blocks are the hand count of
    that sequence.  With ``exhaust`` every candidate is (-1, -1, -1),
    outside the ball: all 16 are drawn and none is taken."""
    k1d_scenes(tmp_path)  # the env map
    path = tmp_path / f"env_aligned{align}.xml"
    path.write_text(env_aligned_xml(align))
    mc, tab, ctab = _tables(path)
    n_ml, n_area = ENV_ALIGNED_LIGHTS[align]
    assert (mc.ml_lights.shape[0], mc.area_lights.shape[0]) == (n_ml, n_area)
    base_env = 3 + 3 * n_ml + 2 * n_area
    assert base_env % 4 == align
    n = 96
    o, d = _down_rays(n, 0.5, (-4.0, 4.0), (1.5, 3.5), seed=3 + align)
    draws = philox_table(11, align, n, mc.max_iters, mc.n_draws)
    if exhaust:
        draws[base_env:base_env + mk.ENV_DRAWS] = 0.0
    stats: dict = {}
    rad = mk.mega_trace_ref(mc, tab, ctab, o, d, draws=draws, stats=stats)
    k, none = _replay_env(draws, base_env, n)
    lights = [s for a in range(n_area) for s in (3 + 3 * n_ml + 2 * a,
                                                 4 + 3 * n_ml + 2 * a)]
    lights += [s for m in range(n_ml) for s in (3 + 3 * m, 4 + 3 * m, 5 + 3 * m)]
    want = sum(blocks_of(lights + list(range(base_env, base_env + 3 * int(ki))))
               for ki in k)
    assert stats["traces"] == n
    assert stats["draws"] == n * len(lights) + 3 * int(k.sum())
    assert stats["philox_blocks"] == want
    assert stats["env_candidates"] == int(k.sum())
    assert stats["env_exhausted"] == int(none.sum())
    if exhaust:
        assert bool(none.all()) and bool((k == 16).all())
    else:
        assert 0 < stats["philox_blocks"] < stats["draws"] / 2
    assert bool(torch.isfinite(rad).all())
