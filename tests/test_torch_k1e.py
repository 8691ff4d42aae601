"""Large geometry (K1e) of the PyTorch port against the JAX package, on
this host's CPU.

Past ``FLAT_MAX_FACES`` work items ``build_mega`` adds a tree of 4-wide
nodes over leaves of ``LEAF_ROWS`` (4) rows of the triangle table, and the
CUDA kernels walk it in place of the 128-face chunk sweep (the JAX kernel
streams its table from HBM instead).
Here, with the thresholds of both packages lowered as the JAX kernel's own
streamed-geometry tests lower theirs:

* ``mega_trace_ref`` on ``scene/synth.py::terrain_scene(n=33)`` (2,048
  faces), untextured and textured, against the JAX streamed kernel in
  interpret mode on 1,024 seeded primary rays: mean |d| < 0.01 and 99.9%
  quantile < 0.5 (the K1a/K1d bound); the Cornell mesh-light scene on the
  JAX kernel's own host draw table within 1e-4;
* the tree tables: every row in exactly one leaf of at most LEAF_ROWS
  consecutive rows, leaf boxes holding their faces swept over the motion, each node's
  child boxes holding that child's children, every node reached once, the
  stack need within the kernels' stack;
* ``TreeWalker`` (the kernels' walk on the host) against the brute force:
  the same closest hit and winning row on the terrain at pixel centres, on
  a moving terrain, and on a constructed tie on a shared edge whose faces
  lie in different leaves;
* the host BVH builder against the JAX native builder, the pack of a mesh
  past 4,096 faces against the JAX pack, and ``render_camera`` past the
  lowered threshold.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advanced_cpu_raytracing_tpu.ops.pallas.megakernel as jmk
from advanced_cpu_raytracing_tpu.accel.bvh import build_bvh as jax_build_bvh
from advanced_cpu_raytracing_tpu.native import bindings as jax_native
from advanced_cpu_raytracing_tpu.ops.pallas.megakernel import LANES, TILE
from advanced_cpu_raytracing_tpu.render import camera as jax_camera
from advanced_cpu_raytracing_tpu.render.renderer import (
    options_for_camera as jax_options_for_camera,
)
from advanced_cpu_raytracing_tpu.scene.pack import pack_scene as jax_pack_scene
from advanced_cpu_raytracing_tpu.scene.synth import terrain_scene as jax_terrain
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene as jax_load_scene
from advanced_cpu_raytracing_tpu_torch.accel import bvh
from advanced_cpu_raytracing_tpu_torch.ops import megakernel as mk
from advanced_cpu_raytracing_tpu_torch.render import renderer
from advanced_cpu_raytracing_tpu_torch.render.camera import (
    build_camera,
    generate_rays,
)
from advanced_cpu_raytracing_tpu_torch.scene.pack import (
    FIELD_NAMES,
    _face_props,
    pack_scene,
)
from advanced_cpu_raytracing_tpu_torch.scene.synth import terrain_scene
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from tests.scene_builders import cornell_pt_xml
from test_torch_common import assert_tree_invariants

torch.set_num_threads(1)

N_RAYS = 1024


def _jax_rays(jcfg, n, seed):
    cam = jax_camera.build_camera(jcfg.cameras[0])
    rng = np.random.default_rng(seed)
    px = jnp.asarray(rng.uniform(0, cam.width, n).astype(np.float32))
    py = jnp.asarray(rng.uniform(0, cam.height, n).astype(np.float32))
    return jax_camera.generate_rays(cam, px, py, jnp.zeros((n, 2)), dof=False)


def _moving_terrain(n=17):
    cfg = terrain_scene(n=n, width=64, height=48)
    cfg.meshes[0].motion_blur = np.array([0.4, 0.0, 0.2])
    return cfg


def _tables(cfg, monkeypatch, flat_max):
    monkeypatch.setattr(mk, "FLAT_MAX_FACES", flat_max)
    pack = pack_scene(cfg, device="cpu")
    return mk.build_mega(pack, renderer.options_for_camera(cfg, cfg.cameras[0]),
                         device="cpu")


@pytest.mark.parametrize("textured", [False, True], ids=["plain", "textured"])
def test_plain_version_matches_jax_streamed_terrain(monkeypatch, textured):
    """The JAX kernel streams the 2,048-face terrain past a 512-face
    ceiling; the port's plain version (the kernels' reference) renders the
    same rays through a scene with a tree."""
    jcfg = jax_terrain(n=33, width=64, height=48, textured=textured)
    jpack = jax_pack_scene(jcfg)
    monkeypatch.setattr(jmk, "_VMEM_MAX_FACES", 512)
    jmc, jtab, jctab, jimg = jmk.build_mega(
        jpack, jax_options_for_camera(jcfg, jcfg.cameras[0]))
    assert jmc.stream_geo
    o, d = _jax_rays(jcfg, N_RAYS, seed=2)
    want = np.asarray(jmk.mega_trace(jmc, jtab, jctab, o, d, interpret=True,
                                     img_tab=jimg))
    mc, tab, ctab = _tables(terrain_scene(n=33, width=64, height=48,
                                          textured=textured), monkeypatch, 512)
    assert mc.variant == ("mega_tex_tree" if textured else "mega_whitted_tree")
    got = mk.mega_trace_ref(mc, tab, ctab, torch.as_tensor(np.array(o)),
                            torch.as_tensor(np.array(d))).numpy()
    diff = np.abs(got - want)
    assert np.isfinite(got).all()
    assert diff.mean() < 0.01, diff.mean()
    assert np.quantile(diff, 0.999) < 0.5, np.quantile(diff, 0.999)


def test_plain_version_matches_jax_streamed_meshlight(tmp_path, monkeypatch):
    """Mesh-light NEE with the geometry past an 8-face ceiling, both fed
    the JAX kernel's host draw table."""
    (tmp_path / "pt.xml").write_text(
        cornell_pt_xml(depth=2, res=32, spp=1, params="NextEventEstimation"))
    path = str(tmp_path / "pt.xml")
    jcfg = jax_load_scene(path)
    monkeypatch.setattr(jmk, "_VMEM_MAX_FACES", 8)
    jmc, jtab, jctab, jimg = jmk.build_mega(
        jax_pack_scene(jcfg), jax_options_for_camera(jcfg, jcfg.cameras[0]),
        host_rng=True)
    assert jmc.stream_geo and jmc.mesh_lights
    n = 512
    o, d = _jax_rays(jcfg, n, seed=6)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jmk.mega_trace(jmc, jtab, jctab, o, d, interpret=True,
                                     seed=0, rng_key=key, img_tab=jimg))
    r_pad = -(-n // TILE) * TILE
    table = np.array(jax.random.uniform(
        key, (jmc.max_iters * jmc.n_draws, r_pad // LANES, LANES),
        jnp.float32)).reshape(-1, r_pad)[:, :n]
    mc, tab, ctab = _tables(load_scene(path), monkeypatch, 8)
    assert mc.variant == "mega_pt_tree" and mc.ml_lights.shape[0] == 1
    got = mk.mega_trace_ref(mc, tab, ctab, torch.as_tensor(np.array(o)),
                            torch.as_tensor(np.array(d)),
                            draws=torch.as_tensor(table))
    torch.testing.assert_close(got, torch.as_tensor(want), rtol=1e-4,
                               atol=1e-4)


def _tree_scene(name):
    if name == "terrain":
        return terrain_scene(n=33, width=64, height=48), 512
    if name == "moving_terrain":
        return _moving_terrain(), 0
    cfg = terrain_scene(n=65, width=64, height=48, textured=True)
    return cfg, 4096


@pytest.mark.parametrize("name", ["terrain", "moving_terrain",
                                  "textured_8192"])
def test_tree_tables_hold_their_invariants(monkeypatch, name):
    cfg, flat_max = _tree_scene(name)
    mc, tab, _ = _tables(cfg, monkeypatch, flat_max)
    assert mc.n_tri > flat_max and mc.tree is not None
    assert mc.faces_move == (name == "moving_terrain")
    assert_tree_invariants(mc, tab)


def test_tree_deeper_than_the_stack_raises(monkeypatch):
    monkeypatch.setattr(mk, "TREE_STACK", 4)
    with pytest.raises(ValueError, match="kernels' stack holds 4"):
        _tables(terrain_scene(n=33, width=64, height=48), monkeypatch, 512)


def _brute(mc, tab, ctab, o, d, tau=None):
    geo = mk._Geometry(mc, tab, ctab, None)
    t, *_, hit, win = geo.trace(*o.T, *d.T, tau=tau, want_win=True)
    return t, hit, win


def _assert_walker_is_brute_force(mc, tab, ctab, o, d, tau=None):
    walker = mk.TreeWalker(mc, tab)
    t, hit, win = _brute(mc, tab, ctab, o, d, tau)
    assert hit.any()
    w = walker.walk(o, d, tau=tau)
    assert w["row"].tolist() == win.tolist()
    assert torch.equal(w["t"][hit], t[hit])
    assert int(w["tri_tests"].max()) < mc.n_tri  # the walk culls
    # what it marks as read: the winners, among the rows it tested
    reads = walker.reads
    assert reads["won"].nonzero().squeeze(1).tolist() == sorted(
        set(win[win >= 0].tolist()))
    assert not (reads["won"] & ~reads["rows"]).any()
    assert 0 < int(reads["rows"].sum()) <= int(w["tri_tests"].sum())
    assert bool(reads["nodes"][0])
    # a shadow query without a limit is blocked where the ray hits a face
    far = torch.full((len(o),), 1e30)
    assert walker.walk(o, d, limit=far, tau=tau)["blocked"].tolist() == (
        win >= 0).tolist()
    # one ray at a time, the same walk
    for i in range(0, len(o), max(1, len(o) // 8)):
        one = walker.walk(o[i:i + 1], d[i:i + 1],
                          tau=None if tau is None else tau[i:i + 1])
        for key in ("row", "t", "slab_tests", "tri_tests"):
            assert one[key][0] == w[key][i], (key, i)


def test_walker_matches_brute_force_on_the_terrain(monkeypatch):
    """Pixel-centre rays of the regular grid, where shared edges give
    ties."""
    cfg = terrain_scene(n=33, width=64, height=48)
    mc, tab, ctab = _tables(cfg, monkeypatch, 512)
    cam = build_camera(cfg.cameras[0], device="cpu")
    idx = torch.arange(0, 64 * 48, 3)
    o, d = generate_rays(cam, (idx % 64).float() + 0.5,
                         (idx // 64).float() + 0.5)
    _assert_walker_is_brute_force(mc, tab, ctab, o, d)


def test_walker_matches_brute_force_on_a_moving_terrain(monkeypatch):
    """Each ray at its own time: the walk tests the unmoved origin against
    the swept leaf boxes, then each face at its moved origin."""
    cfg = _moving_terrain()
    mc, tab, ctab = _tables(cfg, monkeypatch, 0)
    cam = build_camera(cfg.cameras[0], device="cpu")
    rng = np.random.default_rng(4)
    n = 512
    o, d = generate_rays(cam, torch.as_tensor(rng.uniform(0, 64, n), dtype=torch.float32),
                         torch.as_tensor(rng.uniform(0, 48, n), dtype=torch.float32))
    tau = torch.as_tensor(rng.uniform(0, 1, n), dtype=torch.float32)
    _assert_walker_is_brute_force(mc, tab, ctab, o, d, tau)
    # the motion changes hits: the walk is not the static one
    static = _brute(mc, tab, ctab, o, d)[2]
    assert (static != _brute(mc, tab, ctab, o, d, tau)[2]).any()


def test_walker_keeps_the_lowest_row_on_a_shared_edge_tie(monkeypatch):
    """A flat grid and rays straight down onto its vertices and the
    midpoints of its edges: every face around the point is hit at exactly
    t = 1.  Where those faces lie in different leaves, the walk may reach a
    higher row first; it must still return the lowest, as the sequential
    sweep does."""
    cfg = terrain_scene(n=9, width=64, height=48)
    cfg.meshes[0].vertices[:, 1] = 0.0
    mc, tab, ctab = _tables(cfg, monkeypatch, 0)
    verts = tab[:mc.n_tri, 0:9].reshape(-1, 3, 3)
    rays_o, rays_d, pairs = [], [], []
    for x in np.arange(-7.0, 8.0, 1.0):
        for z in np.arange(-15.0, 0.0, 1.0):
            o = torch.tensor([[x, 1.0, z]])
            d = torch.tensor([[0.0, -1.0, 0.0]])
            t, valid = mk._tri_hit(verts[:, 0].T, verts[:, 1].T, verts[:, 2].T,
                                   *(c[:, None] for c in (*o.T, *d.T)))
            rows = torch.where(valid[0] & (t[0] == 1.0))[0]
            if len(set((rows // mc.tree_leaf_rows).tolist())) > 1:
                rays_o.append(o)
                rays_d.append(d)
                pairs.append(rows)
    assert len(pairs) > 4, "no tie across leaves"
    o, d = torch.cat(rays_o), torch.cat(rays_d)
    _assert_walker_is_brute_force(mc, tab, ctab, o, d)
    _, _, win = _brute(mc, tab, ctab, o, d)
    assert [int(w) for w in win] == [int(p.min()) for p in pairs]


def test_render_camera_takes_a_scene_past_the_threshold(monkeypatch):
    """Past the (lowered) threshold the scene gets a tree and renders on
    the CPU; the plain version's brute force gives the flat scene's
    frame."""
    cfg = terrain_scene(n=17, width=24, height=16)
    monkeypatch.setattr(mk, "FWD_FLAT_MAX_FACES", 1 << 20)
    flat = renderer.render_camera(pack_scene(cfg, device="cpu"), cfg,
                                  cfg.cameras[0], device="cpu")
    monkeypatch.setattr(mk, "FWD_FLAT_MAX_FACES", 0)
    pack = pack_scene(cfg, device="cpu")
    opts = renderer.options_for_camera(cfg, cfg.cameras[0])
    assert mk.mega_missing(pack.static, opts, pack) == []
    assert renderer._mega_build_cached(pack, opts, torch.device("cpu"))[0].tree is not None
    img = renderer.render_camera(pack, cfg, cfg.cameras[0], device="cpu")
    np.testing.assert_array_equal(img, flat)


def _terrain_faces(n):
    cfg = terrain_scene(n=n)
    _, center, _, bb_min, bb_max = _face_props(
        np.asarray(cfg.meshes[0].vertices, np.float64),
        np.asarray(cfg.meshes[0].faces, np.int64))
    return bb_min, bb_max, center


@pytest.mark.parametrize("n", [65, 257], ids=["8192", "131072"])
def test_native_builder_equals_jax_native_builder(n):
    fmin, fmax, ctr = _terrain_faces(n)
    want = jax_native.build_bvh_native(fmin, fmax, ctr)
    assert want is not None, "the JAX native builder did not load"
    got = bvh.build_bvh(fmin, fmax, ctr)
    assert len(ctr) >= bvh.NATIVE_MIN_FACES
    for field in ("order", "node_min", "node_max", "node_left", "node_right",
                  "node_first", "node_count"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field),
                                      err_msg=field)
    assert got.max_depth == want.max_depth
    # and the JAX package's own entry point takes the same path
    np.testing.assert_array_equal(jax_build_bvh(fmin, fmax, ctr).order, got.order)


def test_native_builder_failure_raises_with_the_compiler_output(tmp_path,
                                                                 monkeypatch):
    bad = tmp_path / "bvh_builder.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(bvh, "_SOURCE", bad)
    monkeypatch.setattr(bvh, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(bvh, "_LIB", None)
    fmin, fmax, ctr = _terrain_faces(65)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on bvh_builder.cpp"):
        bvh.build_bvh(fmin, fmax, ctr)


def test_pack_of_a_mesh_past_4096_faces_equals_jax():
    cfg = terrain_scene(n=65, textured=True)
    jp = jax_pack_scene(jax_terrain(n=65, textured=True))
    tp = pack_scene(cfg, device="cpu")
    assert dataclasses.asdict(tp.static) == dataclasses.asdict(jp.static)
    bad = [name for name in FIELD_NAMES
           if not np.array_equal(getattr(tp, name).numpy(),
                                 np.asarray(getattr(jp, name)))
           or getattr(tp, name).numpy().dtype != np.asarray(getattr(jp, name)).dtype]
    assert not bad, f"fields differing from the JAX pack: {bad}"
