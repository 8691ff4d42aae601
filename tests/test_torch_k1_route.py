"""The forward route's geometry (K1a, K1c, K1d over the tree) of the
PyTorch port, on this host's CPU.

``render_camera`` builds its tables through ``renderer._mega_build_cached``,
which adds the tree past ``FWD_FLAT_MAX_FACES`` work items (one 128-face
chunk), so the main paths' scenes walk 4-wide nodes over 4-row leaves
(``LEAF_ROWS``) in place of the flat chunk sweep; a scene of one chunk
keeps the flat kernel, and the differentiable render (``build_bwd_consts``,
K2) takes the same threshold and leaves (its boxes refit per call,
``tests/test_torch_k2a_tree.py``).  Here:

* the route: which instantiation each main path's scene takes, forward and
  differentiable;
* the wide tree of the 32,768-face scenes: every row in exactly one leaf,
  each child box holding its rows' boxes swept over the motion, the stack
  need recorded and within the kernels' stack;
* ``TreeWalker`` (the kernels' walk on the host) equal to the brute force,
  t and row exactly, on primary rays and first mirror bounces of
  ``scenes/whitted_conductors.xml`` and ``scenes/feat_lights_brdf.xml`` (its
  rays through the lens at motion times), its shadow queries too, its stack
  within the recorded need, and on the ray in the floor's plane that must
  reach the back wall;
* the plain version through the route against the JAX kernel in interpret
  mode (the coarse-torus slice and ``feat_lights_brdf.xml``), with the
  bounds of ``tests/test_torch_megakernel.py`` and
  ``tests/test_torch_k1c.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu.ops.pallas.megakernel import LANES, TILE
from advanced_cpu_raytracing_tpu.ops.pallas.megakernel import (
    build_mega as jax_build_mega,
    mega_trace as jax_mega_trace,
)
from advanced_cpu_raytracing_tpu.render import camera as jax_camera
from advanced_cpu_raytracing_tpu.render.renderer import (
    options_for_camera as jax_options_for_camera,
)
from advanced_cpu_raytracing_tpu.scene.pack import pack_scene as jax_pack_scene
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene as jax_load_scene
from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb
from advanced_cpu_raytracing_tpu_torch.ops import megakernel as mk
from advanced_cpu_raytracing_tpu_torch.render import renderer
from advanced_cpu_raytracing_tpu_torch.render.camera import (
    build_camera,
    generate_rays,
)
from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import (
    gauge_scene_xml,
)
from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from test_torch_common import (
    REPO,
    assert_tree_invariants,
    coarse_slice_scene,
    lights_brdf_scene,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
# the main paths' scenes and the instantiation render_camera launches
ROUTES = {"whitted_conductors.xml": "mega_whitted_tree",
          "feat_lights_brdf.xml": "mega_ext_tree",
          "feat_textures.xml": "mega_tex_tree",
          "feat_pt.xml": "mega_pt"}


def _forward(path):
    cfg = load_scene(str(path))
    pack = pack_scene(cfg, device="cpu")
    opts = renderer.options_for_camera(cfg, cfg.cameras[0])
    return cfg, pack, opts, renderer._mega_build_cached(pack, opts, CPU)


def _lens_rays(cfg, n, seed):
    """``n`` rays through random pixels and, where the camera has a thin
    lens, random lens points."""
    cam = build_camera(cfg.cameras[0], device="cpu")
    rng = np.random.default_rng(seed)
    w, h = cfg.cameras[0].width, cfg.cameras[0].height
    px = torch.as_tensor(rng.uniform(0, w, n).astype(np.float32))
    py = torch.as_tensor(rng.uniform(0, h, n).astype(np.float32))
    lens = (torch.as_tensor(rng.uniform(-1, 1, (n, 2)).astype(np.float32))
            if cam.use_dof else None)
    o, d = generate_rays(cam, px, py, lens, dof=cam.use_dof)
    return o.contiguous(), d.contiguous()


@pytest.mark.parametrize("name", list(ROUTES))
def test_forward_route_walks_the_tree_past_one_chunk(name):
    """render_camera's tables: the tree for the three scenes of 32,768
    faces (257 chunks), the flat kernel for feat_pt.xml's 12 faces; the
    tables without the forward route's threshold (K2's) stay flat."""
    _, pack, opts, (mc, tab, _) = _forward(REPO / "scenes" / name)
    assert mc.variant == ROUTES[name]
    assert (mc.tree is not None) == (mc.n_tri > mk.CHUNK)
    assert mk.build_mega(pack, opts, device="cpu")[0].variant == mc.kernel
    if mc.tree is not None:
        assert mc.n_chunks == 257
        assert mc.tree_leaf_rows == mk.LEAF_ROWS == 4
        assert_tree_invariants(mc, tab)


def test_route_follows_only_its_own_threshold(monkeypatch):
    """K2's FLAT_MAX_FACES set to 0 leaves the forward route as it is;
    FWD_FLAT_MAX_FACES set to 0 takes feat_pt.xml's 12 faces to the tree,
    and the cache keeps the two builds apart."""
    cfg = load_scene(str(REPO / "scenes" / "feat_pt.xml"))
    pack = pack_scene(cfg, device="cpu")
    opts = renderer.options_for_camera(cfg, cfg.cameras[0])
    assert renderer._mega_build_cached(pack, opts, CPU)[0].variant == "mega_pt"
    monkeypatch.setattr(mk, "FLAT_MAX_FACES", 0)
    assert renderer._mega_build_cached(pack, opts, CPU)[0].variant == "mega_pt"
    monkeypatch.setattr(mk, "FWD_FLAT_MAX_FACES", 0)
    mc, tab, _ = renderer._mega_build_cached(pack, opts, CPU)
    # 12 faces: one node over three 4-row leaves
    assert mc.variant == "mega_pt_tree" and mc.tree.shape[0] == 1
    assert mc.tree_stack == 2
    assert_tree_invariants(mc, tab)


@pytest.mark.parametrize("flat_max", [None, 0], ids=["kept", "lowered"])
def test_bwd_build_keeps_the_flat_max_faces_threshold(tmp_path, monkeypatch,
                                                      flat_max):
    """K2's tables (build_bwd_consts) on the gauge scene (32,768 torus
    faces) take the forward route's threshold (FWD_FLAT_MAX_FACES) alone:
    with FLAT_MAX_FACES as it is or lowered, the tree over LEAF_ROWS-row
    leaves, the forward route's tree."""
    if flat_max is not None:
        monkeypatch.setattr(mk, "FLAT_MAX_FACES", flat_max)
    cfg = load_scene(gauge_scene_xml(tmp_path, REPO / "scenes"))
    pack = pack_scene(cfg, device="cpu")
    opts = renderer.options_for_camera(cfg, cfg.cameras[0])
    bc = mb.build_bwd_consts(pack, opts, device="cpu")
    assert bc.mc.n_tri > mk.FWD_FLAT_MAX_FACES
    assert bc.variant == "mega_bwd_tree"
    assert bc.mc.tree_leaf_rows == mk.LEAF_ROWS == 4
    assert bc.mc.tree_stack <= mk.TREE_STACK
    tab = mk.build_mega(pack, opts, device="cpu",
                        flat_max=mk.FWD_FLAT_MAX_FACES)[1]
    assert_tree_invariants(bc.mc, tab)
    assert (bc.mc.tree.view(torch.int32)
            == renderer._mega_build_cached(pack, opts, CPU)[0].tree
            .view(torch.int32)).all()


def _brute(mc, tab, o, d, tau=None):
    """The closest face of every ray over all rows, the lowest row on a tie
    (the flat sweep's winner): t (inf on a miss), row (-1)."""
    w = mc.n_tri
    v = [tab[:w, k][None, :] for k in range(9)]
    p = [o[:, k:k + 1] for k in range(3)]
    if tau is not None and mc.faces_move:
        p = [c + mc.tri_motion[:w, k][None, :] * tau[:, None]
             for k, c in enumerate(p)]
    t, valid = mk._tri_hit(v[0:3], v[3:6], v[6:9], *p,
                           *(d[:, k:k + 1] for k in range(3)))
    t = torch.where(valid, t, torch.full_like(t, float("inf")))
    t_min, row = t.min(dim=1)  # the first index on a tie
    hit = t_min < float("inf")
    return t_min, hit, torch.where(hit, row, -1)


@pytest.mark.parametrize("name", ["whitted_conductors.xml",
                                  "feat_lights_brdf.xml"])
def test_walker_matches_brute_force_on_the_main_scenes(name):
    """Primary rays and their first mirror bounce (closest hits, t and row
    exactly) and shadow rays from the hits toward a light (blocked or
    not), each ray of feat_lights_brdf.xml at its own motion time."""
    cfg, _, _, (mc, tab, ctab) = _forward(REPO / "scenes" / name)
    assert mc.has_motion == (name == "feat_lights_brdf.xml")
    o, d = _lens_rays(cfg, 384, seed=3)
    rng = np.random.default_rng(5)
    tau = (torch.as_tensor(rng.uniform(0, 1, len(o)).astype(np.float32))
           if mc.has_motion else None)
    walker = mk.TreeWalker(mc, tab)
    t, hit, win = _brute(mc, tab, o, d, tau)
    got = walker.walk(o, d, tau=tau)
    assert hit.float().mean() > 0.8
    assert got["row"].tolist() == win.tolist()
    assert torch.equal(got["t"][hit], t[hit])
    assert int(got["stack_peak"].max()) <= mc.tree_stack
    # the first mirror bounce off the faces hit
    face = hit
    nrm = tab[win[face], 9:12]
    p = o[face] + t[face, None] * d[face] + 1e-3 * nrm
    r = d[face] - 2.0 * (d[face] * nrm).sum(1, keepdim=True) * nrm
    tau_b = None if tau is None else tau[face]
    t2, hit2, win2 = _brute(mc, tab, p, r, tau_b)
    got2 = walker.walk(p, r, tau=tau_b)
    assert hit2.any()
    assert got2["row"].tolist() == win2.tolist()
    assert torch.equal(got2["t"][hit2], t2[hit2])
    # shadow rays toward a light: blocked where a face lies before it
    light = next(x[0, 0:3] for x in (mc.point_lights, mc.spot_lights,
                                     mc.area_lights) if x.shape[0])
    ls = light - p
    dist = ls.norm(dim=1)
    ls = ls / dist[:, None]
    ts, _, _ = _brute(mc, tab, p, ls, tau_b)
    want = ts < dist
    blocked = walker.walk(p, ls, limit=dist, tau=tau_b)["blocked"]
    assert blocked.tolist() == want.tolist()
    assert 0 < int(want.sum()) < len(want)


def test_floor_plane_ray_reaches_the_back_wall():
    """A ray along -z in the plane y = -10 of the floor (and of the boxes
    that hold it): the slab keeps a box whose face plane the ray runs in,
    so the walk reaches the back wall's bottom edge at t = 35."""
    _, _, _, (mc, tab, ctab) = _forward(REPO / "scenes" /
                                        "whitted_conductors.xml")
    o = torch.tensor([[3.3, -10.0, 25.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    t, hit, win = _brute(mc, tab, o, d)
    got = mk.TreeWalker(mc, tab).walk(o, d)
    assert bool(hit[0]) and float(t[0]) == 35.0
    assert got["row"].tolist() == win.tolist() and float(got["t"][0]) == 35.0
    # the chunk's box and a leaf box have their floor in that plane
    assert float(ctab[0, 1]) == -10.0
    wd = mk.TREE_WIDTH
    assert (mc.tree[:, wd:2 * wd] == -10.0).any()


@pytest.mark.parametrize("name", ["slice", "lights_brdf"])
def test_plain_version_through_the_route_matches_jax(tmp_path, name):
    """The coarse-torus slice (Whitted, depth 6) and feat_lights_brdf.xml
    (K1c: spot, area and mesh lights, BRDFs, roughness, motion; the JAX
    kernel's host draw table) through the forward route's tables, which
    hold a tree, against the JAX kernel in interpret mode."""
    sampled = name == "lights_brdf"
    path = (lights_brdf_scene(tmp_path, res=32) if sampled
            else coarse_slice_scene(tmp_path))
    cfg, _, _, (mc, tab, ctab) = _forward(path)
    assert mc.variant == ("mega_ext_tree" if sampled else "mega_whitted_tree")
    jcfg = jax_load_scene(path)
    jmc, jtab, jctab, _ = jax_build_mega(
        jax_pack_scene(jcfg), jax_options_for_camera(jcfg, jcfg.cameras[0]),
        host_rng=sampled)
    n = 256
    cam = jax_camera.build_camera(jcfg.cameras[0])
    rng = np.random.default_rng(9)
    px = rng.uniform(0, cam.width, n).astype(np.float32)
    py = rng.uniform(0, cam.height, n).astype(np.float32)
    o, d = jax_camera.generate_rays(cam, jnp.asarray(px), jnp.asarray(py),
                                    jnp.zeros((n, 2)), dof=False)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax_mega_trace(jmc, jtab, jctab, o, d, interpret=True,
                                     rng_key=key if sampled else None))
    table = None
    if sampled:
        r_pad = -(-n // TILE) * TILE
        table = torch.as_tensor(np.array(jax.random.uniform(
            key, (jmc.max_iters * jmc.n_draws, r_pad // LANES, LANES),
            jnp.float32)).reshape(-1, r_pad)[:, :n])
    got = mk.mega_trace_ref(mc, tab, ctab, torch.as_tensor(np.array(o)),
                            torch.as_tensor(np.array(d)), draws=table).numpy()
    diff = np.abs(got - want)
    assert np.isfinite(got).all()
    if sampled:
        assert ((diff <= 1e-3 + 1e-3 * np.abs(want)).all(axis=1)).mean() >= 0.995
        assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean())
    else:
        assert np.mean(diff) < 0.01
        assert np.quantile(diff, 0.999) < 0.5
