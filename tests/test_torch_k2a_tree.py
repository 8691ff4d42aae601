"""K2's geometry on the forward route's tree, its boxes refit from each
call's vertices (slice F3), on this host's CPU.

``build_bwd_consts`` builds K2's tables with the forward route's
threshold (``FWD_FLAT_MAX_FACES``, one 128-face chunk) and leaves
(``LEAF_ROWS`` = 4); each call refits the boxes the kernels read from its
own vertices (``ops/megabwd.py::refit``, plain version ``refit_ref``).
Here:

* the refit of ``build_mega``'s own vertices is the built tree bit for bit
  (min and max do not round), on the gauge scene's 32,768-face torus and
  the slice scene's coarse torus;
* under vertices moved by a seeded offset, each leaf's box is its rows'
  min and max and each child box the union of its node's children, so it
  holds every row; a scene of one chunk gets its rows' box;
* the route: past one chunk the tree over 4-row leaves, ``feat_pt.xml``
  the flat chunk, and which kernels each launches;
* on a 250-face gauge scene with one torus vertex moved out of its 4-row
  leaf's initial box but inside its 128-face chunk's box, the plain version
  against the JAX fused kernel in interpret mode (``make_diff_render(...,
  interpret=True)``, whose chunk boxes stay the initial pack's) in value
  and every cotangent, rays aimed at the moved faces; the built leaf
  boxes would drop the moved face on some of those rays (``TreeWalker``),
  the refit ones do not;
* the JAX-side divergence: with the vertex moved out of its chunk's box,
  the JAX kernel's constant chunk box drops the moved face on rays where
  the port (any box refit) hits it.

Tolerances: the JAX package's kernel test's (tests/test_megabwd.py:100,
107-109), as ``tests/test_torch_diff.py`` states them.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu.diff.params import (
    extract_params as jax_extract_params,
)
from advanced_cpu_raytracing_tpu.ops.pallas.megabwd import (
    make_diff_render as jax_make_diff_render,
    wavefront_rng,
)
from advanced_cpu_raytracing_tpu.render.renderer import (
    options_for_camera as jax_options_for_camera,
)
from advanced_cpu_raytracing_tpu.scene.pack import pack_scene as jax_pack_scene
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene as jax_load_scene
from advanced_cpu_raytracing_tpu_torch.diff.params import params_from_arrays
from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb
from advanced_cpu_raytracing_tpu_torch.ops import megakernel as mk
from advanced_cpu_raytracing_tpu_torch.render.renderer import options_for_camera
from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import (
    gauge_scene_xml,
    ply_bytes,
    torus_mesh,
)
from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from test_torch_common import REPO, coarse_slice_scene
from test_torch_diff import LEAVES, assert_grads_close

torch.set_num_threads(1)

DEPTH = 2
N_AIMED = 192  # rays aimed at the moved faces
# the 250-face gauge scene: a 240-face torus and the room's 10 faces, two
# of the JAX kernel's 128-face chunks and a tree of 4-row leaves here
SMALL_TORUS = dict(n_major=12, n_minor=10)


def _bwd(path, device="cpu"):
    cfg = load_scene(str(path))
    pack = pack_scene(cfg, device=device)
    opts = options_for_camera(cfg, cfg.cameras[0])
    return cfg, pack, opts, mb.build_bwd_consts(pack, opts, device=device)


def _built_tri(pack, opts):
    return mk.build_mega(pack, opts, device="cpu",
                         flat_max=mk.FWD_FLAT_MAX_FACES)[1]


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("scene", ["gauge", "slice_coarse"])
def test_refit_of_the_built_vertices_is_the_built_tree(tmp_path, scene):
    path = (gauge_scene_xml(tmp_path, REPO / "scenes") if scene == "gauge"
            else coarse_slice_scene(tmp_path))
    _, pack, opts, bc = _bwd(path)
    assert bc.mc.tree is not None and bc.mc.tree_leaf_rows == 4
    tab = _built_tri(pack, opts)
    nodes, chunk = mb.refit_ref(bc, tab[:, :9].contiguous())
    assert torch.equal(_bits(nodes), _bits(bc.mc.tree))
    assert chunk is bc.chunk_tab  # the tree kernels read no chunk box
    # the call's own vertices (torch's transform of the pack) give the
    # same boxes on these scenes, whose entities are untransformed
    nodes_w, _ = mb.refit_ref(bc, mb.world_vertices(bc, pack.verts))
    assert torch.equal(_bits(nodes_w), _bits(bc.mc.tree))


def _moved_tri_w(bc, pack, scale, seed):
    rng = np.random.default_rng(seed)
    verts = pack.verts + torch.as_tensor(
        rng.normal(0.0, scale, tuple(pack.verts.shape)).astype(np.float32))
    return mb.world_vertices(bc, verts)


def test_refit_of_moved_vertices_holds_every_row(tmp_path):
    _, pack, _, bc = _bwd(coarse_slice_scene(tmp_path))
    mc = bc.mc
    tri_w = _moved_tri_w(bc, pack, 0.3, 7)
    nodes, _ = mb.refit_ref(bc, tri_w)
    wd = mk.TREE_WIDTH
    box = nodes[:, :6 * wd].reshape(-1, 6, wd)
    code = _bits(nodes)[:, 6 * wd:7 * wd]
    cnt = _bits(nodes)[:, 7 * wd:8 * wd]
    v = tri_w.reshape(-1, 3, 3)
    moved_out = 0
    seen = torch.zeros(mc.n_tri, dtype=torch.bool)
    for n in range(nodes.shape[0]):
        for k in range(wd):
            c = int(code[n, k])
            if cnt[n, k] < 0:
                continue
            lo, hi = box[n, 0:3, k], box[n, 3:6, k]
            if c < 0:  # a leaf: rows first .. first + count - 1
                first, count = (~c) >> 5, (~c) & 31
                rows = v[first:first + count].reshape(-1, 3)
                assert torch.equal(lo, rows.amin(0))
                assert torch.equal(hi, rows.amax(0))
                seen[first:first + count] = True
                old = mc.tree[n, :6 * wd].reshape(6, wd)[:, k]
                moved_out += int(((rows < old[0:3]) | (rows > old[3:6])).any())
            else:  # a node: the union of its children's boxes
                kids = box[c][:, cnt[c] >= 0]
                assert torch.equal(lo, kids[0:3].amin(1))
                assert torch.equal(hi, kids[3:6].amax(1))
    assert bool(seen.all())
    assert moved_out > 0  # the offset took rows out of their built leaves


@pytest.mark.parametrize("scene", ["gauge_coarse", "slice_coarse"])
def test_refit_kernel_spans_give_the_plain_boxes(tmp_path, scene):
    """The refit kernel's two passes over ``refit_spans``' tables, taken
    here on the CPU, give ``refit_ref``'s boxes bit for bit."""
    path = (gauge_scene_xml(tmp_path, REPO / "scenes", coarse=True)
            if scene == "gauge_coarse" else coarse_slice_scene(tmp_path))
    _, pack, _, bc = _bwd(path)
    rows = bc.mc.tree_leaf_rows
    runs, spans = bc.tree_runs.tolist(), bc.tree_spans.tolist()
    assert sorted(runs) == list(range(-(-bc.n_tri // rows)))
    tri_w = _moved_tri_w(bc, pack, 0.3, 11)
    v = tri_w.reshape(-1, 3, 3)
    fmin, fmax = v.amin(1), v.amax(1)
    # pass 1: each run's box, in the runs' order
    run_lo = torch.stack([fmin[j * rows:(j + 1) * rows].amin(0) for j in runs])
    run_hi = torch.stack([fmax[j * rows:(j + 1) * rows].amax(0) for j in runs])
    # pass 2: each child slot's over its span
    ref, _ = mb.refit_ref(bc, tri_w)
    wd = mk.TREE_WIDTH
    box = ref[:, :6 * wd].reshape(-1, 6, wd)
    cnt = _bits(ref)[:, 7 * wd:8 * wd]
    for slot, (first, count) in enumerate(spans):
        n, k = divmod(slot, wd)
        assert (count == 0) == bool(cnt[n, k] < 0)
        if count:
            assert torch.equal(box[n, 0:3, k],
                               run_lo[first:first + count].amin(0))
            assert torch.equal(box[n, 3:6, k],
                               run_hi[first:first + count].amax(0))


def test_single_chunk_refit_box_is_the_rows_box(tmp_path):
    _, pack, _, bc = _bwd(REPO / "scenes" / "feat_pt.xml")
    assert bc.mc.tree is None and bc.mc.n_chunks == 1
    tri_w = _moved_tri_w(bc, pack, 0.2, 3)
    nodes, chunk = mb.refit_ref(bc, tri_w)
    rows = tri_w.reshape(-1, 3)
    assert nodes is None
    assert torch.equal(chunk[0, 0:3], rows.amin(0))
    assert torch.equal(chunk[0, 3:6], rows.amax(0))
    assert torch.equal(chunk[0, 6:8], torch.zeros(2))
    # unmoved: the built box
    _, built = mb.refit_ref(bc, mb.world_vertices(bc, pack.verts))
    assert torch.equal(built, bc.chunk_tab)


def test_k2_routes_past_one_chunk_to_the_tree(tmp_path):
    _, _, _, bc = _bwd(gauge_scene_xml(tmp_path, REPO / "scenes", coarse=True))
    assert bc.n_tri > mk.CHUNK
    assert bc.variant == "mega_bwd_tree" and bc.mc.tree_leaf_rows == 4
    assert (bc.primal_kernel, bc.backward_kernel) == ("mega_bwd_primal_tree",
                                                      "mega_bwd_rev")
    assert mb.boxes_read(bc)
    _, _, _, bp = _bwd(REPO / "scenes" / "feat_pt.xml")
    assert bp.variant == "mega_bwd_pt" and bp.mc.tree is None
    assert (bp.primal_kernel, bp.backward_kernel) == ("mega_bwd_primal_pt",
                                                      "mega_bwd_pt")
    assert not mb.boxes_read(bp)
    assert mb.records_shape(bc, 10) == (mb.bc_depth(bc) * mb.SEG_WORDS + 1, 10)
    assert {"mega_bwd_rev", "mega_bwd_refit", "mega_bwd_primal_tree",
            "mega_bwd_pt_tree"} <= set(mb.LAUNCHES)
    assert "mega_bwd" not in mb.LAUNCHES and "mega_bwd_tree" not in mb.LAUNCHES
    with pytest.raises(ValueError, match="motion"):
        mb.refit_ref(dataclasses.replace(
            bc, mc=dataclasses.replace(bc.mc, has_motion=True)),
            torch.zeros((bc.n_tri, 9)))


# ---- a moved face against the JAX kernel ----


@pytest.fixture(scope="module")
def small_gauge(tmp_path_factory):
    """The 250-face gauge scene (its glass kept: the dielectric's split) at
    depth 2, both packs, and the JAX parameters."""
    out = tmp_path_factory.mktemp("small_gauge")
    path = gauge_scene_xml(out, REPO / "scenes", coarse=True)
    (out / "gauge_coarse_mesh.ply").write_bytes(
        ply_bytes(*torus_mesh(**SMALL_TORUS)))
    cfg = load_scene(path)
    pack = pack_scene(cfg, device="cpu")
    opts = dataclasses.replace(options_for_camera(cfg, cfg.cameras[0]),
                               max_depth=DEPTH)
    bc = mb.build_bwd_consts(pack, opts, device="cpu")
    assert bc.n_tri == 250 and bc.mc.tree is not None
    jcfg = jax_load_scene(path)
    jpack = jax_pack_scene(jcfg)
    jopts = dataclasses.replace(jax_options_for_camera(jcfg, jcfg.cameras[0]),
                                max_depth=DEPTH)
    arrays = {k: np.asarray(v) for k, v in
              jax_extract_params(jpack, LEAVES).items()}
    return dict(cfg=cfg, pack=pack, opts=opts, bc=bc, jpack=jpack,
                jopts=jopts, arrays=arrays)


def _torus_vertices(s):
    """Torus vertices all of whose faces (4 or more) lie in one 128-row
    chunk: (vertex, its faces' rows, the chunk, the chunk's built box, the
    first face's built leaf box, the vertex's world position)."""
    bc = s["bc"]
    tv = bc.tv.numpy()
    tri = _built_tri(s["pack"], s["opts"])[:, :9].numpy().reshape(-1, 3, 3)
    wd = mk.TREE_WIDTH
    leaf_of = {}
    for n in range(bc.mc.tree.shape[0]):
        for k, c in enumerate(_bits(bc.mc.tree)[n, 6 * wd:7 * wd].tolist()):
            if c < 0:
                first, count = (~c) >> 5, (~c) & 31
                for r in range(first, first + count):
                    leaf_of[r] = (n, k)
    for vert in np.unique(tv[10:]):  # the torus's vertices (rows 10 on)
        rows = np.nonzero((tv == vert).any(axis=1))[0]
        chunks = set(rows // mk.CHUNK)
        if len(chunks) != 1 or len(rows) < 4:
            continue
        ci = chunks.pop()
        part = tri[ci * mk.CHUNK:(ci + 1) * mk.CHUNK].reshape(-1, 3)
        n, k = leaf_of[rows[0]]
        leaf = bc.mc.tree[n, :6 * wd].reshape(6, wd)[:, k].numpy()
        world = tri[rows[0]][list(tv[rows[0]]).index(vert)].copy()
        yield vert, rows, ci, (part.min(0), part.max(0)), leaf, world


def _moved(s, vert, row, world):
    """The JAX parameters with ``vert`` at ``world`` (through its entity's
    transform) and the port's world vertices of them."""
    bc = s["bc"]
    obj = np.linalg.solve(bc.rot[row].numpy().astype(np.float64),
                          world - bc.trn[row].numpy())
    moved = dict(s["arrays"])
    moved["verts"] = s["arrays"]["verts"].copy()
    moved["verts"][vert] = obj.astype(np.float32)
    return moved, mb.world_vertices(bc, torch.tensor(moved["verts"]))


def _move_out_of_the_leaf(s):
    """A vertex moved along the axis where its chunk's box reaches
    farthest past the first face's leaf box, halfway to the chunk box's
    face: out of the leaf's built box, inside the chunk's."""
    for vert, rows, _, (c_lo, c_hi), leaf, world in _torus_vertices(s):
        gap = np.concatenate([c_hi - leaf[3:6], leaf[0:3] - c_lo])
        axis = int(np.argmax(gap))
        if gap[axis] < 0.5:
            continue
        a = axis % 3
        world[a] = (0.5 * (leaf[3 + a] + c_hi[a]) if axis < 3
                    else 0.5 * (leaf[a] + c_lo[a]))
        return (*_moved(s, vert, rows[0], world), rows)
    raise AssertionError("no torus vertex fits")


def _aimed_rays(s, tri_w, rows, n, seed):
    """Rays from the camera's eye at random points of the faces ``rows``."""
    rng = np.random.default_rng(seed)
    eye = np.asarray(s["cfg"].cameras[0].position, np.float32)
    v = tri_w[torch.as_tensor(rows)].numpy().reshape(-1, 3, 3)
    pick = rng.integers(0, len(rows), n)
    b = rng.uniform(0.05, 0.95, (n, 2))
    b = np.where(b.sum(1, keepdims=True) > 1.0, 1.0 - b, b)
    pts = (v[pick, 0] * (1.0 - b[:, :1] - b[:, 1:]) + v[pick, 1] * b[:, :1]
           + v[pick, 2] * b[:, 1:])
    d = pts - eye
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return np.broadcast_to(eye, d.shape).astype(np.float32).copy(), d


def _jax_render(s, arrays, o, d, grads: bool):
    f_jax = jax_make_diff_render(s["jpack"], s["jopts"], interpret=True)

    def loss(params, o_, d_):
        img = f_jax(params, o_, d_)
        return jnp.sum(img * jnp.cos(0.01 * img)), img

    params = {k: jnp.asarray(v) for k, v in arrays.items()}
    if not grads:
        return np.asarray(loss(params, jnp.asarray(o), jnp.asarray(d))[1])
    (v, img), g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(o), jnp.asarray(d))
    return float(v), np.asarray(img), g


def _ud(n):
    return torch.tensor(np.asarray(wavefront_rng(jax.random.PRNGKey(0), n,
                                                 DEPTH + 1, 0, True)[2]))


def _walk_rows(bc, tree, tri_w, o, d):
    mc = dataclasses.replace(bc.mc, tree=tree)
    tab = torch.cat([tri_w, bc.tri_rest], 1)
    return mk.TreeWalker(mc, tab).walk(torch.tensor(o), torch.tensor(d))["row"]


def test_moved_face_matches_the_jax_kernel(small_gauge):
    s = small_gauge
    bc = s["bc"]
    moved, tri_w, rows = _move_out_of_the_leaf(s)
    o, d = _aimed_rays(s, tri_w, rows, N_AIMED, 5)
    # the built leaf boxes drop a moved face on some of these rays; the
    # refit boxes find the brute force's winners
    geo = mk._Geometry(bc.mc, torch.cat([tri_w, bc.tri_rest], 1),
                       bc.chunk_tab, None)
    win = geo.trace(*torch.tensor(o).T, *torch.tensor(d).T, want_win=True)[-1]
    refit_nodes, _ = mb.refit_ref(bc, tri_w)
    on_face = torch.isin(win, torch.as_tensor(rows))
    assert int(on_face.sum()) >= 16
    assert torch.equal(_walk_rows(bc, refit_nodes, tri_w, o, d), win)
    assert not torch.equal(_walk_rows(bc, bc.mc.tree, tri_w, o, d), win)
    # the plain version against the JAX kernel, value and every cotangent
    v_jax, _, (g_jax, go_jax, gd_jax) = _jax_render(s, moved, o, d, True)
    params = params_from_arrays(moved, "cpu")
    ot = torch.tensor(o, requires_grad=True)
    dt = torch.tensor(d, requires_grad=True)
    img = mb.make_diff_render(s["pack"], s["opts"], device="cpu")(
        params, ot, dt, draws=_ud(N_AIMED))
    val = (img * torch.cos(0.01 * img)).sum()
    val.backward()
    np.testing.assert_allclose(float(val.detach()), v_jax, rtol=2e-4)
    assert_grads_close({k: p.grad.numpy() for k, p in params.items()},
                       {k: np.asarray(x) for k, x in g_jax.items()},
                       "moved face")
    for name, got, want in (("d_o", ot.grad, go_jax), ("d_d", dt.grad, gd_jax)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-3,
                                   atol=5e-4 * np.abs(want).max(), err_msg=name)
    assert np.abs(params["verts"].grad.numpy()).sum() > 0


def test_jax_constant_chunk_boxes_drop_a_face_moved_out_of_its_chunk(
        small_gauge):
    """The JAX-side divergence (ROADMAP Queue 3): past its chunk's initial
    box, a moved face is culled by the JAX kernel on rays that do not
    enter that box, and hit by the port, whose boxes are refit."""
    s = small_gauge
    bc = s["bc"]
    # a vertex moved 3 units past a face of its chunk's box, so that rays
    # reach its faces without entering that box: the JAX kernel sweeps a
    # chunk for all its block's rays when one of them enters the box, so
    # only such rays go in
    for vert, rows, ci, (c_lo, c_hi), _, world in _torus_vertices(s):
        box = bc.chunk_tab[ci].tolist()
        for axis in range(6):
            a, w = axis % 3, world.copy()
            w[a] = c_hi[a] + 3.0 if axis < 3 else c_lo[a] - 3.0
            moved, tri_w = _moved(s, vert, rows[0], w)
            o, d = _aimed_rays(s, tri_w, rows, N_AIMED, 9)
            to, tdir = torch.tensor(o), torch.tensor(d)
            geo = mk._Geometry(bc.mc, torch.cat([tri_w, bc.tri_rest], 1),
                               bc.chunk_tab, None)
            win = geo.trace(*to.T, *tdir.T, want_win=True)[-1]
            outside = ~mk._slab_enter(box, *to.T, *(1.0 / tdir).T,
                                      torch.full((N_AIMED,), mk.BIG))
            sel = (torch.isin(win, torch.as_tensor(rows)) & outside).numpy()
            if sel.sum() >= 8:
                break
        else:
            continue
        break
    else:
        raise AssertionError("no move of a torus vertex fits")
    o, d = o[sel], d[sel]
    img_jax = _jax_render(s, moved, o, d, False)
    with torch.no_grad():
        img = mb.make_diff_render(s["pack"], s["opts"], device="cpu")(
            params_from_arrays(moved, "cpu"), torch.tensor(o),
            torch.tensor(d), draws=_ud(len(o)))
    # the port shades the moved face; JAX sees past it
    diff = np.abs(img.numpy() - img_jax).max(axis=1)
    assert (diff > 1e-2 * np.abs(img.numpy()).max()).mean() > 0.5
