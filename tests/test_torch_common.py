"""Shared helpers of the PyTorch port's tests, and the check that the slice
scene's committed mesh is what ``torus_mesh`` makes.

``scenes/whitted_conductors.xml`` is an in-repo Whitted Cornell box:
point lights and ambient light, mirror, conductor and dielectric spheres,
and a conductor torus read from ``scenes/whitted_conductors_mesh.ply``
(32,768 faces: above one 128-face chunk, below the 98,304 faces where the
JAX kernel starts to stream).  The CPU tests render a coarse variant (768
torus faces, 7 chunks) written next to a copy of the XML.
"""

from __future__ import annotations

import os
import pathlib
import re

import numpy as np

from advanced_cpu_raytracing_tpu_torch.scene import feature_scenes
from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import (  # noqa: F401
    COARSE_TORUS,
    FULL_TORUS,
    ply_bytes,
    torus_mesh,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
SLICE_XML = REPO / "scenes" / "whitted_conductors.xml"
SLICE_PLY = REPO / "scenes" / "whitted_conductors_mesh.ply"

def coarse_slice_scene(tmp_path, width: int | None = None,
                       height: int | None = None) -> str:
    """The slice scene with the coarse torus, written to ``tmp_path``;
    optionally at another resolution.  Returns the XML path."""
    xml = SLICE_XML.read_text()
    if width is not None:
        xml = re.sub(r"<ImageResolution>.*?</ImageResolution>",
                     f"<ImageResolution>{width} {height}</ImageResolution>",
                     xml)
    out = pathlib.Path(tmp_path) / SLICE_XML.name
    out.write_text(xml)
    (pathlib.Path(tmp_path) / SLICE_PLY.name).write_bytes(
        ply_bytes(*torus_mesh(**COARSE_TORUS)))
    return str(out)


def demo_scene(tmp_path) -> str:
    """``__graft_entry__._demo_scene_xml`` minus its AreaLight (area lights
    are outside the Whitted kernel), written to ``tmp_path``."""
    import __graft_entry__ as ge

    xml = re.sub(r"<AreaLight.*?</AreaLight>", "", ge._demo_scene_xml(),
                 flags=re.S)
    out = pathlib.Path(tmp_path) / "demo.xml"
    out.write_text(xml)
    return str(out)


def pt_scene(tmp_path, res: int | None = None, params: str | None = None,
             whitted: bool = False, name: str = "feat_pt.xml") -> str:
    """``scenes/<name>`` (a path-traced Cornell box under an emissive
    LightMesh) written to ``tmp_path``: optionally at ``res`` x ``res``,
    with other ``<RendererParams>``, or with the path-tracing renderer
    stripped (Whitted + LightMesh).  Returns the XML path."""
    xml = (REPO / "scenes" / name).read_text()
    if res is not None:
        xml = re.sub(r"<ImageResolution>.*?</ImageResolution>",
                     f"<ImageResolution>{res} {res}</ImageResolution>", xml)
    if params is not None:
        xml = re.sub(r"<RendererParams>.*?</RendererParams>",
                     f"<RendererParams>{params}</RendererParams>", xml)
    if whitted:
        xml = re.sub(r"<Renderer>.*?</RendererParams>", "", xml, flags=re.S)
    out = pathlib.Path(tmp_path) / name
    out.write_text(xml)
    return str(out)


def lights_brdf_scene(tmp_path, res: int = 48) -> str:
    """``scenes/feat_lights_brdf.xml`` at ``res`` px wide with the coarse
    torus (768 faces, 7 chunks) beside it; returns the XML path."""
    xml = (REPO / "scenes" / "feat_lights_brdf.xml").read_text()
    xml = re.sub(r"<ImageResolution>.*?</ImageResolution>",
                 f"<ImageResolution>{res} {res}</ImageResolution>", xml)
    out = pathlib.Path(tmp_path) / "feat_lights_brdf.xml"
    out.write_text(xml)
    (pathlib.Path(tmp_path) / SLICE_PLY.name).write_bytes(
        ply_bytes(*torus_mesh(**COARSE_TORUS)))
    return str(out)


def k1c_scenes() -> dict:
    """name -> XML of the K1c kernel checks' scenes (the port's
    ``scene/feature_scenes.py``)."""
    return feature_scenes.k1c_scenes(REPO / "scenes")


def assert_tree_invariants(mc, tab) -> None:
    """The K1e tree of ``mc`` over ``tab`` (``ops/megakernel.py::
    _tree_table``): every row in exactly one leaf of at most
    ``mc.tree_leaf_rows`` consecutive rows starting at a multiple of it; each leaf's box
    holds its faces at both ends of the motion; each node child's box holds
    the boxes of that node's children; every node reached once from the
    root; the levels and the stack need (the largest sum over a path from
    the root of each node's children less one) are the recorded ones, and
    the need fits the kernels' stack."""
    from advanced_cpu_raytracing_tpu_torch.ops import megakernel as mk

    w, wd = mc.n_tri, mk.TREE_WIDTH
    nodes = mc.tree.numpy()
    assert nodes.shape[1] == mk.NODE_COLS == 8 * wd
    box = nodes[:, :6 * wd].reshape(-1, 6, wd).transpose(0, 2, 1)  # (N, W, 6)
    code = nodes.view(np.int32)[:, 6 * wd:7 * wd]
    cnt = nodes.view(np.int32)[:, 7 * wd:8 * wd]
    real = cnt >= 0
    leaf = cnt > 0
    assert real.any(axis=1).all()
    # the kernels' codes: a node's row (never the root's 0), ~(first row <<
    # 5 | row count) for a leaf, 0 for no child
    ref = np.where(code < 0, ~code >> 5, code)
    assert (code[~real] == 0).all() and (code[real & ~leaf] > 0).all()
    np.testing.assert_array_equal((~code[leaf]) & 31, cnt[leaf])
    # every row in exactly one leaf of at most tree_leaf_rows consecutive rows
    assert 0 < mc.tree_leaf_rows < 32
    assert (cnt[leaf] <= mc.tree_leaf_rows).all()
    assert (ref[leaf] % mc.tree_leaf_rows == 0).all()
    rows = np.concatenate([np.arange(f, f + c)
                           for f, c in zip(ref[leaf], cnt[leaf])])
    np.testing.assert_array_equal(np.sort(rows), np.arange(w))
    # leaf boxes hold their faces at both ends of the motion
    verts = tab[:w, 0:9].numpy().reshape(w, 3, 3)
    ends = (verts, verts - mc.tri_motion[:w].numpy()[:, None])
    for i, k in zip(*np.where(leaf)):
        for v in ends:
            vs = v[ref[i, k]:ref[i, k] + cnt[i, k]].reshape(-1, 3)
            assert (vs >= box[i, k, 0:3]).all(), (i, k)
            assert (vs <= box[i, k, 3:6]).all(), (i, k)
    # a node child's box holds its children's; every node reached once
    seen = np.zeros(len(nodes), int)

    def visit(i):
        seen[i] += 1
        depth, need = 1, 0
        for k in np.where(real[i])[0]:
            if leaf[i, k]:
                continue
            c = ref[i, k]
            kids = box[c][real[c]]
            assert (kids[:, 0:3] >= box[i, k, 0:3]).all(), (i, k)
            assert (kids[:, 3:6] <= box[i, k, 3:6]).all(), (i, k)
            dep, nd = visit(c)
            depth, need = max(depth, dep + 1), max(need, nd)
        return depth, need + int(real[i].sum()) - 1

    depth, need = visit(0)
    assert (seen == 1).all()
    assert (depth, need) == (mc.tree_depth, mc.tree_stack)
    assert need <= mk.TREE_STACK


def test_committed_mesh_is_torus_mesh():
    assert SLICE_PLY.read_bytes() == ply_bytes(*torus_mesh(**FULL_TORUS))


def test_ply_roundtrip_through_port_loader(tmp_path):
    from advanced_cpu_raytracing_tpu_torch.scene.ply import load_ply

    verts, faces = torus_mesh(**COARSE_TORUS)
    path = os.path.join(tmp_path, "t.ply")
    with open(path, "wb") as f:
        f.write(ply_bytes(verts, faces))
    v2, f2 = load_ply(path)
    np.testing.assert_array_equal(v2, verts)
    np.testing.assert_array_equal(f2, faces)


def test_area_demo_scene_is_the_demo_scene():
    """The port's copy of the demo scene (the K1c area-light check) is the
    JAX package's ``__graft_entry__._demo_scene_xml``."""
    import __graft_entry__ as ge

    assert feature_scenes.AREA_DEMO_XML == ge._demo_scene_xml()
