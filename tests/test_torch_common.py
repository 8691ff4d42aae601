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
