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

REPO = pathlib.Path(__file__).resolve().parents[1]
SLICE_XML = REPO / "scenes" / "whitted_conductors.xml"
SLICE_PLY = REPO / "scenes" / "whitted_conductors_mesh.ply"

# full-size torus of the committed mesh, and the coarse one of the CPU tests
FULL_TORUS = dict(n_major=128, n_minor=128)
COARSE_TORUS = dict(n_major=24, n_minor=16)


def torus_mesh(n_major: int, n_minor: int, major: float = 3.5,
               minor: float = 1.2, center=(4.0, 1.5, -5.0),
               tilt_x_deg: float = 70.0, tilt_y_deg: float = 25.0):
    """A torus in world coordinates: (verts (V,3) f32, faces (F,3) i32),
    two triangles per (major, minor) cell, counter-clockwise seen from
    outside."""
    u = np.arange(n_major) * (2.0 * np.pi / n_major)
    v = np.arange(n_minor) * (2.0 * np.pi / n_minor)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    ring = major + minor * np.cos(vv)
    pts = np.stack([ring * np.cos(uu), minor * np.sin(vv),
                    ring * np.sin(uu)], axis=-1).reshape(-1, 3)
    ax, ay = np.deg2rad(tilt_x_deg), np.deg2rad(tilt_y_deg)
    rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]])
    ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                   [-np.sin(ay), 0, np.cos(ay)]])
    pts = pts @ (ry @ rx).T + np.asarray(center)
    i, j = np.meshgrid(np.arange(n_major), np.arange(n_minor), indexing="ij")
    a = i * n_minor + j
    b = ((i + 1) % n_major) * n_minor + j
    c = ((i + 1) % n_major) * n_minor + (j + 1) % n_minor
    e = i * n_minor + (j + 1) % n_minor
    faces = np.concatenate([np.stack([a, e, c], -1).reshape(-1, 3),
                            np.stack([a, c, b], -1).reshape(-1, 3)])
    return pts.astype(np.float32), faces.astype(np.int32)


def ply_bytes(verts: np.ndarray, faces: np.ndarray) -> bytes:
    """Binary little-endian PLY of float32 vertices and triangle faces."""
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n").encode()
    rows = np.zeros(len(faces), dtype=[("n", "u1"), ("i", "<i4", 3)])
    rows["n"] = 3
    rows["i"] = faces
    return head + verts.astype("<f4").tobytes() + rows.tobytes()


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
