"""The port's native PLY reader (``native/ply_reader.cpp`` through
``native/bindings.py``, compiled with g++ at first use) against the JAX
package's ``load_ply`` and the port's Python reader; the files it leaves
to the Python reader; a failed build raising; and ``utils/logging.py``."""

from __future__ import annotations

import logging
import struct

import numpy as np
import pytest

from advanced_cpu_raytracing_tpu.scene.ply import load_ply as jax_load_ply
from advanced_cpu_raytracing_tpu_torch.native import bindings
from advanced_cpu_raytracing_tpu_torch.scene import ply
from advanced_cpu_raytracing_tpu_torch.utils.logging import get_logger
from test_torch_common import SLICE_PLY

QUAD_VERTS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                       [0.5, 0.5, 1.25]], np.float32)


def _binary_ply(path, count: str = "uchar", extra_vertex: str = "",
                endian: str = "<") -> str:
    """Two quads and a triangle over QUAD_VERTS, binary; ``count`` is the
    face lists' count type, ``extra_vertex`` a float property after z."""
    fmt = {"<": "binary_little_endian", ">": "binary_big_endian"}[endian]
    head = (f"ply\nformat {fmt} 1.0\ncomment a test file\n"
            f"element vertex {len(QUAD_VERTS)}\nproperty float x\n"
            f"property float y\nproperty float z\n"
            + (f"property float {extra_vertex}\n" if extra_vertex else "")
            + f"element face 3\nproperty list {count} int vertex_indices\n"
            "end_header\n")
    body = b""
    for i, v in enumerate(QUAD_VERTS):
        body += struct.pack(endian + "3f", *v)
        if extra_vertex:
            body += struct.pack(endian + "f", 10.0 + i)
    cfmt = {"uchar": "B", "int": "i"}[count]
    for face in ([0, 1, 2, 3], [1, 2, 4], [3, 2, 4, 0]):
        body += struct.pack(endian + cfmt, len(face))
        body += struct.pack(endian + f"{len(face)}i", *face)
    path.write_bytes(head.encode() + body)
    return str(path)


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_native_reader_matches_jax_and_python_on_the_slice_mesh():
    got = bindings.load_ply_native(SLICE_PLY)
    assert got is not None
    assert got[0].shape == (16384, 3) and got[1].shape == (32768, 3)
    _assert_same(got, ply.load_ply_python(str(SLICE_PLY)))
    _assert_same(got, jax_load_ply(str(SLICE_PLY)))
    _assert_same(ply.load_ply(str(SLICE_PLY)), got)


@pytest.mark.parametrize("count", ["uchar", "int"])
def test_native_reader_splits_quads_like_python_and_jax(tmp_path, count):
    path = _binary_ply(tmp_path / "quads.ply", count=count)
    got = bindings.load_ply_native(path)
    assert got is not None and got[1].shape == (5, 3)
    np.testing.assert_array_equal(got[1][:2], [[0, 1, 2], [2, 3, 0]])
    _assert_same(got, ply.load_ply_python(path))
    _assert_same(got, jax_load_ply(path))


@pytest.mark.parametrize("layout", ["ascii", "big endian", "xyz apart"])
def test_other_files_go_to_the_python_reader(tmp_path, layout):
    if layout == "ascii":
        path = tmp_path / "a.ply"
        path.write_text(
            "ply\nformat ascii 1.0\nelement vertex 4\nproperty float x\n"
            "property float y\nproperty float z\nelement face 1\n"
            "property list uchar int vertex_indices\nend_header\n"
            "0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n")
        path = str(path)
    elif layout == "big endian":
        path = _binary_ply(tmp_path / "be.ply", endian=">")
    else:  # x, y, z not side by side
        path = _binary_ply(tmp_path / "nx.ply", extra_vertex="nx")
        text = open(path, "rb").read().replace(
            b"property float z\nproperty float nx\n",
            b"property float nx\nproperty float z\n")
        open(path, "wb").write(text)
    assert bindings.load_ply_native(path) is None
    verts, tris = ply.load_ply(path)
    _assert_same((verts, tris), ply.load_ply_python(path))
    if layout != "xyz apart":
        _assert_same((verts, tris), jax_load_ply(path))
    assert tris.shape[0] >= 2


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "ply_reader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(bindings, "_SOURCE", bad)
    monkeypatch.setattr(bindings, "_LIB", None)
    monkeypatch.setattr("advanced_cpu_raytracing_tpu_torch.native.build."
                        "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on ply_reader.cpp"):
        ply.load_ply(str(SLICE_PLY))


def test_get_logger_is_one_per_name_and_reads_acrt_log_level(monkeypatch):
    monkeypatch.setenv("ACRT_LOG_LEVEL", "debug")
    log = get_logger("acrt.test_native_ply")
    assert log is get_logger("acrt.test_native_ply")
    assert log.level == logging.DEBUG and len(log.handlers) == 1
    assert not log.propagate
    monkeypatch.setenv("ACRT_LOG_LEVEL", "WARNING")
    assert get_logger("acrt.test_native_ply").level == logging.DEBUG
    assert get_logger("acrt.test_native_ply.other").level == logging.WARNING
    assert get_logger().name == "acrt"
