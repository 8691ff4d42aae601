"""ctypes bindings of the native PLY reader (``ply_reader.cpp``), the JAX
package's ``native/bindings.py::load_ply_native``.

The library is compiled by ``native/build.py`` at the first call; a failed
build raises.  A file that the reader does not take (ASCII, big endian,
another vertex or face layout) gives ``None``, and ``scene/ply.py`` reads it
in Python, as the reader's negative return codes ask."""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from advanced_cpu_raytracing_tpu_torch.native.build import build_library

_SOURCE = Path(__file__).resolve().parent / "ply_reader.cpp"
_N_COUNTS = 6  # the counts acrt_ply_open writes
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library(_SOURCE, "libply")))
        lib.acrt_ply_open.restype = ctypes.c_int32
        lib.acrt_ply_open.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        lib.acrt_ply_read.restype = ctypes.c_int32
        lib.acrt_ply_read.argtypes = [ctypes.c_char_p] + [ctypes.c_void_p] * 3
        _LIB = lib
    return _LIB


def load_ply_native(path) -> tuple[np.ndarray, np.ndarray] | None:
    """(vertices (V,3) float32, triangles (F,3) int32) of a binary
    little-endian PLY file, or ``None`` when the reader does not take the
    file.  Two phases: the header's counts, then the rows into buffers
    allocated here."""
    lib = _lib()
    name = str(path).encode()
    counts = np.zeros(_N_COUNTS, np.int64)
    if lib.acrt_ply_open(name, counts.ctypes.data) != 0:
        return None
    n_vert, n_rows = int(counts[0]), int(counts[1])
    verts = np.empty((n_vert, 3), np.float32)
    tris = np.empty((max(2 * n_rows, 1), 3), np.int32)
    nt = lib.acrt_ply_read(name, counts.ctypes.data, verts.ctypes.data,
                           tris.ctypes.data)
    if nt < 0:
        return None
    return verts, np.ascontiguousarray(tris[:nt])
