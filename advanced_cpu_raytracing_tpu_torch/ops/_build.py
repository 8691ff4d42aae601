"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, and loaded with
ctypes.  Libraries go to ``build/kernels/`` beside the package (listed in
``.gitignore``), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is reused; ptxas's report (registers, stack frame, spills
per kernel) is kept beside each library as ``.ptxas``.  ``build_all`` runs
one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from advanced_cpu_raytracing_tpu_torch.utils.profiling import span

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
# -fmad=false: no contraction into FMA, so a kernel computes what its plain
# version computes, in the same order
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict = {}
BUILD_LOG: dict = {}  # name -> {"seconds", "cached", "ptxas"} of the last build

_P = ctypes.c_void_p
_I = ctypes.c_int


class ExtParams(ctypes.Structure):
    """K1c's extension tables: ``mp::ExtParams`` of csrc/mega_pt.cu."""

    _fields_ = [("sl", _P), ("n_spot", _I), ("al", _P), ("n_area", _I),
                ("mx", _P), ("tmo", _P), ("smo", _P)]


class TexParams(ctypes.Structure):
    """K1d's texture and env tables: ``mt::TexParams`` of
    csrc/mega_tex.cuh."""

    _fields_ = [("face", _P), ("sph", _P), ("tint", _P), ("tflt", _P),
                ("texels", _P), ("perm", _P), ("pix_uv", _P), ("n_tex", _I),
                ("tbn_obj", _I), ("bg_tex", _I), ("env_w", _I), ("env_h", _I),
                ("env_first", _I)]


class BwdExtParams(ctypes.Structure):
    """K2b's tables, draws and light cotangents: ``mb::BwdExt`` of
    csrc/mega_bwd.cu."""

    _fields_ = [("sl", _P), ("n_spot", _I), ("al", _P), ("n_area", _I),
                ("mll", _P), ("n_ml", _I), ("mlr", _P), ("uab", _P),
                ("uml", _P), ("ugi", _P), ("d_sl", _P), ("d_al", _P),
                ("d_ml", _P)]


class BwdTexParams(ctypes.Structure):
    """K2c's texture tables, the texel pool and its cotangent: ``mb::BwdTex``
    of csrc/mega_bwd.cu."""

    _fields_ = [("face", _P), ("tint", _P), ("texels", _P), ("d_texels", _P)]


_SIGNATURES = {
    "mega_whitted": {
        # rays, out, n; tri, chunks, the tree (or null); spheres ...
        "mega_whitted_launch": (
            _I, [_P, _P, _P, _I, _P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _I,
                 _P, _I, ctypes.POINTER(ctypes.c_float), _I, _I, _I, _I, _P]),
        "mega_whitted_error_string": (ctypes.c_char_p, [_I]),
    },
    "mega_pt": {
        "mega_pt_launch": (
            _I, [_P, _P, _P, _I, _P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _I,
                 _P, _I, ctypes.POINTER(ctypes.c_float), _P, _I, _P, _I,
                 ctypes.POINTER(ctypes.c_int), _P, ctypes.c_uint32,
                 ctypes.c_uint32, ctypes.POINTER(ExtParams),
                 ctypes.POINTER(TexParams), _P]),
        "mega_pt_error_string": (ctypes.c_char_p, [_I]),
    },
    "mega_bwd": {
        # rays, gbar (null: the primal), out, n; tri, chunks, the tree (or
        # null); spheres, materials, lights, bg, consts; draws, depth,
        # max_depth, flags, seed, step; the cotangents (tri, mat, pl, dl,
        # bg, o, d); K2a's records (or null); K2b's tables (null: K2a);
        # K2c's (null: no texture); stream
        "mega_bwd_launch": (
            _I, [_P, _P, _P, _P, _I, _P, _I, _P, _I, _P, _P, _I, _P, _I, _P,
                 _I, _P, _I, _P, ctypes.POINTER(ctypes.c_float), _P, _I, _I,
                 _I, ctypes.c_uint32, ctypes.c_uint32, _P, _P, _P, _P, _P, _P,
                 _P, _P, ctypes.POINTER(BwdExtParams),
                 ctypes.POINTER(BwdTexParams), _P]),
        # tri_w, n_tri, leaf rows, runs, n_runs, spans, the built tree,
        # n_nodes, the runs' boxes (scratch), nodes out, chunk out, n_chunks;
        # stream
        "mega_bwd_refit_launch": (
            _I, [_P, _I, _I, _P, _I, _P, _P, _I, _P, _P, _P, _I, _P]),
        "mega_bwd_error_string": (ctypes.c_char_p, [_I]),
    },
    "tri_intersect": {
        # o, d, the item table, time (or null: no motion), n, w; t, idx,
        # beta, gamma; stream
        "tri_intersect_launch": (
            _I, [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P]),
        "tri_intersect_error_string": (ctypes.c_char_p, [_I]),
    },
    "bigtex_gather": {
        # idx, tab, n_lanes, taps, n_tab, window_bytes; the group order's
        # scratch, two int32 a group (or null); out, paths (or null); stream
        "bigtex_gather_launch": (
            _I, [_P, _P, ctypes.c_longlong, _I, ctypes.c_longlong, _I, _P, _P,
                 _P, _P]),
        # window_bytes; registers, static shared bytes, blocks an SM out
        "bigtex_gather_info": (_I, [_I, ctypes.POINTER(_I)]),
        "bigtex_gather_error_string": (ctypes.c_char_p, [_I]),
    },
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or /usr/local/cuda/bin)")


def _library(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    blob = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names) -> dict:
    """Compile each ``csrc/<name>.cu`` that has no up-to-date library, one
    ``nvcc`` process per source, all started together.  Returns the library
    paths by name."""
    libs = {name: _library(name) for name in names}
    procs = {}
    t0 = time.perf_counter()
    for name, lib in libs.items():
        if lib.exists():
            log = lib.with_suffix(".ptxas")
            BUILD_LOG[name] = {"seconds": 0.0, "cached": True,
                               "ptxas": log.read_text() if log.exists() else ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{err}")
            continue
        libs[name].with_suffix(".ptxas").write_text(err.strip())
        os.replace(tmp, libs[name])
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                           "cached": False, "ptxas": err.strip()}
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    if name not in _LIBS:
        with span("kernels.load"):
            lib = ctypes.CDLL(str(build(name)))
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _LIBS[name] = lib
    return _LIBS[name]
