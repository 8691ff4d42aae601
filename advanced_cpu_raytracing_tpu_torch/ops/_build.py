"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, and loaded with
ctypes.  Libraries go to ``build/kernels/`` beside the package (listed in
``.gitignore``), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is reused.  ``build_all`` runs one ``nvcc`` per source, all
at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
# -fmad=false: no contraction into FMA, so a kernel computes what its plain
# version computes, in the same order
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict = {}
BUILD_LOG: dict = {}  # name -> {"seconds", "cached", "ptxas"} of the last load

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "mega_whitted": {
        "mega_whitted_launch": (
            _I, [_P, _P, _P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _P, _I,
                 _P, _I, ctypes.POINTER(ctypes.c_float), _I, _I, _I, _I, _P]),
        "mega_whitted_error_string": (ctypes.c_char_p, [_I]),
    },
    "mega_pt": {
        "mega_pt_launch": (
            _I, [_P, _P, _P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _P, _I,
                 _P, _I, ctypes.POINTER(ctypes.c_float), _P, _I, _P, _I,
                 ctypes.POINTER(ctypes.c_int), _P, ctypes.c_uint32,
                 ctypes.c_uint32, _P]),
        "mega_pt_error_string": (ctypes.c_char_p, [_I]),
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
            BUILD_LOG[name] = {"seconds": 0.0, "cached": True, "ptxas": ""}
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
        lib = ctypes.CDLL(str(build(name)))
        for fn, (restype, argtypes) in _SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
    return _LIBS[name]
