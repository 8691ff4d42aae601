"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, and loaded with
ctypes.  Libraries go to ``build/kernels/`` beside the package (listed in
``.gitignore``), named by a hash of the source and flags, so an edited
source is rebuilt and an unchanged one is reused.
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


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    t0 = time.perf_counter()
    if lib.exists():
        BUILD_LOG[name] = {"seconds": 0.0, "cached": True, "ptxas": ""}
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                       "ptxas": proc.stderr.strip()}
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    if name not in _LIBS:
        lib = ctypes.CDLL(str(build(name)))
        for fn, (restype, argtypes) in _SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
    return _LIBS[name]
