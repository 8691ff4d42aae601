"""Compile a native source of this package into a shared library with g++,
at first use: into ``build/native/`` beside the package, named by a hash of
the source and the flags, so an edited source or other flags build anew
and an unchanged one is built once.  A failed build raises with the
compiler's output; nothing falls back.  The libraries have a plain C
interface and are loaded with ctypes."""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def build_library(source: Path, stem: str, flags=CXX_FLAGS,
                  build_dir: Path | None = None) -> Path:
    """The path of ``source`` compiled with ``flags``: ``build_dir``
    (default ``BUILD_DIR``) ``/ <stem>_<hash>.so``, built now unless it
    exists.  Concurrent builds of one library (test workers) each write a
    file of their own and move it into place."""
    source = Path(source)
    build_dir = Path(BUILD_DIR if build_dir is None else build_dir)
    blob = source.read_bytes() + " ".join(flags).encode()
    lib = build_dir / f"{stem}_{hashlib.sha1(blob).hexdigest()[:16]}.so"
    if not lib.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *flags, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {source.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    return lib
