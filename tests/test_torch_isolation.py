"""The PyTorch port stands alone: importing every module of it loads
neither JAX nor the JAX package, needs neither triton nor a CUDA card, and
its entry points refuse to fall back to the CPU when no card is there."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from test_torch_common import REPO

PKG = REPO / "advanced_cpu_raytracing_tpu_torch"

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["triton"] = None  # any import of triton now fails
import torch
assert not torch.cuda.is_available()
import advanced_cpu_raytracing_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.")
             or k == "advanced_cpu_raytracing_tpu"
             or k.startswith("advanced_cpu_raytracing_tpu."))
assert not bad, bad

from advanced_cpu_raytracing_tpu_torch.render.renderer import render_camera
from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
cfg = load_scene(sys.argv[1])
for call in (lambda: pack_scene(cfg),
             lambda: render_camera(pack_scene(cfg, device="cpu"), cfg,
                                   cfg.cameras[0])):
    try:
        call()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError("no error without CUDA")
print("modules", len(names))
"""


def test_port_imports_alone_without_cuda_or_triton():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, str(REPO / "scenes" / "feat_pt.xml")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15


def test_port_sources_import_nothing_of_jax():
    """Static check of every import statement of the package."""
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                root = m.split(".")[0]
                assert root not in ("jax", "jaxlib",
                                    "advanced_cpu_raytracing_tpu"), (path, m)
