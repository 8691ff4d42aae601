"""The PyTorch port stands alone: importing every module of it loads
neither JAX nor the JAX package, needs neither triton nor a CUDA card, and
its entry points (the renderer, the differentiable render's ``optimize``,
``make_diff_render`` and ``mega_bwd_trace``, K3's ``tri_closest_hit``, the
inverse-rendering tool, the big-texture probe, the tree-design tool, the
progressive renderer, the sharded routes, their mesh and dry run, and the
CLI's ``--shard``) refuse to fall back to the CPU when no card is there."""

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
# the modules of slices C3, D1 (the wavefront and K3) and E1 (K4, the
# probe and the profiling helpers) among them
assert {"advanced_cpu_raytracing_tpu_torch.tools.inverse_render",
        "advanced_cpu_raytracing_tpu_torch.scene.feature_scenes",
        "advanced_cpu_raytracing_tpu_torch.ops.megabwd",
        "advanced_cpu_raytracing_tpu_torch.ops.intersect",
        "advanced_cpu_raytracing_tpu_torch.ops.tri_intersect",
        "advanced_cpu_raytracing_tpu_torch.ops.brdf",
        "advanced_cpu_raytracing_tpu_torch.ops.traverse",
        "advanced_cpu_raytracing_tpu_torch.render.shading",
        "advanced_cpu_raytracing_tpu_torch.render.lights",
        "advanced_cpu_raytracing_tpu_torch.render.integrator",
        "advanced_cpu_raytracing_tpu_torch.tools.probe_bigtex",
        "advanced_cpu_raytracing_tpu_torch.ops.bigtex_gather",
        "advanced_cpu_raytracing_tpu_torch.utils.profiling",
        "advanced_cpu_raytracing_tpu_torch.tools.tree_design"} <= set(names)
# slice G1: progressive rendering, the sharded routes, logging and the
# native PLY reader's bindings
assert {"advanced_cpu_raytracing_tpu_torch.render.progressive",
        "advanced_cpu_raytracing_tpu_torch.parallel.mesh",
        "advanced_cpu_raytracing_tpu_torch.parallel.shard_render",
        "advanced_cpu_raytracing_tpu_torch.parallel.dryrun",
        "advanced_cpu_raytracing_tpu_torch.utils.logging",
        "advanced_cpu_raytracing_tpu_torch.native.bindings",
        "advanced_cpu_raytracing_tpu_torch.native.build"} <= set(names)

import dataclasses
from advanced_cpu_raytracing_tpu_torch.diff.optimize import optimize
from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb
from advanced_cpu_raytracing_tpu_torch.render.camera import build_camera
from advanced_cpu_raytracing_tpu_torch.render.renderer import (
    options_for_camera,
    render_camera,
)
from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from advanced_cpu_raytracing_tpu_torch.tools import (
    inverse_render,
    probe_bigtex,
    tree_design,
)
import numpy as np
import torch.distributed as dist
from advanced_cpu_raytracing_tpu_torch.cli.render import main as cli_main
from advanced_cpu_raytracing_tpu_torch.parallel import dryrun, shard_render
from advanced_cpu_raytracing_tpu_torch.parallel.mesh import (
    initialize_distributed,
    make_device_mesh,
)
from advanced_cpu_raytracing_tpu_torch.post.tonemap import (
    reinhard_tonemap_sharded,
)
from advanced_cpu_raytracing_tpu_torch.render.progressive import (
    ProgressiveRenderer,
)
cfg = load_scene(sys.argv[1])
cpu_pack = pack_scene(cfg, device="cpu")
opts = options_for_camera(cfg, cfg.cameras[0])
cam = build_camera(cfg.cameras[0], device="cpu")
for call in (lambda: pack_scene(cfg),
             lambda: render_camera(cpu_pack, cfg, cfg.cameras[0]),
             lambda: optimize(cpu_pack, cam, [0.5], [0.5], opts, [[0, 0, 0]],
                              ("mat_diffuse",), steps=1),
             lambda: mb.make_diff_render(cpu_pack, opts),
             # the wrapper takes the plain version only for CPU tensors, and
             # its scene tables default to the card
             lambda: mb.mega_bwd_trace(mb.build_bwd_consts(cpu_pack, opts),
                                       None, None, None),
             lambda: inverse_render.run("texture", steps=1, spp=1, res=8),
             # the wavefront's scene: optimize's fallback and the route
             lambda: optimize(cpu_pack, dataclasses.replace(cam, use_dof=True),
                              [0.5], [0.5], opts, [[0, 0, 0]],
                              ("mat_diffuse",), steps=1),
             lambda: render_camera(cpu_pack, cfg, cfg.cameras[0], tile_size=8),
             lambda: inverse_render.main(["--texture", "--steps", "1"]),
             lambda: probe_bigtex.run(n_rows=64, blocks=1, iters=1),
             lambda: probe_bigtex.main(["--n-rows", "64", "--blocks", "1"]),
             lambda: tree_design.main(["--count"]),
             lambda: tree_design.main(["--twins"]),
             lambda: ProgressiveRenderer(cpu_pack, cfg, cfg.cameras[0]),
             lambda: initialize_distributed(),
             lambda: initialize_distributed(backend="gloo"),
             lambda: make_device_mesh(),
             lambda: shard_render.render_camera_sharded(cpu_pack, cfg,
                                                        cfg.cameras[0]),
             lambda: shard_render.render_camera_sharded_mega(
                 cpu_pack, cfg, cfg.cameras[0]),
             lambda: shard_render.make_sharded_diff_step(cpu_pack, opts, cam),
             lambda: reinhard_tonemap_sharded(np.ones((2, 2, 3), np.float32)),
             lambda: dryrun.dryrun_multichip(1),
             lambda: cli_main([sys.argv[1], "--shard"])):
    try:
        call()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError("no error without CUDA")
    assert not dist.is_initialized()
print("modules", len(names))
"""


def test_port_imports_alone_without_cuda_or_triton():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, str(REPO / "scenes" / "feat_pt.xml")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 40


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
