"""The wavefront's two entry points in the port.

* ``diff/optimize.py::optimize`` on a scene outside the fused kernels
  (the main path's scene reduced: the env light and a thin lens) takes
  the wavefront fallback, and its loss history over 3 Adam steps matches
  the JAX ``optimize(..., use_fused=False)`` within rtol 1e-3 (as
  ``test_torch_diff_opt.py`` holds K2's), each step fed the JAX loop's
  draws (``step_keys``); the JAX side runs without FMA instructions.
* ``render/renderer.py::render_camera`` sends a scene outside the
  megakernel (depth 12, above its 10) through the wavefront; its lane
  tiles (``tile_size``, the CLI's ``--tile``) change no pixel, since each
  ray's draws are keyed by its index in the frame; ``_auto_tile`` sizes
  tiles as the JAX package's does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from advanced_cpu_raytracing_tpu.render.renderer import (
    _auto_tile as jax_auto_tile,
)
from advanced_cpu_raytracing_tpu_torch.cli.render import main as cli_main
from advanced_cpu_raytracing_tpu_torch.diff.optimize import optimize
from advanced_cpu_raytracing_tpu_torch.diff.params import inject_params
from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb
from advanced_cpu_raytracing_tpu_torch.ops import megakernel as mk
from advanced_cpu_raytracing_tpu_torch.render import renderer
from advanced_cpu_raytracing_tpu_torch.scene import feature_scenes as fs
from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from test_torch_common import REPO
from test_torch_wavefront_draws import (
    both,
    jax_draws,
    pixels,
    run_jax_side,
    scene_xml,
    step_keys,
    with_resolution,
)

FIELDS, SCALE = ("mat_diffuse", "ml_radiance"), (0.8, 1.2)
STEPS, LR, N_RAYS = 3, 1e-2, 128


def test_optimize_fallback_matches_jax(tmp_path):
    path = scene_xml("pt_env_dof", tmp_path / "scene", REPO)
    changes = {"max_iters": 6}
    s = both(path, **changes)
    assert mb.bwd_missing(s["pack"].static, s["opts"], s["pack"]) == [
        "an environment light"]
    assert s["cam"].use_dof
    px, py = pixels(s, N_RAYS, seed=4)
    target = np.random.default_rng(4).uniform(
        0, 300, (N_RAYS, 3)).astype(np.float32)
    ref = run_jax_side([{"fn": "jax_optimize_history", "kwargs": {
        "path": path, "changes": changes, "px": "@px", "py": "@py",
        "target": "@target", "fields": list(FIELDS), "scale": list(SCALE),
        "steps": STEPS, "lr": LR, "seed": 0}}],
        {"px": px, "py": py, "target": target}, tmp_path)[0]["history"]
    pack = inject_params(s["pack"], {f: getattr(s["pack"], f) * k
                                     for f, k in zip(FIELDS, SCALE)})
    draws = [jax_draws(k, N_RAYS, pack) for k in step_keys(0, STEPS)]
    before = (dict(mk.LAUNCHES), dict(mb.LAUNCHES))
    out, history = optimize(pack, s["cam"], px, py, s["opts"], target, FIELDS,
                            steps=STEPS, lr=LR, device="cpu", draws=draws)
    assert (dict(mk.LAUNCHES), dict(mb.LAUNCHES)) == before
    # each step draws anew, so the loss moves with the noise as well
    np.testing.assert_allclose(history, ref, rtol=1e-3)
    assert not torch.equal(out.mat_diffuse, pack.mat_diffuse)


def _deep_scene(tmp_path, res=(12, 10)):
    """The main path's scene (coarse torus) at depth 12, outside the
    megakernel (its MAX_DEPTH is 10), at a small resolution."""
    path = fs.pt_env_dof_scene_xml(REPO / "scenes", tmp_path,
                                   torus=fs.PT_ENV_COARSE_TORUS, depth=12)
    xml = with_resolution(open(path).read(), *res)
    open(path, "w").write(xml)
    return path


def test_render_camera_routes_outside_the_megakernel(tmp_path, monkeypatch):
    path = _deep_scene(tmp_path)
    cfg = load_scene(path)
    pack = pack_scene(cfg, device="cpu")
    opts = renderer.options_for_camera(cfg, cfg.cameras[0])
    assert opts.stochastic_dielectric  # path traced
    assert mk.mega_missing(pack.static, opts, pack) == ["depth above 10"]

    def no_megakernel(*args, **kw):
        raise AssertionError("the megakernel ran on a scene outside it")

    monkeypatch.setattr(renderer, "mega_trace", no_megakernel)
    img = renderer.render_camera(pack, cfg, cfg.cameras[0], spp=4, device="cpu")
    assert img.shape == (10, 12, 3) and np.isfinite(img).all()
    assert img.mean() > 1.0
    tiled = renderer.render_camera(pack, cfg, cfg.cameras[0], spp=4,
                                   device="cpu", tile_size=37)
    np.testing.assert_array_equal(tiled, img)
    u8 = renderer.render_camera(pack, cfg, cfg.cameras[0], spp=4,
                                device="cpu", ldr=True)
    np.testing.assert_array_equal(u8, renderer.ldr_from_radiance(img))
    other = renderer.render_camera(pack, cfg, cfg.cameras[0], spp=4,
                                   device="cpu", seed=1)
    assert not np.array_equal(other, img)


def test_cli_tile_renders_the_same_image(tmp_path):
    path = _deep_scene(tmp_path, res=(9, 7))
    outs = []
    for extra in ([], ["--tile", "20"]):
        out = tmp_path / ("tiled" if extra else "whole")
        assert cli_main([path, "--out-dir", str(out), "--device", "cpu",
                         "--spp", "1", *extra]) == 0
        outs.append(np.asarray(Image.open(out / "pt.png")))
    assert outs[0].shape == (7, 9, 3)
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("changes", [{}, {"russian_roulette": True},
                                     {"path_tracing": False}])
def test_auto_tile_is_the_jax_one(tmp_path, changes):
    s = both(_deep_scene(tmp_path), **changes)
    jopts = dataclasses.replace(s["jopts"], stochastic_dielectric=False)
    opts = dataclasses.replace(s["opts"], stochastic_dielectric=False)
    for total in (100, 10 ** 7):
        assert renderer._auto_tile(total, opts, s["pack"], None) == \
            jax_auto_tile(total, jopts, s["jpack"], None)
    assert renderer._auto_tile(10 ** 7, opts, s["pack"], 333) == 333
