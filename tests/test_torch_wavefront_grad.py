"""Gradients through the port's wavefront (``differentiable=True``, torch
autograd) against ``jax.grad`` through the JAX package's, of the mean
squared error of 128 rays against a seeded target, the port fed the JAX
draws (``jax_draws``) and the JAX side run without FMA instructions
(``run_jax_side``): on the main path's scene reduced (the env light and
the thin lens: kd, the mesh light's radiance, the vertices, and the
atlas, whose env-map texels the env light reads) and on motion with
roughness, its rays aimed at the rough mirror sphere (kd, the point
light, the mirror's roughness, the vertices).  Each leaf within rtol 1e-3
and atol 1e-4 max|ref| (K2's rule); the loss within rtol 1e-5.
``max_iters`` is cut to 6 (the JAX package's own gradient tests take 4):
both integrators stop there.  The textured scenes are held to JAX in
value only (``test_torch_wavefront_features.py``): the JAX gradient of
the Perlin scene took 265 s to compile on this CPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu_torch.diff.params import (
    inject_params,
    params_from_arrays,
)
from test_torch_common import REPO
from test_torch_wavefront_draws import (
    both,
    mse,
    pixels,
    port_trace,
    run_jax_side,
    scene_xml,
)

N_RAYS = 128
CHANGES = {"max_iters": 6}
# name -> (fields, the pixel window (x0, x1, y0, y1) or None: the image)
SCENES = {
    "pt_env_dof": (("mat_diffuse", "ml_radiance", "verts", "img_atlas"), None),
    # the window around the mirror sphere
    "motion_rough": (("mat_diffuse", "pl_intensity", "mat_roughness", "verts"),
                     (19.0, 31.0, 25.0, 37.0)),
}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wavefront_grad")
    out, jax_cases, arrays = {}, [], {}
    for i, (name, (fields, window)) in enumerate(SCENES.items()):
        path = scene_xml(name, tmp / name, REPO)
        s = both(path, differentiable=True, **CHANGES)
        px, py = pixels(s, N_RAYS, seed=2)
        if window is not None:
            g = np.random.default_rng(2)
            px = g.uniform(*window[:2], N_RAYS).astype(np.float32)
            py = g.uniform(*window[2:], N_RAYS).astype(np.float32)
        target = np.random.default_rng(i).uniform(
            0.0, 60.0, (N_RAYS, 3)).astype(np.float32)
        for k, x in (("px", px), ("py", py), ("target", target)):
            arrays[f"{name}_{k}"] = x
        jax_cases.append({"fn": "jax_value_and_grad", "kwargs": {
            "path": path, "changes": CHANGES, "px": f"@{name}_px",
            "py": f"@{name}_py", "target": f"@{name}_target",
            "fields": list(fields), "key_seed": 2}})
        out[name] = (s, px, py, target)
    refs = run_jax_side(jax_cases, arrays, tmp)
    return {name: (*out[name], ref) for name, ref in zip(SCENES, refs)}


@pytest.mark.parametrize("name", list(SCENES))
def test_gradients_match_jax_grad(cases, name):
    s, px, py, target, ref = cases[name]
    fields = SCENES[name][0]
    params = params_from_arrays({k: ref[f"p_{k}"] for k in fields}, "cpu")
    img = port_trace(s, px, py, key_seed=2,
                     pack=inject_params(s["pack"], params))
    loss = mse(img, torch.tensor(target))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref["loss"]), rtol=1e-5)
    for k in fields:
        g, gref = params[k].grad.numpy(), ref[f"g_{k}"]
        assert np.isfinite(g).all(), k
        assert np.abs(gref).max() > 0, k
        np.testing.assert_allclose(g, gref, rtol=1e-3,
                                   atol=1e-4 * np.abs(gref).max(), err_msg=k)
