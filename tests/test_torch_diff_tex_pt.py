"""The differentiable render's diffuse image textures under path tracing
(slice C3, K2c's ``kPt`` twin): ``scenes/feat_pt.xml`` with a bilinear
``replace_kd`` floor tiled twice
(``scene/feature_scenes.py::textured_pt_scene_xml``), NEE and importance
sampling at depth 2, on 256 camera rays, the draws from the JAX
``wavefront_rng(PRNGKey(0), ...)``.

The reference is the JAX package's fused fwd+bwd kernel in interpret mode
(``make_diff_render(..., interpret=True)``, which draws the same
``wavefront_rng`` planes): its wavefront oracle, ``trace_radiance
(differentiable=True)``, takes more than ten minutes to compile on this
textured path-traced scene on the CPU, and the JAX package's own test holds
the kernel's texel cotangents to that oracle
(tests/test_megabwd.py:570-660).  The tolerances are that test's: value
rtol 2e-4, every leaf, ``img_atlas`` included, rtol 5e-3 and atol 5e-4
max|g|.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from advanced_cpu_raytracing_tpu.ops.pallas.megabwd import (
    bwd_eligible as jax_bwd_eligible,
    make_diff_render as jax_make_diff_render,
)
from advanced_cpu_raytracing_tpu.render.renderer import (
    options_for_camera as jax_options_for_camera,
)
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene as jax_load_scene
from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import (
    textured_pt_scene_xml,
)
from test_torch_common import REPO
from test_torch_diff_pt import cos_loss, port, setup
from test_torch_diff_tex import assert_leaves_close

torch.set_num_threads(1)

LEAVES = ("mat_diffuse", "ml_radiance", "verts", "img_atlas")


def test_path_traced_texture_matches_the_jax_kernel(tmp_path):
    path = textured_pt_scene_xml(REPO / "scenes", tmp_path)
    s = setup(None, tmp_path, 256, max_depth=2, leaves=LEAVES, path=path)
    jcfg = jax_load_scene(str(path))
    jopts = dataclasses.replace(
        jax_options_for_camera(jcfg, jcfg.cameras[0]), max_depth=2)
    assert jax_bwd_eligible(s["jpack"].static, jopts, s["jpack"])
    f_jax = jax_make_diff_render(s["jpack"], jopts, interpret=True)

    def loss(params):
        return cos_loss(f_jax(params, jnp.asarray(s["o"]), jnp.asarray(s["d"]),
                              jax.random.PRNGKey(0)), jnp)

    v_jax, g_jax = jax.value_and_grad(loss)(
        {k: jnp.asarray(v) for k, v in s["arrays"].items()})
    v, g = port(s, cos_loss)
    np.testing.assert_allclose(v, float(v_jax), rtol=2e-4)
    assert_leaves_close(g, {k: np.asarray(x) for k, x in g_jax.items()},
                        LEAVES, "path-traced texture")
    bc = s["bc"]
    assert bc.pt and bc.tex and bc.variant == "mega_bwd_pt_tex"
    # the floor's texels get gradient through the camera rays' hits and the
    # GI weight; the floor's vertices through uv
    assert np.abs(g["img_atlas"]).sum() > 0 and np.abs(g["verts"]).sum() > 0
