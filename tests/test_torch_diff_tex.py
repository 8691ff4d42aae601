"""The differentiable render's diffuse image textures (slice C3, K2c)
against the JAX package's own reference for its fused fwd+bwd kernel:
``jax.grad`` of ``trace_radiance(differentiable=True)`` with
``PRNGKey(0)`` (tests/test_megabwd.py:570-660), on 256 camera rays at
depth 2 of the JAX test's two-texture scene (a nearest ``replace_kd``
floor tiled twice, a bilinear ``blend_kd`` wall, a mirror sphere that shows
both; ``scene/feature_scenes.py::tex_bwd_scene_xml``).  The path-traced
textured case is in tests/test_torch_diff_tex_pt.py.

The texel pool is a leaf of the port's plain version; autograd carries its
cotangent back to ``img_atlas`` as the JAX ``tables`` does.  One JAX
value-and-grad, with every leaf, is cached in a module fixture.
The tolerances are the JAX package's own (tests/test_megabwd.py:613-660):
value rtol 2e-4, gradients rtol 5e-3 and atol 5e-4 max|g|, central
differences of one texel (h = 4, the loss is linear in it) within rtol
2e-2.  Also here: the gate (``bwd_missing``) and ``optimize`` over
``img_atlas`` on the CPU against the JAX ``optimize`` through its fused
kernel in interpret mode.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu.diff.optimize import optimize as jax_optimize
from advanced_cpu_raytracing_tpu.diff.params import (
    inject_params as jax_inject_params,
)
from advanced_cpu_raytracing_tpu.render.renderer import (
    options_for_camera as jax_options_for_camera,
)
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene as jax_load_scene
from advanced_cpu_raytracing_tpu_torch.diff.optimize import optimize
from advanced_cpu_raytracing_tpu_torch.diff.params import inject_params
from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb
from advanced_cpu_raytracing_tpu_torch.render.camera import build_camera
from advanced_cpu_raytracing_tpu_torch.render.renderer import options_for_camera
from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import (
    tex_bwd_scene_xml,
    texture_inverse_scene_xml,
    write_random_png,
)
from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from test_torch_diff_pt import cos_loss, oracle, port, setup

torch.set_num_threads(1)

# every leaf of the scene: K2a's and the atlas
LEAVES = ("mat_ambient", "mat_diffuse", "mat_specular", "mat_mirror",
          "mat_phong", "pl_intensity", "bg_color", "verts", "img_atlas")


def assert_leaves_close(got: dict, want: dict, leaves, what: str):
    """Every leaf within the JAX test's rtol 5e-3, atol 5e-4 max|g|."""
    for k in leaves:
        a, b = want[k], got[k]
        assert b.shape == a.shape, k
        assert np.all(np.isfinite(a)) and np.all(np.isfinite(b)), k
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b, a, rtol=5e-3, atol=5e-4 * scale,
                                   err_msg=f"{what}: {k}")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two_textures")
    s = setup(None, tmp, 256, leaves=LEAVES, path=tex_bwd_scene_xml(tmp))
    s["jax"] = oracle(s, cos_loss)
    s["port"] = port(s, cos_loss)
    return s


def test_value_and_every_leaf_match_the_jax_oracle(case):
    v_jax, g_jax = case["jax"]
    v, g = case["port"]
    np.testing.assert_allclose(v, v_jax, rtol=2e-4)
    assert_leaves_close(g, g_jax, LEAVES, "two textures")
    bc = case["bc"]
    assert bc.tex and not bc.k2b and bc.variant == "mega_bwd_tex"
    assert [img for img, _, _ in bc.mc.tex_images] == [0, 1]
    # the texels of both images get gradient, and the vertices through uv
    ga = g["img_atlas"]
    assert all(np.abs(ga[i]).sum() > 0 for i in range(ga.shape[0]))
    assert np.abs(g["verts"]).sum() > 0


def test_central_differences_on_the_most_visible_texels(case):
    """One texel of each image, the one with the largest gradient: the
    green channel moved by +-4 (the loss is linear in a texel, so the step
    adds no truncation error, and the f32 loss resolves it)."""
    _, g = case["port"]
    ga = g["img_atlas"]
    atlas = case["arrays"]["img_atlas"]
    for img in range(ga.shape[0]):
        jj, ii = divmod(int(np.argmax(np.abs(ga[img]).sum(-1))),
                        atlas.shape[2])
        h, vals = 4.0, []
        for step in (h, -h):
            a2 = atlas.copy()
            a2[img, jj, ii, 1] += step
            vals.append(port(case, cos_loss, {**case["arrays"],
                                              "img_atlas": a2}, grad=False))
        fd = (vals[0] - vals[1]) / (2 * h)
        np.testing.assert_allclose(ga[img, jj, ii, 1], fd, rtol=2e-2,
                                   atol=1e-5)


def _scene(xml_path):
    cfg = load_scene(str(xml_path))
    pack = pack_scene(cfg, device="cpu")
    return cfg, pack, options_for_camera(cfg, cfg.cameras[0])


def _swap(xml: str, old: str, new: str) -> str:
    assert xml.count(old) == 1, old
    return xml.replace(old, new)


def test_the_gate_admits_diffuse_images_and_names_each_refused_kind(tmp_path):
    """Image textures with ``replace_kd`` or ``blend_kd`` decals on meshes
    are admitted with no count cap (a 128x128 texture, 4x JAX's 4,096
    texels); sphere textures, the background texture, Perlin textures and
    the specular-slot, bump and normal-map decals are refused by name."""
    base = tex_bwd_scene_xml(tmp_path / "base")
    cfg, pack, opts = _scene(base)
    assert mb.bwd_missing(pack.static, opts, pack) == []
    big = texture_inverse_scene_xml(n=128, out_dir=tmp_path / "big")
    cfg, pack, opts = _scene(big)
    assert pack.static.n_textures == 1 and int(pack.img_w[0]) == 128
    assert mb.bwd_missing(pack.static, opts, pack) == []
    bc = mb.build_bwd_consts(pack, opts, device="cpu")
    assert bc.mc.tex_images == ((0, 128, 128),) and bc.variant == "mega_bwd_tex"
    pool = mb.texel_pool(bc, pack.img_atlas)
    assert torch.equal(pool, bc.mc.texels)

    xml = open(base).read()
    write_random_png(tmp_path / "bg.png", 8, 8, 3)
    bg_map = (f'<Image id="3">{tmp_path / "bg.png"}</Image>\n    </Images>'
              '\n    <TextureMap id="3" type="image"><DecalMode>'
              'replace_background</DecalMode><ImageId>3</ImageId>'
              '</TextureMap>')
    refused = {
        "sphere textures": _swap(xml, "<Radius>0.5</Radius>",
                                 "<Radius>0.5</Radius><Textures>1</Textures>"),
        "the background texture": _swap(xml, "</Images>", bg_map),
        "Perlin textures": _swap(
            xml, '<TextureMap id="1" type="image">\n      <DecalMode>'
            'replace_kd</DecalMode><ImageId>1</ImageId>\n      '
            '<Interpolation>nearest</Interpolation>',
            '<TextureMap id="1" type="perlin">\n      <DecalMode>replace_kd'
            '</DecalMode><NoiseConversion>linear</NoiseConversion>'
            '<NoiseScale>3</NoiseScale>'),
        "replace_ks": _swap(xml, "<DecalMode>blend_kd</DecalMode>",
                            "<DecalMode>replace_ks</DecalMode>"),
        "bump_normal": _swap(xml, "<DecalMode>blend_kd</DecalMode>",
                             "<DecalMode>bump_normal</DecalMode>"),
        "replace_normal": _swap(xml, "<DecalMode>blend_kd</DecalMode>",
                                "<DecalMode>replace_normal</DecalMode>"),
    }
    for name, text in refused.items():
        path = tmp_path / "refused.xml"
        path.write_text(text)
        cfg, pack, opts = _scene(path)
        missing = mb.bwd_missing(pack.static, opts, pack)
        assert any(name in m for m in missing), (name, missing)
        with pytest.raises(NotImplementedError, match=name):
            mb.build_bwd_consts(pack, opts, device="cpu")
    # without its pack a textured scene cannot be checked
    assert mb.bwd_missing(pack.static, opts) == ["textures"]


def test_optimize_on_the_cpu_matches_the_jax_loss_history(tmp_path):
    """Three Adam steps over ``img_atlas`` on the inverse-texture scene
    with a 16x16 texture, from flat grey + N(0, 20) noise of seed 3 (the
    JAX tool's start): the port's ``optimize`` on the CPU against the JAX
    ``optimize`` through its fused kernel in interpret mode, on the same
    128 rays; within 1e-3 relative (f32 on both sides)."""
    path = texture_inverse_scene_xml(n=16, out_dir=tmp_path)
    s = setup(None, tmp_path, 128, seed=11, leaves=("img_atlas",), path=path)
    f = mb.make_diff_render(s["pack"], s["opts"], device="cpu")
    with torch.no_grad():  # the target at the true texture
        target = f({}, torch.tensor(s["o"]), torch.tensor(s["d"])).numpy()
    a = s["arrays"]["img_atlas"]
    start = {"img_atlas": (np.full_like(a, 128.0) + np.random.default_rng(3)
                           .normal(0, 20, a.shape)).astype(np.float32)}
    jcfg = jax_load_scene(str(s["path"]))
    _, h_jax = jax_optimize(
        jax_inject_params(s["jpack"], {k: jnp.asarray(v)
                                       for k, v in start.items()}),
        s["cam"], jnp.asarray(s["px"]), jnp.asarray(s["py"]),
        jax_options_for_camera(jcfg, jcfg.cameras[0]), target,
        ("img_atlas",), steps=3, lr=4.0, use_fused=True)
    cfg = load_scene(str(s["path"]))
    out, h = optimize(inject_params(s["pack"], {k: torch.tensor(v)
                                                for k, v in start.items()}),
                      build_camera(cfg.cameras[0], device="cpu"), s["px"],
                      s["py"], s["opts"], target, ("img_atlas",), steps=3,
                      lr=4.0, device="cpu")
    np.testing.assert_allclose(h, h_jax, rtol=1e-3)
    assert h[-1] < h[0] and len(h) == 3
    moved = (out.img_atlas - torch.tensor(start["img_atlas"])).abs()
    assert float(moved.max()) > 1.0
