"""The differentiable render's kernel path and optimizer on the CPU (slice
C1, K2a): the plain version against the JAX fused fwd+bwd kernel itself
(``make_diff_render(..., interpret=True)``) on the demo scene, ray
cotangents included; ``optimize(device="cpu")`` against the JAX
``optimize`` through its wavefront (``use_fused=False``) on the coarse
gauge scene with its glass made a mirror (no draws, so JAX's per-step keys
change nothing); the gates of ``bwd_missing``; the layout of the Philox
branch uniforms.  Tolerances: the JAX package's kernel test's
(tests/test_megabwd.py:100, 107-109), and 1e-3 relative on the loss
history (three Adam steps from the same start, in f32 on both sides)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu.diff.optimize import optimize as jax_optimize
from advanced_cpu_raytracing_tpu.diff.params import (
    extract_params as jax_extract_params,
    inject_params as jax_inject_params,
)
from advanced_cpu_raytracing_tpu.ops.pallas.megabwd import (
    make_diff_render as jax_make_diff_render,
)
from advanced_cpu_raytracing_tpu.render import camera as jax_camera
from advanced_cpu_raytracing_tpu.render.integrator import (
    RenderOptions as JaxOptions,
    trace_radiance,
)
from advanced_cpu_raytracing_tpu.render.renderer import (
    options_for_camera as jax_options_for_camera,
)
from advanced_cpu_raytracing_tpu.scene.pack import pack_scene as jax_pack_scene
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene as jax_load_scene
from advanced_cpu_raytracing_tpu_torch.diff.optimize import optimize
from advanced_cpu_raytracing_tpu_torch.diff.params import (
    PARAM_FIELDS,
    extract_params,
    inject_params,
    params_from_arrays,
)
from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb
from advanced_cpu_raytracing_tpu_torch.ops.rng import philox4x32, uniform_from_bits
from advanced_cpu_raytracing_tpu_torch.render.camera import build_camera
from advanced_cpu_raytracing_tpu_torch.render.renderer import options_for_camera
from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import gauge_scene_xml
from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from test_torch_common import REPO, demo_scene
from test_torch_diff import LEAVES, assert_grads_close

torch.set_num_threads(1)

N_RAYS, DEPTH = 256, 2


def rays(cam, n, seed):
    rng = np.random.default_rng(seed)
    px = rng.uniform(0, cam.width, n).astype(np.float32)
    py = rng.uniform(0, cam.height, n).astype(np.float32)
    o, d = jax_camera.generate_rays(cam, jnp.asarray(px), jnp.asarray(py),
                                    jnp.zeros((n, 2)), dof=False)
    return px, py, np.asarray(o), np.asarray(d)


def test_plain_version_matches_the_jax_kernel_in_interpret_mode(tmp_path):
    """Value, every K2a leaf and the ray cotangents d_o, d_d against the
    JAX fused kernel (its primal, its fwd+bwd sweep and one-hot epilogue)
    on the demo scene: a mirror and an absorbing dielectric over a floor,
    the background past it."""
    path = demo_scene(tmp_path)
    jcfg = jax_load_scene(path)
    jpack = jax_pack_scene(jcfg)
    jopts = dataclasses.replace(jax_options_for_camera(jcfg, jcfg.cameras[0]),
                                max_depth=DEPTH)
    cam = jax_camera.build_camera(jcfg.cameras[0])
    _, _, o, d = rays(cam, N_RAYS, 3)
    arrays = {k: np.asarray(v) for k, v in
              jax_extract_params(jpack, LEAVES).items()}
    f_jax = jax_make_diff_render(jpack, jopts, interpret=True)

    def loss(params, o_, d_):
        img = f_jax(params, o_, d_)
        return jnp.sum(img * jnp.cos(0.01 * img))

    v_jax, (g_jax, go_jax, gd_jax) = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        {k: jnp.asarray(v) for k, v in arrays.items()}, jnp.asarray(o),
        jnp.asarray(d))
    # the port, fed the same rays, parameters and branch uniforms
    from advanced_cpu_raytracing_tpu.ops.pallas.megabwd import wavefront_rng

    ud = torch.tensor(np.asarray(wavefront_rng(jax.random.PRNGKey(0), N_RAYS,
                                               DEPTH + 1, 0, True)[2]))
    cfg = load_scene(path)
    pack = pack_scene(cfg, device="cpu")
    opts = dataclasses.replace(options_for_camera(cfg, cfg.cameras[0]),
                               max_depth=DEPTH)
    params = params_from_arrays(arrays, "cpu")
    ot = torch.tensor(o, requires_grad=True)
    dt = torch.tensor(d, requires_grad=True)
    img = mb.make_diff_render(pack, opts, device="cpu")(params, ot, dt,
                                                         draws=ud)
    val = (img * torch.cos(0.01 * img)).sum()
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(v_jax), rtol=2e-4)
    assert_grads_close({k: p.grad.numpy() for k, p in params.items()},
                       {k: np.asarray(x) for k, x in g_jax.items()}, "demo")
    for name, got, want in (("d_o", ot.grad, go_jax), ("d_d", dt.grad, gd_jax)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-3,
                                   atol=5e-4 * np.abs(want).max(), err_msg=name)
    assert np.abs(params["bg_color"].grad.numpy()).sum() > 0


# the fields of the loss-history check; not the vertices: the JAX wavefront
# keeps its sweeps on the pack's initial world vertices (wi_v0..wi_v2) and
# moves only the winner's t (ops/traverse.py:274-293), where the fused
# kernels, JAX's and the port's, sweep the moved vertices, so the two
# estimators part as soon as a vertex moves
FIELDS = ("mat_diffuse", "pl_intensity", "dl_radiance")


@pytest.fixture(scope="module")
def gauge(tmp_path_factory):
    """The coarse gauge scene without glass at depth 2: both packs started
    from the same perturbed parameters, the target rendered by JAX at the
    true ones, and the rays' pixel coordinates."""
    path = gauge_scene_xml(tmp_path_factory.mktemp("gauge"), REPO / "scenes",
                           coarse=True, glass=False)
    jcfg = jax_load_scene(path)
    jpack = jax_pack_scene(jcfg)
    cam = jax_camera.build_camera(jcfg.cameras[0])
    px, py, _, _ = rays(cam, N_RAYS, 11)
    d_opts = JaxOptions(max_depth=DEPTH, differentiable=True,
                        max_iters=DEPTH + 2)
    target = np.array(trace_radiance(jpack, cam, jnp.asarray(px),
                                       jnp.asarray(py), jax.random.PRNGKey(0),
                                       d_opts))
    rng = np.random.default_rng(21)
    start = {k: np.asarray(v).copy()
             for k, v in jax_extract_params(jpack, FIELDS).items()}
    start["mat_diffuse"] *= rng.uniform(0.7, 1.1, start["mat_diffuse"].shape
                                        ).astype(np.float32)
    start["pl_intensity"] *= np.float32(1.2)
    start["dl_radiance"] *= np.float32(0.8)
    cfg = load_scene(path)
    pack = pack_scene(cfg, device="cpu")
    return dict(jpack=jax_inject_params(
                    jpack, {k: jnp.asarray(v) for k, v in start.items()}),
                cam=cam, px=px, py=py, d_opts=d_opts, target=target,
                cfg=cfg, pack=inject_params(pack, {k: torch.tensor(v) for k, v
                                                   in start.items()}))


def test_optimize_on_the_cpu_matches_the_jax_loss_history(gauge):
    _, h_jax = jax_optimize(gauge["jpack"], gauge["cam"],
                            jnp.asarray(gauge["px"]), jnp.asarray(gauge["py"]),
                            gauge["d_opts"], gauge["target"], FIELDS, steps=3,
                            lr=5e-2, use_fused=False)
    cfg = gauge["cfg"]
    opts = dataclasses.replace(options_for_camera(cfg, cfg.cameras[0]),
                               max_depth=DEPTH)
    out, h = optimize(gauge["pack"], build_camera(cfg.cameras[0], device="cpu"),
                      gauge["px"], gauge["py"], opts, gauge["target"], FIELDS,
                      steps=3, lr=5e-2, device="cpu")
    np.testing.assert_allclose(h, h_jax, rtol=1e-3)
    assert h[-1] < h[0] and len(h) == 3
    moved = out.mat_diffuse - gauge["pack"].mat_diffuse
    assert float(moved.abs().max()) > 0.05  # three steps of about lr each


def test_optimize_refuses_what_k2a_does_not_cover(gauge, tmp_path):
    """A scene outside the fused kernels (here marked as moving) and a
    camera with depth of field take the wavefront fallback: the loss falls
    over two steps, and no K2 launch is counted."""
    cfg = gauge["cfg"]
    cam = build_camera(cfg.cameras[0], device="cpu")
    opts = dataclasses.replace(options_for_camera(cfg, cfg.cameras[0]),
                               max_depth=DEPTH)
    args = (gauge["px"], gauge["py"])
    moving = dataclasses.replace(gauge["pack"], static=dataclasses.replace(
        gauge["pack"].static, has_motion=True))
    assert "motion blur" in mb.bwd_missing(moving.static, opts)
    before = dict(mb.LAUNCHES)
    lens = dataclasses.replace(cam, use_dof=True, aperture=torch.tensor(0.2),
                               focus_distance=torch.tensor(30.0))
    for pack, camera in ((moving, cam), (gauge["pack"], lens)):
        _, h = optimize(pack, camera, *args, opts, gauge["target"], FIELDS,
                        steps=2, lr=5e-2, device="cpu")
        assert len(h) == 2 and np.isfinite(h).all() and h[1] < h[0], h
    assert mb.LAUNCHES == before


def test_bwd_missing_names_each_gate_and_keeps_no_tpu_cap(gauge):
    st = gauge["pack"].static
    opts = options_for_camera(gauge["cfg"], gauge["cfg"].cameras[0])
    assert mb.bwd_missing(st, opts) == []
    # the JAX TPU caps are gone: 4,096 rows, 32 materials, light counts
    big = dataclasses.replace(st, n_work_items=5000, n_faces=5000,
                              n_materials=40, n_point=9, n_directional=6,
                              n_spheres=8)
    assert mb.bwd_eligible(big, dataclasses.replace(opts, max_depth=10))
    # K2b's envelope: path tracing with RR, and every light kind, up to 32
    pt = dataclasses.replace(opts, path_tracing=True, russian_roulette=True,
                             next_event_estimation=True, max_depth=10)
    lights = dataclasses.replace(st, n_point=10, n_directional=5, n_spot=8,
                                 n_area=5, n_mesh_lights=4)
    assert mb.bwd_missing(lights, pt) == []
    lights = "more than 32 point, directional, spot, area and mesh lights"
    cases = [
        (dataclasses.replace(st, n_point=10, n_directional=5, n_spot=8,
                             n_area=6, n_mesh_lights=4), pt, lights),
        (dataclasses.replace(st, n_mesh_lights=5), opts,
         "more than 4 mesh lights"),
        (dataclasses.replace(st, n_textures=1), opts, "textures"),
        (dataclasses.replace(st, n_env=1), opts, "an environment light"),
        (dataclasses.replace(st, has_motion=True), opts, "motion blur"),
        (dataclasses.replace(st, has_rough=True), opts, "roughness"),
        (dataclasses.replace(st, n_brdfs=1), opts, "pluggable BRDFs"),
        (dataclasses.replace(st, n_spheres=9), opts, "more than 8 spheres"),
        (dataclasses.replace(st, n_materials=129), opts,
         "more than 128 materials"),
        (st, dataclasses.replace(opts, max_depth=11), "depth above 10"),
        (dataclasses.replace(st, n_point=20, n_directional=13), opts, lights),
    ]
    for static, o, want in cases:
        assert want in mb.bwd_missing(static, o), want
        assert not mb.bwd_eligible(static, o)


def test_bwd_missing_words_the_texture_gates(tmp_path):
    """Diffuse image textures are K2c's (tests/test_torch_diff_tex.py); a
    Perlin one, or a specular slot or a bump map, the JAX fused kernel never
    differentiates: the K1d image scene's replace_ks and Perlin replace_kd
    beside its nearest replace_kd and bilinear blend_kd are named, and so
    are the Perlin scene's."""
    from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import k1d_scenes

    xmls = k1d_scenes(tmp_path, REPO / "scenes")
    for name, want in (
            ("image", ["Perlin textures", "textures with decal replace_ks "
                       "(specular-slot, bump or normal-map)"]),
            ("perlin", ["Perlin textures", "textures with decal bump_normal, "
                        "replace_ks (specular-slot, bump or normal-map)"])):
        path = tmp_path / f"{name}.xml"
        path.write_text(xmls[name])
        cfg = load_scene(str(path))
        pack = pack_scene(cfg, device="cpu")
        opts = options_for_camera(cfg, cfg.cameras[0])
        assert mb.bwd_missing(pack.static, opts, pack) == want, name


def test_branch_uniforms_are_philox_keyed_by_seed_and_step():
    """``ud_table`` (the kernel's draws without a table, in torch): row k,
    column i is Philox4x32-10 with key (seed, step) and counter (i, k, 0,
    0), word 0, as 23-bit uniforms."""
    table = mb.ud_table(7, 3, 300, 5)
    assert table.shape == (5, 300) and table.dtype == torch.float32
    i = torch.arange(300, dtype=torch.int64)
    for k in range(5):
        words = philox4x32(i, torch.full_like(i, k), torch.zeros_like(i),
                           torch.zeros_like(i), 7, 3)
        assert torch.equal(table[k], uniform_from_bits(words[0]))
    assert not torch.equal(table, mb.ud_table(7, 4, 300, 5))
    assert float(table.min()) >= 0.0 and float(table.max()) < 1.0


def test_draws_are_required_and_params_carry_over(tmp_path):
    cfg = load_scene(demo_scene(tmp_path))
    pack = pack_scene(cfg, device="cpu")
    opts = options_for_camera(cfg, cfg.cameras[0])
    bc = mb.build_bwd_consts(pack, opts, device="cpu")
    assert bc.has_dielectric and mb.bc_depth(bc) == cfg.max_recursion_depth + 1
    f = mb.make_diff_render(pack, opts, device="cpu")
    tabs = f.tables({})
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]] * 4)
    with pytest.raises(ValueError, match="draws"):
        mb.diff_trace_ref(bc, tabs, o, d)
    # without a table the CPU wrapper draws the Philox twin's uniforms
    assert torch.equal(mb.mega_bwd_trace(bc, tabs, o, d, seed=2, step=1),
                       mb.mega_bwd_trace(bc, tabs, o, d, draws=mb.ud_table(
                           2, 1, 4, mb.bc_depth(bc))))
    # the JAX leaves come across unchanged, and back into a pack
    arrays = {k: np.asarray(getattr(pack, k)) for k in PARAM_FIELDS}
    leaves = params_from_arrays(arrays, "cpu")
    assert all(v.requires_grad and v.dtype == torch.float32
               for v in leaves.values())
    back = extract_params(inject_params(pack, leaves), PARAM_FIELDS)
    for k in PARAM_FIELDS:
        np.testing.assert_array_equal(back[k].detach().numpy(), arrays[k])
