"""The differentiable render's path tracing (slice C2, K2b) against the JAX
package's own reference for its fused fwd+bwd kernel: ``jax.grad`` of
``trace_radiance(differentiable=True)`` with ``PRNGKey(0)``
(tests/test_megabwd.py:294-432), on 256 camera rays (128 under Russian
roulette) of the path-traced Cornell box of ``tests/scene_builders.py``:
at depth 2 in the three RendererParams modes (NEE with importance
sampling, NEE alone, neither), under Russian roulette at depth 1 (its
eight extra segments), and with a diffuse sphere in the box, whose normal
moves with the ray, so that the GI direction's adjoint crosses the
orthonormal basis.

Both packages get the same inputs: the rays from the JAX camera, the
parameters through ``params_from_arrays``, and every draw (mesh-light
picks and barycentrics, GI uniforms, kill draws) from the JAX
``wavefront_rng`` as a ``BwdDraws``, which the oracle consumes lane for
lane.  The tolerances are the JAX package's own: value rtol 2e-4,
gradients rtol 5e-3 and atol 5e-4 max|g| (under RR a log1p loss and atol
1e-3 max|g|: 1/prob fireflies reach 1e4, tests/test_megabwd.py:375-432);
central finite differences within rtol 2e-3.  Also here: the Philox twin
``bwd_draws`` against Philox4x32-10's words, and ``optimize`` on the CPU
against the JAX ``optimize`` through its fused kernel in interpret mode
(the draws of ``PRNGKey(0)`` at every step on both sides), and the
loss of ``chip_smoke.py``'s path-traced (phase 22) and gauge (phase 19,
K2a) training runs falling at every step on a grid of their rays.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

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
from advanced_cpu_raytracing_tpu.ops.pallas.megabwd import wavefront_rng
from advanced_cpu_raytracing_tpu.render import camera as jax_camera
from advanced_cpu_raytracing_tpu.render.integrator import (
    RR_DEPTH_FLOOR,
    RenderOptions as JaxOptions,
    trace_radiance,
)
from advanced_cpu_raytracing_tpu.render.renderer import (
    options_for_camera as jax_options_for_camera,
)
from advanced_cpu_raytracing_tpu.scene.pack import pack_scene as jax_pack_scene
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene as jax_load_scene
from advanced_cpu_raytracing_tpu_torch.diff.optimize import (
    FEAT_PT_RATES,
    GAUGE_RATES,
    optimize,
)
from advanced_cpu_raytracing_tpu_torch.diff.params import (
    inject_params,
    params_from_arrays,
)
from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb
from advanced_cpu_raytracing_tpu_torch.ops.rng import philox4x32, uniform_from_bits
from advanced_cpu_raytracing_tpu_torch.render.camera import build_camera, generate_rays
from advanced_cpu_raytracing_tpu_torch.render.renderer import options_for_camera
from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import gauge_scene_xml
from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from scene_builders import cornell_pt_spec_xml, cornell_pt_xml

torch.set_num_threads(1)

# every differentiable leaf of K2a and K2b
LEAVES = ("mat_ambient", "mat_diffuse", "mat_specular", "mat_mirror",
          "mat_phong", "mat_radiance", "pl_intensity", "dl_radiance",
          "sl_intensity", "al_radiance", "ml_radiance", "bg_color", "verts")


def cos_loss(img, lib=torch):
    """The JAX tests' loss: a non-trivial cotangent per pixel."""
    return (img * lib.cos(0.01 * img)).sum()


def log1p_loss(img, lib=torch):
    """The JAX RR test's loss, on the scale of RR's fireflies."""
    return lib.log1p(img).sum()


def with_sphere(xml: str, material: int = 1) -> str:
    """The Cornell box with a sphere of radius 2 mid-box (the placement of
    scene_builders.cornell_pt_spec_xml's glass sphere) of ``material``."""
    return xml.replace("</VertexData>", "  0 3.5 0\n  </VertexData>").replace(
        "</Objects>", f'<Sphere id="1"><Material>{material}</Material>'
        "<Center>13</Center><Radius>2</Radius></Sphere>\n  </Objects>")


def setup(xml: str, tmp, n: int, max_depth: int | None = None, seed: int = 3,
          window=None, leaves=LEAVES, path=None):
    """Both packages' packs of the scene ``xml`` (written to ``tmp``, or
    the scene file ``path``), the rays from the JAX camera (through uniform
    pixel positions, in the whole image or in ``window`` = (x0, x1, y0,
    y1)), the JAX draws as a ``BwdDraws``, the oracle's options and the
    parameter ``leaves`` as numpy."""
    if path is None:
        path = tmp / "scene.xml"
        path.write_text(xml)
    jcfg = jax_load_scene(str(path))
    jpack = jax_pack_scene(jcfg)
    cam = jax_camera.build_camera(jcfg.cameras[0])
    rng = np.random.default_rng(seed)
    x0, x1, y0, y1 = window or (0, cam.width, 0, cam.height)
    px = rng.uniform(x0, x1, n).astype(np.float32)
    py = rng.uniform(y0, y1, n).astype(np.float32)
    o, d = jax_camera.generate_rays(cam, jnp.asarray(px), jnp.asarray(py),
                                    jnp.zeros((n, 2)), dof=False)
    cfg = load_scene(str(path))
    pack = pack_scene(cfg, device="cpu")
    opts = options_for_camera(cfg, cfg.cameras[0])
    if max_depth is not None:
        opts = dataclasses.replace(opts, max_depth=max_depth)
    bc = mb.build_bwd_consts(pack, opts, device="cpu")
    st = jpack.static
    ml_counts = tuple(int(c) for c in
                      np.asarray(jpack.ml_face_count)[:st.n_mesh_lights])
    planes = wavefront_rng(jax.random.PRNGKey(0), n, mb.bc_depth(bc), st.n_area,
                           st.has_dielectric, ml_counts, need_gi=bc.pt,
                           need_rr=bc.pt_rr, need_sg=bc.pt_spec)
    draws = mb.BwdDraws(*(torch.tensor(np.asarray(x)) for x in planes))
    j_opts = JaxOptions(
        max_depth=opts.max_depth, differentiable=True,
        max_iters=opts.max_depth + 2 + (RR_DEPTH_FLOOR if bc.pt_rr else 0),
        path_tracing=bc.pt, next_event_estimation=bc.pt_nee,
        importance_sampling=bc.pt_importance, russian_roulette=bc.pt_rr,
        stochastic_dielectric=bc.has_dielectric, stochastic_spec_gi=bc.pt_spec)
    arrays = {k: np.asarray(v) for k, v in
              jax_extract_params(jpack, leaves).items()}
    return dict(path=path, jpack=jpack, cam=cam, px=px, py=py, o=np.asarray(o),
                d=np.asarray(d), pack=pack, opts=opts, bc=bc, draws=draws,
                j_opts=j_opts, arrays=arrays)


def oracle(s, loss):
    """JAX value and gradients of the loss through the wavefront."""
    def value(params):
        img = trace_radiance(jax_inject_params(s["jpack"], params), s["cam"],
                             jnp.asarray(s["px"]), jnp.asarray(s["py"]),
                             jax.random.PRNGKey(0), s["j_opts"])
        return loss(img, jnp)

    params = {k: jnp.asarray(v) for k, v in s["arrays"].items()}
    v, g = jax.value_and_grad(value)(params)
    return float(v), {k: np.asarray(x) for k, x in g.items()}


def port(s, loss, arrays=None, grad=True):
    """The port's plain version: the loss, and the leaves' gradients."""
    params = params_from_arrays(s["arrays"] if arrays is None else arrays,
                                "cpu")
    f = mb.make_diff_render(s["pack"], s["opts"], device="cpu")
    with torch.set_grad_enabled(grad):
        value = loss(f(params, torch.tensor(s["o"]), torch.tensor(s["d"]),
                       draws=s["draws"]))
    if not grad:
        return float(value)
    value.backward()
    return float(value.detach()), {k: p.grad.numpy()
                                   for k, p in params.items()}


def assert_grads_close(got: dict, want: dict, what: str,
                       atol_scale: float = 5e-4):
    for k in LEAVES:
        a, b = want[k], got[k]
        assert b.shape == a.shape, (what, k)
        if a.size == 0:
            continue
        assert np.all(np.isfinite(a)), (what, "oracle", k)
        assert np.all(np.isfinite(b)), (what, k)
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b, a, rtol=5e-3, atol=atol_scale * scale,
                                   err_msg=f"{what}: {k}")


NEE_IS = "NextEventEstimation ImportanceSampling"
CASES = {
    # name: (scene XML, rays, loss, gradient atol scale)
    "nee_importance": (cornell_pt_xml(depth=2, res=32, spp=1, params=NEE_IS),
                       256, cos_loss, 5e-4),
    "nee": (cornell_pt_xml(depth=2, res=32, spp=1,
                           params="NextEventEstimation"), 256, cos_loss, 5e-4),
    "no_nee": (cornell_pt_xml(depth=2, res=32, spp=1, params=""), 256,
               cos_loss, 5e-4),
    "russian_roulette": (cornell_pt_xml(depth=1, res=32, spp=1,
                                        params=NEE_IS + " RussianRoulette"),
                         128, log1p_loss, 1e-3),
    "diffuse_sphere": (with_sphere(cornell_pt_xml(depth=2, res=32, spp=1,
                                                  params=NEE_IS)),
                       256, cos_loss, 5e-4),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request, tmp_path_factory):
    xml, n, loss, atol = CASES[request.param]
    s = setup(xml, tmp_path_factory.mktemp(request.param), n)
    s.update(name=request.param, loss=loss, atol=atol)
    s["jax"] = oracle(s, loss)
    s["port"] = port(s, loss)
    return s


def test_value_and_every_leaf_match_the_jax_oracle(case):
    v_jax, g_jax = case["jax"]
    v, g = case["port"]
    np.testing.assert_allclose(v, v_jax, rtol=2e-4)
    assert_grads_close(g, g_jax, case["name"], case["atol"])
    bc = case["bc"]
    assert bc.pt and bc.k2b and bc.variant == "mega_bwd_pt"
    # the GI chain carries gradient: with NEE off the light reaches the
    # camera through emissive hits only
    assert np.abs(g["mat_diffuse"]).sum() > 0
    assert np.abs(g["mat_radiance"]).sum() + np.abs(g["ml_radiance"]).sum() > 0
    if case["name"] != "no_nee":
        assert np.abs(g["ml_radiance"]).sum() > 0
        assert np.abs(g["verts"]).sum() > 0
    if case["name"] == "russian_roulette":
        assert bc.pt_rr and mb.bc_depth(bc) == 1 + 1 + RR_DEPTH_FLOOR
    if case["name"] == "diffuse_sphere":
        assert case["pack"].static.n_spheres == 1 and not bc.pt_spec


@pytest.mark.parametrize("case", ["nee_importance"], indirect=True)
def test_central_finite_differences(case):
    """The plain version's gradient of one wall's diffuse red against
    central differences of its own forward (given the draws the topology
    does not move with kd, so the forward is smooth in it)."""
    _, g = case["port"]
    h = 1e-3
    vals = []
    for step in (h, -h):
        kd = case["arrays"]["mat_diffuse"].copy()
        kd[0, 0] += step
        vals.append(port(case, case["loss"], {**case["arrays"],
                                              "mat_diffuse": kd}, grad=False))
    fd = (vals[0] - vals[1]) / (2 * h)
    np.testing.assert_allclose(g["mat_diffuse"][0, 0], fd, rtol=2e-3)


def test_bwd_draws_are_philox_keyed_by_seed_and_step(tmp_path):
    """``bwd_draws`` (the kernels' draws without a table, in torch): segment
    k of ray i from Philox4x32-10 keyed (seed, step) with counter (i, k, c,
    0) — c = 0 the branch uniform (``ud_table``'s), 1 the GI pair, kill
    draw and coin, 2 + a area light a's offsets minus 0.5, 2 + n_area + m
    mesh light m's face pick min(floor(u count), count - 1) and
    barycentrics — in the JAX ``wavefront_rng`` layout."""
    xml = cornell_pt_spec_xml(depth=2, res=32, spp=1,
                              params=NEE_IS + " RussianRoulette")
    xml = xml.replace("<Lights></Lights>", """<Lights>
      <AreaLight id="1"><Position>0 9 0</Position><Normal>0 -1 0</Normal>
        <Radiance>5 5 5</Radiance><Size>1</Size></AreaLight></Lights>""")
    path = tmp_path / "s.xml"
    path.write_text(xml)
    cfg = load_scene(str(path))
    pack = pack_scene(cfg, device="cpu")
    bc = mb.build_bwd_consts(pack, options_for_camera(cfg, cfg.cameras[0]),
                             device="cpu")
    assert bc.pt_rr and bc.pt_spec and (bc.n_area, bc.n_ml) == (1, 1)
    n, depth = 300, mb.bc_depth(bc)
    dr = mb.bwd_draws(bc, 7, 3, n)
    assert {k: tuple(getattr(dr, k).shape) for k in dr._fields} == {
        k: (v, n) for k, v in mb.draw_planes(bc).items()}
    i = torch.arange(n, dtype=torch.int64)

    def words(k, c):
        return [uniform_from_bits(w) for w in philox4x32(
            i, torch.full_like(i, k), torch.full_like(i, c),
            torch.zeros_like(i), 7, 3)]

    count = int(bc.mc.ml_lights[0, 4])
    for k in (0, depth - 1):
        w = words(k, 1)
        assert torch.equal(dr.ugi[2 * k], w[0])
        assert torch.equal(dr.ugi[2 * k + 1], w[1])
        assert torch.equal(dr.ugi[2 * depth + k], w[2])  # the kill draws
        assert torch.equal(dr.ugi[3 * depth + k], w[3])  # then the coins
        w = words(k, 2)  # the area light
        assert torch.equal(dr.uab[2 * k], w[0] - 0.5)
        assert torch.equal(dr.uab[2 * k + 1], w[1] - 0.5)
        w = words(k, 3)  # the mesh light, after the area light
        assert torch.equal(dr.uml[3 * k], torch.clamp(
            (w[0] * float(count)).to(torch.int64), max=count - 1).float())
        assert torch.equal(dr.uml[3 * k + 1], w[1])
        assert torch.equal(dr.uml[3 * k + 2], w[2])
    picks = dr.uml[0::3]
    assert bool((picks == picks.floor()).all()) and float(picks.min()) == 0.0
    assert float(picks.max()) == count - 1
    assert float(dr.uab.min()) >= -0.5 and float(dr.uab.max()) < 0.5
    assert not torch.equal(dr.ugi, mb.bwd_draws(bc, 7, 4, n).ugi)
    # without a table the CPU wrapper draws the twin's
    f = mb.make_diff_render(pack, options_for_camera(cfg, cfg.cameras[0]),
                            device="cpu")
    tabs = f.tables({})
    o = torch.tensor([[0.0, 5.0, 19.0]] * 6)
    d = torch.nn.functional.normalize(torch.tensor(
        [[0.1 * j, -0.2, -1.0] for j in range(6)]), dim=1)
    assert torch.equal(mb.mega_bwd_trace(bc, tabs, o, d, seed=7, step=3),
                       mb.mega_bwd_trace(bc, tabs, o, d,
                                         mb.bwd_draws(bc, 7, 3, 6)))
    with pytest.raises(ValueError, match="draws"):
        mb.diff_trace_ref(bc, tabs, o, d)
    with pytest.raises(ValueError, match="ugi"):
        mb.mega_bwd_trace(bc, tabs, o, d, mb.bwd_draws(bc, 7, 3, 6)._replace(
            ugi=torch.zeros((2, 6))))


def test_optimize_on_the_cpu_matches_the_jax_loss_history(tmp_path):
    """Three Adam steps on the path-traced box (NEE, importance sampling,
    depth 2) from the same perturbed kd and light radiance: the port's
    ``optimize`` on the CPU, fed the JAX draws of ``PRNGKey(0)``, against
    the JAX ``optimize`` through its fused kernel in interpret mode, whose
    key stays ``PRNGKey(0)`` at every step; within 1e-3 relative (f32 on
    both sides)."""
    fields = ("mat_diffuse", "ml_radiance")
    s = setup(cornell_pt_xml(depth=2, res=32, spp=1, params=NEE_IS), tmp_path,
              128, seed=11)
    f = mb.make_diff_render(s["pack"], s["opts"], device="cpu")
    with torch.no_grad():  # the target at the true parameters
        target = f({}, torch.tensor(s["o"]), torch.tensor(s["d"]),
                   draws=s["draws"]).numpy()
    rng = np.random.default_rng(21)
    start = {k: s["arrays"][k].copy() for k in fields}
    start["mat_diffuse"] *= rng.uniform(0.7, 1.1, start["mat_diffuse"].shape
                                        ).astype(np.float32)
    start["ml_radiance"] *= np.float32(1.3)
    jcfg = jax_load_scene(str(s["path"]))
    _, h_jax = jax_optimize(
        jax_inject_params(s["jpack"], {k: jnp.asarray(v)
                                       for k, v in start.items()}),
        s["cam"], jnp.asarray(s["px"]), jnp.asarray(s["py"]),
        jax_options_for_camera(jcfg, jcfg.cameras[0]), target, fields, steps=3,
        lr=5e-2, use_fused=True)
    cfg = load_scene(str(s["path"]))
    out, h = optimize(inject_params(s["pack"], {k: torch.tensor(v)
                                                for k, v in start.items()}),
                      build_camera(cfg.cameras[0], device="cpu"), s["px"],
                      s["py"], s["opts"], target, fields, steps=3, lr=5e-2,
                      device="cpu", draws=s["draws"])
    np.testing.assert_allclose(h, h_jax, rtol=1e-3)
    assert h[-1] < h[0] and len(h) == 3
    assert float((out.ml_radiance - torch.tensor(start["ml_radiance"])
                  ).abs().max()) > 0.05


def test_the_training_rates_make_the_loss_fall_at_every_step():
    """chip_smoke.py phase 22's training run, cut to a 40x40 grid of its
    800x800 rays on the CPU: the same start (kd scaled by U(0.7, 1.1) of
    seed 7, the mesh light's radiance x1.2, the vertices moved by
    N(0, 0.001)) and the same per-field rates (``diff/optimize.py::
    FEAT_PT_RATES``); the loss falls at every one of the 5 Adam steps, to
    below a third of where it began.  With kd at
    2e-2 it rises after the third step: Adam moves each value about its
    rate a step, and kd's 0.1 channels start within 0.03 of the truth."""
    root = Path(__file__).resolve().parents[1]
    cfg = load_scene(str(root / "scenes" / "feat_pt.xml"))
    cam_cfg = cfg.cameras[0]
    pack, opts = pack_scene(cfg, device="cpu"), options_for_camera(cfg, cam_cfg)
    cam = build_camera(cam_cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    ys, xs = torch.meshgrid(torch.arange(0, cam_cfg.height, 20),
                            torch.arange(0, cam_cfg.width, 20), indexing="ij")
    jit = torch.rand((xs.numel(), 2), generator=gen)
    px = xs.reshape(-1).float() + jit[:, 0]
    py = ys.reshape(-1).float() + jit[:, 1]
    rng = np.random.default_rng(7)
    start = {
        "mat_diffuse": pack.mat_diffuse * torch.as_tensor(rng.uniform(
            0.7, 1.1, tuple(pack.mat_diffuse.shape)).astype(np.float32)),
        "ml_radiance": pack.ml_radiance * 1.2,
        "verts": pack.verts + torch.as_tensor(rng.normal(
            0.0, 0.001, tuple(pack.verts.shape)).astype(np.float32))}
    f = mb.make_diff_render(pack, opts, device="cpu")
    with torch.no_grad():
        target = f({}, *generate_rays(cam, px, py))
    rates = FEAT_PT_RATES
    _, h = optimize(inject_params(pack, start), cam, px, py, opts, target,
                    tuple(rates), steps=5, lr=rates, device="cpu")
    assert all(np.isfinite(h)) and len(h) == 5
    assert all(b < a for a, b in zip(h, h[1:])), h
    assert h[-1] < h[0] / 3, h


def test_the_gauge_rates_make_the_loss_fall_at_every_step(tmp_path):
    """chip_smoke.py phase 19's training run (K2a, the gauge scene at depth
    6), cut to a 20x20 grid of its 800x800 rays on the CPU: the same start
    (kd scaled by U(0.7, 1.1) of seed 6, the point lights x1.2, the vertices
    moved by N(0, 0.01)), the same draws (Philox keyed (0, 0)) and the same
    per-field rates (``diff/optimize.py::GAUGE_RATES``); the loss falls at
    every one of the 5 Adam steps, to below 0.8 of where it began.  With kd
    at 2e-2 (the rate phase 19 had before) or 1e-2 it rises after the third
    step, as phase 19's history did on the card (646.4 -> 465.4 -> 403.35
    -> 403.36 -> 428.0)."""
    cfg = load_scene(gauge_scene_xml(tmp_path, Path(__file__).resolve()
                                     .parents[1] / "scenes"))
    cam_cfg = cfg.cameras[0]
    pack, opts = pack_scene(cfg, device="cpu"), options_for_camera(cfg, cam_cfg)
    cam = build_camera(cam_cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    ys, xs = torch.meshgrid(torch.arange(0, cam_cfg.height, 40),
                            torch.arange(0, cam_cfg.width, 40), indexing="ij")
    jit = torch.rand((xs.numel(), 2), generator=gen)
    px = xs.reshape(-1).float() + jit[:, 0]
    py = ys.reshape(-1).float() + jit[:, 1]
    rng = np.random.default_rng(6)
    start = {
        "mat_diffuse": pack.mat_diffuse * torch.as_tensor(rng.uniform(
            0.7, 1.1, tuple(pack.mat_diffuse.shape)).astype(np.float32)),
        "pl_intensity": pack.pl_intensity * 1.2,
        "verts": pack.verts + torch.as_tensor(rng.normal(
            0.0, 0.01, tuple(pack.verts.shape)).astype(np.float32))}
    f = mb.make_diff_render(pack, opts, device="cpu")
    assert f.bc.variant == "mega_bwd_tree" and f.bc.has_dielectric
    with torch.no_grad():
        target = f({}, *generate_rays(cam, px, py))
    rates = GAUGE_RATES
    _, h = optimize(inject_params(pack, start), cam, px, py, opts, target,
                    tuple(rates), steps=5, lr=rates, device="cpu")
    assert all(np.isfinite(h)) and len(h) == 5
    assert all(b < a for a, b in zip(h, h[1:])), h
    assert h[-1] < 0.8 * h[0], h
