"""The differentiable render's specular mixtures and light sampling (slice
C2, K2b) against the JAX package's oracle, ``jax.grad`` of
``trace_radiance(differentiable=True)`` with ``PRNGKey(0)``
(tests/test_megabwd.py:214-260, 435-568): the path-traced Cornell box with
a mirror and a conductor wall at depth 2, without and with its absorbing
glass sphere (the replayed coin between a GI and a specular child,
``stochastic_spec_gi``); that box with the glass under Russian roulette at
depth 1, the glass made partly diffuse and more absorbing, so that a GI
child leaves its inner surface on an RR-tail segment whose kill and 1/prob
reweight take the weight after Beer's attenuation (the oracle's order,
integrator.py:218-219, 260-265); and ``scenes/feat_spotareaml.xml`` (a spot,
an area and a mesh light, an emissive hit, Whitted) at depth 2.

The method, draws and tolerances are ``tests/test_torch_diff_pt.py``'s
(value rtol 2e-4; gradients rtol 5e-3, atol 5e-4 max|g|, under RR a log1p
loss and atol 1e-3 max|g|; central finite differences within rtol 2e-3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb
from scene_builders import cornell_pt_spec_xml
from test_torch_common import REPO
from test_torch_diff_pt import (
    assert_grads_close,
    cos_loss,
    log1p_loss,
    oracle,
    port,
    setup,
)

torch.set_num_threads(1)


def glass_under_rr() -> str:
    """The mirror / conductor / glass box at depth 1 under Russian roulette,
    its glass diffuse 0.4 and absorbing 0.2 0.5 0.3 per unit, its light
    mesh grown to 9 x 9 of the ceiling: a GI child keeps the glass's
    medium, so the paths that leave the glass see no NEE and count only
    where they hit the light."""
    xml = cornell_pt_spec_xml(depth=1, res=32, spp=1,
                              params="NextEventEstimation RussianRoulette",
                              dielectric=True)
    light = "-1.5 9.99 -1.5   1.5 9.99 -1.5   1.5 9.99 1.5   -1.5 9.99 1.5"
    assert light in xml
    xml = xml.replace(light, "-4.5 9.99 -4.5   4.5 9.99 -4.5   4.5 9.99 4.5   "
                             "-4.5 9.99 4.5")
    glass = xml[xml.index('<Material id="7" type="dielectric">'):]
    glass = glass[:glass.index("</Material>")]
    new = glass.replace("<DiffuseReflectance>0 0 0</DiffuseReflectance>",
                        "<DiffuseReflectance>0.4 0.4 0.4</DiffuseReflectance>"
                        ).replace("0.02 0.05 0.02", "0.2 0.5 0.3")
    assert new != glass
    return xml.replace(glass, new)


# the glass sphere's pixels in the 32x32 box (rows 15-20, columns 12-18)
GLASS = (13.0, 18.0, 15.5, 20.0)
CASES = {
    # name: (scene XML, rays, loss, gradient atol scale, depth, pixels)
    "spec": (cornell_pt_spec_xml(depth=2, res=32, spp=1,
                                 params="NextEventEstimation"),
             256, cos_loss, 5e-4, None, None),
    "spec_glass": (cornell_pt_spec_xml(depth=2, res=32, spp=1,
                                       params="NextEventEstimation",
                                       dielectric=True),
                   256, cos_loss, 5e-4, None, None),
    "glass_under_rr": (glass_under_rr(), 128, log1p_loss, 1e-3, None, GLASS),
    "spot_area_mesh": ((REPO / "scenes" / "feat_spotareaml.xml").read_text(),
                       256, cos_loss, 5e-4, 2, None),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request, tmp_path_factory):
    xml, n, loss, atol, depth, window = CASES[request.param]
    s = setup(xml, tmp_path_factory.mktemp(request.param), n, max_depth=depth,
              seed=5, window=window)
    s.update(name=request.param, loss=loss, atol=atol)
    s["jax"] = oracle(s, loss)
    s["port"] = port(s, loss)
    return s


def test_value_and_every_leaf_match_the_jax_oracle(case):
    v_jax, g_jax = case["jax"]
    v, g = case["port"]
    np.testing.assert_allclose(v, v_jax, rtol=2e-4)
    assert_grads_close(g, g_jax, case["name"], case["atol"])
    bc, st = case["bc"], case["pack"].static
    assert bc.k2b and bc.variant == "mega_bwd_pt"
    if case["name"] == "spot_area_mesh":
        assert not bc.pt and (st.n_spot, st.n_area, st.n_mesh_lights) == (1, 1, 1)
        for k in ("sl_intensity", "al_radiance", "ml_radiance", "mat_radiance",
                  "verts"):
            assert np.abs(g[k]).sum() > 0, k
        return
    assert bc.pt_spec
    if case["name"] != "spec":
        assert st.has_dielectric and mb.draw_planes(bc)["ud"] > 0
    if case["name"] == "glass_under_rr":
        # the rays see the glass: its diffuse colour, not the mirror, moves
        assert bc.pt_rr and mb.bc_depth(bc) == 2 + mb.mk.RR_DEPTH_FLOOR
        assert np.abs(g["mat_diffuse"][6]).sum() > 0
    else:  # a specular child was taken by some ray, and the coin ran
        assert np.abs(g["mat_mirror"]).sum() > 0


@pytest.mark.parametrize("case", ["spec"], indirect=True)
def test_central_finite_differences(case):
    """The plain version's gradient of the mirror's red reflectance against
    central differences of its own forward (the JAX kernel test's check,
    tests/test_megabwd.py:549-568)."""
    _, g = case["port"]
    row = int(np.argmax(np.abs(g["mat_mirror"]).sum(axis=1)))
    h = 1e-3
    vals = []
    for step in (h, -h):
        mir = case["arrays"]["mat_mirror"].copy()
        mir[row, 0] += step
        vals.append(port(case, case["loss"], {**case["arrays"],
                                              "mat_mirror": mir}, grad=False))
    fd = (vals[0] - vals[1]) / (2 * h)
    np.testing.assert_allclose(g["mat_mirror"][row, 0], fd, rtol=2e-3)


def test_draws_of_each_light_kind_reach_the_plain_version(tmp_path):
    """The area offsets and the mesh light's face picks are the draws'
    alone: moving one plane by a table of other uniforms changes the
    radiance, and the wrapper refuses planes of the wrong shape."""
    s = setup(CASES["spot_area_mesh"][0], tmp_path, 64, max_depth=2)
    bc, dr = s["bc"], s["draws"]
    assert mb.draw_planes(bc) == {"uab": 3 * 2, "uml": 3 * 3, "ud": 0,
                                  "ugi": 0}
    f = mb.make_diff_render(s["pack"], s["opts"], device="cpu")
    o, d = torch.tensor(s["o"]), torch.tensor(s["d"])
    with torch.no_grad():
        base = f({}, o, d, draws=dr)
        gen = torch.Generator().manual_seed(9)
        other = mb.table_draws(bc, 64, gen)
        for name in ("uab", "uml"):
            moved = f({}, o, d, draws=dr._replace(**{name: getattr(other, name)}))
            assert not torch.equal(moved, base), name
    with pytest.raises(ValueError, match="uab"):
        f({}, o, d, draws=dr._replace(uab=dr.uab[:2]))
    count = int(bc.mc.ml_lights[0, 4])
    picks = other.uml[0::3]
    assert float(picks.min()) >= 0 and float(picks.max()) <= count - 1
    assert float(other.uab.min()) >= -0.5 and float(other.uab.max()) < 0.5
    assert dataclasses.is_dataclass(bc) and bc.n_area == 1 and bc.n_ml == 1


@pytest.mark.parametrize("name", ["feat_pt", "feat_pt_rr", "feat_pt_spec",
                                  "feat_spotareaml"])
def test_the_bench_scenes_run_on_the_cpu(name):
    """JAX ``bench.py --bwd``'s K2b scenes (``--bwd-scene pt``, ``ptrr``,
    ``ptspec``, ``spotareaml``) through ``make_diff_render`` and one
    ``optimize`` step on the CPU, the plain version both ways: finite
    radiance and gradients, the Philox draws of (seed, step) the same from
    one call to the next."""
    from advanced_cpu_raytracing_tpu_torch.diff.optimize import optimize
    from advanced_cpu_raytracing_tpu_torch.render.camera import (
        build_camera,
        generate_rays,
    )
    from advanced_cpu_raytracing_tpu_torch.render.renderer import (
        options_for_camera,
    )
    from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene

    cfg = load_scene(str(REPO / "scenes" / f"{name}.xml"))
    pack = pack_scene(cfg, device="cpu")
    opts = options_for_camera(cfg, cfg.cameras[0])
    f = mb.make_diff_render(pack, opts, device="cpu")
    assert f.bc.k2b and f.bc.variant == "mega_bwd_pt"
    cam = build_camera(cfg.cameras[0], device="cpu")
    rng = np.random.default_rng(2)
    px = torch.tensor(rng.uniform(0, cfg.cameras[0].width, 48).astype(np.float32))
    py = torch.tensor(rng.uniform(0, cfg.cameras[0].height, 48).astype(np.float32))
    o, d = generate_rays(cam, px, py)
    leaf = pack.mat_diffuse.clone().requires_grad_(True)
    img = f({"mat_diffuse": leaf}, o, d, seed=4, step=1)
    (img ** 2).sum().backward()
    assert bool(torch.isfinite(img).all()) and float(img.detach().sum()) > 0
    assert bool(torch.isfinite(leaf.grad).all()) and float(leaf.grad.abs().sum()) > 0
    with torch.no_grad():
        assert torch.equal(f({}, o, d, seed=4, step=1), img.detach())
    _, hist = optimize(pack, cam, px, py, opts, img.detach() * 0.9,
                       ("mat_diffuse",), steps=1, device="cpu")
    assert len(hist) == 1 and np.isfinite(hist[0])
