"""The differentiable render's plain version (slice C1, K2a) against the
JAX package's own reference for its fused fwd+bwd kernel: ``jax.grad`` of
``trace_radiance(differentiable=True, stochastic_dielectric=True)`` with
``PRNGKey(0)`` (tests/test_megabwd.py:52-58, 158-201), on 256 camera rays
at depth 2 of three in-repo scenes: the coarse slice scene (mirror,
conductors, a dielectric), the demo scene (mirror and dielectric spheres
over a floor, its background seen past the floor) and the coarse gauge
scene with its glass made a mirror (no draws, a directional light); and
the demo scene with its mirror sphere made emissive in both packs (the
emissive hit).

Both packages get the same inputs: the rays from the JAX camera, the
parameters through ``params_from_arrays``, and the dielectric's branch
uniforms from the JAX ``wavefront_rng`` (the oracle consumes the same
draws lane for lane).  One JAX value-and-grad per scene, with every leaf,
is cached in a module fixture.  The tolerances are the JAX package's own
(tests/test_megabwd.py:100, 107-109): value rtol 2e-4, gradients rtol
5e-3 and atol 5e-4 max|g|; central finite differences within rtol 2e-3
(tests/test_megabwd.py:372).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu.diff.params import (
    extract_params as jax_extract_params,
    inject_params as jax_inject_params,
)
from advanced_cpu_raytracing_tpu.ops.pallas.megabwd import wavefront_rng
from advanced_cpu_raytracing_tpu.render import camera as jax_camera
from advanced_cpu_raytracing_tpu.render.integrator import (
    RenderOptions as JaxOptions,
    trace_radiance,
)
from advanced_cpu_raytracing_tpu.scene.pack import pack_scene as jax_pack_scene
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene as jax_load_scene
from advanced_cpu_raytracing_tpu_torch.diff.params import params_from_arrays
from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb
from advanced_cpu_raytracing_tpu_torch.render.renderer import options_for_camera
from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import gauge_scene_xml
from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.types import MaterialType
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from test_torch_common import REPO, coarse_slice_scene, demo_scene

torch.set_num_threads(1)

N_RAYS, DEPTH = 256, 2
# the K2a leaves (JAX tests/test_megabwd.py PARAMS, and the emission)
LEAVES = ("mat_ambient", "mat_diffuse", "mat_specular", "mat_mirror",
          "mat_phong", "mat_radiance", "pl_intensity", "dl_radiance",
          "bg_color", "verts")


def loss_of(img):
    """The JAX test's loss: a non-trivial cotangent per pixel."""
    return (img * torch.cos(0.01 * img)).sum()


def scene_path(name, tmp):
    if name == "slice":
        return coarse_slice_scene(tmp)
    if name.startswith("demo"):
        return demo_scene(tmp)
    return gauge_scene_xml(tmp, REPO / "scenes", coarse=True, glass=False)


def emissive_sphere(pack, to_array):
    """``pack`` with its material 1 (the demo's mirror sphere) emissive,
    of radiance (3, 2, 1): an XML scene has emissive materials only with a
    mesh light (outside K2a), so the emissive hit is set up in the pack."""
    mt = np.asarray(pack.mat_type).copy()
    mt[1] = int(MaterialType.EMISSIVE)
    rad = np.asarray(pack.mat_radiance).copy()
    rad[1] = (3.0, 2.0, 1.0)
    return dataclasses.replace(
        pack, mat_type=to_array(mt), mat_radiance=to_array(rad),
        static=dataclasses.replace(pack.static, has_emissive_mat=True,
                                   has_mirror=False))


def setup(name, tmp):
    """Both packages' packs of scene ``name`` at depth 2, the rays, the
    draws and the parameter leaves as numpy."""
    path = scene_path(name, tmp)
    jcfg = jax_load_scene(path)
    jpack = jax_pack_scene(jcfg)
    cam = jax_camera.build_camera(jcfg.cameras[0])
    rng = np.random.default_rng(3)
    px = rng.uniform(0, cam.width, N_RAYS).astype(np.float32)
    py = rng.uniform(0, cam.height, N_RAYS).astype(np.float32)
    o, d = jax_camera.generate_rays(cam, jnp.asarray(px), jnp.asarray(py),
                                    jnp.zeros((N_RAYS, 2)), dof=False)
    ud = np.asarray(wavefront_rng(jax.random.PRNGKey(0), N_RAYS, DEPTH + 1, 0,
                                  True)[2])
    cfg = load_scene(path)
    pack = pack_scene(cfg, device="cpu")
    opts = dataclasses.replace(options_for_camera(cfg, cfg.cameras[0]),
                               max_depth=DEPTH)
    if name == "demo_emissive":
        jpack = emissive_sphere(jpack, jnp.asarray)
        pack = emissive_sphere(pack, torch.tensor)
    arrays = {k: np.asarray(v) for k, v in
              jax_extract_params(jpack, LEAVES).items()}
    return dict(name=name, jpack=jpack, cam=cam, px=px, py=py, o=np.asarray(o),
                d=np.asarray(d), ud=ud, pack=pack, opts=opts, arrays=arrays)


def oracle(s):
    """JAX value and gradients of the loss through the wavefront."""
    d_opts = JaxOptions(max_depth=DEPTH, differentiable=True,
                        max_iters=DEPTH + 2, stochastic_dielectric=True)

    def loss(params):
        img = trace_radiance(jax_inject_params(s["jpack"], params), s["cam"],
                             jnp.asarray(s["px"]), jnp.asarray(s["py"]),
                             jax.random.PRNGKey(0), d_opts)
        return jnp.sum(img * jnp.cos(0.01 * img))

    params = {k: jnp.asarray(v) for k, v in s["arrays"].items()}
    v, g = jax.value_and_grad(loss)(params)
    return float(v), {k: np.asarray(x) for k, x in g.items()}


def port_value_and_grads(s, arrays=None):
    """The port's plain version: loss value and the leaves' gradients."""
    params = params_from_arrays(s["arrays"] if arrays is None else arrays,
                                "cpu")
    f = mb.make_diff_render(s["pack"], s["opts"], device="cpu")
    draws = (torch.tensor(s["ud"]) if f.bc.has_dielectric else None)
    loss = loss_of(f(params, torch.tensor(s["o"]), torch.tensor(s["d"]),
                     draws=draws))
    loss.backward()
    return float(loss.detach()), {k: p.grad.numpy() for k, p in params.items()}


@pytest.fixture(scope="module",
                params=["slice", "demo", "gauge_mirror", "demo_emissive"])
def case(request, tmp_path_factory):
    s = setup(request.param, tmp_path_factory.mktemp(request.param))
    s["jax"] = oracle(s)
    s["port"] = port_value_and_grads(s)
    return s


def assert_grads_close(got: dict, want: dict, what: str):
    for k in LEAVES:
        a, b = want[k], got[k]
        assert b.shape == a.shape, (what, k)
        if a.size == 0:
            continue
        assert np.all(np.isfinite(b)), (what, k)
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b, a, rtol=5e-3, atol=5e-4 * scale,
                                   err_msg=f"{what}: {k}")


def test_value_and_every_leaf_match_the_jax_oracle(case):
    v_jax, g_jax = case["jax"]
    v, g = case["port"]
    np.testing.assert_allclose(v, v_jax, rtol=2e-4)
    assert_grads_close(g, g_jax, case["name"])
    # the scene exercises what it was chosen for
    assert np.abs(g["verts"]).sum() > 0 and np.abs(g["mat_diffuse"]).sum() > 0
    if case["name"].startswith("demo"):
        assert np.abs(g["bg_color"]).sum() > 0
    if case["name"] == "demo_emissive":
        assert np.abs(g["mat_radiance"]).sum() > 0
    if case["name"] == "gauge_mirror":
        assert np.abs(g["dl_radiance"]).sum() > 0
        assert not case["pack"].static.has_dielectric
    if case["name"] in ("slice", "demo"):
        assert case["pack"].static.has_dielectric
        assert np.abs(g["mat_mirror"]).sum() > 0


@pytest.mark.parametrize("leaf, index, h", [
    ("pl_intensity", (0, 0), 40.0),
    ("mat_diffuse", (0, 1), 1e-3),
])
def test_central_finite_differences(case, leaf, index, h):
    """The plain version's gradient of one parameter against central
    differences of its own forward (topology does not move with these
    parameters, so the forward is smooth in them)."""
    _, g = case["port"]
    base = case["arrays"][leaf]
    vals = []
    for step in (h, -h):
        arr = base.copy()
        arr[index] += step
        params = params_from_arrays({**case["arrays"], leaf: arr}, "cpu")
        f = mb.make_diff_render(case["pack"], case["opts"], device="cpu")
        draws = (torch.tensor(case["ud"]) if f.bc.has_dielectric else None)
        with torch.no_grad():
            vals.append(float(loss_of(f(params, torch.tensor(case["o"]),
                                        torch.tensor(case["d"]), draws=draws))))
    fd = (vals[0] - vals[1]) / (2 * h)
    np.testing.assert_allclose(g[leaf][index], fd, rtol=2e-3)
