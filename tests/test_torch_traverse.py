"""The wavefront's scene queries and BRDFs (``ops/traverse.py``,
``ops/brdf.py``) against the JAX package's, on this host's CPU.

``closest_hit`` and ``occluded`` of both packages on the same rays (camera
rays and rays from inside the scene in random directions) with the JAX
brute-force strategy through its Pallas kernel in interpret mode
(``traverse.USE_PALLAS_BRUTE`` set to True, in this test only) and
through its jnp broadcast (False), on the brute strategy (``feat_pt.xml``,
``feat_spotareaml.xml``: a sphere, an emissive mesh light), the BVH
strategy (``feat_pt.xml`` with a 2,304-face torus: 2,316 work items),
and spheres with motion (``feature_scenes.MOTION_ROUGH_XML``, where the
port's K3 takes the motion rows and JAX its jnp route).  valid, kind,
index and face must agree exactly; t, beta and gamma within rtol 1e-5,
atol 1e-5 (the two Cramer expansions round otherwise).  The
differentiable query (winner recomputed in object space) against the
plain one, and its gradient reaching the vertices.

``eval_brdf`` for each of the five BRDFs against JAX's on seeded inputs
(rtol 1e-5, atol 1e-5).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu.ops import brdf as jax_brdf
from advanced_cpu_raytracing_tpu.ops import traverse as jax_traverse
from advanced_cpu_raytracing_tpu.render import camera as jax_camera
from advanced_cpu_raytracing_tpu.scene.pack import pack_scene as jax_pack_scene
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene as jax_load_scene
from advanced_cpu_raytracing_tpu_torch.ops import brdf
from advanced_cpu_raytracing_tpu_torch.ops import traverse
from advanced_cpu_raytracing_tpu_torch.scene import feature_scenes as fs
from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.types import BrdfType
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from test_torch_common import REPO

N = 512


def _scene(name, tmp):
    if name in ("feat_pt", "feat_spotareaml"):
        return str(REPO / "scenes" / f"{name}.xml")
    if name == "bvh_torus":
        return fs.pt_env_dof_scene_xml(REPO / "scenes", tmp,
                                       torus=dict(n_major=48, n_minor=24))
    path = tmp / "motion.xml"
    path.write_text(fs.MOTION_ROUGH_XML)
    return str(path)


def _rays(jcfg, jpack, seed):
    """N/2 camera rays and N/2 rays from inside the scene's bounds in
    random directions, with times in [0, 1) and shadow distances."""
    g = np.random.default_rng(seed)
    cam = jax_camera.build_camera(jcfg.cameras[0])
    h = N // 2
    px = g.uniform(0, cam.width, h).astype(np.float32)
    py = g.uniform(0, cam.height, h).astype(np.float32)
    o1, d1 = jax_camera.generate_rays(cam, jnp.asarray(px), jnp.asarray(py),
                                      jnp.zeros((h, 2)), dof=False)
    verts = np.asarray(jpack.verts)
    lo, hi = verts.min(0), verts.max(0)
    o2 = g.uniform(lo, hi, (h, 3)).astype(np.float32)
    d2 = g.normal(size=(h, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    o = np.concatenate([np.asarray(o1), o2]).astype(np.float32)
    d = np.concatenate([np.asarray(d1), d2]).astype(np.float32)
    time = g.uniform(0, 1, N).astype(np.float32)
    light_t = g.uniform(0.5, 12.0, N).astype(np.float32)
    return o, d, time, light_t


# the BVH and motion scenes take one JAX route whatever USE_PALLAS_BRUTE
@pytest.mark.parametrize("name,use_pallas", [
    ("feat_pt", True), ("feat_pt", False), ("feat_spotareaml", True),
    ("feat_spotareaml", False), ("bvh_torus", False), ("motion", False)])
def test_queries_match_jax(name, use_pallas, tmp_path, monkeypatch):
    path = _scene(name, tmp_path)
    jcfg = jax_load_scene(path)
    jpack = jax_pack_scene(jcfg)
    pack = pack_scene(load_scene(path), device="cpu")
    assert pack.static.use_bvh == (name == "bvh_torus")
    assert pack.static.has_motion == (name == "motion")
    monkeypatch.setattr(jax_traverse, "USE_PALLAS_BRUTE", use_pallas)
    o, d, time, light_t = _rays(jcfg, jpack, 5)
    jhit = jax_traverse.closest_hit(jpack, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(time))
    t = torch.tensor
    hit = traverse.closest_hit(pack, t(o), t(d), t(time))
    valid = np.asarray(jhit.valid)
    assert 0.3 < valid.mean()
    for f in ("valid", "kind", "index", "face"):
        np.testing.assert_array_equal(getattr(hit, f).numpy(),
                                      np.asarray(getattr(jhit, f)), err_msg=f)
    for f in ("t", "beta", "gamma"):
        a, b = getattr(hit, f).numpy(), np.asarray(getattr(jhit, f))
        np.testing.assert_allclose(a[valid], b[valid], rtol=1e-5, atol=1e-5,
                                   err_msg=f)
    blocked = traverse.occluded(pack, t(o), t(d), t(light_t), t(time))
    jblocked = np.asarray(jax_traverse.occluded(
        jpack, jnp.asarray(o), jnp.asarray(d), jnp.asarray(light_t),
        jnp.asarray(time)))
    np.testing.assert_array_equal(blocked.numpy(), jblocked)
    assert 0.05 < jblocked.mean() < 0.95


def test_differentiable_query_recomputes_the_winner(tmp_path):
    """The same hits, t within 1e-5, and a gradient that reaches the
    vertices of the winners only."""
    path = _scene("feat_pt", tmp_path)
    jcfg = jax_load_scene(path)
    pack = pack_scene(load_scene(path), device="cpu")
    o, d, time, _ = _rays(jcfg, jax_pack_scene(jcfg), 9)
    o, d, time = (torch.tensor(x) for x in (o, d, time))
    plain = traverse.closest_hit(pack, o, d, time)
    verts = pack.verts.clone().requires_grad_(True)
    hit = traverse.closest_hit(dataclasses.replace(pack, verts=verts), o, d,
                               time, differentiable=True)
    for f in ("valid", "kind", "index", "face"):
        assert torch.equal(getattr(hit, f), getattr(plain, f)), f
    v = plain.valid
    torch.testing.assert_close(hit.t[v], plain.t[v], rtol=1e-5, atol=1e-5)
    torch.where(v, hit.t, 0.0).sum().backward()
    used = torch.zeros(verts.shape[0], dtype=torch.bool)
    used[pack.tri_vidx[plain.face[v]].long().flatten()] = True
    g = verts.grad.abs().sum(1)
    assert torch.isfinite(verts.grad).all()
    assert bool((g[~used] == 0).all()) and bool((g[used] > 0).any())


@pytest.mark.parametrize("kind", list(BrdfType))
def test_eval_brdf_matches_jax(kind):
    g = np.random.default_rng(int(kind))
    r = 2048

    def unit(x):
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    n = unit(g.normal(size=(r, 3)))
    w_i = unit(g.normal(size=(r, 3)) + n)
    w_o = unit(g.normal(size=(r, 3)) + n)
    args = dict(
        kind=np.full(r, int(kind), np.int32),
        exponent=g.uniform(1, 60, r).astype(np.float32),
        normalized=g.uniform(size=r) < 0.5, kdfresnel=g.uniform(size=r) < 0.5,
        mat_ior=g.uniform(1.1, 2.5, r).astype(np.float32),
        kd=g.uniform(0, 1, (r, 3)).astype(np.float32),
        ks=g.uniform(0, 1, (r, 3)).astype(np.float32), w_i=w_i, w_o=w_o, n=n)
    got = brdf.eval_brdf(**{k: torch.tensor(v) for k, v in args.items()})
    ref = jax_brdf.eval_brdf(**{k: jnp.asarray(v) for k, v in args.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert (got.numpy() == 0).mean() < 0.6
    for fn in ("default_diffuse", "default_specular"):
        irr = g.uniform(0, 100, (r, 3)).astype(np.float32)
        if fn == "default_diffuse":
            a = (args["kd"], w_i, n, irr)
        else:
            a = (args["ks"], args["exponent"], w_i, w_o, n, irr)
        np.testing.assert_allclose(
            getattr(brdf, fn)(*(torch.tensor(x) for x in a)).numpy(),
            np.asarray(getattr(jax_brdf, fn)(*(jnp.asarray(x) for x in a))),
            rtol=1e-5, atol=1e-5)
