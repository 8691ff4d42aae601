"""The JAX wavefront's draws as a table for the port's integrator.

``jax_draws`` walks the key schedule of the JAX package's
``render/integrator.py::trace_radiance`` (its ``k_time, k_lens, k_loop``
split, each iteration's ``key, k_it`` split and ``_process_hit``'s 9-way
split of ``k_it``) and of ``render/lights.py::direct_lighting`` (area
lights, then mesh lights, then environment lights, each chained off
``k_dl``), as the JAX ``ops/pallas/megabwd.py::wavefront_rng`` walks it for
the fused kernel, and fills an ``ops/rng.py::TableDraws`` with the same
draws: uniforms in [0, 1) that the port maps to each site's range as
``jax.random.uniform`` does, and the mesh-light face picks.  The port's
wavefront then takes the JAX wavefront's randoms ray for ray.  The test
here holds the table's mapping to the JAX draws themselves.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from advanced_cpu_raytracing_tpu.render import camera as jax_camera
from advanced_cpu_raytracing_tpu.render.integrator import (
    RenderOptions as JaxOptions,
    trace_radiance as jax_trace_radiance,
)
from advanced_cpu_raytracing_tpu.scene.pack import pack_scene as jax_pack_scene
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene as jax_load_scene
from advanced_cpu_raytracing_tpu_torch.ops import rng
from advanced_cpu_raytracing_tpu_torch.render.camera import build_camera
from advanced_cpu_raytracing_tpu_torch.render.integrator import trace_radiance
from advanced_cpu_raytracing_tpu_torch.render.renderer import options_for_camera
from advanced_cpu_raytracing_tpu_torch.scene import feature_scenes as fs
from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene


def jax_draws(key, r: int, pack) -> rng.TableDraws:
    """The draws of the JAX ``trace_radiance(pack, cam, px, py, key, opts)``
    for ``r`` rays of the scene of ``pack`` (the port's; its light counts
    and mesh-light face counts pick the draws), each iteration's made when
    the port first asks for it."""
    st = pack.static
    counts = tuple(int(c) for c in pack.ml_face_count[:st.n_mesh_lights])
    return rng.TableDraws(_JaxTable(key, r, st.n_area, counts, st.n_env))


class _JaxTable(dict):
    """(it, site, light) -> the JAX wavefront's draw, filled one loop
    iteration at a time on first use."""

    def __init__(self, key, r, n_area, ml_counts, n_env):
        super().__init__()
        self.r, self.n_area, self.ml_counts, self.n_env = (
            r, n_area, ml_counts, n_env)
        key, k_time, k_lens, self._k = jax.random.split(key, 4)
        self._next = 0
        self[(-1, rng.SITE_TIME, 0)] = _u(k_time, (r,))[:, None]
        self[(-1, rng.SITE_LENS, 0)] = _u(k_lens, (r, 2))

    def __missing__(self, key):
        while self._next <= key[0]:
            self._fill(self._next)
            self._next += 1
        return dict.__getitem__(self, key)

    def _fill(self, it):
        r = self.r
        self._k, k_it = jax.random.split(self._k)
        (_, k_gi, k_rr, k_dl, k_m, k_c, k_t, k_rl,
         k_rf) = jax.random.split(k_it, 9)
        self[(it, rng.SITE_GI, 0)] = _u(k_gi, (r, 2))
        self[(it, rng.SITE_RR, 0)] = _u(k_rr, (r,))[:, None]
        self[(it, rng.SITE_ROUGH_M, 0)] = _u(k_m, (r, 2))
        self[(it, rng.SITE_COIN, 0)] = _u(k_c, (r,))[:, None]
        self[(it, rng.SITE_ROUGH_T, 0)] = _u(k_t, (r, 2))
        self[(it, rng.SITE_REFL, 0)] = _u(k_rl, (r,))[:, None]
        self[(it, rng.SITE_ROUGH_F, 0)] = _u(k_rf, (r, 2))
        kk = k_dl
        for i in range(self.n_area):
            kk, sub = jax.random.split(kk)
            self[(it, rng.SITE_AREA, i)] = _u(sub, (r, 2))
        for i, count in enumerate(self.ml_counts):
            kk, k1, k2 = jax.random.split(kk, 3)
            self[(it, rng.SITE_ML_FACE, i)] = np.array(
                jax.random.randint(k1, (r,), 0, max(count, 1)))
            self[(it, rng.SITE_ML_BARY, i)] = _u(k2, (r, 2))
        for i in range(self.n_env):
            kk, sub = jax.random.split(kk)
            self[(it, rng.SITE_ENV, i)] = _u(sub, (16, r, 3)).transpose(
                1, 0, 2).reshape(r, 48)


def _u(k, shape):
    return np.array(jax.random.uniform(k, shape))


def both(path: str, **changes) -> dict:
    """Both packages' scene, pack, camera and options of the XML at
    ``path``, the options with ``changes`` (RenderOptions fields)."""
    cfg = load_scene(path)
    pack = pack_scene(cfg, device="cpu")
    opts = dataclasses.replace(options_for_camera(cfg, cfg.cameras[0]),
                               **changes)
    jcfg = jax_load_scene(path)
    return dict(cfg=cfg, pack=pack, opts=opts,
                cam=build_camera(cfg.cameras[0], device="cpu"),
                jpack=jax_pack_scene(jcfg),
                jcam=jax_camera.build_camera(jcfg.cameras[0]),
                jopts=JaxOptions(**{f.name: getattr(opts, f.name)
                                    for f in dataclasses.fields(JaxOptions)}))


def pixels(s: dict, r: int, seed: int = 0):
    """``r`` seeded sub-pixel positions over the camera's image."""
    g = np.random.default_rng(seed)
    cam = s["cfg"].cameras[0]
    return (g.uniform(0, cam.width, r).astype(np.float32),
            g.uniform(0, cam.height, r).astype(np.float32))


def jax_trace(s: dict, px, py, key_seed: int = 0) -> np.ndarray:
    """The JAX wavefront's radiance (R,3) of the pixels, key
    ``PRNGKey(key_seed)``."""
    return np.asarray(jax.jit(lambda a, b: jax_trace_radiance(
        s["jpack"], s["jcam"], a, b, jax.random.PRNGKey(key_seed),
        s["jopts"]))(jnp.asarray(px), jnp.asarray(py)))


def port_trace(s: dict, px, py, key_seed: int = 0, pack=None):
    """The port's radiance (R,3) of the pixels, fed the JAX draws of
    ``PRNGKey(key_seed)``; ``pack`` in place of the scene's."""
    pack = s["pack"] if pack is None else pack
    return trace_radiance(pack, s["cam"], torch.tensor(px), torch.tensor(py),
                          jax_draws(jax.random.PRNGKey(key_seed), len(px),
                                    pack), s["opts"])


# Runs the JAX side of the comparisons: XLA's CPU backend contracts
# products into FMAs where the CPU has them, and Perlin bumps (finite
# differences over 1e-3) turn that last bit into 1e-4 of the radiance; with
# --xla_cpu_max_isa=SSE4_2 it computes what the code writes.  argv: the
# cases (JSON), their inputs (npz), the output (npz); each case names a
# function of this module and its keyword arguments.
_JAX_SIDE = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import test_torch_wavefront_draws as h
cases = json.load(open(sys.argv[1]))
arrays = np.load(sys.argv[2])
out = {}
for i, c in enumerate(cases):
    kw = {k: (arrays[v[1:]] if isinstance(v, str) and v.startswith("@") else v)
          for k, v in c["kwargs"].items()}
    for name, x in getattr(h, c["fn"])(**kw).items():
        out[f"{i}/{name}"] = x
np.savez(sys.argv[3], **out)
"""


def run_jax_side(cases: list, arrays: dict, tmp) -> list:
    """Run ``cases`` (dicts: ``fn``, a function of this module returning a
    dict of arrays, and ``kwargs``; a string "@name" stands for
    ``arrays[name]``) in one subprocess without FMA instructions; returns
    each case's dict."""
    import json
    import os
    import subprocess
    import sys

    tmp = pathlib.Path(tmp)
    repo = pathlib.Path(__file__).resolve().parents[1]
    (tmp / "cases.json").write_text(json.dumps(cases))
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(repo), str(repo / "tests")]))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, str(tmp / "cases.json"),
         str(tmp / "in.npz"), str(tmp / "out.npz")], env=env, cwd=repo,
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = np.load(tmp / "out.npz")
    res = [dict() for _ in cases]
    for k in out.files:
        i, name = k.split("/", 1)
        res[int(i)][name] = out[k]
    return res


def jax_radiance(path: str, changes: dict, px, py, key_seed: int = 0) -> dict:
    """A case of ``run_jax_side``: the JAX wavefront's radiance."""
    s = both(path, **changes)
    return {"radiance": jax_trace(s, px, py, key_seed)}


def with_resolution(xml: str, w: int, h: int) -> str:
    return re.sub(r"<ImageResolution>.*?</ImageResolution>",
                  f"<ImageResolution>{w} {h}</ImageResolution>", xml)


def scene_xml(name: str, tmp, repo) -> str:
    """The XML path of one of the wavefront tests' scenes, written to
    ``tmp`` (assets too)."""
    from test_torch_common import coarse_slice_scene, pt_scene

    tmp = pathlib.Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    scenes = repo / "scenes"
    if name == "whitted_glass":
        return coarse_slice_scene(tmp)
    if name == "pt_rr":
        return pt_scene(tmp, params="NextEventEstimation ImportanceSampling "
                        "RussianRoulette")
    if name == "pt_env_dof":
        return fs.pt_env_dof_scene_xml(scenes, tmp,
                                       torus=fs.PT_ENV_COARSE_TORUS)
    k1d = fs.k1d_scenes(tmp, scenes)
    xml = {
        "env_rough_mirror": k1d["env_rough"],
        "motion_rough": fs.MOTION_ROUGH_XML,
        "perlin_bump_rotated": fs.PERLIN_XML.replace(
            "</Textures>", "</Textures><Transformations><Rotation id=\"1\">"
            "30 0 1 0</Rotation></Transformations>", 1).replace(
            '<Mesh id="1"><Material>1</Material><Textures>1 3</Textures>',
            '<Mesh id="1"><Material>1</Material><Textures>1 3</Textures>'
            "<Transformations>r1</Transformations>"),
        "textures_brdf": k1d["image"].replace(
            '<Material id="1">', '<Material id="1" BRDF="1">').replace(
            "<Materials>", "<BRDFs><OriginalPhong id=\"1\"><Exponent>20"
            "</Exponent></OriginalPhong></BRDFs><Materials>"),
        "two_env": k1d["spotareaml_env"].replace(
            "</SphericalDirectionalLight>", "</SphericalDirectionalLight>"
            "<SphericalDirectionalLight id=\"2\"><ImageId>1</ImageId>"
            "</SphericalDirectionalLight>", 1),
    }[name]
    path = tmp / f"{name}.xml"
    path.write_text(xml)
    return str(path)


def test_table_maps_to_the_jax_draws():
    """Each site's range as ``jax.random.uniform`` gives it, bit for bit."""
    key = jax.random.PRNGKey(3)
    r = 64
    draws = rng.TableDraws(_JaxTable(key, r, 1, (5,), 1))
    _, _, k_lens, k_loop = jax.random.split(key, 4)
    lens = np.asarray(jax.random.uniform(k_lens, (r, 2), minval=-1.0,
                                         maxval=1.0))
    np.testing.assert_array_equal(
        draws.uniform(-1, rng.SITE_LENS, r, 2, lo=-1.0, hi=1.0).numpy(), lens)
    _, k_it = jax.random.split(k_loop)
    k_dl = jax.random.split(k_it, 9)[3]
    kk, sub = jax.random.split(k_dl)
    area = np.asarray(jax.random.uniform(sub, (r, 2), minval=-0.5, maxval=0.5))
    np.testing.assert_array_equal(
        draws.uniform(0, rng.SITE_AREA, r, 2, lo=-0.5, hi=0.5).numpy(), area)
    kk, k1, k2 = jax.random.split(kk, 3)
    np.testing.assert_array_equal(
        draws.randint(0, rng.SITE_ML_FACE, r, 5).numpy(),
        np.asarray(jax.random.randint(k1, (r,), 0, 5)))
    kk, sub = jax.random.split(kk)
    env = np.asarray(jax.random.uniform(sub, (16, r, 3), minval=-1.0,
                                        maxval=1.0))
    got = draws.uniform(0, rng.SITE_ENV, r, 48, lo=-1.0, hi=1.0)
    np.testing.assert_array_equal(
        got.reshape(r, 16, 3).transpose(0, 1).numpy(), env)


def test_philox_draws_are_the_same_on_every_tiling():
    """The default source: a tile's draws are the frame's at its rays."""
    full = rng.PhiloxDraws(7, sample=3).uniform(2, rng.SITE_ENV, 40, 48)
    part = rng.PhiloxDraws(7, sample=3, ray0=16).uniform(2, rng.SITE_ENV, 24,
                                                         48)
    assert torch.equal(full[16:], part)
    assert 0.0 <= float(full.min()) and float(full.max()) < 1.0
    assert not torch.equal(full, rng.PhiloxDraws(7, sample=4).uniform(
        2, rng.SITE_ENV, 40, 48))
    picks = rng.PhiloxDraws(1).randint(0, rng.SITE_ML_FACE, 4096, 7)
    assert int(picks.min()) == 0 and int(picks.max()) == 6


def mse(img, target):
    """The gradient tests' loss: the mean squared error."""
    return ((img - target) ** 2).mean()


def jax_value_and_grad(path: str, changes: dict, px, py, target, fields,
                       key_seed: int = 0) -> dict:
    """A case of ``run_jax_side``: the JAX wavefront's ``mse`` against
    ``target`` and its gradient with respect to ``fields`` (``jax.grad``
    through ``trace_radiance(differentiable=True)``)."""
    from advanced_cpu_raytracing_tpu.diff.params import (
        extract_params,
        inject_params,
    )

    s = both(path, differentiable=True, **changes)

    def loss(params):
        img = jax_trace_radiance(inject_params(s["jpack"], params), s["jcam"],
                                 jnp.asarray(px), jnp.asarray(py),
                                 jax.random.PRNGKey(key_seed), s["jopts"])
        return mse(img, jnp.asarray(target))

    params = extract_params(s["jpack"], tuple(fields))
    v, g = jax.jit(jax.value_and_grad(loss))(params)
    out = {f"g_{k}": np.asarray(x) for k, x in g.items()}
    out.update({f"p_{k}": np.asarray(x) for k, x in params.items()})
    out["loss"] = np.asarray(v)
    return out


def jax_optimize_history(path: str, changes: dict, px, py, target, fields,
                         scale, steps: int, lr: float, seed: int) -> dict:
    """A case of ``run_jax_side``: the loss history of the JAX
    ``optimize(..., use_fused=False)`` (``jax.value_and_grad`` through its
    wavefront, a fresh key per step) from the scene's parameters times
    ``scale`` (one factor per field)."""
    from advanced_cpu_raytracing_tpu.diff.optimize import optimize
    from advanced_cpu_raytracing_tpu.diff.params import inject_params

    s = both(path, differentiable=True, **changes)
    start = {f: getattr(s["jpack"], f) * k for f, k in zip(fields, scale)}
    _, history = optimize(inject_params(s["jpack"], start), s["jcam"],
                          jnp.asarray(px), jnp.asarray(py), s["jopts"],
                          jnp.asarray(target), tuple(fields), steps=steps,
                          lr=lr, seed=seed, use_fused=False)
    return {"history": np.asarray(history)}


def step_keys(seed: int, steps: int) -> list:
    """The per-step keys of the JAX ``optimize`` loop (``key, sub =
    jax.random.split(key)``)."""
    key, subs = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs
