"""The port's wavefront integrator (``render/integrator.py::
trace_radiance``) against the JAX package's ``trace_radiance`` on the same
pixels, the port fed the JAX draws of the same key (``jax_draws``), so
both take the same randoms ray for ray: 256 rays per scene, on a
deterministic Whitted scene with the dielectric split (the slice scene
with the coarse torus), ``scenes/feat_pt.xml`` with Russian roulette added
(path tracing, NEE, importance sampling), the main path's scene reduced
(``feature_scenes.pt_env_dof_scene_xml`` with the 96-face torus: the env
light and the thin lens) and the env light over a rough mirror.  Further
scenes in ``test_torch_wavefront_features.py``.

The JAX side runs in a subprocess without FMA instructions
(``run_jax_side``).  Deterministic scenes (Whitted, no draws): radiance
allclose at rtol 1e-4, atol 1e-4, and the u8 values within 1.  Stochastic
scenes: 99.5% of the rays within 1e-3 + 1e-3 |ref| (a last-ulp difference
of a transcendental can flip a sampled path) and the means within 1e-3
relative (K1c's gate).
"""

from __future__ import annotations

import numpy as np
import pytest

from test_torch_common import REPO
from test_torch_wavefront_draws import (
    both,
    pixels,
    port_trace,
    run_jax_side,
    scene_xml,
)

N_RAYS = 256
SCENES = {"whitted_glass": True, "pt_rr": False, "pt_env_dof": False,
          "env_rough_mirror": False}  # name -> deterministic


def check(got, ref, deterministic: bool):
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    if deterministic:
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
        u8 = (lambda x: np.clip(x.astype(np.int32), 0, 255))
        assert np.abs(u8(got) - u8(ref)).max() <= 1
        return
    within = (np.abs(got - ref) <= 1e-3 + 1e-3 * np.abs(ref)).all(axis=1)
    assert within.mean() >= 0.995, within.mean()
    assert abs(got.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Per scene: both packages' setup, the pixels and the JAX radiance."""
    tmp = tmp_path_factory.mktemp("wavefront")
    out, jax_cases, arrays = {}, [], {}
    for name in SCENES:
        path = scene_xml(name, tmp / name, REPO)
        s = both(path)
        px, py = pixels(s, N_RAYS)
        arrays[f"{name}_px"], arrays[f"{name}_py"] = px, py
        jax_cases.append({"fn": "jax_radiance", "kwargs": {
            "path": path, "changes": {}, "px": f"@{name}_px",
            "py": f"@{name}_py"}})
        out[name] = (s, px, py)
    refs = run_jax_side(jax_cases, arrays, tmp)
    return {name: (*out[name], ref["radiance"])
            for name, ref in zip(SCENES, refs)}


@pytest.mark.parametrize("name", list(SCENES))
def test_trace_radiance_matches_jax(cases, name):
    s, px, py, ref = cases[name]
    got = port_trace(s, px, py).numpy()
    check(got, ref, SCENES[name])
    # the scene does something: light reaches most rays
    assert (ref.sum(axis=1) > 0).mean() > 0.3
