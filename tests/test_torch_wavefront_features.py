"""The port's wavefront against the JAX package's on the scenes outside
the megakernel's envelope and on motion (``test_torch_wavefront.py`` has
the method and the gates): motion with roughness
(``feature_scenes.MOTION_ROUGH_XML``), a Perlin bump on a rotated mesh, an
image-textured scene shaded by a pluggable BRDF, and
``scenes/feat_spotareaml.xml`` under two environment lights.  The Perlin
bump's finite differences (1e-3) turn a last-bit difference into 1e-4 of
the radiance, which the JAX side's run without FMA instructions avoids.
"""

from __future__ import annotations

import pytest

from advanced_cpu_raytracing_tpu_torch.ops import megakernel as mk
from test_torch_common import REPO
from test_torch_wavefront import check
from test_torch_wavefront_draws import (
    both,
    pixels,
    port_trace,
    run_jax_side,
    scene_xml,
)

N_RAYS = 256
# name -> (deterministic, what puts it outside the megakernel or None)
SCENES = {"motion_rough": (False, None),
          "perlin_bump_rotated": (True, "Perlin bump_normal on a rotated"),
          "textures_brdf": (True, "textures together with a pluggable BRDF"),
          "two_env": (False, "more than one environment light")}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wavefront_features")
    out, jax_cases, arrays = {}, [], {}
    for name in SCENES:
        path = scene_xml(name, tmp / name, REPO)
        s = both(path)
        px, py = pixels(s, N_RAYS, seed=1)
        arrays[f"{name}_px"], arrays[f"{name}_py"] = px, py
        jax_cases.append({"fn": "jax_radiance", "kwargs": {
            "path": path, "changes": {}, "px": f"@{name}_px",
            "py": f"@{name}_py", "key_seed": 1}})
        out[name] = (s, px, py)
    refs = run_jax_side(jax_cases, arrays, tmp)
    return {name: (*out[name], ref["radiance"])
            for name, ref in zip(SCENES, refs)}


@pytest.mark.parametrize("name", list(SCENES))
def test_trace_radiance_matches_jax(cases, name):
    s, px, py, ref = cases[name]
    deterministic, outside = SCENES[name]
    missing = mk.mega_missing(s["pack"].static, s["opts"], s["pack"])
    assert (outside is None) == (not missing)
    assert outside is None or outside in missing[0]
    got = port_trace(s, px, py, key_seed=1).numpy()
    check(got, ref, deterministic)
