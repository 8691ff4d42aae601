"""Camera rays of the PyTorch port against the JAX package: pinhole,
depth of field (same lens samples on both sides) and lookAt cameras."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu.render import camera as jax_camera
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene as jax_load_scene
from advanced_cpu_raytracing_tpu_torch.render.camera import (
    build_camera,
    generate_rays,
    image_plane_position,
)
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from test_torch_common import SLICE_XML

torch.set_num_threads(1)

CAMERAS = {
    "pinhole": {},
    "dof": dict(aperture_size=0.8, focus_distance=28.0),
    "look_at": dict(is_look_at=True, gaze_point=np.array([1.0, -2.0, 0.0]),
                    fov_y_deg=40.0, width=48, height=32),
}


def _cams(kind):
    overrides = CAMERAS[kind]
    jc = dataclasses.replace(jax_load_scene(str(SLICE_XML)).cameras[0],
                             **overrides)
    tc = dataclasses.replace(load_scene(str(SLICE_XML)).cameras[0],
                             **overrides)
    return jax_camera.build_camera(jc), build_camera(tc, device="cpu")


@pytest.mark.parametrize("kind", sorted(CAMERAS))
def test_generate_rays_matches_jax(kind):
    jcam, tcam = _cams(kind)
    assert tcam.use_dof == jcam.use_dof == (kind == "dof")
    for f in ("position", "gaze", "up", "right", "q", "su_scale", "sv_scale"):
        np.testing.assert_array_equal(getattr(tcam, f).numpy(),
                                      np.asarray(getattr(jcam, f)))
    rng = np.random.default_rng(11)
    n = 2048
    px = rng.uniform(0, tcam.width, n).astype(np.float32)
    py = rng.uniform(0, tcam.height, n).astype(np.float32)
    lens = rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    jo, jd = jax_camera.generate_rays(jcam, jnp.asarray(px), jnp.asarray(py),
                                      jnp.asarray(lens), dof=jcam.use_dof)
    to, td = generate_rays(tcam, torch.as_tensor(px), torch.as_tensor(py),
                           torch.as_tensor(lens), dof=tcam.use_dof)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        image_plane_position(tcam, torch.as_tensor(px), torch.as_tensor(py)).numpy(),
        np.asarray(jax_camera.image_plane_position(jcam, jnp.asarray(px),
                                                   jnp.asarray(py))),
        atol=1e-5, rtol=0)
