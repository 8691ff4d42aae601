"""The port's CUDA kernel on the card (marker ``cuda``; skipped without a
CUDA card, since a CUDA kernel has no CPU mode).  Run them on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu_torch.ops import megakernel as mk
from advanced_cpu_raytracing_tpu_torch.render.camera import build_camera, generate_rays
from advanced_cpu_raytracing_tpu_torch.render.renderer import (
    ldr_from_radiance,
    options_for_camera,
    render_camera,
)
from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from test_torch_common import REPO, coarse_slice_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _scene(tmp_path, dev, res=48):
    cfg = load_scene(coarse_slice_scene(tmp_path, res, res))
    return cfg, pack_scene(cfg, device=dev)


def test_kernel_matches_plain_version(cuda, tmp_path):
    cfg, pack = _scene(tmp_path, cuda)
    mc, tab, ctab = mk.build_mega(pack, options_for_camera(cfg, cfg.cameras[0]),
                                  device=cuda)
    cam = build_camera(cfg.cameras[0], device=cuda)
    rng = np.random.default_rng(1)
    px = torch.as_tensor(rng.uniform(0, 48, 4096).astype(np.float32), device=cuda)
    py = torch.as_tensor(rng.uniform(0, 48, 4096).astype(np.float32), device=cuda)
    o, d = generate_rays(cam, px, py)
    before = mk.mega_trace.launches
    got = mk.mega_trace(mc, tab, ctab, o.contiguous(), d.contiguous())
    torch.cuda.synchronize()
    assert mk.mega_trace.launches == before + 1
    ref = mk.mega_trace_ref(mc, tab, ctab, o.contiguous(), d.contiguous())
    diff = (got - ref).abs().cpu().numpy()
    assert np.mean(diff) < 0.01 and np.quantile(diff, 0.999) < 0.5


def test_render_camera_launches_once_per_sample(cuda, tmp_path):
    cfg, pack = _scene(tmp_path, cuda)
    jitter = torch.rand((4, 48 * 48, 2), generator=torch.Generator().manual_seed(3))
    before = mk.mega_trace.launches
    got = render_camera(pack, cfg, cfg.cameras[0], spp=4, device=cuda,
                        jitter=jitter)
    assert mk.mega_trace.launches == before + 4
    want = render_camera(pack_scene(cfg, device="cpu"), cfg, cfg.cameras[0],
                         spp=4, device="cpu", jitter=jitter)
    du8 = np.abs(ldr_from_radiance(got).astype(int)
                 - ldr_from_radiance(want).astype(int))
    assert (du8.max(axis=-1) > 1).mean() <= 0.005


def test_wrapper_checks_inputs(cuda, tmp_path):
    cfg, pack = _scene(tmp_path, cuda)
    mc, tab, ctab = mk.build_mega(pack, options_for_camera(cfg, cfg.cameras[0]),
                                  device=cuda)
    o = torch.zeros((8, 3), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        mk.mega_trace(mc, tab, ctab, o.double(), o.double())
    with pytest.raises(ValueError, match="shape"):
        mk.mega_trace(mc, tab, ctab, o[:, :2].contiguous(), o[:, :2].contiguous())


def test_scene_outside_envelope_raises_on_cuda(cuda):
    cfg = load_scene(str(REPO / "scenes" / "feat_pt.xml"))
    with pytest.raises(NotImplementedError, match="path tracing"):
        render_camera(pack_scene(cfg, device=cuda), cfg, cfg.cameras[0],
                      device=cuda)
