"""The PyTorch port's renderer, tonemapper and CLI against the JAX package.

``render_camera`` on the coarse slice scene at 48x48 on the CPU (the plain
version of the kernel) against the JAX ``render_camera`` on its
interpreted kernel route (``ACRT_FORCE_MEGA=1``, as the JAX package's own
tests force it): at 1 spp (with the 32x32 tile remap of deep dielectric
scenes) and at 4 spp, where the port is fed the JAX jitter draws.
Radiance holds to the kernel tolerance; the u8 image may differ by at most
1 except on 0.5% of the pixels (silhouettes)."""

from __future__ import annotations

import pathlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from advanced_cpu_raytracing_tpu.post.tonemap import (
    reinhard_tonemap as jax_reinhard_tonemap,
)
from advanced_cpu_raytracing_tpu.render import renderer as jax_renderer
from advanced_cpu_raytracing_tpu.scene.pack import pack_scene as jax_pack_scene
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene as jax_load_scene
from advanced_cpu_raytracing_tpu_torch.cli.render import main as cli_main
from advanced_cpu_raytracing_tpu_torch.post.tonemap import reinhard_tonemap
from advanced_cpu_raytracing_tpu_torch.render.renderer import (
    ldr_from_radiance,
    render_camera,
    render_scene,
)
from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from test_torch_common import coarse_slice_scene

torch.set_num_threads(1)

RES = 48


def _jax_jitter(seed: int, n_cells: int, r: int) -> np.ndarray:
    """The JAX renderer's stratified jitter draws, (S, R, 2): sample s uses
    uniform(split(fold_in(PRNGKey(seed), s))[0], (R, 2))."""
    key = jax.random.PRNGKey(seed)
    out = []
    for s in range(n_cells * n_cells):
        k_jit, _ = jax.random.split(jax.random.fold_in(key, s))
        out.append(np.asarray(jax.random.uniform(k_jit, (r, 2))))
    return np.stack(out)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = coarse_slice_scene(tmp_path_factory.mktemp("render"), RES, RES)
    jcfg = jax_load_scene(path)
    jpack = jax_pack_scene(jcfg)
    cfg = load_scene(path)
    pack = pack_scene(cfg, device="cpu")
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ACRT_FORCE_MEGA", "1")
        for spp in (1, 4):
            want[spp] = jax_renderer.render_camera(
                jpack, jcfg, jcfg.cameras[0], seed=0, spp=spp)
    return dict(path=path, cfg=cfg, pack=pack, want=want)


def _assert_close(got, want):
    diff = np.abs(got - want)
    assert np.isfinite(got).all()
    assert np.mean(diff) < 0.01
    assert np.quantile(diff, 0.999) < 0.5
    du8 = np.abs(ldr_from_radiance(got).astype(int)
                 - ldr_from_radiance(want).astype(int))
    assert (du8.max(axis=-1) > 1).mean() <= 0.005


def test_render_camera_1spp_matches_jax(scene):
    cfg = scene["cfg"]
    got = render_camera(scene["pack"], cfg, cfg.cameras[0], spp=1,
                        device="cpu")
    assert got.shape == (RES, RES, 3) and got.dtype == np.float32
    _assert_close(got, scene["want"][1])
    ldr = render_camera(scene["pack"], cfg, cfg.cameras[0], spp=1, ldr=True,
                        device="cpu")
    assert ldr.dtype == np.uint8
    np.testing.assert_array_equal(ldr, ldr_from_radiance(got))


def test_render_camera_4spp_with_jax_jitter_matches_jax(scene):
    cfg = scene["cfg"]
    jitter = torch.as_tensor(_jax_jitter(0, 2, RES * RES))
    got = render_camera(scene["pack"], cfg, cfg.cameras[0], spp=4,
                        device="cpu", jitter=jitter)
    _assert_close(got, scene["want"][4])


@pytest.mark.parametrize("burn", [1.0, 0.0])
def test_reinhard_tonemap_matches_jax(burn):
    rng = np.random.default_rng(5)
    hdr = rng.lognormal(3.0, 1.5, (24, 40, 3)).astype(np.float32)
    hdr[0, 0] = 0.0
    hdr[1, 1, 0] = np.nan
    want = jax_reinhard_tonemap(hdr, key_value=0.18, burn_percent=burn,
                                saturation=0.9, gamma=2.2)
    got = reinhard_tonemap(hdr, key_value=0.18, burn_percent=burn,
                           saturation=0.9, gamma=2.2, device="cpu")
    assert got.dtype == np.uint8 and got.shape == hdr.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_cli_writes_png(scene, tmp_path):
    rc = cli_main([scene["path"], "--out-dir", str(tmp_path), "--spp", "1",
                   "--device", "cpu"])
    assert rc == 0
    out = tmp_path / scene["cfg"].cameras[0].image_name
    img = np.asarray(Image.open(out))
    assert img.shape == (RES, RES, 3)
    got = render_camera(scene["pack"], scene["cfg"], scene["cfg"].cameras[0],
                        spp=1, ldr=True, device="cpu")
    np.testing.assert_array_equal(img, got)


def test_cli_tonemapped_camera_writes_hdr_and_png(scene, tmp_path):
    xml = pathlib.Path(scene["path"]).read_text().replace(
        "<NumSamples>16</NumSamples>",
        "<NumSamples>16</NumSamples><Tonemap><TMO>Photographic</TMO>"
        "<TMOOptions>0.18 1</TMOOptions><Saturation>1.0</Saturation>"
        "<Gamma>2.2</Gamma></Tonemap>")
    path = pathlib.Path(scene["path"]).with_name("tonemapped.xml")
    path.write_text(xml)
    assert cli_main([str(path), "--out-dir", str(tmp_path), "--spp", "1",
                     "--device", "cpu"]) == 0
    stem = tmp_path / pathlib.Path(scene["cfg"].cameras[0].image_name).stem
    hdr = render_camera(scene["pack"], scene["cfg"], scene["cfg"].cameras[0],
                        spp=1, device="cpu")
    np.testing.assert_array_equal(
        np.asarray(Image.open(f"{stem}.png")),
        reinhard_tonemap(hdr, key_value=0.18, burn_percent=1.0, device="cpu"))
    assert pathlib.Path(f"{stem}.hdr").stat().st_size > RES * RES * 4


def test_render_scene_renders_every_camera(scene):
    results = render_scene(scene["path"], spp=1, device="cpu")
    assert [c.image_name for c, _ in results] == [
        c.image_name for c in scene["cfg"].cameras]
    np.testing.assert_array_equal(
        results[0][1], render_camera(scene["pack"], scene["cfg"],
                                     scene["cfg"].cameras[0], spp=1,
                                     device="cpu"))
