"""The port's progressive renderer (``render/progressive.py``) against the
JAX package's ``ProgressiveRenderer``.

Pass 0 (no jitter) of the coarse slice scene (Whitted, no DoF) at 24x24
holds to the JAX class's pass 0 (its wavefront) within the kernel
tolerance of tests/test_torch_render.py, on the port's K1 route (the plain
version) and on its wavefront route; a resumed renderer equals the
uninterrupted one bit for bit, on both routes; checkpoints pass between the two packages
both ways, and ``load`` refuses another size, seed or version; the tile
size changes no pixel; a path-traced box's 2-pass frame means over 8 seeds
agree with the JAX class's by a Welch z-test (|z| < 4, as in
tests/test_torch_pt.py)."""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu.render.progressive import (
    ProgressiveRenderer as JaxProgressiveRenderer,
)
from advanced_cpu_raytracing_tpu.scene.pack import pack_scene as jax_pack_scene
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene as jax_load_scene
from advanced_cpu_raytracing_tpu_torch.render import progressive
from advanced_cpu_raytracing_tpu_torch.render.progressive import (
    CKPT_VERSION,
    ProgressiveRenderer,
)
from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from test_torch_common import coarse_slice_scene
from test_torch_pt import _pt_box
from test_torch_render import _assert_close

torch.set_num_threads(1)

RES = 24


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = coarse_slice_scene(tmp_path_factory.mktemp("progressive"), RES, RES)
    jcfg = jax_load_scene(path)
    jr = JaxProgressiveRenderer(jax_pack_scene(jcfg), jcfg, jcfg.cameras[0],
                                tile_size=256)
    jr.step()
    cfg = load_scene(path)
    return dict(cfg=cfg, pack=pack_scene(cfg, device="cpu"), jax=jr)


def _renderer(scene, wavefront=False, res=RES, **kw):
    """A renderer of the scene's camera at ``res`` x ``res``, on the K1
    route or, with ``wavefront``, on the wavefront's."""
    cfg = scene["cfg"]
    cam_cfg = dataclasses.replace(cfg.cameras[0], width=res, height=res)
    if not wavefront:
        return ProgressiveRenderer(scene["pack"], cfg, cam_cfg, device="cpu",
                                   **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(progressive, "mega_missing", lambda *a: ["forced"])
        return ProgressiveRenderer(scene["pack"], cfg, cam_cfg, device="cpu",
                                   **kw)


@pytest.mark.parametrize("wavefront", [False, True], ids=["k1", "wavefront"])
def test_pass_0_matches_the_jax_renderer(scene, wavefront):
    r = _renderer(scene, wavefront)
    assert (r._mega is None) == wavefront
    r.step()
    img = r.image
    assert img.shape == (RES, RES, 3) and img.dtype == np.float32
    _assert_close(img, scene["jax"].image)
    assert r.acc.dtype == torch.float64


@pytest.mark.parametrize("wavefront", [False, True], ids=["k1", "wavefront"])
def test_resume_is_bit_for_bit(scene, tmp_path, wavefront):
    """At 12x12 (the wavefront takes ~0.7 s a pass on the CPU)."""
    ck = str(tmp_path / "render.ckpt.npz")
    a = _renderer(scene, wavefront, res=12, seed=3)
    a.step()
    a.step()
    a.save(ck)
    assert not pathlib.Path(ck + ".tmp.npz").exists()
    b = _renderer(scene, wavefront, res=12, seed=3)
    assert b.load(ck) and b.samples_done == 2
    np.testing.assert_array_equal(b.image, a.image)
    a.step()
    b.step()
    np.testing.assert_array_equal(b.image, a.image)


def test_render_saves_every_few_passes_and_resumes(scene, tmp_path):
    ck = str(tmp_path / "r.npz")
    a = _renderer(scene, res=12)
    a.render(3, checkpoint=ck, checkpoint_every=2)
    with np.load(ck) as data:
        assert int(data["samples_done"]) == 3
    b = _renderer(scene, res=12)
    img = b.render(4, checkpoint=ck)
    assert b.samples_done == 4
    a.step()
    np.testing.assert_array_equal(img, a.image)


def test_checkpoints_pass_between_the_packages(scene, tmp_path):
    jr = scene["jax"]
    ck_jax = str(tmp_path / "jax.npz")
    jr.save(ck_jax)
    r = _renderer(scene)
    assert r.load(ck_jax) and r.samples_done == 1
    np.testing.assert_array_equal(r.image, jr.image)

    ck_port = str(tmp_path / "port.npz")
    r.step()
    r.save(ck_port)
    jcfg = jr.cfg
    j2 = JaxProgressiveRenderer(jr.pack, jcfg, jcfg.cameras[0], tile_size=256)
    assert j2.load(ck_port) and j2.samples_done == 2
    np.testing.assert_array_equal(j2.image, r.image)
    with np.load(ck_port) as data:
        assert sorted(data.files) == ["acc", "height", "samples_done", "seed",
                                      "version", "width"]
        assert data["acc"].dtype == np.float64
        assert int(data["version"]) == CKPT_VERSION == 1


def test_load_refuses_another_size_seed_or_version(scene, tmp_path):
    ck = str(tmp_path / "c.npz")
    a = _renderer(scene)
    a.step()
    a.save(ck)
    assert not _renderer(scene, seed=1).load(ck)
    assert not _renderer(scene).load(str(tmp_path / "missing.npz"))
    b = _renderer(scene, res=RES // 2)
    assert not b.load(ck) and b.samples_done == 0
    with np.load(ck) as data:
        fields = dict(data)
    fields["version"] = CKPT_VERSION + 1
    bad = str(tmp_path / "v2.npz")
    np.savez(bad, **fields)
    c = _renderer(scene)
    assert not c.load(bad) and c.samples_done == 0


def test_the_tile_size_changes_no_pixel(scene):
    """Two passes (the second jittered) in tiles of 50 rays and in one
    tile, at 12x12."""
    a = _renderer(scene, wavefront=True, res=12, tile_size=50)
    b = _renderer(scene, wavefront=True, res=12)
    for r in (a, b):
        r.step()
        r.step()
    np.testing.assert_array_equal(a.image, b.image)


def test_path_traced_frames_match_the_jax_renderer_in_expectation(tmp_path):
    path = _pt_box(tmp_path, "NextEventEstimation ImportanceSampling")
    xml = pathlib.Path(path).read_text().replace("32 32", "16 16")
    pathlib.Path(path).write_text(xml)
    cfg = load_scene(path)
    pack = pack_scene(cfg, device="cpu")
    jcfg = jax_load_scene(path)
    jr = JaxProgressiveRenderer(jax_pack_scene(jcfg), jcfg, jcfg.cameras[0],
                                tile_size=256)
    n_seeds = 8
    ours, theirs = [], []
    for s in range(n_seeds):
        r = ProgressiveRenderer(pack, cfg, cfg.cameras[0], seed=s,
                                device="cpu")
        assert r._mega is not None  # K1b's plain version
        r.render(2)
        ours.append(r.image.mean())
        # one JAX renderer (one compile), reset for each seed
        jr.seed, jr.samples_done = 100 + s, 0
        jr.acc[:] = 0.0
        jr.render(2)
        theirs.append(jr.image.mean())
    ours, theirs = np.array(ours), np.array(theirs)
    assert np.isfinite(ours).all()
    z = abs(ours.mean() - theirs.mean()) / np.sqrt(
        ours.var() / n_seeds + theirs.var() / n_seeds + 1e-12)
    assert z < 4.0, (ours.mean(), theirs.mean(), z)
