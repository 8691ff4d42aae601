"""Path tracing and mesh lights (K1b) of the PyTorch port against the JAX
package, on this host's CPU.

* ``build_mega`` against the JAX ``build_mega(..., host_rng=True)``: the
  mesh-light table, the draw layout, the iteration and stack sizing, the
  emission column, on ``scenes/feat_pt.xml``, ``feat_pt_rr.xml``,
  ``feat_pt_spec.xml`` and ``feat_pt.xml`` without its renderer (Whitted +
  LightMesh);
* ``mega_trace_ref`` against the JAX kernel in interpret mode on 1,024
  camera rays, both fed the JAX kernel's own draw table, so the two draw
  the same numbers ray for ray.  A last-ulp difference (XLA's and torch's
  sin/cos/exp/log) can flip a Russian-roulette kill or a GI hit and change
  that ray by a whole path, so the tolerance allows a few rays: 99.5% of
  them within 1e-3 + 1e-3 |ref|, batch means within 1%, all finite;
* the Philox4x32-10 twin against the Random123 known answers, and the draw
  table's layout;
* a CPU frame in expectation against the JAX wavefront estimator: a Welch
  z-test over per-seed global means (the estimator is heavy-tailed), as
  tests/test_megakernel.py does for the JAX kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu.ops.pallas.megakernel import (
    LANES,
    TILE,
    build_mega as jax_build_mega,
    mega_trace as jax_mega_trace,
)
from advanced_cpu_raytracing_tpu.render import camera as jax_camera
from advanced_cpu_raytracing_tpu.render.integrator import trace_radiance
from advanced_cpu_raytracing_tpu.render.renderer import (
    options_for_camera as jax_options_for_camera,
)
from advanced_cpu_raytracing_tpu.scene.pack import pack_scene as jax_pack_scene
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene as jax_load_scene
from advanced_cpu_raytracing_tpu_torch.cli.render import main as cli_main
from advanced_cpu_raytracing_tpu_torch.ops import megakernel as mk
from advanced_cpu_raytracing_tpu_torch.ops.rng import (
    philox4x32,
    philox_table,
    rnd,
    uniform_from_bits,
)
from advanced_cpu_raytracing_tpu_torch.render.renderer import (
    options_for_camera,
    render_camera,
)
from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from test_torch_common import pt_scene

torch.set_num_threads(1)

N_RAYS = 1024
# name -> pt_scene arguments
CONFIGS = {
    "pt": dict(name="feat_pt.xml"),
    "pt_rr": dict(name="feat_pt_rr.xml"),
    "pt_spec": dict(name="feat_pt_spec.xml"),
    "whitted_meshlight": dict(name="feat_pt.xml", whitted=True),
    "pt_uniform_no_nee": dict(name="feat_pt.xml", params=""),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def config(request, tmp_path_factory):
    path = pt_scene(tmp_path_factory.mktemp(request.param),
                    **CONFIGS[request.param])
    jcfg = jax_load_scene(path)
    jpack = jax_pack_scene(jcfg)
    cfg = load_scene(path)
    pack = pack_scene(cfg, device="cpu")
    jtabs = jax_build_mega(jpack, jax_options_for_camera(jcfg, jcfg.cameras[0]),
                           host_rng=True)
    tabs = mk.build_mega(pack, options_for_camera(cfg, cfg.cameras[0]),
                         device="cpu")
    cam = jax_camera.build_camera(jcfg.cameras[0])
    rng = np.random.default_rng(7)
    px = rng.uniform(0, cam.width, N_RAYS).astype(np.float32)
    py = rng.uniform(0, cam.height, N_RAYS).astype(np.float32)
    o, d = jax_camera.generate_rays(cam, jnp.asarray(px), jnp.asarray(py),
                                    jnp.zeros((N_RAYS, 2)), dof=False)
    jmc, jtab, jctab, _ = jtabs
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_mega_trace(jmc, jtab, jctab, o, d, interpret=True,
                                     rng_key=key))
    # the JAX kernel's host table (mega_trace_flat): (rows, n_rows, 128)
    # uniforms over the rays padded to whole 1024-ray tiles
    r_pad = -(-N_RAYS // TILE) * TILE
    table = np.array(jax.random.uniform(
        key, (jmc.max_iters * jmc.n_draws, r_pad // LANES, LANES),
        jnp.float32)).reshape(-1, r_pad)[:, :N_RAYS]
    return dict(name=request.param, cfg=cfg, jtabs=jtabs, tabs=tabs,
                o=np.array(o), d=np.array(d), want=want, table=table)


def _assert_close_pt(got, want):
    diff = np.abs(got - want)
    assert np.isfinite(got).all()
    assert ((diff <= 1e-3 + 1e-3 * np.abs(want)).all(axis=1)).mean() >= 0.995
    assert abs(got.mean() - want.mean()) <= 0.01 * abs(want.mean())


def test_build_mega_matches_jax(config):
    jmc, jtab, jctab, _ = config["jtabs"]
    mc, tab, ctab = config["tabs"]
    np.testing.assert_array_equal(tab.numpy(), np.asarray(jtab)[:, :16])
    np.testing.assert_array_equal(ctab.numpy(), np.asarray(jctab))
    assert (mc.max_iters, mc.stack_k, mc.n_draws, mc.rr_floor) == (
        jmc.max_iters, jmc.stack_k, jmc.n_draws, jmc.rr_floor)
    assert (mc.pt, mc.pt_importance, mc.pt_nee, mc.pt_rr, mc.has_emissive) == (
        jmc.pt, jmc.pt_importance, jmc.pt_nee, jmc.pt_rr, jmc.has_emissive)
    for i, m in enumerate(jmc.materials):  # emission is the JAX m[9]
        np.testing.assert_array_equal(mc.materials[i, 19:22].numpy(),
                                      np.float32(m[9]))
    # mesh lights: per light (radiance, ((row, weight, corners), ...))
    faces = mc.ml_faces.numpy()
    assert mc.ml_lights.shape[0] == len(jmc.mesh_lights) == 1
    for li, (rad, jfaces) in enumerate(jmc.mesh_lights):
        row = mc.ml_lights[li].numpy()
        np.testing.assert_array_equal(row[:3], np.float32(rad))
        first, count = int(row[3]), int(row[4])
        assert count == len(jfaces)
        for k, (_, wgt, corners) in enumerate(jfaces):
            np.testing.assert_array_equal(faces[first + k, :9],
                                          np.float32(corners))
            assert faces[first + k, 9] == np.float32(wgt)
    assert mc.kernel == "mega_pt"


def test_mega_trace_ref_matches_jax_kernel(config):
    mc, tab, ctab = config["tabs"]
    stats: dict = {}
    got = mk.mega_trace_ref(mc, tab, ctab, torch.as_tensor(config["o"]),
                            torch.as_tensor(config["d"]),
                            draws=torch.as_tensor(config["table"]),
                            stats=stats).numpy()
    _assert_close_pt(got, config["want"])
    assert stats["traces"] >= N_RAYS
    assert ("gi_traces" in stats) == mc.pt
    assert ("shadow_rays" in stats) == (not mc.pt or mc.pt_nee)


def test_mega_trace_on_cpu_draws_the_philox_table(config):
    mc, tab, ctab = config["tabs"]
    o, d = torch.as_tensor(config["o"][:96]), torch.as_tensor(config["d"][:96])
    before = dict(mk.LAUNCHES)
    got = mk.mega_trace(mc, tab, ctab, o, d, seed=3, sample=5)
    assert mk.LAUNCHES == before  # no kernel launch on the CPU
    draws = philox_table(3, 5, 96, mc.max_iters, mc.n_draws)
    torch.testing.assert_close(
        got, mk.mega_trace_ref(mc, tab, ctab, o, d, draws=draws), rtol=0, atol=0)
    with pytest.raises(ValueError, match="draw table"):
        mk.mega_trace_ref(mc, tab, ctab, o, d)


@pytest.mark.parametrize("ctr,key,want", [
    # Random123 known-answer vectors for philox4x32-10
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    words = philox4x32(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(w) for w in words) == want


def test_philox_table_layout():
    """Row it * n_draws + slot, column ray: word slot % 4 of the block at
    counter (ray, it, slot // 4, 0) under key (seed, sample)."""
    n_rays, max_iters, n_draws, seed, sample = 37, 5, 9, 0x12345678, 6
    table = philox_table(seed, sample, n_rays, max_iters, n_draws)
    assert table.shape == (max_iters * n_draws, n_rays)
    assert table.dtype == torch.float32
    ray = torch.arange(n_rays, dtype=torch.int64)
    for it in (0, 3, 4):
        for slot in (0, 2, 3, 4, 8):
            words = philox4x32(ray, torch.full_like(ray, it),
                               torch.full_like(ray, slot // 4),
                               torch.zeros_like(ray), seed, sample)
            torch.testing.assert_close(
                rnd(table, it, slot, max_iters, n_draws),
                uniform_from_bits(words[slot % 4]), rtol=0, atol=0)
    # 23-bit uniforms in [0, 1), clamped iteration past the last row
    assert float(table.min()) >= 0.0 and float(table.max()) < 1.0
    assert torch.equal(table * 2.0 ** 23, torch.floor(table * 2.0 ** 23))
    assert torch.equal(rnd(table, 99, 1, max_iters, n_draws),
                       rnd(table, max_iters - 1, 1, max_iters, n_draws))
    assert not torch.equal(table, philox_table(seed, sample + 1, n_rays,
                                               max_iters, n_draws))


def test_philox_table_is_uniform():
    table = philox_table(1, 0, 4096, 4, 6).flatten().double()
    hist = torch.histc(table, bins=16, min=0.0, max=1.0)
    expected = table.numel() / 16
    chi2 = float(((hist - expected) ** 2 / expected).sum())
    assert chi2 < 45.0  # 15 degrees of freedom: p < 1e-4 above this
    assert abs(float(table.mean()) - 0.5) < 0.01


def test_options_for_camera_matches_jax(tmp_path):
    for args in CONFIGS.values():
        path = pt_scene(tmp_path, **args)
        cfg, jcfg = load_scene(path), jax_load_scene(path)
        opts = options_for_camera(cfg, cfg.cameras[0])
        jopts = jax_options_for_camera(jcfg, jcfg.cameras[0])
        for field in ("path_tracing", "importance_sampling",
                      "next_event_estimation", "russian_roulette", "max_depth"):
            assert getattr(opts, field) == getattr(jopts, field), field
    assert mk.RR_DEPTH_FLOOR == 8


def test_render_camera_pt_is_keyed_by_seed(tmp_path):
    cfg = load_scene(pt_scene(tmp_path, res=12))
    pack = pack_scene(cfg, device="cpu")
    one = render_camera(pack, cfg, cfg.cameras[0], seed=4, spp=4, device="cpu")
    again = render_camera(pack, cfg, cfg.cameras[0], seed=4, spp=4, device="cpu")
    other = render_camera(pack, cfg, cfg.cameras[0], seed=5, spp=4, device="cpu")
    np.testing.assert_array_equal(one, again)
    assert np.isfinite(one).all() and not np.array_equal(one, other)


@pytest.mark.parametrize("name", ["feat_pt.xml", "feat_pt_rr.xml",
                                  "feat_pt_spec.xml"])
def test_cli_renders_pt_scenes(tmp_path, name):
    """The CLI renders the committed PT scenes unchanged (here at 12x12)."""
    from PIL import Image

    path = pt_scene(tmp_path, res=12, name=name)
    assert cli_main([path, "--out-dir", str(tmp_path), "--spp", "1",
                     "--seed", "2", "--device", "cpu"]) == 0
    cfg = load_scene(path)
    img = np.asarray(Image.open(tmp_path / cfg.cameras[0].image_name))
    want = render_camera(pack_scene(cfg, device="cpu"), cfg, cfg.cameras[0],
                         seed=2, spp=1, ldr=True, device="cpu")
    np.testing.assert_array_equal(img, want)
    assert img.shape == (12, 12, 3) and img.mean() > 1.0


def _pt_box(tmp_path, params: str, pt: bool = True):
    """The JAX kernel test's tamed PT box (tests/test_megakernel.py:115):
    kd about 0.35 and depth 3, so that the reference's divergent estimator
    stays tame enough for a statistical comparison; at 32x32."""
    from tests.test_golden_features import PT_BOX

    xml = PT_BOX.format(name="torchpt", spp=1, params=params)
    xml = (xml.replace("0.7 0.7 0.7", "0.35 0.35 0.35")
              .replace("0.7 0.12 0.12", "0.35 0.1 0.1")
              .replace("0.12 0.7 0.12", "0.1 0.35 0.1")
              .replace("<MaxRecursionDepth>4</MaxRecursionDepth>",
                       "<MaxRecursionDepth>3</MaxRecursionDepth>")
              .replace("128 128", "32 32"))
    if not pt:
        xml = xml.replace("<Renderer>PathTracing</Renderer>", "")
        xml = xml.replace("<RendererParams></RendererParams>", "")
    path = tmp_path / "torchpt.xml"
    path.write_text(xml)
    return str(path)


@pytest.mark.parametrize("params,pt", [
    ("NextEventEstimation ImportanceSampling", True),
    ("NextEventEstimation ImportanceSampling RussianRoulette", True),
    ("", True),
    ("", False),
])
def test_pt_frame_matches_jax_wavefront_in_expectation(tmp_path, params, pt):
    """The port's CPU frame (the plain version, Philox draws) against the
    JAX wavefront estimator ``trace_radiance`` (jax.random draws) over 24
    seeds each: Welch z < 4 on the per-seed global means."""
    path = _pt_box(tmp_path, params, pt)
    cfg = load_scene(path)
    pack = pack_scene(cfg, device="cpu")
    jcfg = jax_load_scene(path)
    jpack = jax_pack_scene(jcfg)
    jopts = jax_options_for_camera(jcfg, jcfg.cameras[0])
    cam = jax_camera.build_camera(jcfg.cameras[0])
    w, h = cfg.cameras[0].width, cfg.cameras[0].height
    idx = np.arange(w * h)
    px = jnp.asarray((idx % w).astype(np.float32))
    py = jnp.asarray((idx // w).astype(np.float32))
    f = jax.jit(lambda k: trace_radiance(jpack, cam, px, py, k, jopts))
    n_seeds = 24
    ours = np.array([render_camera(pack, cfg, cfg.cameras[0], seed=s, spp=1,
                                   device="cpu").mean() for s in range(n_seeds)])
    theirs = np.array([float(np.asarray(f(jax.random.PRNGKey(300 + s))).mean())
                       for s in range(n_seeds)])
    z = abs(ours.mean() - theirs.mean()) / np.sqrt(
        ours.var() / n_seeds + theirs.var() / n_seeds + 1e-12)
    assert z < 4.0, (ours.mean(), theirs.mean(), z)
