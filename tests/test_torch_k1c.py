"""Spot and area lights, the pluggable BRDFs, glossy roughness and motion
blur (K1c) of the PyTorch port against the JAX package, on this host's CPU.

* ``build_mega``'s new tables (spot lights, area lights, the materials'
  roughness and BRDF, per-face and per-sphere motion, motion-swept chunk
  boxes) against the JAX ``build_mega`` fields on the same scene;
* ``mega_trace_ref`` against the JAX kernel in interpret mode on the same
  camera rays, on the scenes of the JAX kernel's own K1c tests
  (tests/test_megakernel.py: spot + directional, the BRDF zoo, the demo
  scene's area light, motion + roughness) and on
  ``scenes/feat_spotareaml.xml`` as Whitted and as path tracing with a
  rough dielectric.  Deterministic scenes: mean |Δ| < 0.01 and 99.9%
  quantile < 0.5 (the JAX kernel test's bound; fp reassociation at
  silhouettes).  Sampled scenes, both fed the JAX kernel's own draw table:
  99.5% of rays within 1e-3 + 1e-3 |ref| (a last-ulp difference may flip a
  sampled path), batch means within 1e-3 relative;
* the Philox table across several Philox blocks (15 draws, the motion time
  in the last slot);
* a 48 px CPU frame of ``feat_spotareaml.xml`` against the JAX wavefront in
  expectation (Welch z < 4 over per-seed means), the CLI on it, and one
  CPU frame of ``scenes/feat_lights_brdf.xml`` (coarse torus), routed to
  the K1c variant.
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
from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import path_traced
from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from test_torch_common import REPO, k1c_scenes, lights_brdf_scene

torch.set_num_threads(1)

# name -> (rays, sampled) of the K1c scenes (scene/feature_scenes.py)
CONFIGS = {
    "spot_dir": (1024, False),
    "brdf_zoo": (2048, False),
    "area_demo": (1024, True),
    "motion_rough": (1024, True),
    "spotareaml": (1024, True),
    "spotareaml_pt_rough_glass": (1024, True),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def config(request, tmp_path_factory):
    n, sampled = CONFIGS[request.param]
    path = tmp_path_factory.mktemp(request.param) / f"{request.param}.xml"
    path.write_text(k1c_scenes()[request.param])
    jcfg = jax_load_scene(str(path))
    jpack = jax_pack_scene(jcfg)
    cfg = load_scene(str(path))
    pack = pack_scene(cfg, device="cpu")
    jtabs = jax_build_mega(jpack, jax_options_for_camera(jcfg, jcfg.cameras[0]),
                           host_rng=sampled)
    tabs = mk.build_mega(pack, options_for_camera(cfg, cfg.cameras[0]),
                         device="cpu")
    cam = jax_camera.build_camera(jcfg.cameras[0])
    rng = np.random.default_rng(7)
    px = rng.uniform(0, cam.width, n).astype(np.float32)
    py = rng.uniform(0, cam.height, n).astype(np.float32)
    o, d = jax_camera.generate_rays(cam, jnp.asarray(px), jnp.asarray(py),
                                    jnp.zeros((n, 2)), dof=False)
    jmc, jtab, jctab, _ = jtabs
    key = jax.random.PRNGKey(13)
    want = np.asarray(jax_mega_trace(jmc, jtab, jctab, o, d, interpret=True,
                                     rng_key=key if sampled else None))
    table = None
    if sampled:
        # the JAX kernel's host table (mega_trace_flat): (rows, n_rows, 128)
        # uniforms over the rays padded to whole 1024-ray tiles
        r_pad = -(-n // TILE) * TILE
        table = np.array(jax.random.uniform(
            key, (jmc.max_iters * jmc.n_draws, r_pad // LANES, LANES),
            jnp.float32)).reshape(-1, r_pad)[:, :n]
    return dict(name=request.param, sampled=sampled, pack=pack,
                opts=options_for_camera(cfg, cfg.cameras[0]), jtabs=jtabs,
                tabs=tabs, o=np.array(o), d=np.array(d), want=want, table=table)


def test_build_mega_matches_jax(config):
    jmc, jtab, jctab, _ = config["jtabs"]
    mc, tab, ctab = config["tabs"]
    jtab = np.asarray(jtab)
    np.testing.assert_array_equal(tab.numpy(), jtab[:, :16])
    # chunk boxes, swept over both ends of the motion in motion scenes
    np.testing.assert_array_equal(ctab.numpy(), np.asarray(jctab))
    assert (mc.max_iters, mc.stack_k, mc.n_draws) == (
        jmc.max_iters, jmc.stack_k, jmc.n_draws)
    assert (mc.has_rough, mc.has_motion) == (jmc.has_rough, jmc.has_motion)
    # spot lights: (pos, dir, intensity, cos half coverage, cos half falloff)
    sl = mc.spot_lights.numpy()
    assert sl.shape == (len(jmc.spot_lights), mk.SPOT_COLS)
    for row, (pos, dr, inten, chc, chf, _, _) in zip(sl, jmc.spot_lights):
        np.testing.assert_array_equal(row[:9], np.float32([*pos, *dr, *inten]))
        assert (row[9], row[10]) == (np.float32(chc), np.float32(chf))
        assert row[11] == np.float32(max(chf - chc, 1e-9))
    # area lights: (pos, normal, radiance, extent, area, u, v)
    al = mc.area_lights.numpy()
    assert al.shape == (len(jmc.area_lights), mk.AREA_COLS)
    for row, (pos, nrm, rad, ext, area, u, v) in zip(al, jmc.area_lights):
        np.testing.assert_array_equal(
            row, np.float32([*pos, *nrm, *rad, ext, area, *u, *v]))
    # roughness and the resolved BRDF (JAX material fields 10-14)
    mx = mc.mat_ext.numpy()
    for i, m in enumerate(jmc.materials):
        np.testing.assert_array_equal(mx[i, 0:5], np.float32(m[10:15]))
    assert mc.has_brdf == any(m[11] >= 0 for m in jmc.materials)
    # motion: per-face world motion (JAX tri columns 16:19), per-sphere
    # object-space motion
    if jmc.has_motion:
        np.testing.assert_array_equal(mc.tri_motion.numpy(), jtab[:, 16:19])
    else:
        assert not mc.tri_motion.numpy().any()
    assert mc.faces_move == bool(mc.tri_motion.numpy().any())
    assert mc.spheres_move == bool(mc.sph_motion.numpy().any())
    for i, s in enumerate(jmc.spheres):
        np.testing.assert_array_equal(
            mc.sph_motion[i].numpy(),
            np.float32(s[5]) if jmc.has_motion else np.zeros(3, np.float32))
    assert mc.kernel == "mega_ext"
    assert mk.mega_missing(config["pack"].static, config["opts"]) == []


def _assert_close(got, want, sampled):
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    if sampled:
        assert ((diff <= 1e-3 + 1e-3 * np.abs(want)).all(axis=1)).mean() >= 0.995
        assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean())
    else:
        assert np.mean(diff) < 0.01
        assert np.quantile(diff, 0.999) < 0.5


def test_mega_trace_ref_matches_jax_kernel(config):
    mc, tab, ctab = config["tabs"]
    stats: dict = {}
    table = config["table"]
    got = mk.mega_trace_ref(
        mc, tab, ctab, torch.as_tensor(config["o"]), torch.as_tensor(config["d"]),
        draws=None if table is None else torch.as_tensor(table),
        stats=stats).numpy()
    _assert_close(got, config["want"], config["sampled"])
    # every light of the scene casts shadow rays, spot and area lights too
    n_lights = (mc.point_lights.shape[0] + mc.dir_lights.shape[0]
                + mc.spot_lights.shape[0] + mc.area_lights.shape[0])
    assert stats["shadow_rays"] >= n_lights * 0.3 * len(got)
    # the bound's motion operations: only tests of what moves count
    for kind, motion in (("tri", mc.tri_motion[:mc.n_tri]),
                         ("sphere", mc.sph_motion)):
        moving = (motion != 0).any(dim=1)
        n_moving = stats.get(f"{kind}_motion_tests", 0)
        if not moving.any():
            assert n_moving == 0
        elif moving.all():
            assert n_moving == stats[f"{kind}_tests"]
        else:
            assert 0 < n_moving < stats[f"{kind}_tests"]


def test_mega_trace_on_cpu_is_the_plain_version(config):
    mc, tab, ctab = config["tabs"]
    o, d = torch.as_tensor(config["o"][:96]), torch.as_tensor(config["d"][:96])
    before = dict(mk.LAUNCHES)
    got = mk.mega_trace(mc, tab, ctab, o, d, seed=3, sample=5)
    assert mk.LAUNCHES == before  # no kernel launch on the CPU
    draws = (philox_table(3, 5, 96, mc.max_iters, mc.n_draws)
             if mc.n_draws else None)
    torch.testing.assert_close(
        got, mk.mega_trace_ref(mc, tab, ctab, o, d, draws=draws), rtol=0, atol=0)
    assert (mc.n_draws > 0) == config["sampled"]


@pytest.mark.parametrize("it", [0, 2])
def test_philox_table_across_blocks(it):
    """15 draws per node (RR, GI, one mesh light, two area lights, the
    roughness pairs and the motion time) span four Philox blocks: slot s
    is word s % 4 of the block at counter (ray, it, s // 4, 0)."""
    n_rays, max_iters, n_draws, seed, sample = 33, 4, 15, 0x2468ACE, 9
    table = philox_table(seed, sample, n_rays, max_iters, n_draws)
    assert table.shape == (max_iters * n_draws, n_rays)
    ray = torch.arange(n_rays, dtype=torch.int64)
    for slot in range(n_draws):
        words = philox4x32(ray, torch.full_like(ray, it),
                           torch.full_like(ray, slot // 4),
                           torch.zeros_like(ray), seed, sample)
        torch.testing.assert_close(rnd(table, it, slot, max_iters, n_draws),
                                   uniform_from_bits(words[slot % 4]),
                                   rtol=0, atol=0)
    # the motion time is row n_draws - 1: iteration 0, the last slot
    torch.testing.assert_close(table[n_draws - 1],
                               rnd(table, 0, n_draws - 1, max_iters, n_draws),
                               rtol=0, atol=0)


def test_spotareaml_frame_matches_jax_wavefront_in_expectation(tmp_path):
    """A 48x36 CPU frame of feat_spotareaml.xml (the plain version, Philox
    draws) against the JAX wavefront ``trace_radiance`` (jax.random draws)
    over 24 seeds each: Welch z < 4 on the per-seed global means."""
    xml = (REPO / "scenes" / "feat_spotareaml.xml").read_text().replace(
        "320 240", "48 36")
    path = tmp_path / "feat_spotareaml.xml"
    path.write_text(xml)
    cfg = load_scene(str(path))
    pack = pack_scene(cfg, device="cpu")
    jcfg = jax_load_scene(str(path))
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
    theirs = np.array([float(np.asarray(f(jax.random.PRNGKey(400 + s))).mean())
                       for s in range(n_seeds)])
    z = abs(ours.mean() - theirs.mean()) / np.sqrt(
        ours.var() / n_seeds + theirs.var() / n_seeds + 1e-12)
    assert z < 4.0, (ours.mean(), theirs.mean(), z)


def test_cli_renders_spotareaml(tmp_path):
    """The CLI renders scenes/feat_spotareaml.xml (here at 32x24) to the PNG
    that render_camera makes."""
    from PIL import Image

    path = tmp_path / "feat_spotareaml.xml"
    path.write_text((REPO / "scenes" / "feat_spotareaml.xml").read_text()
                    .replace("320 240", "32 24"))
    assert cli_main([str(path), "--out-dir", str(tmp_path), "--spp", "1",
                     "--seed", "2", "--device", "cpu"]) == 0
    img = np.asarray(Image.open(tmp_path / "feat_spotareaml.png"))
    cfg = load_scene(str(path))
    want = render_camera(pack_scene(cfg, device="cpu"), cfg, cfg.cameras[0],
                         seed=2, spp=1, ldr=True, device="cpu")
    np.testing.assert_array_equal(img, want)
    assert img.shape == (24, 32, 3) and img.mean() > 1.0


@pytest.mark.parametrize("pt", [False, True])
def test_lights_brdf_scene_renders_through_k1c(tmp_path, pt):
    """scenes/feat_lights_brdf.xml (the card's main path) parses, packs and
    routes to the K1c variant; a 1-spp 48 px CPU frame with DoF is finite
    and lit.  ``pt``: the path-tracing variant made by substitution."""
    path = lights_brdf_scene(tmp_path)
    if pt:
        xml = path_traced(open(path).read())
        open(path, "w").write(xml)
    cfg = load_scene(path)
    pack = pack_scene(cfg, device="cpu")
    opts = options_for_camera(cfg, cfg.cameras[0])
    st = pack.static
    assert (st.n_spot, st.n_area, st.n_mesh_lights, st.n_brdfs) == (1, 2, 1, 5)
    assert st.has_rough and st.has_motion and st.has_dielectric
    assert opts.path_tracing == pt and cfg.max_recursion_depth == 4
    assert mk.mega_missing(st, opts) == []
    mc = mk.build_mega(pack, opts, device="cpu")[0]
    assert mc.kernel == "mega_ext" and mc.n_draws == 15
    assert cfg.cameras[0].aperture_size > 0  # the DoF lens path
    img = render_camera(pack, cfg, cfg.cameras[0], seed=1, spp=1, device="cpu")
    assert img.shape == (48, 48, 3) and np.isfinite(img).all()
    assert 5.0 < float(np.clip(img, 0, 255).mean()) < 250.0
