"""Textures and the environment light (K1d) of the PyTorch port against
the JAX package, on this host's CPU.

* ``build_mega``'s new tables against the JAX ``build_mega`` fields on
  each K1d scene (``scene/feature_scenes.py::k1d_scenes``, the scenes of
  the JAX kernel's own texture and env tests): the per-face slots, UVs
  and tangent frames (JAX tri columns 19:48), the texel pool against the
  pack's atlas at each image's size, the Perlin permutation, the env map's
  size, the background texture and the sphere slots;
* ``mega_trace_ref`` against the JAX kernel in interpret mode on the same
  camera rays.  Scenes without draws: mean |d| < 0.01 and 99.9% quantile
  < 0.5; scenes with draws (the env light), both fed the JAX kernel's own
  draw table: 99.5% of rays within 1e-3 + 1e-3 |ref|, batch means within
  1e-3 relative.  The JAX kernel's polynomial atan2 returns 0 at (+-0, -0)
  where IEEE atan2 (the reference's, libdevice's, torch's) returns +-pi:
  an env lookup along an axis-aligned fallback normal then reads the
  middle column instead of the edge.  The comparison runs the port under
  the JAX convention for that one point; the port's own convention is
  held by ``test_env_fallback_reads_the_reference_column``;
* a 48 px CPU frame of the env scene against the JAX wavefront in
  expectation (Welch z < 4 over per-seed means), the CLI on
  ``scenes/feat_textures.xml`` (coarse torus), the committed texture
  assets, and ``mega_missing``'s remaining gates.
"""

from __future__ import annotations

import dataclasses
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu.ops.pallas.megakernel import (
    LANES,
    TILE,
    _perm512_table,
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
from advanced_cpu_raytracing_tpu_torch.ops.rng import philox_table
from advanced_cpu_raytracing_tpu_torch.render.renderer import (
    options_for_camera,
    render_camera,
)
from advanced_cpu_raytracing_tpu_torch.scene import feature_scenes as fs
from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from test_torch_common import COARSE_TORUS, REPO, ply_bytes, torus_mesh

torch.set_num_threads(1)

N_RAYS = 1024
# every K1d scene, held against the JAX kernel here (chip_smoke.py holds the
# CUDA kernel to the plain version on them too); the JAX interpret runs
# take most of this file's time
SCENES = ["perlin", "image", "maps", "six_textures", "big_nearest",
          "big_bilinear", "hdr_texture", "bg_nearest", "bg_bilinear",
          "transformed_maps", "sphere_perlin_bump", "sphere_replace_kd",
          "sphere_blend_kd", "sphere_replace_all", "sphere_bump_normal", "env",
          "env_big", "env_rough", "env_motion_rough", "spotareaml_env",
          "spotareaml_env_pt_rough_glass"]


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("k1d")
    xmls = fs.k1d_scenes(d, REPO / "scenes")
    for name, xml in xmls.items():
        (d / f"{name}.xml").write_text(xml)
    return d


@pytest.fixture(scope="module", params=SCENES)
def config(request, scene_dir):
    name = request.param
    sampled = name in fs.K1D_SAMPLED
    path = str(scene_dir / f"{name}.xml")
    jcfg = jax_load_scene(path)
    jpack = jax_pack_scene(jcfg)
    cfg = load_scene(path)
    pack = pack_scene(cfg, device="cpu")
    opts = options_for_camera(cfg, cfg.cameras[0])
    jtabs = jax_build_mega(jpack, jax_options_for_camera(jcfg, jcfg.cameras[0]),
                           host_rng=sampled)
    tabs = mk.build_mega(pack, opts, device="cpu")
    cam = jax_camera.build_camera(jcfg.cameras[0])
    rng = np.random.default_rng(7)
    w, h = cam.width, cam.height
    px = rng.uniform(0, w, N_RAYS).astype(np.float32)
    py = rng.uniform(0, h, N_RAYS).astype(np.float32)
    o, d = jax_camera.generate_rays(cam, jnp.asarray(px), jnp.asarray(py),
                                    jnp.zeros((N_RAYS, 2)), dof=False)
    jmc, jtab, jctab, jimg = jtabs
    pix = jnp.asarray(px) * (1.0 / w), jnp.asarray(py) * (1.0 / h)
    key = jax.random.PRNGKey(13)
    want = np.asarray(jax_mega_trace(
        jmc, jtab, jctab, o, d, interpret=True,
        rng_key=key if sampled else None, img_tab=jimg,
        pix_uv=pix if jmc.bg_tex >= 0 else None))
    table = None
    if sampled:
        # the JAX kernel's host table (mega_trace_flat)
        r_pad = -(-N_RAYS // TILE) * TILE
        table = np.array(jax.random.uniform(
            key, (jmc.max_iters * jmc.n_draws, r_pad // LANES, LANES),
            jnp.float32)).reshape(-1, r_pad)[:, :N_RAYS]
    pix_uv = torch.stack((torch.as_tensor(px) * (1.0 / w),
                          torch.as_tensor(py) * (1.0 / h)), -1)
    return dict(name=name, sampled=sampled, pack=pack, jpack=jpack, opts=opts,
                jtabs=jtabs, tabs=tabs, o=np.array(o), d=np.array(d),
                want=want, table=table, pix_uv=pix_uv)


def test_scenes_are_every_k1d_scene(scene_dir):
    assert sorted(SCENES) == sorted(fs.k1d_scenes(scene_dir, REPO / "scenes"))


def test_build_mega_matches_jax(config):
    jmc, jtab, _, _ = config["jtabs"]
    mc, tab, _ = config["tabs"]
    jtab = np.asarray(jtab)
    assert mc.kernel == "mega_tex"
    assert mk.mega_missing(config["pack"].static, config["opts"],
                           config["pack"]) == []
    assert (mc.max_iters, mc.stack_k, mc.n_draws) == (
        jmc.max_iters, jmc.stack_k, jmc.n_draws)
    np.testing.assert_array_equal(tab.numpy(), jtab[:, :16])
    face = mc.tex_face.numpy()
    n_cols = jtab.shape[1]
    if mc.n_textures:
        # slots (diffuse, specular, bump; replace_all and normal where the
        # JAX table has image columns), UVs, tangent frame
        np.testing.assert_array_equal(face[:, 0:3], jtab[:, 19:22])
        if n_cols >= 32:
            np.testing.assert_array_equal(face[:, 3:11], jtab[:, 22:30])
        if n_cols > 32:
            np.testing.assert_array_equal(face[:, 11:n_cols - 19],
                                          jtab[:, 30:n_cols])
        assert mc.tbn_obj == jmc.tbn_obj
    assert mc.bg_tex == jmc.bg_tex
    np.testing.assert_array_equal(mc.perm.numpy(), _perm512_table().reshape(-1))
    # the pool holds every image at its native size, as the pack's atlas
    atlas = np.asarray(config["jpack"].img_atlas)
    timg = np.asarray(config["jpack"].tex_img)
    texels = mc.texels.numpy()
    for ti, (kind, interp, blend, conv, w, h, first) in enumerate(
            mc.tex_int.numpy()[:mc.n_textures]):
        if kind == 0:
            np.testing.assert_array_equal(
                texels[first:first + w * h],
                atlas[timg[ti], :h, :w].reshape(-1, 3))
    if jmc.env:
        w, h, first = mc.env
        assert (w, h) == tuple(jmc.env[:2])
        eimg = int(np.asarray(config["jpack"].env_img)[0])
        np.testing.assert_array_equal(texels[first:first + w * h],
                                      atlas[eimg, :h, :w].reshape(-1, 3))
    else:
        assert mc.env == ()
    for row, jrow in zip(mc.tex_sph.numpy(), jmc.sph_tex):
        np.testing.assert_array_equal(row[:5], np.float32(jrow))


def _atan2_jax_zero(atan2):
    """IEEE atan2 except 0 at (+-0, +-0), the JAX kernel's atan2_k there."""
    return lambda y, x: torch.where((y == 0) & (x == 0), torch.zeros_like(y),
                                    atan2(y, x))


def _assert_close(got, want, sampled):
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    if sampled:
        assert ((diff <= 1e-3 + 1e-3 * np.abs(want)).all(axis=1)).mean() >= 0.995
        assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean())
    else:
        assert np.mean(diff) < 0.01
        assert np.quantile(diff, 0.999) < 0.5


def test_mega_trace_ref_matches_jax_kernel(config, monkeypatch):
    mc, tab, ctab = config["tabs"]
    monkeypatch.setattr(torch, "atan2", _atan2_jax_zero(torch.atan2))
    stats: dict = {}
    table = config["table"]
    got = mk.mega_trace_ref(
        mc, tab, ctab, torch.as_tensor(config["o"]), torch.as_tensor(config["d"]),
        draws=None if table is None else torch.as_tensor(table), stats=stats,
        pix_uv=config["pix_uv"]).numpy()
    _assert_close(got, config["want"], config["sampled"])
    # the bound's data-dependent work: Perlin evaluations where a Perlin
    # texture is in a slot, texel taps where an image or the env is read,
    # up to 16 candidates per lit node of an env scene
    used = {int(x) for x in mc.tex_face[:, 0:5].unique().tolist()
            + mc.tex_sph[:, 0:4].flatten().tolist() if x >= 0}
    kinds = {int(mc.tex_int[ti, 0]) for ti in used}
    assert (stats.get("perlin_evals", 0) > 0) == (1 in kinds)
    assert (stats.get("texel_taps", 0) > 0) == (
        0 in kinds or bool(mc.env) or mc.bg_tex >= 0)
    if mc.env:
        assert 0 < stats["env_candidates"] <= 16 * stats["traces"]


def test_mega_trace_on_cpu_is_the_plain_version(config):
    mc, tab, ctab = config["tabs"]
    o, d = torch.as_tensor(config["o"][:96]), torch.as_tensor(config["d"][:96])
    pix_uv = config["pix_uv"][:96]
    before = dict(mk.LAUNCHES)
    got = mk.mega_trace(mc, tab, ctab, o, d, seed=3, sample=5, pix_uv=pix_uv)
    assert mk.LAUNCHES == before  # no kernel launch on the CPU
    draws = (philox_table(3, 5, 96, mc.max_iters, mc.n_draws)
             if mc.n_draws else None)
    torch.testing.assert_close(
        got, mk.mega_trace_ref(mc, tab, ctab, o, d, draws=draws, pix_uv=pix_uv),
        rtol=0, atol=0)
    assert (mc.n_draws > 0) == config["sampled"]


def test_env_draw_slots_sit_below_roughness(scene_dir):
    """The env's 48 candidate slots follow the mesh and area lights' and
    precede the roughness pair (the JAX layout): the rough mirror of
    ``env_rough`` draws 3 + 48 + 4 per node.  With its roughness draws at
    0.5 (no perturbation) and every other draw as in the smooth ``env``
    scene, it renders what the smooth mirror renders."""
    frames = {}
    for name in ("env", "env_rough"):
        cfg = load_scene(str(scene_dir / f"{name}.xml"))
        mc, tab, ctab = mk.build_mega(pack_scene(cfg, device="cpu"),
                                      options_for_camera(cfg, cfg.cameras[0]),
                                      device="cpu")
        frames[name] = (mc, tab, ctab, cfg)
    smooth, rough = frames["env"][0], frames["env_rough"][0]
    assert (smooth.n_draws, rough.n_draws) == (3 + mk.ENV_DRAWS, 7 + mk.ENV_DRAWS)
    assert rough.has_rough and smooth.max_iters == rough.max_iters
    n = 512
    rng = np.random.default_rng(5)
    table = torch.as_tensor(rng.uniform(0.0, 1.0, (smooth.max_iters,
                                                   smooth.n_draws, n))
                            .astype(np.float32))
    pad = torch.full((smooth.max_iters, 4, n), 0.5)
    rough_table = torch.cat([table, pad], 1).reshape(-1, n)
    from advanced_cpu_raytracing_tpu_torch.render.camera import (
        build_camera,
        generate_rays,
    )

    cam = build_camera(frames["env"][3].cameras[0], device="cpu")
    px = torch.as_tensor(rng.uniform(0, 320, n).astype(np.float32))
    py = torch.as_tensor(rng.uniform(0, 240, n).astype(np.float32))
    o, d = (t.contiguous() for t in generate_rays(cam, px, py))
    want = mk.mega_trace_ref(*frames["env"][:3], o, d,
                             draws=table.reshape(-1, n))
    got = mk.mega_trace_ref(*frames["env_rough"][:3], o, d, draws=rough_table)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_env_fallback_reads_the_reference_column(scene_dir):
    """Along the normal (0, 1, 0) of an axis-aligned floor, -v_z is -0:
    atan2(0, -0) = pi, so u = 1 and the lookup reads the map's last column
    of its top row (the reference's and the JAX wavefront's convention)."""
    cfg = load_scene(str(scene_dir / "env.xml"))
    mc = mk.build_mega(pack_scene(cfg, device="cpu"),
                       options_for_camera(cfg, cfg.cameras[0]), device="cpu")[0]
    w, h, first = mc.env
    ops = mk._Tex(mc, lambda key, n: None)
    rad = ops.env(torch.zeros(1), torch.ones(1), torch.zeros(1))
    torch.testing.assert_close(rad[0], mc.texels[first + w - 1] * (2.0 * np.pi),
                               rtol=0, atol=0)
    assert not torch.equal(mc.texels[first + w - 1], mc.texels[first + w // 2])


def test_env_frame_matches_jax_wavefront_in_expectation(scene_dir, tmp_path):
    """A 48x36 CPU frame of the env scene (the plain version, Philox draws)
    against the JAX wavefront ``trace_radiance`` (jax.random draws) over 16
    seeds each: Welch z < 4 on the per-seed global means."""
    xml = (scene_dir / "env.xml").read_text().replace("320 240", "48 36")
    path = scene_dir / "env_48.xml"
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
    n_seeds = 16
    ours = np.array([render_camera(pack, cfg, cfg.cameras[0], seed=s, spp=1,
                                   device="cpu").mean() for s in range(n_seeds)])
    theirs = np.array([float(np.asarray(f(jax.random.PRNGKey(500 + s))).mean())
                       for s in range(n_seeds)])
    z = abs(ours.mean() - theirs.mean()) / np.sqrt(
        ours.var() / n_seeds + theirs.var() / n_seeds + 1e-12)
    assert z < 4.0, (ours.mean(), theirs.mean(), z)


def _textures_scene(tmp_path, res: int) -> str:
    """scenes/feat_textures.xml at res x res with the coarse torus and the
    committed textures beside it."""
    xml = (REPO / "scenes" / "feat_textures.xml").read_text()
    xml = re.sub(r"<ImageResolution>.*?</ImageResolution>",
                 f"<ImageResolution>{res} {res}</ImageResolution>", xml)
    out = tmp_path / "feat_textures.xml"
    out.write_text(xml)
    (tmp_path / "whitted_conductors_mesh.ply").write_bytes(
        ply_bytes(*torus_mesh(**COARSE_TORUS)))
    shutil.copytree(REPO / "scenes" / "textures", tmp_path / "textures")
    return str(out)


def test_cli_renders_feat_textures(tmp_path):
    """The CLI renders scenes/feat_textures.xml (here 32 px, coarse torus)
    to the PNG that render_camera makes; the scene routes to K1d with every
    texture path: 8 textures, a bilinear and a nearest image, a normal map,
    an image and a Perlin bump, a blend, a sphere texture and the env."""
    from PIL import Image

    path = _textures_scene(tmp_path, 32)
    assert cli_main([path, "--out-dir", str(tmp_path), "--spp", "1",
                     "--seed", "2", "--device", "cpu"]) == 0
    img = np.asarray(Image.open(tmp_path / "feat_textures.png"))
    cfg = load_scene(path)
    pack = pack_scene(cfg, device="cpu")
    want = render_camera(pack, cfg, cfg.cameras[0], seed=2, spp=1, ldr=True,
                         device="cpu")
    np.testing.assert_array_equal(img, want)
    assert img.shape == (32, 32, 3) and 5.0 < img.mean() < 250.0
    mc = mk.build_mega(pack, options_for_camera(cfg, cfg.cameras[0]),
                       device="cpu")[0]
    assert mc.kernel == "mega_tex" and mc.n_textures == 8
    assert mc.n_draws == 3 + mk.ENV_DRAWS and mc.env == (1024, 512, mc.env[2])
    assert mc.bg_tex < 0 and not mc.tbn_obj
    sizes = {tuple(r[4:6]) for r in mc.tex_int.numpy().tolist()}
    assert {(1024, 1024), (1024, 512), (0, 0)} <= sizes


def test_feature_textures_are_the_committed_ones(tmp_path):
    """scenes/textures/ holds what feature_scenes.write_feature_textures
    makes."""
    fs.write_feature_textures(tmp_path)
    names = sorted(p.name for p in (REPO / "scenes" / "textures").iterdir())
    assert names == sorted(fs.feature_texture_images())
    for name in names:
        assert (tmp_path / name).read_bytes() == (
            REPO / "scenes" / "textures" / name).read_bytes(), name


_GATES = {
    "texture_brdf": (lambda x: x.replace('<Material id="1">',
                                         '<Material id="1" BRDF="1">').replace(
        "<Materials>", "<BRDFs><OriginalPhong id=\"1\"><Exponent>20</Exponent>"
        "</OriginalPhong></BRDFs><Materials>"), "textures together with a "
                     "pluggable BRDF"),
    "texture_motion": (lambda x: x.replace(
        "<Faces>5 6 7  5 7 8</Faces></Mesh>",
        "<Faces>5 6 7  5 7 8</Faces><MotionBlur>0 0.5 0</MotionBlur></Mesh>"),
        "textures together with motion blur"),
    "perlin_bump_rotated": (lambda x: x.replace(
        "</Textures>", "</Textures><Transformations><Rotation id=\"1\">30 0 1 0"
        "</Rotation></Transformations>", 1).replace(
        '<Mesh id="1"><Material>1</Material><Textures>1 3</Textures>',
        '<Mesh id="1"><Material>1</Material><Textures>1 3</Textures>'
        "<Transformations>r1</Transformations>"),
        "Perlin bump_normal on a rotated or scaled mesh"),
}


@pytest.mark.parametrize("gate", list(_GATES))
def test_mega_missing_names_each_remaining_gate(tmp_path, gate):
    """The Perlin scene stays inside the envelope; each change puts it
    outside with one entry that says what to remove, and it renders through
    the wavefront (at 16x12, 1 spp) with no K1 launch."""
    mutate, words = _GATES[gate]
    xml = mutate(fs.PERLIN_XML)
    assert xml != fs.PERLIN_XML
    path = tmp_path / f"{gate}.xml"
    path.write_text(xml)
    cfg = load_scene(str(path))
    pack = pack_scene(cfg, device="cpu")
    missing = mk.mega_missing(pack.static, options_for_camera(
        cfg, cfg.cameras[0]), pack)
    assert len(missing) == 1 and words in missing[0], missing
    cfg.cameras[0].width, cfg.cameras[0].height = 16, 12
    before = dict(mk.LAUNCHES)
    frame = render_camera(pack, cfg, cfg.cameras[0], spp=1, device="cpu")
    assert mk.LAUNCHES == before
    assert frame.shape == (12, 16, 3) and np.isfinite(frame).all()
    assert frame.max() > 0


def test_mega_missing_names_streamed_geometry():
    """Past 98,304 faces, where the JAX kernel streams its geometry, the
    kernels walk a tree (K1e): inside the envelope, textured or not.  Past
    the pack's 2,097,152 faces the scene has no work items: outside it."""
    cfg = load_scene(str(REPO / "scenes" / "feat_textures.xml"))
    pack = pack_scene(cfg, device="cpu")
    opts = options_for_camera(cfg, cfg.cameras[0])
    assert mk.mega_missing(pack.static, opts, pack) == []
    big = dataclasses.replace(pack.static, n_work_items=mk.FLAT_MAX_FACES + 1)
    assert mk.mega_missing(big, opts, pack) == []
    huge = dataclasses.replace(pack.static, n_work_items=0)
    assert huge.n_faces > 0
    assert mk.mega_missing(huge, opts, pack) == ["more than 2,097,152 faces"]
    with pytest.raises(TypeError, match="needs its pack"):
        mk.mega_missing(pack.static, opts)
