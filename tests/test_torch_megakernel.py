"""The Whitted megakernel's host side and plain version against the JAX
package: ``build_mega`` tables, and ``mega_trace_ref`` on the CPU against
the JAX ``mega_trace`` in interpret mode on 1,024 camera rays of the
coarse slice scene (mirror, conductors, dielectric at depth 6, 7 chunks)
and of the demo scene.  The tolerance is that of the JAX package's own
kernel test (tests/test_megakernel.py): only fp reassociation at
silhouettes may differ."""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from advanced_cpu_raytracing_tpu.ops.pallas.megakernel import (
    build_mega as jax_build_mega,
    mega_trace as jax_mega_trace,
)
from advanced_cpu_raytracing_tpu.render import camera as jax_camera
from advanced_cpu_raytracing_tpu.render.integrator import RenderOptions as JaxOptions
from advanced_cpu_raytracing_tpu.scene.pack import pack_scene as jax_pack_scene
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene as jax_load_scene
from advanced_cpu_raytracing_tpu_torch.ops import megakernel as mk
from advanced_cpu_raytracing_tpu_torch.render.renderer import (
    options_for_camera,
    render_camera,
)
from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from tests.scene_builders import textured_xml
from test_torch_common import REPO, coarse_slice_scene, demo_scene

torch.set_num_threads(1)

N_RAYS = 1024


@pytest.fixture(scope="module", params=["slice", "demo"])
def scene(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    path = coarse_slice_scene(tmp) if request.param == "slice" else demo_scene(tmp)
    jcfg = jax_load_scene(path)
    jpack = jax_pack_scene(jcfg)
    cfg = load_scene(path)
    pack = pack_scene(cfg, device="cpu")
    opts = options_for_camera(cfg, cfg.cameras[0])
    jtabs = jax_build_mega(jpack, JaxOptions(max_depth=cfg.max_recursion_depth))
    tabs = mk.build_mega(pack, opts, device="cpu")
    cam = jax_camera.build_camera(jcfg.cameras[0])
    rng = np.random.default_rng(7)
    px = rng.uniform(0, cam.width, N_RAYS).astype(np.float32)
    py = rng.uniform(0, cam.height, N_RAYS).astype(np.float32)
    o, d = jax_camera.generate_rays(cam, jnp.asarray(px), jnp.asarray(py),
                                    jnp.zeros((N_RAYS, 2)), dof=False)
    jmc, jtab, jctab, _ = jtabs
    want = np.asarray(jax_mega_trace(jmc, jtab, jctab, o, d, interpret=True))
    return dict(name=request.param, static=pack.static, opts=opts,
                jtabs=jtabs, tabs=tabs, o=np.array(o), d=np.array(d),
                want=want)


def test_build_mega_tables_match_jax(scene):
    jmc, jtab, jctab, _ = scene["jtabs"]
    mc, tab, ctab = scene["tabs"]
    np.testing.assert_array_equal(tab.numpy(), np.asarray(jtab)[:, :16])
    np.testing.assert_array_equal(ctab.numpy(), np.asarray(jctab))
    assert (mc.n_tri, mc.stack_k, mc.max_iters, mc.max_depth) == (
        jmc.n_tri, jmc.stack_k, jmc.max_iters, jmc.max_depth)
    assert mc.n_chunks == len(np.asarray(jctab))
    if scene["name"] == "slice":
        assert mc.n_chunks >= 4 and mc.stack_k > 0
    for i, s in enumerate(jmc.spheres):  # (minv, nrm, center, radius, mat)
        np.testing.assert_array_equal(
            mc.spheres[i].numpy(),
            np.float32(list(s[0]) + list(s[1]) + list(s[2]) + [s[3], s[4]]))
    for i, m in enumerate(jmc.materials):
        row = [m[0], *m[1], *m[2], *m[3], *m[4], m[5], m[6], m[7], *m[8], *m[9]]
        np.testing.assert_array_equal(mc.materials[i].numpy(), np.float32(row))
    np.testing.assert_array_equal(
        mc.point_lights.numpy(),
        np.float32([list(p) + list(i) for p, i in jmc.point_lights]).reshape(-1, 6))
    assert (mc.ambient, mc.bg) == (jmc.ambient, jmc.bg)
    assert mc.eps == pytest.approx(jmc.eps, rel=0, abs=0)


def test_mega_trace_ref_matches_jax_kernel(scene):
    mc, tab, ctab = scene["tabs"]
    got = mk.mega_trace_ref(mc, tab, ctab, torch.as_tensor(scene["o"]),
                            torch.as_tensor(scene["d"])).numpy()
    diff = np.abs(got - scene["want"])
    assert np.isfinite(got).all()
    assert np.mean(diff) < 0.01
    assert np.quantile(diff, 0.999) < 0.5


def test_mega_trace_on_cpu_is_the_plain_version(scene):
    mc, tab, ctab = scene["tabs"]
    o, d = torch.as_tensor(scene["o"][:64]), torch.as_tensor(scene["d"][:64])
    before = dict(mk.LAUNCHES)
    got = mk.mega_trace(mc, tab, ctab, o, d)
    assert mk.LAUNCHES == before  # no kernel launch on the CPU
    torch.testing.assert_close(got, mk.mega_trace_ref(mc, tab, ctab, o, d),
                               rtol=0, atol=0)


def test_mega_eligible_accepts_the_slice(scene):
    assert mk.mega_eligible(scene["static"], scene["opts"])
    assert mk.mega_missing(scene["static"], scene["opts"]) == []


@pytest.mark.parametrize("name", ["feat_pt.xml", "feat_pt_rr.xml",
                                  "feat_pt_spec.xml"])
def test_mega_eligible_accepts_path_tracing(name):
    cfg = load_scene(str(REPO / "scenes" / name))
    pack = pack_scene(cfg, device="cpu")
    opts = options_for_camera(cfg, cfg.cameras[0])
    assert opts.path_tracing and opts.next_event_estimation
    assert mk.mega_missing(pack.static, opts) == []
    mc = mk.build_mega(pack, opts, device="cpu")[0]
    assert mc.kernel == "mega_pt" and mc.n_draws == 6


def test_mega_eligible_accepts_spot_area_and_env_lights(tmp_path):
    """Spot and area lights are inside the envelope since K1c, and an
    environment light since K1d: the scene with both routes to the K1d
    variant and renders on the CPU; a second environment light puts it
    outside, and only for that: it renders through the wavefront, with no
    K1 launch."""
    cfg = load_scene(str(REPO / "scenes" / "feat_spotareaml.xml"))
    pack = pack_scene(cfg, device="cpu")
    opts = options_for_camera(cfg, cfg.cameras[0])
    assert pack.static.n_spot and pack.static.n_area
    assert mk.mega_missing(pack.static, opts) == []
    assert mk.mega_eligible(pack.static, opts)
    img = tmp_path / "sky.png"
    Image.fromarray(np.full((4, 8, 3), 200, np.uint8)).save(img)
    env = ("<SphericalDirectionalLight id=\"{}\"><ImageId>1</ImageId>"
           "</SphericalDirectionalLight>")
    xml = (REPO / "scenes" / "feat_spotareaml.xml").read_text().replace(
        "</Lights>", env.format(1) + "</Lights>"
        f"<Textures><Images><Image id=\"1\">{img}</Image></Images></Textures>")
    xml = re.sub(r"<ImageResolution>.*?</ImageResolution>",
                 "<ImageResolution>12 9</ImageResolution>", xml)
    path = tmp_path / "env.xml"
    path.write_text(xml)
    cfg = load_scene(str(path))
    pack = pack_scene(cfg, device="cpu")
    assert mk.mega_missing(pack.static, opts, pack) == []
    assert mk.mega_eligible(pack.static, opts, pack)
    mc = mk.build_mega(pack, opts, device="cpu")[0]
    assert mc.kernel == "mega_tex" and mc.env == (8, 4, 0)
    frame = render_camera(pack, cfg, cfg.cameras[0], spp=1, device="cpu")
    assert frame.shape == (9, 12, 3) and np.isfinite(frame).all()
    path.write_text(xml.replace("</Lights>", env.format(2) + "</Lights>"))
    cfg = load_scene(str(path))
    pack = pack_scene(cfg, device="cpu")
    assert mk.mega_missing(pack.static, opts, pack) == [
        "more than one environment light"]
    assert_wavefront_frame(pack, cfg, (9, 12, 3))


def assert_wavefront_frame(pack, cfg, shape):
    """A finite 1-spp frame of a scene outside the megakernel, through the
    wavefront: neither the kernels nor their plain version run, and no
    launch is counted."""
    from advanced_cpu_raytracing_tpu_torch.render import renderer

    before = dict(mk.LAUNCHES)

    def no_megakernel(*args, **kw):
        raise AssertionError("the megakernel ran on a scene outside it")

    mega_trace = renderer.mega_trace
    renderer.mega_trace = no_megakernel
    try:
        frame = render_camera(pack, cfg, cfg.cameras[0], spp=1, device="cpu")
    finally:
        renderer.mega_trace = mega_trace
    assert mk.LAUNCHES == before
    assert frame.shape == shape and np.isfinite(frame).all()
    assert frame.max() > 0


def test_mega_eligible_rejects_textures(tmp_path):
    """Image and Perlin textures route to the K1d variant since K1d; once a
    pluggable BRDF shades the same scene it is outside, naming that, and
    renders through the wavefront."""
    img = tmp_path / "checker.png"
    Image.fromarray(np.kron(np.eye(2, dtype=np.uint8) * 255, np.ones(
        (4, 4), np.uint8))[..., None].repeat(3, -1)).save(img)
    xml = tmp_path / "tex.xml"
    xml.write_text(textured_xml(str(img), tex_ids="1 2", res=8))
    cfg = load_scene(str(xml))
    pack = pack_scene(cfg, device="cpu")
    opts = options_for_camera(cfg, cfg.cameras[0])
    assert mk.mega_missing(pack.static, opts, pack) == []
    assert mk.build_mega(pack, opts, device="cpu")[0].kernel == "mega_tex"
    frame = render_camera(pack, cfg, cfg.cameras[0], spp=1, device="cpu")
    assert frame.shape == (8, 8, 3) and np.isfinite(frame).all()
    xml.write_text(xml.read_text().replace(
        '<Material id="1">', '<Material id="1" BRDF="1">').replace(
        "<Materials>", "<BRDFs><OriginalPhong id=\"1\"><Exponent>20"
        "</Exponent></OriginalPhong></BRDFs><Materials>"))
    cfg = load_scene(str(xml))
    pack = pack_scene(cfg, device="cpu")
    missing = mk.mega_missing(pack.static, opts, pack)
    assert len(missing) == 1 and "pluggable BRDF" in missing[0]
    assert "textures together with" in missing[0]
    assert_wavefront_frame(pack, cfg, (8, 8, 3))


def test_scene_without_materials_renders_with_the_default_row(tmp_path):
    """The pack keeps one default material row when a scene defines none;
    the kernel's table must hold it too, since faces index it."""
    xml = re.sub(r"<Materials>.*?</Materials>", "",
                 (REPO / "scenes" / "feat_pt.xml").read_text(), flags=re.S)
    xml = re.sub(r"<Renderer>.*?</RendererParams>", "", xml, flags=re.S)
    xml = re.sub(r"<LightMesh.*?</LightMesh>", "", xml, flags=re.S)
    xml = re.sub(r"<Material>\d+</Material>", "<Material>1</Material>", xml)
    xml = xml.replace("<Lights></Lights>", "<Lights><AmbientLight>5 5 5"
                      "</AmbientLight></Lights>")
    path = tmp_path / "nomat.xml"
    path.write_text(xml.replace("800 800", "8 8"))
    cfg = load_scene(str(path))
    pack = pack_scene(cfg, device="cpu")
    mc = mk.build_mega(pack, options_for_camera(cfg, cfg.cameras[0]),
                       device="cpu")[0]
    assert cfg.materials == [] and mc.materials.shape == (1, mk.MAT_COLS)
    img = render_camera(pack, cfg, cfg.cameras[0], device="cpu", spp=1)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()


def test_plain_version_divides_once():
    """``_div`` rounds a quotient once, as the kernels' IEEE division does
    (a float32 quotient rounded from float64 is the correctly rounded one);
    torch's number over a tensor is the tensor's reciprocal times the
    number, which rounds twice."""
    x = torch.as_tensor(np.random.default_rng(3).uniform(0.01, 10.0, 4096)
                        .astype(np.float32))
    want = (7.0 / x.double()).float()
    assert torch.equal(mk._div(7.0, x), want)
    assert not torch.equal(7.0 / x, want)
    eps = float(np.float32(1e-3))
    assert torch.equal(mk._div(x, 1e-3), (x.double() / eps).float())


def test_chunk_cull_keeps_a_box_whose_face_plane_the_ray_runs_in(tmp_path):
    """A ray along -z in the plane y = -10 of chunk 0's box (the room's
    floor) reaches the back wall's bottom edge at t = 35.  The culled sweep
    must test chunk 0: ``_slab_enter`` (the plain version's count of the
    kernels' ``slab``, csrc/mega_common.cuh) takes a NaN plane as not
    limiting the ray, as the tree's ``slab_entry`` does, where the JAX
    package's ``chunk_sweep`` (megakernel.py:1454-1480) drops the box."""
    cfg = load_scene(coarse_slice_scene(tmp_path))
    pack = pack_scene(cfg, device="cpu")
    mc, tab, ctab = mk.build_mega(pack, options_for_camera(cfg, cfg.cameras[0]),
                                  device="cpu")
    box = ctab[0].tolist()
    assert box[1] == -10.0
    o = torch.tensor([[3.3, -10.0, 25.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    iv = 1.0 / d
    assert bool(mk._slab_enter(box, o[:, 0], o[:, 1], o[:, 2], *iv.T,
                               torch.tensor([mk.BIG])))
    # a box the ray runs beside, not in: still culled
    far = [box[0], box[1] - 5.0, box[2], box[3], box[1] - 1.0, box[5]]
    assert not bool(mk._slab_enter(far, o[:, 0], o[:, 1], o[:, 2], *iv.T,
                                   torch.tensor([mk.BIG])))
    stats = {}
    t, *_, hit, win = mk._Geometry(mc, tab, ctab, stats).trace(
        *o.T, *d.T, want_win=True)
    assert bool(hit) and float(t) == 35.0 and int(win) >= 0
    # the count includes every face of chunk 0, the box the ray runs in
    assert stats["tri_tests"] >= mk.CHUNK
