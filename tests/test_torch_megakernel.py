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


def test_mega_eligible_rejects_spot_and_area_lights():
    cfg = load_scene(str(REPO / "scenes" / "feat_spotareaml.xml"))
    pack = pack_scene(cfg, device="cpu")
    opts = options_for_camera(cfg, cfg.cameras[0])
    missing = mk.mega_missing(pack.static, opts)
    assert "spot lights" in missing and "area lights" in missing
    assert not mk.mega_eligible(pack.static, opts)
    with pytest.raises(NotImplementedError, match="spot lights, area lights"):
        render_camera(pack, cfg, cfg.cameras[0], device="cpu")


def test_mega_eligible_rejects_textures(tmp_path):
    img = tmp_path / "checker.png"
    Image.fromarray(np.kron(np.eye(2, dtype=np.uint8) * 255, np.ones(
        (4, 4), np.uint8))[..., None].repeat(3, -1)).save(img)
    xml = tmp_path / "tex.xml"
    xml.write_text(textured_xml(str(img), tex_ids="1"))
    cfg = load_scene(str(xml))
    pack = pack_scene(cfg, device="cpu")
    opts = options_for_camera(cfg, cfg.cameras[0])
    assert mk.mega_missing(pack.static, opts) == ["textures"]
    with pytest.raises(NotImplementedError, match="textures"):
        render_camera(pack, cfg, cfg.cameras[0], device="cpu")


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
