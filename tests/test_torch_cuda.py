"""The port's CUDA kernels on the card (marker ``cuda``; skipped without a
CUDA card, since a CUDA kernel has no CPU mode).  Run them on the card with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
-m cuda``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu_torch.ops import megakernel as mk
from advanced_cpu_raytracing_tpu_torch.ops.rng import philox_table
from advanced_cpu_raytracing_tpu_torch.render.camera import build_camera, generate_rays
from advanced_cpu_raytracing_tpu_torch.render.renderer import (
    ldr_from_radiance,
    options_for_camera,
    render_camera,
)
from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import (
    K1D_SAMPLED,
    k1d_scenes,
    path_traced,
)
from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.synth import terrain_scene
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from test_torch_common import (
    COARSE_TORUS,
    REPO,
    coarse_slice_scene,
    k1c_scenes,
    lights_brdf_scene,
    ply_bytes,
    pt_scene,
    torus_mesh,
)

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
    before = mk.LAUNCHES["mega_whitted"]
    got = mk.mega_trace(mc, tab, ctab, o.contiguous(), d.contiguous())
    torch.cuda.synchronize()
    assert mk.LAUNCHES["mega_whitted"] == before + 1
    ref = mk.mega_trace_ref(mc, tab, ctab, o.contiguous(), d.contiguous())
    diff = (got - ref).abs().cpu().numpy()
    assert np.mean(diff) < 0.01 and np.quantile(diff, 0.999) < 0.5


def test_render_camera_launches_once_per_sample(cuda, tmp_path):
    cfg, pack = _scene(tmp_path, cuda)
    jitter = torch.rand((4, 48 * 48, 2), generator=torch.Generator().manual_seed(3))
    before = mk.LAUNCHES["mega_whitted"]
    got = render_camera(pack, cfg, cfg.cameras[0], spp=4, device=cuda,
                        jitter=jitter)
    assert mk.LAUNCHES["mega_whitted"] == before + 4
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


def test_scene_outside_envelope_raises_on_cuda(cuda, tmp_path):
    """A textured scene renders through K1d on the card; with a pluggable
    BRDF added it is outside the envelope, naming that, and renders through
    the wavefront: K3 launches, no K1 kernel does, and the frame is the
    CPU's."""
    from advanced_cpu_raytracing_tpu_torch.ops import tri_intersect as k3
    from PIL import Image
    from scene_builders import textured_xml

    Image.fromarray(np.kron(np.eye(2, dtype=np.uint8) * 255, np.ones(
        (4, 4), np.uint8))[..., None].repeat(3, -1)).save(tmp_path / "checker.png")
    path = tmp_path / "tex.xml"
    path.write_text(textured_xml(str(tmp_path / "checker.png"), tex_ids="1 2",
                                 res=16))
    cfg = load_scene(str(path))
    before = dict(mk.LAUNCHES)
    img = render_camera(pack_scene(cfg, device=cuda), cfg, cfg.cameras[0],
                        spp=1, device=cuda)
    assert mk.LAUNCHES["mega_tex"] == before["mega_tex"] + 1
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    path.write_text(path.read_text().replace(
        '<Material id="1">', '<Material id="1" BRDF="1">').replace(
        "<Materials>", "<BRDFs><OriginalPhong id=\"1\"><Exponent>20"
        "</Exponent></OriginalPhong></BRDFs><Materials>"))
    cfg = load_scene(str(path))
    pack = pack_scene(cfg, device=cuda)
    missing = mk.mega_missing(pack.static, options_for_camera(
        cfg, cfg.cameras[0]), pack)
    assert len(missing) == 1 and "textures together with" in missing[0]
    before, k3_before = dict(mk.LAUNCHES), k3.LAUNCHES["tri_intersect"]
    img = render_camera(pack, cfg, cfg.cameras[0], spp=1, device=cuda)
    assert mk.LAUNCHES == before
    assert k3.LAUNCHES["tri_intersect"] > k3_before
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    ref = render_camera(pack_scene(cfg, device="cpu"), cfg, cfg.cameras[0],
                        spp=1, device="cpu")
    np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("name", ["feat_pt.xml", "feat_pt_spec.xml"])
@pytest.mark.parametrize("mode", ["table", "philox"])
def test_pt_kernel_matches_plain_version(cuda, tmp_path, name, mode):
    """K1b against its plain version on the same draws: at most a few rays
    in a thousand may differ by a path flipped by a last-ulp difference."""
    cfg = load_scene(pt_scene(tmp_path, name=name))
    pack = pack_scene(cfg, device=cuda)
    mc, tab, ctab = mk.build_mega(pack, options_for_camera(cfg, cfg.cameras[0]),
                                  device=cuda)
    cam = build_camera(cfg.cameras[0], device=cuda)
    rng = np.random.default_rng(2)
    n = 4096
    px = torch.as_tensor(rng.uniform(0, 800, n).astype(np.float32), device=cuda)
    py = torch.as_tensor(rng.uniform(0, 800, n).astype(np.float32), device=cuda)
    o, d = (t.contiguous() for t in generate_rays(cam, px, py))
    rows = mc.max_iters * mc.n_draws
    draws = (torch.rand((rows, n), generator=torch.Generator(device=cuda)
                        .manual_seed(4), device=cuda) if mode == "table" else None)
    before = dict(mk.LAUNCHES)
    got = mk.mega_trace(mc, tab, ctab, o, d, draws=draws, seed=5, sample=2)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["mega_pt"] == before["mega_pt"] + 1
    if draws is None:
        draws = philox_table(5, 2, n, mc.max_iters, mc.n_draws, device=cuda)
    ref = mk.mega_trace_ref(mc, tab, ctab, o, d, draws=draws)
    diff = (got - ref).abs()
    assert torch.isfinite(got).all()
    assert (diff <= 1e-3 + 1e-3 * ref.abs()).all(dim=1).float().mean() >= 0.995
    assert abs(float(got.mean()) - float(ref.mean())) <= 0.01 * float(ref.mean())


def test_pt_render_camera_launches_once_per_sample(cuda, tmp_path):
    """A 48 px path-traced box on the card draws the numbers its CPU frame
    draws (Philox keyed by seed and sample), so the frames agree."""
    cfg = load_scene(pt_scene(tmp_path, res=48))
    jitter = torch.rand((4, 48 * 48, 2), generator=torch.Generator().manual_seed(3))
    before = dict(mk.LAUNCHES)
    got = render_camera(pack_scene(cfg, device=cuda), cfg, cfg.cameras[0],
                        seed=7, spp=4, device=cuda, jitter=jitter)
    assert mk.LAUNCHES["mega_pt"] == before["mega_pt"] + 4
    assert mk.LAUNCHES["mega_whitted"] == before["mega_whitted"]
    want = render_camera(pack_scene(cfg, device="cpu"), cfg, cfg.cameras[0],
                         seed=7, spp=4, device="cpu", jitter=jitter)
    du8 = np.abs(ldr_from_radiance(got).astype(int)
                 - ldr_from_radiance(want).astype(int))
    assert (du8.max(axis=-1) > 1).mean() <= 0.01


@pytest.mark.parametrize("name", ["spot_dir", "brdf_zoo", "area_demo",
                                  "motion_rough", "spotareaml",
                                  "spotareaml_pt_rough_glass"])
@pytest.mark.parametrize("mode", ["table", "philox"])
def test_ext_kernel_matches_plain_version(cuda, tmp_path, name, mode):
    """K1c against its plain version on the same draws (none in the
    deterministic scenes): at most a few rays in a thousand may differ by a
    sampled path flipped by a last-ulp difference."""
    path = tmp_path / f"{name}.xml"
    path.write_text(k1c_scenes()[name])
    cfg = load_scene(str(path))
    pack = pack_scene(cfg, device=cuda)
    mc, tab, ctab = mk.build_mega(pack, options_for_camera(cfg, cfg.cameras[0]),
                                  device=cuda)
    assert mc.kernel == "mega_ext"
    cam = build_camera(cfg.cameras[0], device=cuda)
    rng = np.random.default_rng(3)
    n = 4096
    w, h = cfg.cameras[0].width, cfg.cameras[0].height
    px = torch.as_tensor(rng.uniform(0, w, n).astype(np.float32), device=cuda)
    py = torch.as_tensor(rng.uniform(0, h, n).astype(np.float32), device=cuda)
    o, d = (t.contiguous() for t in generate_rays(cam, px, py))
    rows = mc.max_iters * mc.n_draws
    draws = (torch.rand((rows, n), generator=torch.Generator(device=cuda)
                        .manual_seed(4), device=cuda)
             if mode == "table" and rows else None)
    before = dict(mk.LAUNCHES)
    got = mk.mega_trace(mc, tab, ctab, o, d, draws=draws, seed=5, sample=2)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["mega_ext"] == before["mega_ext"] + 1
    if draws is None and rows:
        draws = philox_table(5, 2, n, mc.max_iters, mc.n_draws, device=cuda)
    ref = mk.mega_trace_ref(mc, tab, ctab, o, d, draws=draws)
    diff = (got - ref).abs()
    assert torch.isfinite(got).all()
    assert (diff <= 1e-3 + 1e-3 * ref.abs()).all(dim=1).float().mean() >= 0.995
    assert abs(float(got.mean()) - float(ref.mean())) <= 1e-3 * float(ref.mean())


@pytest.mark.parametrize("pt", [False, True])
def test_ext_render_camera_launches_once_per_sample(cuda, tmp_path, pt):
    """feat_lights_brdf.xml (coarse torus, 48 px, DoF) on the card: K1c
    launches once per sample and no other variant, and the frame is finite
    (its lens draws come from the card's generator, so no CPU frame draws
    the same rays)."""
    path = lights_brdf_scene(tmp_path)
    if pt:
        xml = path_traced(open(path).read())
        open(path, "w").write(xml)
    cfg = load_scene(path)
    jitter = torch.rand((4, 48 * 48, 2), generator=torch.Generator().manual_seed(3))
    before = dict(mk.LAUNCHES)
    got = render_camera(pack_scene(cfg, device=cuda), cfg, cfg.cameras[0],
                        seed=7, spp=4, device=cuda, jitter=jitter)
    after = dict(mk.LAUNCHES)
    assert after["mega_ext"] == before["mega_ext"] + 4
    assert (after["mega_pt"], after["mega_whitted"]) == (
        before["mega_pt"], before["mega_whitted"])
    assert np.isfinite(got).all()


@pytest.mark.parametrize("name,mode", [("six_textures", "philox"),
                                       ("env_rough", "table"),
                                       ("spotareaml_env_pt_rough_glass",
                                        "philox")])
def test_tex_kernel_matches_plain_version(cuda, tmp_path, name, mode):
    """K1d against its plain version on the same draws: scenes without
    draws to K1a's bound, the others to K1c's."""
    path = tmp_path / f"{name}.xml"
    path.write_text(k1d_scenes(tmp_path, REPO / "scenes")[name])
    cfg = load_scene(str(path))
    pack = pack_scene(cfg, device=cuda)
    mc, tab, ctab = mk.build_mega(pack, options_for_camera(cfg, cfg.cameras[0]),
                                  device=cuda)
    assert mc.kernel == "mega_tex" and (mc.n_draws > 0) == (name in K1D_SAMPLED)
    cam = build_camera(cfg.cameras[0], device=cuda)
    rng = np.random.default_rng(6)
    n = 4096
    w, h = cfg.cameras[0].width, cfg.cameras[0].height
    px = torch.as_tensor(rng.uniform(0, w, n).astype(np.float32), device=cuda)
    py = torch.as_tensor(rng.uniform(0, h, n).astype(np.float32), device=cuda)
    o, d = (t.contiguous() for t in generate_rays(cam, px, py))
    rows = mc.max_iters * mc.n_draws
    draws = (torch.rand((rows, n), generator=torch.Generator(device=cuda)
                        .manual_seed(4), device=cuda)
             if mode == "table" and rows else None)
    before = dict(mk.LAUNCHES)
    got = mk.mega_trace(mc, tab, ctab, o, d, draws=draws, seed=5, sample=2)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["mega_tex"] == before["mega_tex"] + 1
    if draws is None and rows:
        draws = philox_table(5, 2, n, mc.max_iters, mc.n_draws, device=cuda)
    ref = mk.mega_trace_ref(mc, tab, ctab, o, d, draws=draws)
    diff = (got - ref).abs()
    assert torch.isfinite(got).all()
    if rows:
        assert (diff <= 1e-3 + 1e-3 * ref.abs()).all(dim=1).float().mean() >= 0.995
        assert abs(float(got.mean()) - float(ref.mean())) <= 1e-3 * float(ref.mean())
    else:
        assert float(diff.mean()) < 0.01
        assert float(torch.quantile(diff.flatten(), 0.999)) < 0.5


def test_tex_render_camera_launches_once_per_sample(cuda, tmp_path):
    """feat_textures.xml (coarse torus, 48 px) on the card: K1d launches
    once per sample and no other variant, and the frame agrees with the
    CPU frame of the same jitter and Philox draws."""
    xml = (REPO / "scenes" / "feat_textures.xml").read_text().replace(
        "800 800", "48 48")
    path = tmp_path / "feat_textures.xml"
    path.write_text(xml)
    (tmp_path / "whitted_conductors_mesh.ply").write_bytes(
        ply_bytes(*torus_mesh(**COARSE_TORUS)))
    (tmp_path / "textures").symlink_to(REPO / "scenes" / "textures")
    cfg = load_scene(str(path))
    jitter = torch.rand((4, 48 * 48, 2), generator=torch.Generator().manual_seed(3))
    before = dict(mk.LAUNCHES)
    got = render_camera(pack_scene(cfg, device=cuda), cfg, cfg.cameras[0],
                        seed=7, spp=4, device=cuda, jitter=jitter)
    after = dict(mk.LAUNCHES)
    assert after["mega_tex"] == before["mega_tex"] + 4
    assert all(after[k] == before[k] for k in ("mega_whitted", "mega_pt",
                                                "mega_ext"))
    want = render_camera(pack_scene(cfg, device="cpu"), cfg, cfg.cameras[0],
                         seed=7, spp=4, device="cpu", jitter=jitter)
    du8 = np.abs(ldr_from_radiance(got).astype(int)
                 - ldr_from_radiance(want).astype(int))
    assert np.isfinite(got).all() and (du8.max(axis=-1) > 1).mean() <= 0.01


@pytest.mark.parametrize("textured", [False, True], ids=["plain", "textured"])
def test_tree_kernel_matches_plain_version(cuda, monkeypatch, textured):
    """K1e: the 8,192-face terrain past a lowered threshold walks the tree;
    at pixel centres (ties on the grid's shared edges) the tree
    instantiation agrees with the plain version's brute force."""
    monkeypatch.setattr(mk, "FLAT_MAX_FACES", 4096)
    cfg = terrain_scene(n=65, width=64, height=48, textured=textured)
    pack = pack_scene(cfg, device=cuda)
    mc, tab, ctab = mk.build_mega(pack, options_for_camera(cfg, cfg.cameras[0]),
                                  device=cuda)
    key = "mega_tex_tree" if textured else "mega_whitted_tree"
    assert mc.variant == key
    cam = build_camera(cfg.cameras[0], device=cuda)
    idx = torch.arange(64 * 48, device=cuda)
    o, d = (t.contiguous() for t in generate_rays(
        cam, (idx % 64).float() + 0.5, (idx // 64).float() + 0.5))
    before = dict(mk.LAUNCHES)
    got = mk.mega_trace(mc, tab, ctab, o, d)
    torch.cuda.synchronize()
    after = dict(mk.LAUNCHES)
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == key) for k in after}
    ref = mk.mega_trace_ref(mc, tab, ctab, o, d)
    diff = (got - ref).abs()
    assert torch.isfinite(got).all()
    assert float(diff.mean()) < 0.01
    assert float(torch.quantile(diff.flatten(), 0.999)) < 0.5


def test_tree_render_camera_launches_once_per_sample(cuda, monkeypatch):
    """K1e through render_camera: the tree instantiation launches once per
    sample and nothing else; the frame agrees with the CPU frame."""
    monkeypatch.setattr(mk, "FLAT_MAX_FACES", 0)
    cfg = terrain_scene(n=33, width=48, height=32, textured=True)
    jitter = torch.rand((4, 48 * 32, 2), generator=torch.Generator().manual_seed(3))
    before = dict(mk.LAUNCHES)
    got = render_camera(pack_scene(cfg, device=cuda), cfg, cfg.cameras[0],
                        seed=7, spp=4, device=cuda, jitter=jitter)
    after = dict(mk.LAUNCHES)
    assert {k: after[k] - before[k] for k in after} == {
        k: 4 * int(k == "mega_tex_tree") for k in after}
    want = render_camera(pack_scene(cfg, device="cpu"), cfg, cfg.cameras[0],
                         seed=7, spp=4, device="cpu", jitter=jitter)
    du8 = np.abs(ldr_from_radiance(got).astype(int)
                 - ldr_from_radiance(want).astype(int))
    assert np.isfinite(got).all() and (du8.max(axis=-1) > 1).mean() <= 0.01


def _diff_scene(tmp_path, dev, glass=True):
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb
    from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import (
        gauge_scene_xml,
    )

    cfg = load_scene(gauge_scene_xml(tmp_path, REPO / "scenes", coarse=True,
                                     glass=glass))
    pack = pack_scene(cfg, device=dev)
    opts = options_for_camera(cfg, cfg.cameras[0])
    f = mb.make_diff_render(pack, opts, device=dev)
    cam = build_camera(cfg.cameras[0], device=dev)
    rng = np.random.default_rng(4)
    px = torch.as_tensor(rng.uniform(0, 800, 2048).astype(np.float32), device=dev)
    py = torch.as_tensor(rng.uniform(0, 800, 2048).astype(np.float32), device=dev)
    o, d = generate_rays(cam, px, py)
    return cfg, pack, opts, f, cam, o.contiguous(), d.contiguous(), px, py


@pytest.mark.parametrize("mode", ["table", "philox"])
@pytest.mark.parametrize("tree", [False, True], ids=["chunks", "tree"])
def test_bwd_kernel_matches_plain_version(cuda, tmp_path, monkeypatch, mode,
                                          tree):
    """K2a's primal and fwd+bwd against the plain version and autograd on
    the coarse gauge scene (depth 6, a dielectric): radiance to K1a's
    bound, every cotangent within rtol 1e-3, atol 1e-4 max|ref| (atomic
    sums, and a hand-derived adjoint)."""
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb

    if tree:
        monkeypatch.setattr(mk, "FLAT_MAX_FACES", 0)
    _, _, _, f, _, o, d, _, _ = _diff_scene(tmp_path, cuda)
    bc = f.bc
    assert bc.variant == ("mega_bwd_tree" if tree else "mega_bwd")
    tabs = mb.BwdTables(*(t.detach().contiguous() for t in f.tables({})))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    gbar = torch.randn(o.shape, generator=gen, device=cuda)
    depth = mb.bc_depth(bc)
    draws = (torch.rand((depth, o.shape[0]), generator=gen, device=cuda)
             if mode == "table" else None)
    before = dict(mb.LAUNCHES)
    prim = mb.mega_bwd_trace(bc, tabs, o, d, draws, seed=3, step=1)
    got, g = mb.mega_bwd_trace(bc, tabs, o, d, draws, seed=3, step=1, gbar=gbar)
    torch.cuda.synchronize()
    assert mb.LAUNCHES[bc.variant] == before[bc.variant] + 1
    primal = bc.variant.replace("mega_bwd", "mega_bwd_primal")
    assert mb.LAUNCHES[primal] == before[primal] + 1
    if draws is None:
        draws = mb.ud_table(3, 1, o.shape[0], depth, device=cuda)
    ref, gref = mb.mega_bwd_trace_ref(bc, tabs, o, d, draws, gbar)
    for out in (prim, got):
        diff = (out - ref).abs().cpu().numpy()
        assert np.mean(diff) < 0.01 and np.quantile(diff, 0.999) < 0.5
    for k in gref._fields:
        a, b = getattr(gref, k), getattr(g, k)
        assert bool(torch.isfinite(b).all()), k
        if a.numel():
            torch.testing.assert_close(b, a, rtol=1e-3,
                                       atol=1e-4 * float(a.abs().max()))


def test_optimize_goes_through_the_bwd_kernel(cuda, tmp_path):
    """Three Adam steps on the card: one primal and one fwd+bwd launch per
    step, no K1 launch, a falling loss, and the loss history of the plain
    version on the CPU within rtol 1e-3."""
    from advanced_cpu_raytracing_tpu_torch.diff.optimize import optimize
    from advanced_cpu_raytracing_tpu_torch.diff.params import inject_params
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb

    cfg, pack, opts, f, cam, o, d, px, py = _diff_scene(tmp_path, cuda,
                                                        glass=False)
    with torch.no_grad():
        target = f({}, o, d)
    start = {"mat_diffuse": pack.mat_diffuse * 0.8}
    before = dict(mb.LAUNCHES), dict(mk.LAUNCHES)
    _, hist = optimize(inject_params(pack, start), cam, px, py, opts, target,
                       ("mat_diffuse",), steps=3, device=cuda)
    assert mb.LAUNCHES["mega_bwd_primal"] == before[0]["mega_bwd_primal"] + 3
    assert mb.LAUNCHES["mega_bwd"] == before[0]["mega_bwd"] + 3
    assert dict(mk.LAUNCHES) == before[1]
    assert hist[-1] < hist[0]
    cpu_pack = pack_scene(cfg, device="cpu")
    _, hist_cpu = optimize(inject_params(cpu_pack, {
        "mat_diffuse": cpu_pack.mat_diffuse * 0.8}),
        build_camera(cfg.cameras[0], device="cpu"), px.cpu(), py.cpu(), opts,
        target.cpu(), ("mat_diffuse",), steps=3, device="cpu")
    np.testing.assert_allclose(hist, hist_cpu, rtol=1e-3)


K2B_SCENES = ("feat_pt", "feat_pt_rr", "feat_pt_spec", "feat_spotareaml")


def _k2b_scene(dev, name, n=2048):
    """A K2b scene of scenes/ on the card: its differentiable render, the
    pack, options and camera, and n random primary rays."""
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb

    cfg = load_scene(str(REPO / "scenes" / f"{name}.xml"))
    pack = pack_scene(cfg, device=dev)
    opts = options_for_camera(cfg, cfg.cameras[0])
    f = mb.make_diff_render(pack, opts, device=dev)
    cam = build_camera(cfg.cameras[0], device=dev)
    rng = np.random.default_rng(6)
    px = torch.as_tensor(rng.uniform(0, cfg.cameras[0].width, n).astype(
        np.float32), device=dev)
    py = torch.as_tensor(rng.uniform(0, cfg.cameras[0].height, n).astype(
        np.float32), device=dev)
    o, d = generate_rays(cam, px, py)
    return cfg, pack, opts, f, cam, o.contiguous(), d.contiguous(), px, py


@pytest.mark.parametrize("mode", ["table", "philox"])
@pytest.mark.parametrize("name", K2B_SCENES)
def test_k2b_kernel_matches_plain_version(cuda, name, mode):
    """K2b's primal and fwd+bwd against the plain version and autograd on
    the path-traced scenes (NEE, Russian roulette, the specular mixtures)
    and the Whitted spot + area + mesh-light scene, with table draws from
    a torch.Generator and with Philox against its twin ``bwd_draws``:
    radiance to K1a's bound, every cotangent within rtol 1e-3, atol 1e-4
    max|ref|."""
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb

    _, _, _, f, _, o, d, _, _ = _k2b_scene(cuda, name)
    bc = f.bc
    assert bc.k2b and bc.variant == "mega_bwd_pt"
    tabs = mb.BwdTables(*(t.detach().contiguous() for t in f.tables({})))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    gbar = torch.randn(o.shape, generator=gen, device=cuda)
    draws = (mb.table_draws(bc, o.shape[0], gen, cuda) if mode == "table"
             else None)
    before = dict(mb.LAUNCHES)
    prim = mb.mega_bwd_trace(bc, tabs, o, d, draws, seed=3, step=1)
    got, g = mb.mega_bwd_trace(bc, tabs, o, d, draws, seed=3, step=1, gbar=gbar)
    torch.cuda.synchronize()
    assert {k: mb.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k in ("mega_bwd_pt", "mega_bwd_primal_pt")) for k in before}
    if draws is None:
        draws = mb.bwd_draws(bc, 3, 1, o.shape[0], device=cuda)
    ref, gref = mb.mega_bwd_trace_ref(bc, tabs, o, d, draws, gbar)
    for out in (prim, got):
        diff = (out - ref).abs().cpu().numpy()
        assert np.mean(diff) < 0.01 and np.quantile(diff, 0.999) < 0.5
    for k in gref._fields:
        a, b = getattr(gref, k), getattr(g, k)
        assert bool(torch.isfinite(b).all()), k
        if a.numel():
            torch.testing.assert_close(b, a, rtol=1e-3,
                                       atol=1e-4 * float(a.abs().max()))


def test_optimize_goes_through_the_k2b_kernel(cuda):
    """Three Adam steps on scenes/feat_pt.xml on the card: one K2b primal
    and one K2b fwd+bwd launch per step, nothing else, and a falling
    loss."""
    from advanced_cpu_raytracing_tpu_torch.diff.optimize import optimize
    from advanced_cpu_raytracing_tpu_torch.diff.params import inject_params
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb

    _, pack, opts, f, cam, o, d, px, py = _k2b_scene(cuda, "feat_pt", 4096)
    with torch.no_grad():
        target = f({}, o, d)
    start = {"mat_diffuse": pack.mat_diffuse * 0.8,
             "ml_radiance": pack.ml_radiance * 1.3}
    before = dict(mb.LAUNCHES), dict(mk.LAUNCHES)
    _, hist = optimize(inject_params(pack, start), cam, px, py, opts, target,
                       tuple(start), steps=3,
                       lr={"mat_diffuse": 5e-2, "ml_radiance": 0.5},
                       device=cuda)
    assert {k: mb.LAUNCHES[k] - before[0][k] for k in before[0]} == {
        k: 3 * int(k in ("mega_bwd_pt", "mega_bwd_primal_pt"))
        for k in before[0]}
    assert dict(mk.LAUNCHES) == before[1]
    assert all(np.isfinite(hist)) and hist[-1] < hist[0]


def _k2c_scene(dev, tmp_path, name, n=2048):
    """A K2c scene on the card: ``two`` (the JAX texture-gradient test's
    nearest replace_kd floor, bilinear blend_kd wall and mirror sphere;
    Whitted) or ``pt`` (scenes/feat_pt.xml with a bilinear replace_kd floor;
    path tracing), its differentiable render and n random primary rays."""
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb
    from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import (
        tex_bwd_scene_xml,
        textured_pt_scene_xml,
    )

    path = (tex_bwd_scene_xml(tmp_path) if name == "two"
            else textured_pt_scene_xml(REPO / "scenes", tmp_path))
    cfg = load_scene(path)
    pack = pack_scene(cfg, device=dev)
    opts = options_for_camera(cfg, cfg.cameras[0])
    f = mb.make_diff_render(pack, opts, device=dev)
    cam = build_camera(cfg.cameras[0], device=dev)
    rng = np.random.default_rng(8)
    px = torch.as_tensor(rng.uniform(0, cfg.cameras[0].width, n).astype(
        np.float32), device=dev)
    py = torch.as_tensor(rng.uniform(0, cfg.cameras[0].height, n).astype(
        np.float32), device=dev)
    o, d = generate_rays(cam, px, py)
    return pack, opts, f, cam, o.contiguous(), d.contiguous(), px, py


@pytest.mark.parametrize("tree", [False, True], ids=["chunks", "tree"])
@pytest.mark.parametrize("name", ["two", "pt"])
def test_k2c_kernel_matches_plain_version(cuda, tmp_path, monkeypatch, name,
                                          tree):
    """K2c's primal and fwd+bwd (the Whitted and the path-traced texture
    twins, over the chunks and the tree) against the plain version and
    autograd: radiance to K1a's bound, every cotangent, the texel pool's
    included, within rtol 1e-3, atol 1e-4 max|ref|."""
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb

    if tree:
        monkeypatch.setattr(mk, "FLAT_MAX_FACES", 0)
    _, _, f, _, o, d, _, _ = _k2c_scene(cuda, tmp_path, name)
    bc = f.bc
    assert bc.variant == ("mega_bwd" + ("_pt" if name == "pt" else "")
                          + "_tex" + ("_tree" if tree else ""))
    tabs = mb.BwdTables(*(t.detach().contiguous() for t in f.tables({})))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    gbar = torch.randn(o.shape, generator=gen, device=cuda)
    draws = mb.table_draws(bc, o.shape[0], gen, cuda) if bc.pt else None
    before = dict(mb.LAUNCHES)
    prim = mb.mega_bwd_trace(bc, tabs, o, d, draws, seed=3, step=1)
    got, g = mb.mega_bwd_trace(bc, tabs, o, d, draws, seed=3, step=1, gbar=gbar)
    torch.cuda.synchronize()
    primal = bc.variant.replace("mega_bwd", "mega_bwd_primal")
    assert {k: mb.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k in (bc.variant, primal)) for k in before}
    ref, gref = mb.mega_bwd_trace_ref(bc, tabs, o, d, draws, gbar)
    for out in (prim, got):
        diff = (out - ref).abs().cpu().numpy()
        assert np.mean(diff) < 0.01 and np.quantile(diff, 0.999) < 0.5
    assert float(gref.texels.abs().sum()) > 0
    for k in gref._fields:
        a, b = getattr(gref, k), getattr(g, k)
        assert bool(torch.isfinite(b).all()), k
        if a.numel():
            torch.testing.assert_close(b, a, rtol=1e-3,
                                       atol=1e-4 * float(a.abs().max()))


def test_optimize_recovers_a_texture_through_the_k2c_kernel(cuda, tmp_path):
    """Three Adam steps over img_atlas on the two-texture scene on the
    card: one K2c primal and one K2c fwd+bwd launch per step, nothing else,
    a falling loss, and the loss history of the plain version on the CPU
    within rtol 1e-3."""
    from advanced_cpu_raytracing_tpu_torch.diff.optimize import optimize
    from advanced_cpu_raytracing_tpu_torch.diff.params import inject_params
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb

    pack, opts, f, cam, o, d, px, py = _k2c_scene(cuda, tmp_path, "two", 4096)
    with torch.no_grad():
        target = f({}, o, d)
    start = {"img_atlas": torch.full_like(pack.img_atlas, 128.0)}
    before = dict(mb.LAUNCHES), dict(mk.LAUNCHES)
    _, hist = optimize(inject_params(pack, start), cam, px, py, opts, target,
                       ("img_atlas",), steps=3, lr=4.0, device=cuda)
    assert {k: mb.LAUNCHES[k] - before[0][k] for k in before[0]} == {
        k: 3 * int(k in ("mega_bwd_tex", "mega_bwd_primal_tex"))
        for k in before[0]}
    assert dict(mk.LAUNCHES) == before[1]
    assert all(np.isfinite(hist)) and hist[-1] < hist[0]
    cpu_pack = pack_scene(load_scene(str(tmp_path / "texbwd.xml")),
                          device="cpu")
    _, hist_cpu = optimize(
        inject_params(cpu_pack, {"img_atlas": start["img_atlas"].cpu()}),
        build_camera(load_scene(str(tmp_path / "texbwd.xml")).cameras[0],
                     device="cpu"), px.cpu(), py.cpu(), opts, target.cpu(),
        ("img_atlas",), steps=3, lr=4.0, device="cpu")
    np.testing.assert_allclose(hist, hist_cpu, rtol=1e-3)


# ---- K3, the dense closest hit of the wavefront (slice D1) ----


def _k3_table(w, seed, dev):
    """Items around the origin with det = 0 rows (every 5th) and exact ties
    (every 7th a copy of item 0)."""
    g = np.random.default_rng(seed)
    v0 = g.uniform(-1.0, 1.0, (w, 3)).astype(np.float32)
    v1 = (v0 + g.uniform(-0.6, 0.6, (w, 3))).astype(np.float32)
    v2 = (v0 + g.uniform(-0.6, 0.6, (w, 3))).astype(np.float32)
    v1[4::5] = v0[4::5]
    for v in (v0, v1, v2):
        v[6::7] = v[0]
    return [torch.tensor(x, device=dev) for x in (v0, v1, v2)]


@pytest.mark.parametrize("w", [1, 12, 300, 2048])
@pytest.mark.parametrize("motion", [False, True])
def test_k3_kernel_matches_plain_version(cuda, w, motion):
    """Bit for bit: the same arithmetic in the same order, IEEE division,
    no FMA contraction."""
    from advanced_cpu_raytracing_tpu_torch.ops import tri_intersect as k3

    v0, v1, v2 = _k3_table(w, w, cuda)
    g = np.random.default_rng(w)
    n = 20000
    o = torch.tensor(g.uniform(-0.3, 0.3, (n, 3)).astype(np.float32) + np.float32(
        [0, 0, 3]), device=cuda)
    k = torch.as_tensor(g.integers(0, w, n), device=cuda)
    d = (v0[k] + 0.3 * (v1[k] - v0[k]) + 0.3 * (v2[k] - v0[k]) - o).contiguous()
    mo = {}
    if motion:
        mo = dict(motion=torch.tensor(g.normal(0, 0.2, (w, 3)).astype(np.float32),
                                      device=cuda),
                  time=torch.rand(n, device=cuda))
    before = k3.LAUNCHES["tri_intersect"]
    got = k3.tri_closest_hit(o, d, v0, v1, v2, **mo)
    ref = k3.tri_closest_hit_ref(o, d, v0, v1, v2, **mo)
    assert k3.LAUNCHES["tri_intersect"] == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert (got[1] >= 0).float().mean() > 0.2 or w == 1


def test_optimize_goes_through_k3(cuda, tmp_path):
    """The wavefront fallback of ``optimize`` on the main path's scene
    (coarse torus, 4,096 rays, 2 steps): K3 launches, no K1 or K2 kernel
    does, and the loss history is the CPU's."""
    import dataclasses

    from advanced_cpu_raytracing_tpu_torch.diff.optimize import optimize
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb
    from advanced_cpu_raytracing_tpu_torch.ops import tri_intersect as k3
    from advanced_cpu_raytracing_tpu_torch.scene import feature_scenes as fs

    path = fs.pt_env_dof_scene_xml(REPO / "scenes", tmp_path,
                                   torus=fs.PT_ENV_COARSE_TORUS)
    cfg = load_scene(path)
    opts = dataclasses.replace(options_for_camera(cfg, cfg.cameras[0]),
                               max_iters=6)
    g = np.random.default_rng(3)
    px = g.uniform(0, 800, 4096).astype(np.float32)
    py = g.uniform(0, 800, 4096).astype(np.float32)
    target = g.uniform(0, 300, (4096, 3)).astype(np.float32)
    hist = {}
    for dev in (cuda, torch.device("cpu")):
        pack = pack_scene(cfg, device=dev)
        before = (dict(mk.LAUNCHES), dict(mb.LAUNCHES),
                  k3.LAUNCHES["tri_intersect"])
        _, hist[dev.type] = optimize(
            pack, build_camera(cfg.cameras[0], device=dev), px, py, opts,
            target, ("mat_diffuse", "ml_radiance"), steps=2, lr=1e-2,
            device=dev)
        assert mk.LAUNCHES == before[0] and mb.LAUNCHES == before[1]
        launched = k3.LAUNCHES["tri_intersect"] - before[2]
        assert launched > 0 if dev.type == "cuda" else launched == 0
    np.testing.assert_allclose(hist["cuda"], hist["cpu"], rtol=1e-3)


# ---- K4, the big-texture gather probe's gather-sum (slice E1) ----


@pytest.mark.parametrize("taps,spread,n_rows,blocks",
                         [(1, 4, 512, 64), (4, 16, 8192, 512), (4, 256, 8192, 7)])
def test_k4_kernel_matches_plain_version(cuda, taps, spread, n_rows, blocks):
    """Bit for bit: the same sums in the same tap order; lanes with an
    index outside the table NaN in both."""
    from advanced_cpu_raytracing_tpu_torch.ops import bigtex_gather as k4
    from advanced_cpu_raytracing_tpu_torch.tools.probe_bigtex import make_inputs

    idx, tab = make_inputs(n_rows, taps, spread, blocks, seed=taps, device=cuda)
    n = tab.numel()
    edge = idx.reshape(taps, -1)
    edge[:, :4] = torch.tensor([0, n - 1, -1, n], dtype=torch.int32,
                               device=cuda)[None]
    before = k4.LAUNCHES["bigtex_gather"]
    got = k4.gather_sum(idx, tab)
    ref = k4.gather_sum_ref(idx, tab)
    assert k4.LAUNCHES["bigtex_gather"] == before + 1
    assert got.shape == (blocks, 8, 128)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    ok = ~torch.isnan(ref)
    assert torch.equal(got[ok], ref[ok])
    assert int(torch.isnan(ref).sum()) == 2
    with pytest.raises(ValueError, match="int32"):
        k4.gather_sum(idx.long(), tab)


def test_probe_goes_through_k4(cuda):
    from advanced_cpu_raytracing_tpu_torch.ops import bigtex_gather as k4
    from advanced_cpu_raytracing_tpu_torch.tools import probe_bigtex

    before = k4.LAUNCHES["bigtex_gather"]
    res = probe_bigtex.run(n_rows=512, taps=2, spread=8, blocks=16, iters=3,
                           device=cuda, log=lambda s: None)
    assert k4.LAUNCHES["bigtex_gather"] == before + 1 + 1 + 3
    assert res["err"] == 0.0 and res["device"].startswith("cuda")
