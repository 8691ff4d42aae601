"""The port's CUDA kernels on the card (marker ``cuda``; skipped without a
CUDA card, since a CUDA kernel has no CPU mode).  Run them on the card with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
-m cuda``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu_torch.ops import megakernel as mk
from advanced_cpu_raytracing_tpu_torch.ops import rng
from advanced_cpu_raytracing_tpu_torch.ops.rng import philox_table
from advanced_cpu_raytracing_tpu_torch.render.camera import build_camera, generate_rays
from advanced_cpu_raytracing_tpu_torch.render.renderer import (
    ldr_from_radiance,
    options_for_camera,
    render_camera,
)
from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import (
    ENV_ALIGNED_LIGHTS,
    K1D_SAMPLED,
    env_aligned_xml,
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
    """The coarse slice (768 faces, past one chunk) through render_camera:
    the tree instantiation of K1a launches once per sample, nothing else."""
    cfg, pack = _scene(tmp_path, cuda)
    jitter = torch.rand((4, 48 * 48, 2), generator=torch.Generator().manual_seed(3))
    before = dict(mk.LAUNCHES)
    got = render_camera(pack, cfg, cfg.cameras[0], spp=4, device=cuda,
                        jitter=jitter)
    assert {k: mk.LAUNCHES[k] - before[k] for k in before} == {
        k: 4 * int(k == "mega_whitted_tree") for k in before}
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
    """feat_lights_brdf.xml (coarse torus, 48 px, DoF) on the card: K1c's
    tree instantiation (768 faces, past one chunk) launches once per sample
    and no other variant, and the frame is finite
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
    assert {k: after[k] - before[k] for k in before} == {
        k: 4 * int(k == "mega_ext_tree") for k in before}
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


@pytest.mark.parametrize("align", sorted(ENV_ALIGNED_LIGHTS))
@pytest.mark.parametrize("mode", ["philox", "exhausted"])
def test_tex_kernel_env_draws_at_every_alignment(cuda, tmp_path, align, mode):
    """K1d against its plain version on the env scene whose candidates'
    draws start at word ``align`` of a Philox block (the kernel's cursor
    serves them across block edges at every offset), on 65,536 camera rays:
    in Philox mode, where a lit node exhausts its 16 candidates about
    0.74^16 of the time, and in table mode with every candidate at (-1,
    -1, -1), outside the ball, so every lit node falls back to its normal."""
    k1d_scenes(tmp_path)  # the env map
    path = tmp_path / f"env_aligned{align}.xml"
    path.write_text(env_aligned_xml(align))
    cfg = load_scene(str(path))
    pack = pack_scene(cfg, device=cuda)
    mc, tab, ctab = mk.build_mega(pack, options_for_camera(cfg, cfg.cameras[0]),
                                  device=cuda)
    n_ml, n_area = ENV_ALIGNED_LIGHTS[align]
    base_env = 3 + 3 * n_ml + 2 * n_area
    assert mc.kernel == "mega_tex" and base_env % 4 == align
    cam = build_camera(cfg.cameras[0], device=cuda)
    rng = np.random.default_rng(8 + align)
    n = 65536
    w, h = cfg.cameras[0].width, cfg.cameras[0].height
    px = torch.as_tensor(rng.uniform(0, w, n).astype(np.float32), device=cuda)
    py = torch.as_tensor(rng.uniform(0, h, n).astype(np.float32), device=cuda)
    o, d = (t.contiguous() for t in generate_rays(cam, px, py))
    draws = None
    if mode == "exhausted":
        draws = torch.rand((mc.max_iters * mc.n_draws, n), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(9))
        for it in range(mc.max_iters):
            row = it * mc.n_draws + base_env
            draws[row:row + mk.ENV_DRAWS] = 0.0
    before = dict(mk.LAUNCHES)
    got = mk.mega_trace(mc, tab, ctab, o, d, draws=draws, seed=3, sample=align)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["mega_tex"] == before["mega_tex"] + 1
    if draws is None:
        draws = philox_table(3, align, n, mc.max_iters, mc.n_draws, device=cuda)
    stats: dict = {}
    ref = mk.mega_trace_ref(mc, tab, ctab, o, d, draws=draws, stats=stats)
    diff = (got - ref).abs()
    assert torch.isfinite(got).all()
    assert (diff <= 1e-3 + 1e-3 * ref.abs()).all(dim=1).float().mean() >= 0.995
    assert abs(float(got.mean()) - float(ref.mean())) <= 1e-3 * float(ref.mean())
    if mode == "exhausted":
        assert stats["env_exhausted"] * 16 == stats["env_candidates"] > 0
    else:
        assert stats["env_exhausted"] >= 100


def test_tex_render_camera_launches_once_per_sample(cuda, tmp_path):
    """feat_textures.xml (coarse torus, 48 px) on the card: K1d's tree
    instantiation (past one chunk) launches once per sample and no other
    variant, and the frame agrees with the
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
    assert {k: after[k] - before[k] for k in before} == {
        k: 4 * int(k == "mega_tex_tree") for k in before}
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
    monkeypatch.setattr(mk, "FWD_FLAT_MAX_FACES", 0)
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


def _k2a_check(bc, tabs, o, d, draws, gbar, moved_rows=None):
    """K2a's primal and its primal with records + reverse kernel against
    the plain version and autograd: radiance to K1a's bound, every
    cotangent within rtol 1e-3, atol 1e-4 max|ref| (atomic sums, and a
    hand-derived adjoint); exactly the primal twice, the reverse kernel
    once and, where the kernels read boxes, the refit twice.  With
    ``moved_rows``, some rays' closest hits are on those rows (moved
    faces) in both."""
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb

    before = dict(mb.LAUNCHES)
    prim = mb.mega_bwd_trace(bc, tabs, o, d, draws, seed=3, step=1)
    got, g = mb.mega_bwd_trace(bc, tabs, o, d, draws, seed=3, step=1, gbar=gbar)
    torch.cuda.synchronize()
    refits = 2 * int(mb.boxes_read(bc))
    assert {k: mb.LAUNCHES[k] - before[k] for k in before} == {
        k: {bc.primal_kernel: 2, "mega_bwd_rev": 1,
            "mega_bwd_refit": refits}.get(k, 0) for k in before}
    if draws is None:
        draws = mb.ud_table(3, 1, o.shape[0], mb.bc_depth(bc), device=o.device)
    ref, gref = mb.mega_bwd_trace_ref(bc, tabs, o, d, draws, gbar)
    assert torch.equal(prim, got)  # the same primal launch
    diff = (prim - ref).abs().cpu().numpy()
    assert np.mean(diff) < 0.01 and np.quantile(diff, 0.999) < 0.5
    for k in gref._fields:
        a, b = getattr(gref, k), getattr(g, k)
        assert bool(torch.isfinite(b).all()), k
        if a.numel():
            torch.testing.assert_close(b, a, rtol=1e-3,
                                       atol=1e-4 * float(a.abs().max()))
    if moved_rows is not None:
        tri = torch.cat([tabs.tri_w, bc.tri_rest], 1)
        geo = mk._Geometry(bc.mc, tri, bc.chunk_tab, None)
        win = geo.trace(*o.T, *d.T, want_win=True)[-1]
        on = torch.isin(win, moved_rows)
        assert int(on.sum()) > 0
        assert float((g.tri_w[moved_rows].abs().sum())) > 0
    return prim, g


@pytest.mark.parametrize("mode", ["table", "philox"])
@pytest.mark.parametrize("tree", [False, True], ids=["chunks", "tree"])
def test_bwd_kernel_matches_plain_version(cuda, tmp_path, monkeypatch, mode,
                                          tree):
    """K2a's primal and its reverse kernel on the primal's records against
    the plain version and autograd on the coarse gauge scene (depth 6, a
    dielectric: its split takes the branch draws), over the tree (the
    route past one chunk) and over the chunks (the threshold raised)."""
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb

    if not tree:
        monkeypatch.setattr(mk, "FWD_FLAT_MAX_FACES", mk.FLAT_MAX_FACES)
    _, _, _, f, _, o, d, _, _ = _diff_scene(tmp_path, cuda)
    bc = f.bc
    assert bc.has_dielectric
    assert bc.variant == ("mega_bwd_tree" if tree else "mega_bwd")
    tabs = mb.BwdTables(*(t.detach().contiguous() for t in f.tables({})))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    gbar = torch.randn(o.shape, generator=gen, device=cuda)
    depth = mb.bc_depth(bc)
    draws = (torch.rand((depth, o.shape[0]), generator=gen, device=cuda)
             if mode == "table" else None)
    _k2a_check(bc, tabs, o, d, draws, gbar)


@pytest.mark.parametrize("tree", [False, True], ids=["chunks", "tree"])
def test_bwd_kernel_hits_moved_faces(cuda, tmp_path, monkeypatch, tree):
    """Vertices moved by a seeded offset (rows out of their built leaf and
    chunk boxes): the refit kernel equals refit_ref bit for bit, and the
    primal and reverse kernel still hit the moved faces and match the
    plain version, Philox draws on the dielectric's split."""
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb

    if not tree:
        monkeypatch.setattr(mk, "FWD_FLAT_MAX_FACES", mk.FLAT_MAX_FACES)
    _, pack, _, f, _, o, d, _, _ = _diff_scene(tmp_path, cuda)
    bc = f.bc
    rng = np.random.default_rng(9)
    verts = pack.verts + torch.as_tensor(rng.normal(
        0.0, 0.15, tuple(pack.verts.shape)).astype(np.float32), device=cuda)
    tabs = mb.BwdTables(*(t.detach().contiguous()
                          for t in f.tables({"verts": verts})))
    nodes, chunk = mb.refit(bc, tabs.tri_w)
    want_nodes, want_chunk = mb.refit_ref(bc, tabs.tri_w)
    assert torch.equal(chunk.view(torch.int32), want_chunk.view(torch.int32))
    if tree:
        assert torch.equal(nodes.view(torch.int32),
                           want_nodes.view(torch.int32))
        built = bc.mc.tree[:, :24]
    else:
        assert nodes is None
        built = bc.chunk_tab
    assert not torch.equal(built, (nodes if tree else chunk)[:, :built.shape[1]])
    # the rows that left their built boxes
    rows = tabs.tri_w.reshape(-1, 3, 3)
    w = bc.mc.n_tri
    if tree:
        moved = torch.zeros(w, dtype=torch.bool, device=cuda)
        wd = mk.TREE_WIDTH
        code = bc.mc.tree.view(torch.int32)[:, 6 * wd:7 * wd]
        for n, k in (code < 0).nonzero().tolist():
            c = int(code[n, k])
            first, count = (~c) >> 5, (~c) & 31
            box = bc.mc.tree[n, :6 * wd].reshape(6, wd)[:, k]
            r = rows[first:first + count].reshape(-1, 3)
            moved[first:first + count] |= bool(((r < box[0:3])
                                                | (r > box[3:6])).any())
    else:
        ci = torch.arange(w, device=cuda) // mk.CHUNK
        box = bc.chunk_tab[ci]
        moved = ((rows < box[:, None, 0:3]) | (rows > box[:, None, 3:6])
                 ).flatten(1).any(1)
    moved_rows = moved.nonzero().squeeze(1)
    assert moved_rows.numel() > 0
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    gbar = torch.randn(o.shape, generator=gen, device=cuda)
    _k2a_check(bc, tabs, o, d, None, gbar, moved_rows)


def test_refit_kernel_matches_refit_ref(cuda, tmp_path, monkeypatch):
    """The refit kernel bit for bit against refit_ref: the gauge scene's
    32,768-face tree, the coarse gauge over its 7 chunks, and feat_pt.xml's
    one chunk, at the built vertices (the built boxes) and moved ones."""
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb
    from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import (
        gauge_scene_xml,
    )

    paths = [gauge_scene_xml(tmp_path / "full", REPO / "scenes"),
             gauge_scene_xml(tmp_path / "coarse", REPO / "scenes", coarse=True),
             str(REPO / "scenes" / "feat_pt.xml")]
    rng = np.random.default_rng(1)
    for i, path in enumerate(paths):
        if i == 1:
            monkeypatch.setattr(mk, "FWD_FLAT_MAX_FACES", mk.FLAT_MAX_FACES)
        cfg = load_scene(path)
        pack = pack_scene(cfg, device=cuda)
        bc = mb.build_bwd_consts(pack, options_for_camera(cfg, cfg.cameras[0]),
                                 device=cuda)
        assert (bc.mc.tree is not None) == (i == 0)
        for scale in (0.0, 0.2):
            verts = pack.verts + torch.as_tensor(rng.normal(
                0.0, scale, tuple(pack.verts.shape)).astype(np.float32),
                device=cuda)
            tri_w = mb.world_vertices(bc, verts).contiguous()
            before = mb.LAUNCHES["mega_bwd_refit"]
            got = mb.refit(bc, tri_w)
            torch.cuda.synchronize()
            assert mb.LAUNCHES["mega_bwd_refit"] == before + 1
            want = mb.refit_ref(bc, tri_w)
            for a, b in zip(got, want):
                assert (a is None) == (b is None)
                if a is not None:
                    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
            if scale == 0.0 and i == 0:
                assert torch.equal(got[0].view(torch.int32),
                                   bc.mc.tree.view(torch.int32))


def test_k2a_records_are_required(cuda, tmp_path):
    """No fallback: K2a's reverse kernel without the primal's records, or
    with records of the wrong shape, raises and launches nothing; so does
    the primal given a mis-shaped buffer."""
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb

    _, _, _, f, _, o, d, _, _ = _diff_scene(tmp_path, cuda)
    bc = f.bc
    tabs = mb.BwdTables(*(t.detach().contiguous() for t in f.tables({})))
    run = mb._Launch(bc, tabs, o, d, None, 0, 0)
    gbar = torch.ones_like(o)
    rec = run.new_records()
    run.primal(rec)
    before = dict(mb.LAUNCHES)
    with pytest.raises(ValueError, match="records"):
        run.backward(gbar, ("mat",), None)
    with pytest.raises(ValueError, match="records"):
        run.backward(gbar, ("mat",), rec[:-1].contiguous())
    with pytest.raises(ValueError, match="records"):
        run.primal(torch.empty((3, o.shape[0]), device=cuda))
    assert dict(mb.LAUNCHES) == before
    _, g = run.backward(gbar, ("mat",), rec)
    assert float(g.mat.abs().sum()) > 0


def test_k2a_backward_runs_twice_on_a_retained_graph(cuda, tmp_path):
    """The primal's records and boxes are saved for the backward: with the
    graph retained, autograd.grad twice and then backward each run the
    reverse kernel on the same records, with one primal and one refit, and
    agree within rtol 1e-3, atol 1e-4 max|first|; after that backward
    autograd has freed them, and a further one raises."""
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb

    _, pack, _, f, _, o, d, _, _ = _diff_scene(tmp_path, cuda)
    assert f.bc.variant == "mega_bwd_tree"
    params = {"mat_diffuse": pack.mat_diffuse.clone().requires_grad_(True),
              "verts": pack.verts.clone().requires_grad_(True)}
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    gbar = torch.randn(o.shape, generator=gen, device=cuda)
    before = dict(mb.LAUNCHES)
    loss = (f(params, o, d) * gbar).sum()
    leaves = list(params.values())
    first = torch.autograd.grad(loss, leaves, retain_graph=True)
    again = torch.autograd.grad(loss, leaves, retain_graph=True)
    loss.backward()
    torch.cuda.synchronize()
    assert {k: mb.LAUNCHES[k] - before[k] for k in before} == {
        k: {"mega_bwd_primal_tree": 1, "mega_bwd_refit": 1,
            "mega_bwd_rev": 3}.get(k, 0) for k in before}
    for a, b, c in zip(first, again, (p.grad for p in leaves)):
        assert float(a.abs().max()) > 0
        for x in (b, c):
            torch.testing.assert_close(x, a, rtol=1e-3,
                                       atol=1e-4 * float(a.abs().max()))
    with pytest.raises(RuntimeError, match="second time"):
        loss.backward()


def test_optimize_goes_through_the_bwd_kernel(cuda, tmp_path):
    """Three Adam steps on the card over the coarse gauge's tree: per step
    one refit, one tree primal (writing its records) and one reverse
    kernel, no other launch, a falling loss, and the loss history of the
    plain version on the CPU within rtol 1e-3."""
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
    assert {k: mb.LAUNCHES[k] - before[0][k] for k in before[0]} == {
        k: 3 * int(k in ("mega_bwd_refit", "mega_bwd_primal_tree",
                         "mega_bwd_rev")) for k in before[0]}
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
        monkeypatch.setattr(mk, "FWD_FLAT_MAX_FACES", 0)
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
    assert {k: mb.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k in (bc.backward_kernel, bc.primal_kernel))
        + 2 * int(tree and k == "mega_bwd_refit") for k in before}
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


def _quad_case(dev, tmp_path, n_tex=64, image=None, n=4096):
    """The inverse-texture quad (a 64x64 texture, or ``image``) on the
    card: its differentiable render, tables, n random primary rays and a
    random radiance cotangent."""
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb
    from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import (
        texture_inverse_scene_xml,
    )

    cfg = load_scene(texture_inverse_scene_xml(n_tex, image=image,
                                               out_dir=tmp_path))
    pack = pack_scene(cfg, device=dev)
    f = mb.make_diff_render(pack, options_for_camera(cfg, cfg.cameras[0]),
                            device=dev)
    rng = np.random.default_rng(5)
    px, py = (torch.as_tensor(rng.uniform(0, 800, n).astype(np.float32),
                              device=dev) for _ in range(2))
    o, d = generate_rays(build_camera(cfg.cameras[0], device=dev), px, py)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    gbar = torch.randn(o.shape, generator=gen, device=dev)
    tabs = mb.BwdTables(*(t.detach().contiguous() for t in f.tables({})))
    return f, pack, tabs, o.contiguous(), d.contiguous(), gbar


def _assert_grads_close(g, gref, fields):
    for k in fields:
        a, b = getattr(gref, k), getattr(g, k)
        assert bool(torch.isfinite(b).all()), k
        if a.numel():
            torch.testing.assert_close(b, a, rtol=1e-3,
                                       atol=1e-4 * float(a.abs().max()))


@pytest.mark.parametrize("pool,rows_shared", [("64x64", True),
                                              ("64x64", False),
                                              ("1024x1024", True)])
def test_k2c_fwd_bwd_matches_plain_on_both_scatter_paths(
        cuda, tmp_path, monkeypatch, pool, rows_shared):
    """K2c's fwd+bwd on the inverse-texture quad, its texel pool (64x64,
    and floor_tiles.png's 1,048,576 texels) summed by warp straight into
    global memory, its rows' sums in each block's shared memory (the
    default) or summed by warp into global memory: every cotangent against
    autograd within rtol 1e-3 and atol 1e-4 max|ref|."""
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb

    image = REPO / "scenes" / "textures" / "floor_tiles.png" if (
        pool == "1024x1024") else None
    if not rows_shared:
        monkeypatch.setattr(mb, "TRI_SHARED_MAX_ROWS", 0)
    f, _, tabs, o, d, gbar = _quad_case(cuda, tmp_path, image=image)
    bc = f.bc
    assert bool(mb.scatter_flags(bc, True) & mb.FLAG_TRI_SHARED) == rows_shared
    _, g = mb.mega_bwd_trace(bc, tabs, o, d, gbar=gbar)
    _, gref = mb.mega_bwd_trace_ref(bc, tabs, o, d, gbar=gbar)
    assert float(gref.texels.abs().sum()) > 0
    _assert_grads_close(g, gref, gref._fields)


def test_k2c_fwd_bwd_keeps_two_filters_on_one_image_apart(cuda, tmp_path):
    """Two textures over one image of the pool, nearest on one half of
    the floor and bilinear on the other (``shared_image_scene_xml``): a
    warp's lanes that read the same first texel through different filters
    add different taps, and every cotangent, the pool's included, agrees
    with autograd within rtol 1e-3 and atol 1e-4 max|ref|."""
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb
    from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import (
        shared_image_scene_xml,
    )

    cfg = load_scene(shared_image_scene_xml(out_dir=tmp_path))
    pack = pack_scene(cfg, device=cuda)
    f = mb.make_diff_render(pack, options_for_camera(cfg, cfg.cameras[0]),
                            device=cuda)
    assert len(f.bc.mc.tex_images) == 1
    rng = np.random.default_rng(9)
    px, py = (torch.as_tensor(rng.uniform(0, 800, 8192).astype(np.float32),
                              device=cuda) for _ in range(2))
    o, d = generate_rays(build_camera(cfg.cameras[0], device=cuda), px, py)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    gbar = torch.randn(o.shape, generator=gen, device=cuda)
    tabs = mb.BwdTables(*(t.detach().contiguous() for t in f.tables({})))
    o, d = o.contiguous(), d.contiguous()
    _, g = mb.mega_bwd_trace(f.bc, tabs, o, d, gbar=gbar)
    _, gref = mb.mega_bwd_trace_ref(f.bc, tabs, o, d, gbar=gbar)
    assert float(gref.texels.abs().sum()) > 0
    _assert_grads_close(g, gref, gref._fields)


def _feat_pt_case(dev, n=4096):
    """scenes/feat_pt.xml (K2b: path tracing under a mesh light) on the
    card: its render, tables, n random primary rays, a random radiance
    cotangent and Philox's draws."""
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb

    cfg = load_scene(str(REPO / "scenes" / "feat_pt.xml"))
    pack = pack_scene(cfg, device=dev)
    f = mb.make_diff_render(pack, options_for_camera(cfg, cfg.cameras[0]),
                            device=dev)
    rng = np.random.default_rng(6)
    px, py = (torch.as_tensor(rng.uniform(0, 800, n).astype(np.float32),
                              device=dev) for _ in range(2))
    o, d = generate_rays(build_camera(cfg.cameras[0], device=dev), px, py)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    gbar = torch.randn(o.shape, generator=gen, device=dev)
    tabs = mb.BwdTables(*(t.detach().contiguous() for t in f.tables({})))
    return (f, tabs, o.contiguous(), d.contiguous(), gbar,
            mb.bwd_draws(f.bc, 0, 0, n, device=dev))


@pytest.mark.parametrize("scene", ["quad", "feat_pt.xml"])
def test_unasked_cotangents_stay_zero_and_asked_ones_do_not_move(
        cuda, tmp_path, scene):
    """Each target alone, and a pair: the targets not asked for stay
    exactly 0, the asked ones agree with the call that asks for every
    target (itself held to autograd) within the cotangents' tolerance."""
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb

    if scene == "quad":
        f, _, tabs, o, d, gbar = _quad_case(cuda, tmp_path)
        draws = None
    else:
        f, tabs, o, d, gbar, draws = _feat_pt_case(cuda)
    bc = f.bc
    _, full = mb.mega_bwd_trace(bc, tabs, o, d, draws, gbar=gbar)
    _, gref = mb.mega_bwd_trace_ref(bc, tabs, o, d, draws, gbar)
    _assert_grads_close(full, gref, gref._fields)
    present = [k for k in mb.SCATTER_FLAGS if getattr(tabs, k).numel()]
    for targets in [[k] for k in present] + [present[:2]]:
        _, g = mb.mega_bwd_trace(bc, tabs, o, d, draws, gbar=gbar,
                                 scatter=targets)
        for k in mb.SCATTER_FLAGS:
            if k not in targets:
                assert not bool(getattr(g, k).any()), (targets, k)
        _assert_grads_close(g, full, targets + ["o", "d"])


def test_render_backward_scatters_only_what_needs_a_gradient(cuda, tmp_path,
                                                             monkeypatch):
    """Autograd through make_diff_render on the card with only img_atlas
    requiring grad: one fwd+bwd launch, asked for the texels alone; its
    other table cotangents exactly 0; the atlas's gradient the plain
    version's texel cotangent."""
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb

    f, pack, tabs, o, d, gbar = _quad_case(cuda, tmp_path, n_tex=16)
    seen = []
    backward = mb._Launch.backward

    def spy(self, gbar_, targets, rec=None):
        res = backward(self, gbar_, targets, rec)
        seen.append((targets, res[1]))
        return res

    monkeypatch.setattr(mb._Launch, "backward", spy)
    before = mb.LAUNCHES["mega_bwd_tex"]
    atlas = pack.img_atlas.detach().clone().requires_grad_(True)
    img = f({"img_atlas": atlas}, o, d)
    (img * gbar).sum().backward()
    assert mb.LAUNCHES["mega_bwd_tex"] == before + 1
    assert len(seen) == 1 and list(seen[0][0]) == ["texels"]
    for k in mb.SCATTER_FLAGS:
        if k != "texels":
            assert not bool(getattr(seen[0][1], k).any()), k
    _, gref = mb.mega_bwd_trace_ref(f.bc, tabs, o, d, gbar=gbar)
    (img_i, h, w), = f.bc.mc.tex_images
    got = atlas.grad[img_i, :h, :w].reshape(-1, 3)
    assert float(gref.texels.abs().sum()) > 0
    torch.testing.assert_close(got, gref.texels, rtol=1e-3,
                               atol=1e-4 * float(gref.texels.abs().max()))


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


@pytest.mark.parametrize("n", [1, 4097, 20003])
@pytest.mark.parametrize("table", ["vertices and edges", "ties at t_best",
                                   "scaled", "near-degenerate", "motion"])
def test_k3_is_exact_at_the_edges_of_its_rejection(cuda, table, n):
    """Bit for bit on ops/tri_intersect.py::edge_tables: quotients within
    rounding of 0 and of beta + gamma = 1, items at exactly the best t,
    determinants outside the rejection's trusted range, denormal
    numerators and quotients that underflow to -0, det = 0, with and
    without motion, at ray counts that are no multiple of the rays a
    block takes."""
    from advanced_cpu_raytracing_tpu_torch.ops import tri_intersect as k3

    tab = k3.edge_tables(n, seed=n, device=cuda)[table]
    got = k3.tri_closest_hit(*tab)
    ref = k3.tri_closest_hit_ref(*tab)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


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


def _k4_paths(idx, tab, window):
    """K4 against its plain version bit for bit (NaN lanes alike), one
    launch, its path counts against gather_plan_ref's; returns them."""
    from advanced_cpu_raytracing_tpu_torch.ops import bigtex_gather as k4

    paths = torch.zeros(2, dtype=torch.int32, device=idx.device)
    # freed just before the call: a lane K4 never writes keeps this value
    torch.full(idx.shape[1:], 7.0, device=idx.device)
    before = k4.LAUNCHES["bigtex_gather"]
    got = k4.gather_sum(idx, tab, window, paths)
    ref = k4.gather_sum_ref(idx, tab)
    assert k4.LAUNCHES["bigtex_gather"] == before + 1
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], ref[~nan])
    plan = k4.gather_plan_ref(idx, tab.numel(),
                              window if tab.data_ptr() % 16 == 0 else 0)
    assert paths.tolist() == list(plan["counts"])
    return paths.tolist()


@pytest.mark.parametrize("case", ["window", "direct", "mixed", "incoherent",
                                  "ordered", "ordered past the staging"])
def test_k4_window_and_direct_groups_match_plain_version(cuda, case):
    from advanced_cpu_raytracing_tpu_torch.ops import bigtex_gather as k4
    from advanced_cpu_raytracing_tpu_torch.tools.probe_bigtex import (
        FRAME,
        make_inputs,
    )

    w = k4.WINDOW_BYTES
    if case in ("window", "direct"):
        idx, tab = make_inputs(8192, 4, 16, 64, seed=1, device=cuda)
        want = [64, 0] if case == "window" else [0, 64]
        window = w if case == "window" else 0
    elif case == "mixed":
        a, tab = make_inputs(8192, 4, 16, 40, seed=2, device=cuda)
        b, _ = make_inputs(8192, 4, 256, 24, seed=3, device=cuda)
        idx = torch.cat([a, b], dim=1).contiguous()
        idx = idx[:, torch.randperm(64, device=cuda)].contiguous()
        want, window = [40, 24], w
    elif case == "incoherent":
        idx, tab = make_inputs(8192, 4, 8190, 64, seed=4, device=cuda)
        want, window = [0, 64], w
    else:  # a table past L2: the groups in window order
        blocks = 64 if case == "ordered" else 40000
        idx, tab = make_inputs(FRAME["n_rows"], 4 if blocks == 64 else 1,
                               64, blocks, seed=5, device=cuda)
        assert k4.ordered(tab)
        want, window = [blocks, 0], w
    assert _k4_paths(idx, tab, window) == want


@pytest.mark.parametrize("extra,want", [(0, [3, 1]), (16, [2, 2])])
def test_k4_spans_at_the_window_and_16_bytes_more(cuda, extra, want):
    """Group 0 spans the window or 16 bytes more, group 1 one row, group 2
    one lane 4 MB away (direct), the partial last group only NaN lanes
    (a tap outside the table, an index below 0); the table is past L2, so
    the groups run in window order."""
    from advanced_cpu_raytracing_tpu_torch.ops import bigtex_gather as k4

    g, w = k4.GROUP, k4.WINDOW_BYTES
    gen = torch.Generator(device=cuda)
    gen.manual_seed(extra)
    tab = torch.rand(16 * 2**20, generator=gen, device=cuda)
    hi = (w + extra) // 4 - 1
    idx = torch.randint(0, hi + 1, (4, 3 * g + 100), generator=gen,
                        device=cuda, dtype=torch.int32)
    idx[0, 0], idx[1, 1] = 0, hi
    idx[:, g:2 * g] = 9000 + idx[:, g:2 * g] % 128
    idx[:, 2 * g] += 2**20
    idx[:, 3 * g:] = 100 + idx[:, 3 * g:] % 512
    idx[0, 3 * g + 7] = -3
    idx[2, 3 * g:] = tab.numel() + 11
    assert _k4_paths(idx, tab, w) == want
    assert bool(torch.isnan(k4.gather_sum(idx, tab)[3 * g:]).all())


def test_k4_edge_lanes_and_refused_windows(cuda):
    """chip_smoke.py phase 31's edge lanes through the window and directly,
    a table off 16 bytes and 5 taps (direct); a window past the card's
    shared memory raises with the CUDA error, and the next call runs."""
    from advanced_cpu_raytracing_tpu_torch.ops import bigtex_gather as k4
    from advanced_cpu_raytracing_tpu_torch.tools.probe_bigtex import make_inputs

    idx, tab = make_inputs(512, 1, 4, 64, seed=31, device=cuda)
    n = tab.numel()
    edge = torch.tensor(
        [[0, n - 1, 5, 5, 3, -1, n, 2**31 - 1, -2**31, 9],
         [0, n - 1, 5, 5, 3, 4, 7, 1, 2, n + 5],
         [0, n - 1, 5, 9, 3, 4, 7, 1, 2, 0]], dtype=torch.int32, device=cuda)
    near = edge.clone()
    near[:, :5] = near[:, :5] % 64
    for window in (k4.WINDOW_BYTES, 0):
        assert _k4_paths(edge, tab, window) == [0, 1]
        assert _k4_paths(near, tab, window) == ([1, 0] if window else [0, 1])
    assert int(torch.isnan(k4.gather_sum(edge, tab)).sum()) == 5
    assert _k4_paths(idx.reshape(1, -1)[:, 1:], tab.reshape(-1)[1:],
                     k4.WINDOW_BYTES) == [0, 64]
    five = torch.randint(0, n, (5, 3000), device=cuda, dtype=torch.int32)
    assert _k4_paths(five, tab, k4.WINDOW_BYTES) == [0, 3]
    with pytest.raises(RuntimeError, match="CUDA error"):
        k4.gather_sum(idx, tab, 256 * 1024)
    assert _k4_paths(idx, tab, k4.WINDOW_BYTES) == [64, 0]


def test_probe_goes_through_k4(cuda):
    from advanced_cpu_raytracing_tpu_torch.ops import bigtex_gather as k4
    from advanced_cpu_raytracing_tpu_torch.tools import probe_bigtex

    before = k4.LAUNCHES["bigtex_gather"]
    res = probe_bigtex.run(n_rows=512, taps=2, spread=8, blocks=16, iters=3,
                           device=cuda, log=lambda s: None)
    assert k4.LAUNCHES["bigtex_gather"] == before + 1 + 1 + 3
    assert res["err"] == 0.0 and res["device"].startswith("cuda")


# the draw kernel's cases: the key's words at their edges, a tile's first
# ray past 0, the per-ray iteration -1 and a loop iteration, a site of a
# light past 0, and r off the kernel's 256 threads
DRAW_KEYS = [(0, 0), (7, 1), (2**31 + 3, 2**32 + 5)]
DRAW_SITES = [(-1, rng.SITE_JITTER, 0), (3, rng.SITE_AREA, 2)]
DRAW_RANGES = [(0.0, 1.0), (-1.0, 1.0), (-0.5, 0.5)]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 48])
def test_philox_draws_kernel_matches_the_twin(cuda, n):
    """One launch a call, the CPU twin's uniforms moved to the card bit for
    bit."""
    for (seed, sample), ray0, (it, site, light), (lo, hi) in (
            (k, r0, st, rg) for k in DRAW_KEYS for r0 in (0, 70_001)
            for st in DRAW_SITES for rg in DRAW_RANGES):
        d = rng.PhiloxDraws(seed, sample, ray0, device=cuda)
        before = rng.LAUNCHES["philox_draws"]
        got = d.uniform(it, site, 1_000, n, light=light, lo=lo, hi=hi)
        assert rng.LAUNCHES["philox_draws"] == before + 1
        want = d.to("cpu").uniform(it, site, 1_000, n, light=light, lo=lo,
                                   hi=hi)
        assert got.is_cuda and got.shape == (1_000, n)
        assert torch.equal(got, want.to(cuda)), (seed, sample, ray0, it, site,
                                                 lo, hi)


def test_philox_draws_kernel_randint_known_answer_and_refusals(cuda):
    d = rng.PhiloxDraws(2**31 + 9, 2**32, ray0=12, device=cuda)
    before = rng.LAUNCHES["philox_draws"]
    got = d.randint(1, rng.SITE_ML_FACE, 777, 13, light=1)
    assert rng.LAUNCHES["philox_draws"] == before + 1
    assert torch.equal(got, d.to("cpu").randint(1, rng.SITE_ML_FACE, 777, 13,
                                                light=1).to(cuda))
    # counter (0, 0, 0, 0), key (0, 0): Random123's first known answer
    words = torch.tensor([0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8])
    u = rng.PhiloxDraws(device=cuda).uniform(-1, 0, 1, 4)
    assert torch.equal(u.cpu(), rng.uniform_from_bits(words)[None])
    edge = rng.PhiloxDraws(3, ray0=2**32 - 300, device=cuda)
    assert torch.equal(edge.uniform(0, rng.SITE_GI, 300, 2).cpu(),
                       edge.to("cpu").uniform(0, rng.SITE_GI, 300, 2))
    before = rng.LAUNCHES["philox_draws"]
    assert edge.uniform(0, rng.SITE_GI, 0, 2).shape == (0, 2)
    with pytest.raises(ValueError, match="32 bits"):
        edge.uniform(0, rng.SITE_GI, 301, 2)
    with pytest.raises(ValueError, match="at least 1"):
        edge.uniform(0, rng.SITE_GI, 4, 0)
    assert rng.LAUNCHES["philox_draws"] == before


def test_progressive_pass_launches_one_draw_kernel(cuda, tmp_path,
                                                   monkeypatch):
    """Pass 0 draws nothing, every later pass one launch; the sum equals,
    bit for bit, that of the same passes jittered by the CPU twin's draws
    moved to the card."""
    from advanced_cpu_raytracing_tpu_torch.render import progressive

    cfg, pack = _scene(tmp_path, cuda)
    r = progressive.ProgressiveRenderer(pack, cfg, cfg.cameras[0], seed=5,
                                        device=cuda)
    assert r._mega is not None and not r.cam.use_dof
    per_pass = []
    for _ in range(3):
        before = rng.LAUNCHES["philox_draws"]
        r.step()
        per_pass.append(rng.LAUNCHES["philox_draws"] - before)
    assert per_pass == [0, 1, 1]

    kernel_draws = rng.PhiloxDraws

    class TwinOnCard(kernel_draws):
        def uniform(self, *args, **kwargs):
            twin = kernel_draws(self.seed, self.sample, self.ray0, "cpu")
            return twin.uniform(*args, **kwargs).to(self.device)

    monkeypatch.setattr(progressive.rng, "PhiloxDraws", TwinOnCard)
    twin = progressive.ProgressiveRenderer(pack, cfg, cfg.cameras[0], seed=5,
                                           device=cuda)
    before = rng.LAUNCHES["philox_draws"]
    for _ in range(3):
        twin.step()
    assert rng.LAUNCHES["philox_draws"] == before
    assert torch.equal(r.acc, twin.acc)
