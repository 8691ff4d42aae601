"""The frozen reference against the program's plain versions at a small
size (the reference itself imports neither), its isolation, and the
roofline count's independence of the program's tree."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from bench_tiny import ROOT, run_of, tiny_scene_dir
from benchmark import harness
from benchmark.reference import diffchain, philox, whitted
from benchmark.reference import scene as ref_scene


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return tiny_scene_dir(tmp_path_factory.mktemp("scenes"))


def _port(path):
    from advanced_cpu_raytracing_tpu_torch.render import renderer
    from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene

    cfg = load_scene(str(path))
    pack = pack_scene(cfg, device="cpu")
    return cfg, pack, renderer.options_for_camera(cfg, cfg.cameras[0])


def _rays(sc, n, seed):
    g = torch.Generator().manual_seed(seed)
    w, h = sc.camera.width, sc.camera.height
    pix = torch.randint(0, w * h, (n,), generator=g)
    px = (pix % w).float() + torch.rand(n, generator=g)
    py = (pix // w).float() + torch.rand(n, generator=g)
    return px, py


@pytest.mark.parametrize("scene", ["conductors.xml", "whitted_conductors"])
def test_whitted_matches_the_plain_version(scenes, scene):
    """The reference's radiance against ``mega_trace_ref`` (the program's
    plain version, through ``mega_trace`` on the CPU), on the small torus
    and on the repo's own 32,768-face scene, on rays of the program's
    camera."""
    from advanced_cpu_raytracing_tpu_torch.ops.megakernel import mega_trace
    from advanced_cpu_raytracing_tpu_torch.render import renderer
    from advanced_cpu_raytracing_tpu_torch.render.camera import (
        build_camera,
        generate_rays,
    )

    path = (scenes / scene if scene.endswith(".xml")
            else harness.BENCH_DIR / "configs" / "conductors.xml")
    n = 256 if scene.endswith(".xml") else 48
    sc = ref_scene.load(path)
    cfg, pack, opts = _port(path)
    assert torch.equal(pack.verts, torch.as_tensor(sc.verts))
    mc, tri, ch = renderer._mega_build_cached(pack, opts, torch.device("cpu"))
    px, py = _rays(sc, n, 1)
    o, d = generate_rays(build_camera(cfg.cameras[0], device="cpu"), px, py)
    o2, d2 = whitted.camera_rays(sc, px, py)
    assert torch.equal(o, o2)
    assert torch.allclose(d, d2, rtol=0, atol=1e-7)
    want = mega_trace(mc, tri, ch, o.contiguous(), d.contiguous())
    got = whitted.radiance(whitted.tables(sc, "cpu"), o, d)
    # the same terms summed in another order
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-4)
    assert want.abs().max() > 1.0


def test_diff_chain_matches_the_plain_version(scenes):
    """The differentiable chain's radiance and gradients against
    ``diff_trace_ref`` (through ``make_diff_render`` on the CPU) with the
    vertices moved, on Philox branch draws."""
    from advanced_cpu_raytracing_tpu_torch.ops.megabwd import make_diff_render

    path = scenes / "gauge.xml"
    sc = ref_scene.load(path)
    cfg, pack, opts = _port(path)
    f = make_diff_render(pack, opts, device="cpu")
    px, py = _rays(sc, 300, 2)
    o, d = whitted.camera_rays(sc, px, py)
    g = torch.Generator().manual_seed(4)
    verts = pack.verts + 0.01 * torch.randn(pack.verts.shape, generator=g)
    p = {"mat_diffuse": pack.mat_diffuse.clone(),
         "pl_intensity": pack.pl_intensity.clone(), "verts": verts}
    p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    q = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    seed = 2147480001
    a = f(p, o, d, seed=seed)
    ud = philox.branch_uniforms(seed, 0, o.shape[0], sc.max_depth + 1)
    b = diffchain.render(whitted.tables(sc, "cpu"), q, o, d, ud)
    assert torch.allclose(a, b, rtol=1e-5, atol=1e-4)
    w = torch.randn(a.shape, generator=g)
    (a * w).sum().backward()
    (b * w).sum().backward()
    for k in p:
        assert torch.allclose(p[k].grad, q[k].grad, rtol=1e-4,
                              atol=1e-4 * float(q[k].grad.abs().max())), k


def test_philox_copy_matches_the_programs():
    from advanced_cpu_raytracing_tpu_torch.ops import rng

    seed = 3 * 2**31 + 5  # past 32 bits: both keep the low word
    assert torch.equal(rng.philox_table(seed, 0, 100, 7, 1),
                       philox.branch_uniforms(seed, 0, 100, 7))
    pix = torch.tensor([0, 5, 639999, 123456])
    for s in (1, 2, 777):
        want = rng.PhiloxDraws(seed, sample=s).uniform(
            -1, rng.SITE_JITTER, 640000, 2)[pix]
        assert torch.equal(philox.pass_jitter(seed, s, pix), want)


def _reference_modules() -> list[str]:
    """Every module of the benchmark's reference folder, and each
    reference that a configuration of the spec names."""
    layout = harness.Layout()
    names = {p.stem for p in (harness.BENCH_DIR / "reference").glob("*.py")
             if p.stem != "__init__"}
    names |= {layout.config(c["name"]).get("reference", "whitted")
              for c in layout.spec["configs"]}
    return sorted(names)


@pytest.mark.parametrize("name", _reference_modules())
def test_reference_loads_nothing_of_the_program_or_jax(name):
    assert (harness.BENCH_DIR / "reference" / f"{name}.py").exists()
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.%s\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % (str(ROOT), name))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    tops = set(json.loads(out.replace("'", '"')))
    for top in ("jax", "jaxlib", "flax", "advanced_cpu_raytracing_tpu",
                "advanced_cpu_raytracing_tpu_torch"):
        assert top not in tops


def test_roofline_count_ignores_the_programs_tree(tmp_path, monkeypatch):
    """The count comes from the reference alone: the program built with
    another tree (the forward route's threshold and the leaf size changed)
    gives the same count."""
    from advanced_cpu_raytracing_tpu_torch.ops import megakernel as mk

    def count():
        run = run_of("conductors.frame16", tmp_path)
        runner = run.layout.module("runners", "frames")
        st = runner.setup(run)
        work = runner.window(run, st)
        ans = runner.answers(run, st, work)
        c = runner.counts(run, ans)
        return c, run.layout.module("rooflines", "k1").least_s(run, c)

    base = count()
    monkeypatch.setattr(mk, "FWD_FLAT_MAX_FACES", 1 << 20)
    assert count() == base
    monkeypatch.setattr(mk, "FWD_FLAT_MAX_FACES", 8)
    monkeypatch.setattr(mk, "LEAF_ROWS", 2)
    assert count() == base
    assert base[0]["queries"] > 0 and base[1] > 0
