"""The port's sharded routes (``parallel/``, ``post/tonemap.py::
reinhard_tonemap_sharded``, the CLI's ``--shard``) against the unsharded
port and the JAX package's ``parallel/shard_render.py`` on a 2-device mesh
of the 8 virtual CPU devices (tests/conftest.py).

Each rank's part is a plain function of its rank, so the parts of ranks 0
and 1 are computed and joined here in one process; the collectives
themselves run in a one-rank gloo group, in the CLI, and in one gloo dry
run of two spawned ranks.  Tolerances: K1's (tests/test_torch_render.py)
against the JAX kernel; 1e-6 for the wavefront's shards against the
unsharded wavefront; one u8 step for the tonemap; rtol 1e-5 for the
sharded fused step against the unsharded port step, and K2's rtol 1e-3
(tests/test_torch_diff.py) against the JAX sharded step."""

from __future__ import annotations

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from PIL import Image

from advanced_cpu_raytracing_tpu.diff.params import (
    extract_params as jax_extract_params,
    inject_params as jax_inject_params,
)
from advanced_cpu_raytracing_tpu.parallel import shard_render as jax_sr
from advanced_cpu_raytracing_tpu.parallel.mesh import (
    make_device_mesh as jax_make_device_mesh,
)
from advanced_cpu_raytracing_tpu.post.tonemap import (
    reinhard_tonemap_sharded as jax_reinhard_tonemap_sharded,
)
from advanced_cpu_raytracing_tpu.render import camera as jax_camera
from advanced_cpu_raytracing_tpu.render.integrator import (
    RenderOptions as JaxOptions,
)
from advanced_cpu_raytracing_tpu.render.renderer import (
    options_for_camera as jax_options_for_camera,
)
from advanced_cpu_raytracing_tpu.scene.pack import pack_scene as jax_pack_scene
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene as jax_load_scene
from advanced_cpu_raytracing_tpu_torch.cli.render import main as cli_main
from advanced_cpu_raytracing_tpu_torch.diff.params import (
    extract_params,
    inject_params,
)
from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb
from advanced_cpu_raytracing_tpu_torch.parallel import shard_render as sr
from advanced_cpu_raytracing_tpu_torch.parallel.dryrun import dryrun_multichip
from advanced_cpu_raytracing_tpu_torch.parallel.mesh import (
    TILE_AXIS,
    initialize_distributed,
    make_device_mesh,
    shard_bounds,
)
from advanced_cpu_raytracing_tpu_torch.post.tonemap import (
    reinhard_tonemap,
    reinhard_tonemap_sharded,
    tonemap_constants,
    tonemap_shard_map,
    tonemap_shard_stats,
)
from advanced_cpu_raytracing_tpu_torch.render import renderer
from advanced_cpu_raytracing_tpu_torch.render.camera import (
    build_camera,
    generate_rays,
)
from advanced_cpu_raytracing_tpu_torch.render.integrator import RenderOptions
from advanced_cpu_raytracing_tpu_torch.render.renderer import (
    options_for_camera,
    render_camera,
)
from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from test_torch_common import coarse_slice_scene, demo_scene
from test_torch_render import _assert_close

torch.set_num_threads(1)

WORLD = 2
FIELDS = ("mat_diffuse", "pl_intensity", "verts")
# the demo scene's glass made a mirror: nothing draws, so the sharded and
# unsharded steps trace the same paths whatever their keys
MIRROR_GLASS = ('<Material id="3" type="mirror"><AmbientReflectance>0 0 0'
                '</AmbientReflectance><DiffuseReflectance>0.2 0.1 0.1'
                '</DiffuseReflectance><SpecularReflectance>0 0 0'
                '</SpecularReflectance><MirrorReflectance>0.5 0.5 0.5'
                '</MirrorReflectance></Material>')


def joined(part_of, n: int):
    """The parts of ranks 0..WORLD-1 joined, cut to ``n`` rows."""
    return torch.cat([part_of(r) for r in range(WORLD)])[:n]


@pytest.fixture
def one_rank():
    """A one-rank gloo group and its mesh, destroyed afterwards."""
    assert initialize_distributed(device="cpu")
    try:
        yield make_device_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """The deterministic demo scene (one chunk: a floor of 2 faces, a
    mirror and a second mirror sphere), in both packages, with 8 rays a
    rank."""
    path = pathlib.Path(demo_scene(tmp_path_factory.mktemp("shard_demo")))
    xml, n = re.subn(r'<Material id="3" type="dielectric">.*?</Material>',
                     MIRROR_GLASS, path.read_text(), flags=re.S)
    assert n == 1
    path.write_text(xml)
    cfg = load_scene(str(path))
    jcfg = jax_load_scene(str(path))
    rng = np.random.default_rng(4)
    n = 8 * WORLD
    return dict(cfg=cfg, pack=pack_scene(cfg, device="cpu"),
                cam=build_camera(cfg.cameras[0], device="cpu"),
                jcfg=jcfg, jpack=jax_pack_scene(jcfg),
                jcam=jax_camera.build_camera(jcfg.cameras[0]),
                px=rng.uniform(0, 63, n).astype(np.float32),
                py=rng.uniform(0, 63, n).astype(np.float32),
                target=rng.uniform(0, 40, (n, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def jmesh():
    """The JAX package's 2-device mesh of the virtual CPU devices."""
    return jax_make_device_mesh(WORLD)


@pytest.mark.parametrize("total,world", [(1, 1), (231, 2), (256, 2),
                                         (640000, 3), (7, 8)])
def test_shard_bounds_cover_every_pixel_once(total, world):
    seen = np.zeros(total, int)
    spans = [shard_bounds(total, world, r) for r in range(world)]
    for r, (lo, hi) in enumerate(spans):
        assert (hi - lo) % 8 == 0 and hi - lo == spans[0][1] - spans[0][0]
        assert lo == (spans[r - 1][1] if r else 0)
        seen[lo:min(hi, total)] += 1
    assert (seen == 1).all() and spans[-1][1] - total < 8 * world
    with pytest.raises(ValueError):
        shard_bounds(total, world, world)


def test_k1_shards_match_the_jax_sharded_megakernel(tmp_path, jmesh):
    path = coarse_slice_scene(tmp_path, 16, 16)
    jcfg = jax_load_scene(path)
    jcam = dataclasses.replace(jcfg.cameras[0], num_samples=1)
    want = jax_sr.render_camera_sharded_mega(
        jax_pack_scene(jcfg), jcfg, jcam, mesh=jmesh, seed=0)
    cfg = load_scene(path)
    pack = pack_scene(cfg, device="cpu")
    cam_cfg = dataclasses.replace(cfg.cameras[0], num_samples=1)
    assert not sr.mega_missing(pack.static,
                               options_for_camera(cfg, cam_cfg), pack)
    got = joined(lambda r: sr.shard_image(pack, cfg, cam_cfg, r, WORLD,
                                          device="cpu"),
                 16 * 16).reshape(16, 16, 3).numpy()
    _assert_close(got, want)
    # no draws at 1 spp: every world size gives render_camera's image
    np.testing.assert_array_equal(
        got, render_camera(pack, cfg, cam_cfg, device="cpu"))


def test_wavefront_shards_equal_the_unsharded_wavefront(tmp_path,
                                                        monkeypatch):
    """10x10 (100 pixels: shards of 56, the last padded) at 4 spp."""
    path = coarse_slice_scene(tmp_path, 10, 10)
    cfg = load_scene(path)
    pack = pack_scene(cfg, device="cpu")
    cam_cfg = dataclasses.replace(cfg.cameras[0], num_samples=4)
    for module in (sr, renderer):
        monkeypatch.setattr(module, "mega_missing", lambda *a: ["forced"])
    got = joined(lambda r: sr.shard_image(pack, cfg, cam_cfg, r, WORLD, seed=5,
                                          device="cpu"), 100)
    want = render_camera(pack, cfg, cam_cfg, seed=5, device="cpu")
    np.testing.assert_allclose(got.reshape(10, 10, 3).numpy(), want,
                               rtol=0, atol=1e-6)


def test_one_rank_group_renders_what_render_camera_renders(tmp_path,
                                                           one_rank):
    mesh = one_rank
    assert mesh.mesh_dim_names == (TILE_AXIS,) and mesh.size() == 1
    path = coarse_slice_scene(tmp_path, 12, 12)
    cfg = load_scene(path)
    pack = pack_scene(cfg, device="cpu")
    cam_cfg = dataclasses.replace(cfg.cameras[0], num_samples=4)
    want = render_camera(pack, cfg, cam_cfg, seed=2, device="cpu")
    for fn in (sr.render_camera_sharded, sr.render_camera_sharded_mega):
        np.testing.assert_array_equal(
            fn(pack, cfg, cam_cfg, mesh=mesh, seed=2, device="cpu"), want)
    with pytest.raises(ValueError, match="one process per device"):
        make_device_mesh(2, device="cpu")


def test_the_default_mesh_needs_a_process_group(demo):
    """With no mesh and no group the collective routes raise and make
    none, so no one-rank group is left behind."""
    assert not dist.is_initialized()
    hdr = np.ones((4, 4, 3), np.float32)
    for call in (lambda: make_device_mesh(device="cpu"),
                 lambda: reinhard_tonemap_sharded(hdr, device="cpu"),
                 lambda: sr.render_sharded(demo["pack"], demo["cam"],
                                           demo["px"], demo["py"], 0,
                                           RenderOptions())):
        with pytest.raises(RuntimeError, match="no process group"):
            call()
        assert not dist.is_initialized()


@pytest.mark.parametrize("burn", [0.0, 1.0, 8.0])
def test_sharded_tonemap_matches_the_unsharded_and_jax(burn, one_rank,
                                                      jmesh):
    rng = np.random.default_rng(5)
    # 21x11 = 231 pixels: padded shards
    hdr = (rng.uniform(0, 4, (21, 11, 3)) ** 2).astype(np.float32)
    hdr[3, 4] = np.nan
    want = reinhard_tonemap(hdr, burn_percent=burn, device="cpu")
    flat = torch.nan_to_num(torch.as_tensor(hdr)).reshape(-1, 3)
    stats = [tonemap_shard_stats(flat, r, WORLD) for r in range(WORLD)]
    avg_lum, thresh = tonemap_constants(
        sum(s[0] for s in stats), sum(s[1] for s in stats),
        torch.cat([s[2] for s in stats]), burn_percent=burn)
    got = joined(lambda r: tonemap_shard_map(flat, r, WORLD, avg_lum, thresh),
                 231).reshape(21, 11, 3).numpy()
    theirs = jax_reinhard_tonemap_sharded(hdr, jmesh,
                                          burn_percent=burn)
    for other in (want, theirs):
        assert np.abs(got.astype(int) - other.astype(int)).max() <= 1
    # the collective path at one rank is the unsharded tonemap
    np.testing.assert_array_equal(
        reinhard_tonemap_sharded(hdr, one_rank, burn_percent=burn,
                                 device="cpu"), want)


def test_sharded_diff_step_matches_the_unsharded_step_and_jax(demo, jmesh):
    cfg, pack, cam = demo["cfg"], demo["pack"], demo["cam"]
    opts = dataclasses.replace(options_for_camera(cfg, cfg.cameras[0]),
                               max_depth=2)
    render = mb.make_diff_render(pack, opts, device="cpu")
    assert not mb.needs_draws(render.bc) and render.bc.mc.n_chunks == 1
    params = extract_params(pack, FIELDS)
    px, py, target = demo["px"], demo["py"], demo["target"]
    n = len(px)
    parts = [sr.shard_diff_step(render, cam, params, px, py, target, r, WORLD)
             for r in range(WORLD)]
    loss = sum(p[0] for p in parts)
    grads = {k: sum(p[1][k] for p in parts) for k in FIELDS}
    # the unsharded port step
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    o, d = generate_rays(cam, torch.as_tensor(px), torch.as_tensor(py))
    loss_1 = torch.mean((render(leaves, o, d) - torch.as_tensor(target)) ** 2)
    loss_1.backward()
    np.testing.assert_allclose(float(loss), float(loss_1.detach()), rtol=1e-5)
    for k in FIELDS:
        want = leaves[k].grad.numpy()
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=1e-5,
                                   atol=1e-6 * max(np.abs(want).max(), 1e-9),
                                   err_msg=k)
    # the JAX sharded step (its K2 interpreted) on a 2-device mesh
    jopts = dataclasses.replace(
        jax_options_for_camera(demo["jcfg"], demo["jcfg"].cameras[0]),
        max_depth=2)
    jstep = jax_sr.make_sharded_diff_step(
        demo["jpack"], jopts, demo["jcam"], mesh=jmesh,
        interpret=True)
    jloss, jgrads = jstep(jax_extract_params(demo["jpack"], FIELDS),
                          jnp.asarray(px), jnp.asarray(py),
                          jnp.asarray(target), None)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)
    for k in FIELDS:
        want = np.asarray(jgrads[k])
        assert np.abs(want).sum() > 0, k
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)


def test_loss_and_grads_match_jax(demo, one_rank, jmesh):
    opts = RenderOptions(max_depth=2, differentiable=True, max_iters=4)
    fields = ("mat_diffuse", "pl_intensity")
    px, py, target = demo["px"], demo["py"], demo["target"]

    def extract(p):
        return extract_params(p, fields)

    parts = [sr.shard_loss_and_grads(demo["pack"], demo["cam"], px, py, 0,
                                     opts, target, extract, inject_params, r,
                                     WORLD) for r in range(WORLD)]
    loss = sum(p[0] for p in parts)
    grads = {k: sum(p[1][k] for p in parts) for k in fields}
    jloss, jgrads = jax_sr.loss_and_grads(
        demo["jpack"], demo["jcam"], px, py, jax.random.PRNGKey(0),
        JaxOptions(max_depth=2, differentiable=True, max_iters=4), target,
        lambda p: jax_extract_params(p, fields), jax_inject_params,
        mesh=jmesh)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in fields:
        want = np.asarray(jgrads[k])
        assert np.abs(want).sum() > 0
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max(), err_msg=k)
    # the collective path at one rank
    loss1, grads1 = sr.loss_and_grads(demo["pack"], demo["cam"], px, py, 0,
                                      opts, target, extract, inject_params,
                                      mesh=one_rank)
    np.testing.assert_allclose(float(loss1), float(loss), rtol=1e-6)
    # and render_sharded: the wavefront's batch
    got = sr.render_sharded(demo["pack"], demo["cam"], px, py, 0, opts,
                            mesh=one_rank)
    assert got.shape == (len(px), 3) and np.isfinite(got).all()


def test_dryrun_multichip_on_two_gloo_ranks():
    res = dryrun_multichip(WORLD, "cpu", timeout_s=180)
    assert set(res) == {"1", "1b", "2", "3", "3b"}
    assert res["1"]["shape"] == [64, 64, 3]
    assert all(np.isfinite(res[k]["loss"]) for k in ("3", "3b"))


def test_cli_shard_at_one_rank_writes_the_plain_clis_files(tmp_path):
    """A tonemapped camera: the sharded render and tonemap at one rank."""
    path = pathlib.Path(coarse_slice_scene(tmp_path, 16, 16))
    path.write_text(path.read_text().replace(
        "<NumSamples>16</NumSamples>",
        "<NumSamples>16</NumSamples><Tonemap><TMO>Photographic</TMO>"
        "<TMOOptions>0.18 1</TMOOptions><Saturation>1.0</Saturation>"
        "<Gamma>2.2</Gamma></Tonemap>"))
    outs = {}
    for mode in ("plain", "shard"):
        out = tmp_path / mode
        argv = [str(path), "--out-dir", str(out), "--spp", "4", "--device",
                "cpu"] + (["--shard"] if mode == "shard" else [])
        assert cli_main(argv) == 0
        assert not dist.is_initialized()  # the CLI destroyed its group
        outs[mode] = sorted(p.name for p in out.iterdir()), out
    assert outs["plain"][0] == outs["shard"][0] and len(outs["plain"][0]) == 2
    for name in outs["plain"][0]:
        a = (outs["plain"][1] / name).read_bytes()
        b = (outs["shard"][1] / name).read_bytes()
        if name.endswith(".png"):
            a = np.asarray(Image.open(outs["plain"][1] / name))
            b = np.asarray(Image.open(outs["shard"][1] / name))
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, name
