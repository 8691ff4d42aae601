"""The fwd+bwd's per-target scatter (``ops/megabwd.py``: ``SCATTER_FLAGS``,
``scatter_flags``, ``launch_flags``, ``_Render.backward``).

Each cotangent target of the fwd+bwd kernel (vertices by row, materials,
point and directional lights, background, spot, area and mesh lights,
texels) has its own flag, and ``_Render.backward`` sets them from
``ctx.needs_input_grad``: a table that needs no gradient gets ``None`` and
the kernel never adds to it.  Here on the CPU: the flag word that
``mega_bwd_trace`` builds for each pattern of requested inputs (vertices
only, texels only, materials and lights, all, none: the rays alone), read
from the call ``_Render.backward`` makes; and the cotangents the plain
version returns for the requested inputs against ``jax.grad`` of the JAX
``trace_radiance(differentiable=True)`` on the inverse-texture quad with a
16x16 texture, 128 rays (the JAX tests' tolerances, rtol 5e-3 and atol
5e-4 max|g|, as tests/test_torch_diff_tex.py), and on its floor cut in two
quads that read one image through a nearest and a bilinear texture (the
kernel groups a warp's texel adds by tap and filter), the same bits whichever
other inputs are requested, and ``None`` for the others.  The JAX
gradient of the vertices takes minutes to compile here, so the oracle
leaves them out: the vertices' gradient is held to the JAX oracle on the
two-texture scene by tests/test_torch_diff_tex.py, and here to the same
bits as when every input is requested.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu_torch.diff.params import params_from_arrays
from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb
from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import (
    shared_image_scene_xml,
    texture_inverse_scene_xml,
)
from test_torch_diff_pt import cos_loss, oracle, setup

torch.set_num_threads(1)

# the quad's differentiable leaves (no directional, spot, area or mesh
# light) and the tables they reach
LEAVES = ("mat_ambient", "mat_diffuse", "mat_specular", "mat_phong",
          "pl_intensity", "bg_color", "verts", "img_atlas")
TABLE_OF = {"mat_ambient": "mat", "mat_diffuse": "mat", "mat_specular": "mat",
            "mat_phong": "mat", "pl_intensity": "pl", "bg_color": "bg",
            "verts": "tri_w", "img_atlas": "texels"}
PATTERNS = {
    "vertices only": ("verts",),
    "texels only": ("img_atlas",),
    "materials and lights": ("mat_diffuse", "mat_ambient", "pl_intensity",
                             "bg_color"),
    "all": LEAVES,
    "none": (),
}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scatter_flags")
    s = setup(None, tmp, 128, leaves=LEAVES,
              path=texture_inverse_scene_xml(16, out_dir=tmp))
    s["jax"] = oracle(dict(s, arrays={k: v for k, v in s["arrays"].items()
                                      if k != "verts"}), cos_loss)
    return s


def backward_calls(case, leaves, monkeypatch):
    """Render the case with ``leaves`` requiring grad (and, with none, the
    rays), run ``_Render.backward`` once through the output's grad_fn, and
    return the scatter argument of its ``mega_bwd_trace`` call, the grads it
    returned per input, and the params."""
    calls = []
    trace = mb.mega_bwd_trace

    def spy(*args, **kw):
        if kw.get("gbar") is not None:
            calls.append(kw.get("scatter", True))
        return trace(*args, **kw)

    monkeypatch.setattr(mb, "mega_bwd_trace", spy)
    params = params_from_arrays({k: case["arrays"][k] for k in leaves}, "cpu")
    f = mb.make_diff_render(case["pack"], case["opts"], device="cpu")
    o = torch.tensor(case["o"]).requires_grad_(not leaves)
    img = f(params, o, torch.tensor(case["d"]), draws=case["draws"])
    grads = img.grad_fn.apply(torch.ones_like(img))
    assert len(calls) == 1
    return calls[0], grads, params, f.bc


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_backward_builds_the_flag_word_of_its_inputs(case, pattern,
                                                     monkeypatch):
    """The targets ``_Render.backward`` asks for are the tables of the
    requested inputs; the fwd+bwd's flag word has their SC_* flags and no
    other, the scene's switches, and the quad's 2 rows in shared memory
    when their target is asked for; every table not asked for gets
    ``None``."""
    leaves = PATTERNS[pattern]
    scatter, grads, _, bc = backward_calls(case, leaves, monkeypatch)
    want = sorted({TABLE_OF[k] for k in leaves})
    assert sorted(mb.scatter_targets(scatter)) == want
    flags = mb.launch_flags(bc, scatter)
    sc = [name for name, bit in mb.SCATTER_FLAGS.items() if flags & bit]
    assert sorted(sc) == want
    assert bool(flags & mb.FLAG_TRI_SHARED) == ("tri_w" in want)
    assert flags & ~(mb.FLAG_TRI_SHARED | sum(
        mb.SCATTER_FLAGS.values())) == mb.launch_flags(bc, False)
    # bc, draws, seed, step, then BwdTables' fields, o, d
    per_input = dict(zip(mb.BwdTables._fields + ("o", "d"), grads[4:]))
    for name, g in per_input.items():
        asked = name in want or (name == "o" and not leaves)
        assert (g is not None) == asked, (name, asked)
    assert grads[:4] == (None,) * 4


def test_scatter_targets_names_and_refuses():
    """True names every table, False none, a list its tables; an unknown
    name raises."""
    assert mb.scatter_targets(True) == mb.BwdTables._fields
    assert mb.scatter_targets(False) == ()
    assert mb.scatter_targets(["texels", "mat"]) == ("texels", "mat")
    with pytest.raises(ValueError, match="unknown targets"):
        mb.scatter_targets(["texels", "verts"])


def test_shared_copies_follow_their_thresholds(case, monkeypatch):
    """FLAG_TRI_SHARED only where the rows are asked for and fit under
    their threshold."""
    bc = mb.build_bwd_consts(case["pack"], case["opts"], device="cpu")
    shared = mb.FLAG_TRI_SHARED
    assert mb.scatter_flags(bc, True) & shared == shared
    monkeypatch.setattr(mb, "TRI_SHARED_MAX_ROWS", 1)
    assert mb.scatter_flags(bc, True) & shared == 0
    monkeypatch.setattr(mb, "TRI_SHARED_MAX_ROWS", 2)
    assert mb.scatter_flags(bc, True) & shared == shared
    assert mb.scatter_flags(bc, ["mat", "texels"]) & shared == 0


@pytest.mark.parametrize("pattern", [p for p in PATTERNS if p != "none"])
def test_requested_cotangents_match_jax_and_ignore_the_others(
        case, pattern, monkeypatch):
    """The requested leaves' gradients against the JAX oracle; each equal
    bit for bit to its gradient when every leaf is requested; the leaves
    not requested get none."""
    leaves = PATTERNS[pattern]
    _, g_jax = case["jax"]

    def grads(requested):
        params = params_from_arrays(case["arrays"], "cpu")
        for k, p in params.items():
            p.requires_grad_(k in requested)
        f = mb.make_diff_render(case["pack"], case["opts"], device="cpu")
        loss = cos_loss(f(params, torch.tensor(case["o"]),
                          torch.tensor(case["d"]), draws=case["draws"]))
        loss.backward()
        return {k: None if p.grad is None else p.grad.numpy()
                for k, p in params.items()}

    got, every = grads(leaves), grads(LEAVES)
    for k in LEAVES:
        if k not in leaves:
            assert got[k] is None, k
            continue
        np.testing.assert_array_equal(got[k], every[k], err_msg=k)
        if k == "verts":
            assert np.abs(got[k]).sum() > 0
            continue
        a, b = g_jax[k], got[k]
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b, a, rtol=5e-3, atol=5e-4 * scale,
                                   err_msg=f"{pattern}: {k}")


def test_mega_bwd_trace_on_the_cpu_zeroes_the_targets_not_asked(case):
    """``scatter`` on the CPU: the asked targets equal the full call's, the
    others are 0, the rays' cotangents are always there."""
    bc = mb.build_bwd_consts(case["pack"], case["opts"], device="cpu")
    f = mb.make_diff_render(case["pack"], case["opts"], device="cpu")
    tabs = mb.BwdTables(*(t.detach() for t in f.tables({})))
    o, d = torch.tensor(case["o"]), torch.tensor(case["d"])
    gbar = torch.ones_like(o)
    _, full = mb.mega_bwd_trace(bc, tabs, o, d, case["draws"], gbar=gbar)
    assert float(full.texels.abs().sum()) > 0 and float(
        full.tri_w.abs().sum()) > 0
    for scatter in (["texels"], ["tri_w", "mat"], False):
        _, g = mb.mega_bwd_trace(bc, tabs, o, d, case["draws"], gbar=gbar,
                                 scatter=scatter)
        for k in mb.BwdGrads._fields:
            a, b = getattr(full, k), getattr(g, k)
            if k in ("o", "d") or k in mb.scatter_targets(scatter):
                assert torch.equal(a, b), (scatter, k)
            else:
                assert not b.any(), (scatter, k)


def test_two_filters_on_one_image_match_jax(tmp_path):
    """The quad cut in two, a nearest and a bilinear texture over one
    image (``shared_image_scene_xml``): the pool holds the image once and
    both textures start at its first texel; the texels' and materials'
    cotangents of the plain version against the JAX oracle, rtol 5e-3 and
    atol 5e-4 max|g|, and more than a quarter of the texels get one."""
    leaves = ("mat_diffuse", "pl_intensity", "img_atlas")
    s = setup(None, tmp_path, 128, leaves=leaves,
              path=shared_image_scene_xml(out_dir=tmp_path))
    mc = s["bc"].mc
    assert len(mc.tex_images) == 1
    tint = mc.tex_int[:2].numpy()
    assert sorted(tint[:, 1]) == [0, 1] and tint[0, 6] == tint[1, 6]
    _, g_jax = oracle(s, cos_loss)
    params = params_from_arrays(s["arrays"], "cpu")
    f = mb.make_diff_render(s["pack"], s["opts"], device="cpu")
    cos_loss(f(params, torch.tensor(s["o"]), torch.tensor(s["d"]),
               draws=s["draws"])).backward()
    for k in leaves:
        a, b = g_jax[k], params[k].grad.numpy()
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b, a, rtol=5e-3, atol=5e-4 * scale,
                                   err_msg=k)
    (img, h, w), = mc.tex_images
    touched = np.abs(params["img_atlas"].grad.numpy()[img, :h, :w]).sum(-1)
    assert (touched > 0).sum() > h * w // 4
