"""The port of the JAX package's tools/inverse_render.py
(``advanced_cpu_raytracing_tpu_torch/tools/inverse_render.py``) on the CPU,
through the plain version of the differentiable render, at a coarse size:
its texture mode (slice C3's path, K2c on the card) at 32x32 with a 16x16
texture and its gauge mode (K2a) at 10x10, one sample grid, a few Adam
steps; the loss falls and the summary line parses."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu_torch.tools import inverse_render

torch.set_num_threads(1)


def test_texture_mode_recovers_toward_the_texture():
    s = inverse_render.run("texture", steps=6, spp=1, res=32, lr=2e-2,
                           n_tex=16, device="cpu", log=lambda _: None)
    h = s["loss_history"]
    assert len(h) == 6 and all(np.isfinite(h))
    assert all(b < a for a, b in zip(h, h[1:])), h
    assert s["variant"] == "mega_bwd_tex" and s["device"] == "cpu"
    assert s["fields"] == ["img_atlas"] and s["texels"] == 16 * 16
    assert s["unobservable_entries"]["img_atlas"] < 16 * 16 * 3
    assert s["max_rel_err_observable"]["img_atlas"] <= s["max_rel_err"][
        "img_atlas"]
    assert s["rays_per_s"] > 0 and np.isfinite(s["texture_psnr_db"])


def test_the_command_line_takes_another_image(tmp_path, capsys):
    """``--image``: the quad carries the given image (here 16x16) in place
    of the authored texture; the last line printed is the summary, also
    written to ``--out``."""
    from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import (
        write_random_png,
    )

    write_random_png(tmp_path / "img.png", 16, 16, 4)
    out = tmp_path / "texture.json"
    inverse_render.main(["--texture", "--device", "cpu", "--res", "16",
                         "--spp", "1", "--steps", "2", "--image",
                         str(tmp_path / "img.png"), "--out", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    assert summary == json.loads(out.read_text())
    assert lines[0].startswith("step 0: loss ")
    assert summary["texels"] == 256 and "img.png" in summary["scene"]
    assert summary["loss_history"][1] < summary["loss_history"][0]


def test_gauge_mode_falls(tmp_path):
    s = inverse_render.run("gauge", steps=3, spp=1, res=10, lr=2e-2,
                           device="cpu", log=lambda _: None)
    h = s["loss_history"]
    assert s["variant"] == "mega_bwd_tree" and s["fields"] == ["mat_diffuse",
                                                          "pl_intensity"]
    assert all(np.isfinite(h)) and all(b < a for a, b in zip(h, h[1:])), h


def test_the_tool_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inverse_render.run("texture", steps=1, spp=1, res=8)
