"""Scene packing of the PyTorch port against the JAX package.

Every ScenePack field must equal the JAX field exactly, on the demo scene
(without its AreaLight) and on the coarse slice scene.  Both scenes keep
every mesh under 4,096 faces: from there the JAX package builds BVHs in
native C++ code, which orders faces differently from the numpy BVH code
that both packages share below it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu.scene.pack import pack_scene as jax_pack_scene
from advanced_cpu_raytracing_tpu.scene.xml_parser import load_scene as jax_load_scene
from advanced_cpu_raytracing_tpu_torch.scene.pack import (
    FIELD_NAMES,
    StaticInfo,
    pack_from_arrays,
    pack_scene,
)
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from test_torch_common import coarse_slice_scene, demo_scene

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["demo", "slice"])
def packs(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    path = demo_scene(tmp) if request.param == "demo" else coarse_slice_scene(tmp)
    return (jax_pack_scene(jax_load_scene(path)),
            pack_scene(load_scene(path), device="cpu"))


def test_static_info_matches_jax(packs):
    jp, tp = packs
    assert dataclasses.asdict(tp.static) == dataclasses.asdict(jp.static)


def test_pack_fields_equal_jax(packs):
    jp, tp = packs
    bad = []
    for name in FIELD_NAMES:
        want = np.asarray(getattr(jp, name))
        got = getattr(tp, name)
        assert got.device.type == "cpu"
        got = got.numpy()
        if (got.dtype != want.dtype or got.shape != want.shape
                or not np.array_equal(got, want)):
            bad.append(name)
    assert not bad, f"fields differing from the JAX pack: {bad}"


def test_pack_from_arrays_round_trips_a_jax_pack(packs):
    jp, _ = packs
    fields = {n: np.asarray(getattr(jp, n)) for n in FIELD_NAMES}
    static = StaticInfo(**dataclasses.asdict(jp.static))
    tp = pack_from_arrays(fields, static, device="cpu")
    assert tp.static == static
    for n in FIELD_NAMES:
        np.testing.assert_array_equal(getattr(tp, n).numpy(), fields[n])
    del fields["verts"]
    with pytest.raises(KeyError, match="verts"):
        pack_from_arrays(fields, static, device="cpu")
