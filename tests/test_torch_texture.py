"""The port's texture sampling (``ops/texture.py``) against the JAX
package's ``ops/texture.py`` on the same seeded numpy inputs: Perlin noise,
nearest lookups and UV tiling bit for bit; bilinear lookups to 1e-6
relative, since the port weights the four taps in the megakernel's order
((1-dx)(1-dy)) c, not the JAX function's c (1-dx) (1-dy)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu.ops import texture as jax_texture
from advanced_cpu_raytracing_tpu.ops.pallas.megakernel import _perm512_table
from advanced_cpu_raytracing_tpu_torch.ops import texture

N = 4096


def _atlas(seed):
    """Three images of odd sizes in one padded atlas, and rays' (image,
    u, v) with UVs below 0 and above 1."""
    rng = np.random.default_rng(seed)
    atlas = rng.uniform(0.0, 255.0, (3, 9, 11, 3)).astype(np.float32)
    img_w = np.array([11, 7, 5], np.int32)
    img_h = np.array([9, 4, 8], np.int32)
    idx = rng.integers(0, 3, N).astype(np.int32)
    u = rng.uniform(-0.3, 1.3, N).astype(np.float32)
    v = rng.uniform(-0.3, 1.3, N).astype(np.float32)
    u[:8] = [0.0, 1.0, 0.5, 1 / 11, 2 / 11, 10 / 11, 1 / 7, 0.2]  # texel edges
    return atlas, img_w, img_h, idx, u, v


def _both(fn_name, args):
    jout = getattr(jax_texture, fn_name)(*(jnp.asarray(a) for a in args))
    tout = getattr(texture, fn_name)(*(torch.as_tensor(a) for a in args))
    return np.asarray(jout), tout.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_nearest_matches_jax_bit_for_bit(seed):
    want, got = _both("sample_nearest", _atlas(seed))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_bilinear_matches_jax(seed):
    want, got = _both("sample_bilinear", _atlas(seed))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * 255.0)


def test_tile_uv_matches_jax_bit_for_bit():
    """Exact integers above 1 map to 1, not 0 (mesh.cpp:382-389)."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-3.0, 5.0, N).astype(np.float32)
    x[:60] = np.arange(-10, 50) / 4.0
    want, got = _both("tile_uv", (x,))
    np.testing.assert_array_equal(got, want)
    assert got[np.where(x == 3.0)[0][0]] == 1.0


@pytest.mark.parametrize("scale", [0.6, 3.0, 17.0])
def test_perlin_matches_jax_bit_for_bit(scale):
    rng = np.random.default_rng(4)
    p = rng.uniform(-40.0, 40.0, (N, 3)).astype(np.float32)
    p[:4] = [[0.0, 0.0, 0.0], [-1.0, 2.0, -3.0], [255.5, 256.0, -256.5],
             [1e-3, -1e-3, 0.5]]
    noise = np.full(N, scale, np.float32)
    conv = (np.arange(N) % 2).astype(np.int32)
    want, got = _both("perlin_sample", (p, noise, conv))
    np.testing.assert_array_equal(got, want)
    raw_want, raw_got = _both("perlin_raw", (p,))
    np.testing.assert_array_equal(raw_got, raw_want)
    assert np.abs(raw_got).max() <= 1.0 and raw_got.std() > 0.1


def test_permutation_is_the_kernels():
    np.testing.assert_array_equal(texture.PERM512.astype(np.float32),
                                  _perm512_table().reshape(-1))
