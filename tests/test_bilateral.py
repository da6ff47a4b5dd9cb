"""Joint-bilateral pass (models/denoise._bilateral_pass) against a per-pixel
NumPy filter written straight from BilateralFilter.hlsli: 51 taps along one
axis, the disk-like tap table, the joint colour weight, and zero reads out
of bounds (D3D's out-of-bounds texture reads)."""

import jax.numpy as jnp
import numpy as np
import pytest

from dxrexperiments_tpu.models.denoise import (
    KERNEL_TAPS,
    MAX_EXTENT,
    _bilateral_pass,
)

TABLE = [1.0, 1.0, 0.9, 0.75, 0.6, 0.5, 0.0]


def _data(h=20, w=26, seed=0):
    rs = np.random.default_rng(seed)
    inp = rs.uniform(0, 1, (h, w, 3)).astype(np.float32)
    guide = np.zeros((h, w, 3), np.float32)
    guide[:, w // 2:] = 0.8  # an edge for the joint term
    guide += rs.uniform(0, 0.05, (h, w, 3)).astype(np.float32)
    return inp, guide


def numpy_pass(inp, guide, radius, axis):
    h, w, _ = inp.shape
    out = np.zeros_like(inp, dtype=np.float64)
    for y in range(h):
        for x in range(w):
            color = np.zeros(3)
            weight = 0.0
            for i in range(-MAX_EXTENT, MAX_EXTENT + 1):
                yy, xx = (y + i, x) if axis == 0 else (y, x + i)
                inside = 0 <= yy < h and 0 <= xx < w
                s_in = inp[yy, xx] if inside else np.zeros(3)
                s_g = guide[yy, xx] if inside else np.zeros(3)
                idx = int(abs(i) * (KERNEL_TAPS - 1)
                          / (0.001 + abs(radius * 0.8)))
                tap = TABLE[min(max(idx, 0), KERNEL_TAPS)]
                cw = 1.0 - min(max(np.abs(guide[y, x] - s_g).sum() * 10.0,
                                   0.0), 1.0)
                color += s_in * tap * cw
                weight += tap * cw
            out[y, x] = color / max(weight, 1e-8)
    return out


@pytest.mark.parametrize(
    "axis,radius,seed",
    [(1, 12.0, 0), (0, 7.0, 3), (1, 1.0, 5)],
    ids=["horizontal", "vertical", "small_radius"],
)
def test_bilateral_pass_matches_per_pixel_filter(axis, radius, seed):
    inp, guide = _data(seed=seed)
    got = np.asarray(_bilateral_pass(
        jnp.asarray(inp), jnp.asarray(guide), jnp.asarray(radius), axis=axis
    ))
    np.testing.assert_allclose(got, numpy_pass(inp, guide, radius, axis),
                               atol=2e-5)
