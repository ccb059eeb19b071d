"""The blur kernel's band ranges (``blur_cuda.band_ranges``) on the CPU.

The CUDA kernel runs ``k`` only over each tile's range of non-zero entries of
``T``: the rows of ``T_h`` a block owns (phase 1) and the columns of ``T_w`` a
warp owns (phase 2). ``band_ranges`` states those ranges where the CPU can
reach them. These tests hold the contract the kernel relies on: every entry
outside a tile's range is exactly zero and both ends are non-zero, an all-zero
tile has no range, and a blur computed tile by tile over the ranges, rounded
out to multiples of 4 as the kernel rounds them, equals the JAX package's
Pallas kernel (interpret mode). The kernel itself is held against the plain
version on a card by tests/test_torch_cuda.py.

Tolerance of the tiled blur against JAX: rtol 1e-5 / atol 1e-6, float32 on
both sides with another summation order (as tests/test_torch_blur.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from blurred_gan_tpu.ops.blur_pallas import _pallas_impl
from blurred_gan_tpu_torch.ops import blur_cuda
from blurred_gan_tpu_torch.ops.blur import blur_matrix
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

FWD = dict(rtol=1e-5, atol=1e-6)
# The 3-tap floor, σ = 2, the run's σ₀ = 5, the clip to the full width.
SWEEP = [0.1, 2.0, 5.0, 100.0]
TILES = [(blur_cuda.ROW_TILE, 0), (blur_cuda.COL_TILE, 1)]


def tiles_of(t, tile, axis):
    """The tiles of ``t`` along ``axis``, each with the other axis as columns."""
    m = t if axis == 0 else t.t()
    return [m[s:s + tile] for s in range(0, m.shape[0], tile)]


def assert_exact_ranges(t, tile, axis):
    ranges = blur_cuda.band_ranges(t, tile, axis)
    blocks = tiles_of(t, tile, axis)
    assert len(ranges) == len(blocks)
    for block, rng in zip(blocks, ranges):
        if rng is None:
            assert torch.count_nonzero(block) == 0
            continue
        first, last = rng
        assert torch.count_nonzero(block[:, :first]) == 0
        assert torch.count_nonzero(block[:, last + 1:]) == 0
        assert torch.count_nonzero(block[:, first]) > 0
        assert torch.count_nonzero(block[:, last]) > 0
    return ranges


def aligned(rng):
    """The k the kernel runs for a range: its ends rounded out to 4."""
    first, last = rng
    return first & ~3, (last | 3) + 1


def tiled_blur(planes, t_h, t_w):
    """The kernel's tile-and-range arithmetic in plain PyTorch: phase 1 per
    row tile of T_h over its range, phase 2 per column tile of T_w over its."""
    p, h, w = planes.shape
    # Zero-pad k to a multiple of 4, as the kernel's staging does.
    h4, w4 = -(-h // 4) * 4, -(-w // 4) * 4
    x = torch.zeros(p, h4, w)
    x[:, :h] = planes
    th = torch.zeros(h, h4)
    th[:, :h] = t_h
    tw = torch.zeros(w4, w)
    tw[:w] = t_w
    out = torch.zeros_like(planes)
    col_ranges = blur_cuda.band_ranges(t_w, blur_cuda.COL_TILE, 1)
    for i, rr in enumerate(blur_cuda.band_ranges(t_h, blur_cuda.ROW_TILE, 0)):
        rows = slice(i * blur_cuda.ROW_TILE, (i + 1) * blur_cuda.ROW_TILE)
        if rr is None:
            continue  # an empty row tile writes zeros
        k0, k1 = aligned(rr)
        y = torch.zeros(p, th[rows].shape[0], w4)
        y[:, :, :w] = torch.matmul(th[rows, k0:k1], x[:, k0:k1])
        for j, cr in enumerate(col_ranges):
            cols = slice(j * blur_cuda.COL_TILE, (j + 1) * blur_cuda.COL_TILE)
            if cr is not None:
                k0, k1 = aligned(cr)
                out[:, rows, cols] = torch.matmul(y[:, :, k0:k1], tw[k0:k1, cols])
    return out


@pytest.mark.parametrize("sigma", SWEEP)
@pytest.mark.parametrize("tile,axis", TILES)
def test_band_ranges_sigma_sweep(sigma, tile, axis):
    t = blur_matrix(sigma, 128)
    ranges = assert_exact_ranges(t, tile, axis)
    assert all(r is not None for r in ranges)
    if sigma == 5.0:
        # 31 taps: an interior tile of 32 spans 62 k, 64 once rounded out to 4.
        assert ranges[1] == (17, 78)
        assert aligned(ranges[1]) == (16, 80)
    if sigma == 100.0:
        # Clipped to 129 taps (half-width 64): only the outer tiles skip.
        assert ranges == [(0, 95), (0, 127), (0, 127), (32, 127)]


@pytest.mark.parametrize("tile,axis", TILES)
def test_band_ranges_random_dense(tile, axis):
    t = torch.from_numpy(np.random.RandomState(0).randn(128, 128).astype(np.float32))
    assert assert_exact_ranges(t, tile, axis) == [(0, 127)] * 4


def test_band_ranges_zero_tile():
    t = blur_matrix(5.0, 128)
    t[32:64, :] = 0
    t[:, 64:96] = 0
    rows = assert_exact_ranges(t, blur_cuda.ROW_TILE, 0)
    cols = assert_exact_ranges(t, blur_cuda.COL_TILE, 1)
    assert rows[1] is None and all(r is not None for i, r in enumerate(rows) if i != 1)
    assert cols[2] is None and all(r is not None for i, r in enumerate(cols) if i != 2)


def test_band_ranges_16x32_plane():
    # One partial row tile (16 rows) and one column tile of 32.
    t_h, t_w = blur_matrix(2.0, 16, 32), blur_matrix(2.0, 32, 32)
    assert assert_exact_ranges(t_h, blur_cuda.ROW_TILE, 0) == [(0, 15)]
    assert assert_exact_ranges(t_w, blur_cuda.COL_TILE, 1) == [(0, 31)]


def test_band_ranges_bad_axis():
    with pytest.raises(ValueError):
        blur_cuda.band_ranges(torch.eye(4), 2, 2)


@pytest.mark.parametrize("shape,sigma", [((3, 128, 128), 5.0), ((3, 128, 128), 0.1),
                                         ((3, 128, 128), 100.0), ((2, 16, 32), 2.0),
                                         ((2, 40, 70), 3.0)])
def test_tiled_blur_matches_jax(shape, sigma):
    p, h, w = shape
    planes = np.random.RandomState(1).randn(*shape).astype(np.float32)
    t_h = blur_matrix(sigma, h, max(h, w))
    t_w = blur_matrix(sigma, w, max(h, w))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_pallas_impl(jnp.asarray(planes), jnp.asarray(t_h.numpy()),
                                       jnp.asarray(t_w.numpy())))
    got = tiled_blur(torch.from_numpy(planes), t_h, t_w)
    np.testing.assert_allclose(got.numpy(), want, **FWD)


def test_tiled_blur_zero_tile_matches_plain():
    t = blur_matrix(5.0, 128)
    t[32:64, :] = 0
    t[:, 64:96] = 0
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 128, 128).astype(np.float32))
    got = tiled_blur(x, t, t)
    assert torch.count_nonzero(got[:, 32:64]) == 0
    assert torch.count_nonzero(got[:, :, 64:96]) == 0
    torch.testing.assert_close(got, blur_cuda.blur_planes_reference(x, t, t), **FWD)
