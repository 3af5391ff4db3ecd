"""The port's KMeans kernels, held against the JAX package's Pallas kernels.

The same numpy inputs, made from a seed, go through the Pallas kernel in
interpret mode on the CPU (as tests/test_pallas_kernels.py runs it) and
through the port's wrapper on CPU tensors, which runs the kernel's plain
PyTorch version. Tolerances: labels exact (the data sit far from any tie);
partial sums rtol 1e-5, atol 1e-4 (float32 sums of a few hundred rows,
added in a different order); counts exact.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against these plain versions there.
"""

import numpy as np
import pytest
import torch

from flink_ml_tpu.ops import pallas_kernels as pk
from flink_ml_tpu_torch.ops import kernels

RTOL, ATOL = 1e-5, 1e-4


def _separated(seed, n, d, k, scale=10.0, noise=0.1):
    """Rows around k well-separated centers: no row is near a tie."""
    rng = np.random.default_rng(seed)
    centers = (rng.normal(size=(k, d)) * scale).astype(np.float32)
    x = (centers[rng.integers(0, k, n)]
         + rng.normal(size=(n, d)) * noise).astype(np.float32)
    return x, centers, rng


@pytest.mark.parametrize("n,d,k", [(300, 16, 7), (1030, 8, 5), (1, 4, 3),
                                   (pk.TILE_N, 4, 3)])
def test_assign_nearest_plain_matches_pallas(n, d, k):
    x, c, _ = _separated(n + d + k, n, d, k)
    want = np.asarray(pk.assign_nearest(x, c, interpret=True))
    got = kernels.assign_nearest(torch.from_numpy(x), torch.from_numpy(c))
    assert got.dtype == torch.int32 and tuple(got.shape) == (n,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,d,k,zero_share", [
    (300, 8, 5, 0.1),    # well separated, some zero-weight rows
    (1030, 16, 4, 0.0),  # ragged: not a multiple of the Pallas tile
    (517, 6, 3, 0.5),    # half the rows weigh nothing
])
def test_lloyd_partial_sums_plain_matches_pallas(n, d, k, zero_share):
    x, c, rng = _separated(7 * n + d, n, d, k)
    v = (rng.random(n) >= zero_share).astype(np.float32)
    want = np.asarray(pk.lloyd_partial_sums(x, v, c, interpret=True))
    got = kernels.lloyd_partial_sums(
        torch.from_numpy(x), torch.from_numpy(v), torch.from_numpy(c)).numpy()
    assert got.shape == (k, d + 1)
    np.testing.assert_allclose(got[:, :-1], want[:, :-1], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[:, -1], want[:, -1])
    assert got[:, -1].sum() == v.sum()


def test_lloyd_partial_sums_zero_weight_rows_add_nothing():
    x, c, _ = _separated(3, 64, 5, 4)
    v = np.ones(64, np.float32)
    v[::2] = 0.0
    full = kernels.lloyd_partial_sums(
        torch.from_numpy(x), torch.from_numpy(v), torch.from_numpy(c))
    kept = kernels.lloyd_partial_sums(
        torch.from_numpy(x[1::2].copy()), torch.ones(32), torch.from_numpy(c))
    np.testing.assert_allclose(full.numpy(), kept.numpy(), rtol=RTOL, atol=ATOL)


def test_lloyd_partial_sums_empty_input_is_zeros():
    c = np.arange(12, dtype=np.float32).reshape(3, 4)
    want = np.asarray(pk.lloyd_partial_sums(
        np.zeros((0, 4), np.float32), np.zeros(0, np.float32), c,
        interpret=True))
    got = kernels.lloyd_partial_sums(
        torch.zeros((0, 4)), torch.zeros(0), torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (3, 5) and not got.any()


def test_assign_nearest_empty_input():
    got = kernels.assign_nearest(torch.zeros((0, 4)), torch.ones((3, 4)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (0,)


def test_assign_nearest_first_minimum_on_ties():
    # two identical centroids: the lower index wins, as jnp.argmin picks
    c = np.array([[1.0, 0.0], [0.0, 1.0], [0.0, 1.0]], np.float32)
    x = np.array([[0.0, 2.0], [3.0, 0.0]], np.float32)
    want = np.asarray(pk.assign_nearest(x, c, interpret=True))
    got = kernels.assign_nearest(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [1, 0]


def _two_level_sum(p):
    """The fixed order of the reduce kernel, in numpy float32: the B rows
    cut into at most 32 contiguous slices of ceil(B / 32) rows, each added
    in row order from 0, then the slice sums added by a pairwise tree."""
    b = p.shape[0]
    rows = -(-b // 32)
    sums = []
    for lo in range(0, b, rows):
        s = np.zeros(p.shape[1:], np.float32)
        for r in range(lo, min(b, lo + rows)):
            s = s + p[r]
        sums.append(s)
    stride = 1
    while stride < 32:
        for i in range(0, 32, 2 * stride):
            if i + stride < len(sums):
                sums[i] = sums[i] + sums[i + stride]
        stride *= 2
    return sums[0]


def test_reduce_partials_plain_adds_in_order():
    # a fixed order: 9 rows are 9 slices of one row, then the tree
    rng = np.random.default_rng(5)
    p = rng.normal(size=(9, 3, 4)).astype(np.float32)
    want = torch.from_numpy(_two_level_sum(p))
    pt = torch.from_numpy(p)
    assert torch.equal(kernels.reduce_partials(pt), want)
    assert torch.equal(kernels.reduce_partials(pt[:, 0].contiguous()), want[0])
    # -0 rows sum to +0, as the kernel's s = 0, s += p does
    zero = kernels.reduce_partials(torch.full((3, 2), -0.0))
    assert not torch.signbit(zero).any()


# the main paths' partials shapes (Lloyd, SGD, FTRL's gradient sums and
# per-row dots at the card's chunk counts) and the most blocks a launch
# may have
REDUCE_SHAPES = [(391, 10, 101), (782, 102), (1024, 100, 2), (25, 131_072, 1),
                 (65_535, 102)]


@pytest.mark.parametrize("shape", REDUCE_SHAPES)
def test_reduce_layout_fits_and_covers(shape):
    # the order's slices: at most 32, contiguous, none empty, covering the
    # rows; partials of at most 32 rows (FTRL's per-row dots) are one row a
    # slice. The kernels pick their own tiling from (B, width) and the
    # rows' alignment, with a static 1 KiB of shared memory a block.
    blocks = shape[0]
    slice_rows, slices = kernels.reduce_slices(blocks)
    assert 1 <= slices <= kernels.REDUCE_SLICES
    assert (slices - 1) * slice_rows < blocks <= slices * slice_rows
    assert (slice_rows == 1) == (blocks <= kernels.REDUCE_SLICES)
    p = np.random.default_rng(blocks).normal(size=(blocks, 2)).astype(np.float32)
    assert torch.equal(kernels.reduce_partials_plain(torch.from_numpy(p)),
                       torch.from_numpy(_two_level_sum(p)))


@pytest.mark.parametrize("shape", [(391, 3), (782, 5), (1024, 2, 3), (25, 7),
                                   (33, 4), (2_049, 2), (1, 5), (32, 4),
                                   (64, 3)])
def test_reduce_partials_plain_follows_the_kernel_order(shape):
    p = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    got = kernels.reduce_partials_plain(torch.from_numpy(p))
    assert torch.equal(got, torch.from_numpy(_two_level_sum(p)))
    np.testing.assert_allclose(got.numpy(), p.astype(np.float64).sum(0),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bad", ["float64", "noncontiguous", "width", "rank",
                                 "weights"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    x, c = torch.zeros((8, 4)), torch.ones((3, 4))
    v = torch.ones(8)
    if bad == "float64":
        x = x.double()
    elif bad == "noncontiguous":
        x = torch.zeros((4, 8)).T
    elif bad == "width":
        c = torch.ones((3, 5))
    elif bad == "rank":
        x = torch.zeros(8)
    elif bad == "weights":
        v = torch.ones(7)
    with pytest.raises((TypeError, ValueError)):
        kernels.lloyd_partial_sums(x, v, c)
    if bad != "weights":
        with pytest.raises((TypeError, ValueError)):
            kernels.assign_nearest(x, c)


#: shared memory of one Hopper SM, and what the card keeps of it per block
SM_SMEM_BYTES, BLOCK_RESERVED_BYTES = 228 * 1024, 1024


def test_layout_gate_main_path_and_limits():
    # the KMeans benchmark shape fits one 128-row tile with all 10 centroids
    rows, kchunk, smem = kernels._layout(10, 100, lloyd=True)
    assert (rows, kchunk) == (128, 16) and smem <= kernels.SMEM_BLOCK_BYTES
    # cT, csq, the x tile, the (key, weight) pairs and the accumulator
    assert smem == 4 * (16 * 100 + 16 + 128 * 101 + 2 * 128 + 10 * 101)
    # room for 3 such blocks in an SM
    assert 3 * (smem + BLOCK_RESERVED_BYTES) <= SM_SMEM_BYTES
    assert kernels.lloyd_kernel_fits(10, 100) and kernels.assign_kernel_fits(10, 100)
    # wide k: assign scores centroids chunk by chunk, so any k fits
    rows, kchunk, _ = kernels._layout(5000, 100, lloyd=False)
    assert kchunk < 5000 and kernels.assign_kernel_fits(100_000, 100)
    # Lloyd's (k, d+1) accumulator must fit a block's shared memory
    assert not kernels.lloyd_kernel_fits(1000, 100)
    # a tile of very wide rows does not fit at all
    assert not kernels.assign_kernel_fits(10, 4096)
    for k, d in [(3, 7), (300, 100), (64, 512)]:
        for lloyd in (False, True):
            layout = kernels._layout(k, d, lloyd)
            if layout is not None:
                rows, kchunk, smem = layout
                assert rows % 32 == 0 and kchunk % 16 == 0
                assert smem <= kernels.SMEM_BLOCK_BYTES



def test_layout_largest_lloyd_k_at_d100():
    # the (k, d+1) accumulator sets the gate: at d = 100 the largest k runs
    # 32-row tiles of one 16-centroid chunk, and one more does not fit
    rows, kchunk, smem = kernels._layout(526, 100, lloyd=True)
    assert (rows, kchunk) == (32, 16)
    assert smem == 4 * (16 * 100 + 16 + 32 * 101 + 2 * 32 + 526 * 101)
    assert smem <= kernels.SMEM_BLOCK_BYTES
    assert kernels.lloyd_kernel_fits(526, 100)
    assert not kernels.lloyd_kernel_fits(527, 100)
