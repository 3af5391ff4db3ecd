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


def test_reduce_partials_plain_adds_in_order():
    rng = np.random.default_rng(5)
    p = torch.from_numpy(rng.normal(size=(9, 3, 4)).astype(np.float32))
    want = p[0].clone()
    for b in range(1, 9):
        want += p[b]
    assert torch.equal(kernels.lloyd_reduce_partials(p), want)


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


def test_layout_gate_main_path_and_limits():
    # the KMeans benchmark shape fits one 128-row tile with all 10 centroids
    rows, kchunk, smem = kernels._layout(10, 100, lloyd=True)
    assert (rows, kchunk) == (128, 16) and smem <= kernels.SMEM_BLOCK_BYTES
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
