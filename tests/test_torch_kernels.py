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
    # the KMeans benchmark shape keeps the fused kernels' 128-row tile with
    # all 10 centroids, byte for byte the layout it had
    plan = kernels.kmeans_plan(1_000_000, 10, 100, True)
    assert plan.route == "fused"
    assert (plan.rows, plan.kchunk, plan.smem) == (
        128, 16, 4 * (16 * 100 + 16 + 128 * 101 + 2 * 128 + 10 * 101))
    assert plan.smem <= kernels.SMEM_BLOCK_BYTES
    # room for 3 such blocks in an SM
    assert 3 * (plan.smem + BLOCK_RESERVED_BYTES) <= SM_SMEM_BYTES
    assert kernels.kmeans_plan(1_000_000, 10, 100, False).route == "fused"
    # the hand-over in k·d, measured on the card: up to 6,400 fused, more
    # tiled, for both kernels
    assert kernels.FUSED_MAX_KD == 6_400
    for lloyd in (False, True):
        for k, d, route in [(64, 100, "fused"), (65, 100, "tiled"),
                            (25, 256, "fused"), (26, 256, "tiled"),
                            (5000, 100, "tiled"), (3200, 2, "fused"),
                            (3201, 2, "tiled")]:
            assert kernels.kmeans_plan(50_000, k, d, lloyd).route == route
    # the hand-over in d: a 128-row x tile and a 16-centroid chunk fit one
    # block up to d = 403 (assign) and d = 375 (Lloyd, k = 10); wider rows
    # take the tiled route at any k
    assert kernels.kmeans_plan(10_000, 10, 403, False).route == "fused"
    assert kernels.kmeans_plan(10_000, 10, 404, False).route == "tiled"
    assert kernels.kmeans_plan(10_000, 10, 375, True).route == "fused"
    assert kernels.kmeans_plan(10_000, 10, 376, True).route == "tiled"
    # fused tiles whose 32-centroid chunk does not fit beside the x tile
    # score their centroids in chunks of 16
    assert kernels.kmeans_plan(50_000, 17, 370, False)[:2] == ("fused", 128)
    assert kernels.kmeans_plan(50_000, 17, 370, False).kchunk == 16
    assert kernels.kmeans_plan(50_000, 18, 340, True)[:2] == ("fused", 128)
    assert kernels.kmeans_plan(50_000, 18, 340, True).kchunk == 16
    tiled = kernels.kmeans_plan(10_000, 10, 4096, False)
    assert (tiled.route, tiled.dpad, tiled.kp) == ("tiled", 4096, 64)
    assert tiled.smem == kernels.label_smem_bytes(64, 4096) <= \
        kernels.SMEM_BLOCK_BYTES
    for k, d in [(3, 7), (300, 100), (64, 512)]:
        for lloyd in (False, True):
            p = kernels.kmeans_plan(1000, k, d, lloyd)
            assert p.smem <= kernels.SMEM_BLOCK_BYTES
            if p.route == "fused":
                assert p.rows == 128 and p.kchunk % 16 == 0


def test_layout_largest_lloyd_k_at_d100():
    # at d = 100 the fused Lloyd kernel takes 64 centroids at most (k·d up
    # to the measured 6,400), staged in one chunk; its (k, d+1) accumulator
    # would fit beside the 128-row tile up to k = 428, but the tiled route
    # is faster from k·d = 8,000; one more centroid takes the tiled route
    plan = kernels.kmeans_plan(1_000_000, 64, 100, True)
    assert (plan.route, plan.rows, plan.kchunk) == ("fused", 128, 64)
    assert plan.smem == 4 * (64 * 100 + 64 + 128 * 101 + 2 * 128
                             + 64 * 101)
    assert plan.smem <= kernels.SMEM_BLOCK_BYTES
    assert kernels._fused_layout(428, 100, True) is not None
    assert kernels._fused_layout(429, 100, True) is None
    tiled = kernels.kmeans_plan(1_000_000, 65, 100, True)
    assert tiled.route == "tiled"
    assert (tiled.dpad, tiled.kp, tiled.chunk_rows, tiled.label_tile) == (
        128, 128, 2048, 96)


# (k, d) up to k = 65,536 and d = 8,192: the main shape, the hand-overs,
# the widths of phase 24 and of the tile engine's edges
PLAN_KS = (1, 2, 10, 16, 17, 32, 33, 64, 100, 102, 103, 128, 129, 428, 429,
           1000, 1024, 1025, 4096, 65_536)
PLAN_DS = (1, 7, 31, 32, 100, 128, 129, 375, 376, 403, 404, 512, 768, 1536,
           1537, 4096, 8192)


@pytest.mark.parametrize("d", PLAN_DS)
@pytest.mark.parametrize("k", PLAN_KS)
def test_kmeans_plan_fits_every_shape(k, d):
    """Every (k, d) has a launch on the card whose shared memory fits a
    block and whose offsets fit the kernels' fields; the tiled Lloyd
    route's device memory stays O(n + k·d)."""
    for lloyd in (False, True):
        for n in (1, 10_007, 1_000_000, kernels.INT32_MAX):
            p = kernels.kmeans_plan(n, k, d, lloyd)
            assert 0 < p.smem <= kernels.SMEM_BLOCK_BYTES
            if p.route == "fused":
                assert (p.rows, p.kchunk % 16) == (128, 0)
                # the entries' 16-bit offsets: accumulator and x tile
                limit = 1 << kernels.FUSED_OFF_BITS
                assert 128 * (d | 1) < limit
                assert not lloyd or k * (d + 1) < limit
                continue
            assert p.route == "tiled"
            assert p.dpad % 32 == 0 and d <= p.dpad < d + 32
            if k <= 64:  # the label body's 64-centroid tile
                assert p.kp == 64
            else:
                assert p.kp % 128 == 0 and k <= p.kp < k + 128
            assert p.smem >= kernels.label_smem_bytes(min(p.kp, 128),
                                                      p.dpad)
            # TMA coordinates and the labels' grid are 32-bit
            assert p.kp <= kernels.INT32_MAX and p.dpad <= kernels.INT32_MAX
            assert -(-n // kernels.TILE_ROWS) <= kernels.INT32_MAX
            if not lloyd:
                continue
            # row ids and places are int32
            assert n <= kernels.INT32_MAX
            assert p.chunk_rows % 256 == 0 and p.chunk_rows >= k
            assert p.nchunks == -(-n // p.chunk_rows)
            m = k * p.nchunks
            assert m <= n + k
            assert 4 * kernels.SORT_WARPS * p.label_tile <= p.smem
            assert -(-k // p.label_tile) <= 65_535
            assert 1 <= p.scan_blocks <= kernels.SCAN_MAX_BLOCKS
            assert (p.scan_blocks - 1) * p.scan_span < m
            assert p.scan_blocks * p.scan_span >= m
            assert p.piece_rows % 32 == 0
            assert p.pieces == -(-n // p.piece_rows)
            assert p.pieces <= k + n // (d + 1) + 2
            # the scratch, 2 (d + 1) floats a piece, is O(n + k d)
            assert 2 * p.pieces * (d + 1) <= 2 * (n + (k + 2) * (d + 1))
            assert 32 <= p.col_threads <= 256 and p.col_threads % 32 == 0
            assert -(-(d + 1) // p.col_threads) <= 65_535


def _labels_of(seed, n, k, skew=None):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k, n)
    if skew is not None:  # nearly every row takes one centroid
        labels = np.where(rng.random(n) < skew, k // 2, labels)
    return torch.from_numpy(labels.astype(np.int32))


@pytest.mark.parametrize("n,k,chunk_rows,skew", [
    (5000, 7, 2048, None), (4097, 300, 2048, None), (3000, 2500, 2560, None),
    (6000, 50, 2048, 0.98), (1, 3, 2048, None)])
def test_sort_by_label_plain_is_a_stable_counting_sort(n, k, chunk_rows, skew):
    labels = _labels_of(n + k, n, k, skew)
    offs, order = kernels.sort_by_label_plain(labels, k, chunk_rows)
    nchunks = -(-n // chunk_rows)
    assert offs.dtype == torch.int32 and offs.shape == (k * nchunks,)
    assert order.dtype == torch.int32 and sorted(order.tolist()) == list(
        range(n))
    lab = labels.numpy()
    ords = order.numpy()
    # label by label, ascending rows within a label
    assert np.all(np.diff(lab[ords]) >= 0)
    same = lab[ords][1:] == lab[ords][:-1]
    assert np.all(np.diff(ords)[same] > 0)
    # offs[l, c] is where chunk c's rows of label l begin
    table = offs.numpy().reshape(k, nchunks)
    for l in range(k):
        for c in range(nchunks):
            rows = np.nonzero((lab == l) & (np.arange(n) // chunk_rows == c))[0]
            if rows.size:
                at = table[l, c]
                assert list(ords[at:at + rows.size]) == list(rows)
    counts = np.bincount(lab, minlength=k)
    np.testing.assert_array_equal(table[:, 0],
                                  np.concatenate([[0], np.cumsum(counts)[:-1]]))


@pytest.mark.parametrize("n,d,k,piece_rows,skew,zero_share", [
    (3000, 6, 5, 256, None, 0.0),      # every label spans pieces
    (2000, 9, 400, 256, None, 0.2),    # most labels within one piece
    (5000, 4, 20, 256, 0.97, 0.0),     # one label holds nearly every row
    (700, 3, 1000, 64, None, 0.5),     # empty labels, half the weights 0
    (1, 5, 3, 256, None, 0.0)])
def test_piece_sums_plain_matches_lloyd_plain(n, d, k, piece_rows, skew,
                                              zero_share):
    rng = np.random.default_rng(n + d + k)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    v = torch.from_numpy((rng.random(n) >= zero_share).astype(np.float32))
    labels = _labels_of(n * k, n, k, skew)
    offs, order = kernels.sort_by_label_plain(labels, k, 2048)
    nchunks = -(-n // 2048)
    out, scratch = kernels.piece_sums_plain(x, v, labels, order, offs,
                                            nchunks, piece_rows)
    one_hot = torch.nn.functional.one_hot(labels.long(), k).float() * v[:, None]
    want = torch.cat([one_hot.T @ x, one_hot.sum(0)[:, None]], dim=1)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    # a long label's parts, slot 0 where they begin a piece, sum to its row
    starts = offs.view(k, nchunks)[:, 0].long()
    ends = torch.cat([starts[1:], torch.tensor([n])])
    for l in range(k):
        s, e = int(starts[l]), int(ends[l])
        if e == s or s // piece_rows == (e - 1) // piece_rows:
            continue
        q0, q1 = s // piece_rows, (e - 1) // piece_rows
        parts = [scratch[q0, 0 if s == q0 * piece_rows else 1]]
        parts += [scratch[q, 0] for q in range(q0 + 1, q1 + 1)]
        total = torch.stack(parts).sum(0)
        assert torch.isfinite(total).all()
        np.testing.assert_allclose(total.numpy(), want[l].numpy(), rtol=RTOL,
                                   atol=ATOL)
    assert k * (d + 1) <= out.numel()


def test_the_tiled_stages_compose_to_lloyd_plain():
    # labels, then the sort, then the pieces: the plain twins of the tiled
    # route's stages give lloyd_partial_sums_plain at a shape the fused
    # tile does not take (k = 1,000 at d = 100), with the card's plan
    x, c, rng = _separated(21, 3000, 100, 1000)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    v = torch.from_numpy((rng.random(3000) >= 0.1).astype(np.float32))
    plan = kernels.kmeans_plan(3000, 1000, 100, True)
    assert plan.route == "tiled"
    labels = kernels.assign_nearest_plain(xt, ct)
    offs, order = kernels.sort_by_label_plain(labels, 1000, plan.chunk_rows)
    out, _ = kernels.piece_sums_plain(xt, v, labels, order, offs,
                                      plan.nchunks, plan.piece_rows)
    want = kernels.lloyd_partial_sums_plain(xt, v, ct)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(out[:, -1].numpy(), want[:, -1].numpy())


@pytest.mark.parametrize("k,kp", [(1, 64), (10, 64), (64, 64), (65, 128),
                                  (128, 128), (129, 256), (1024, 1024)])
def test_kmeans_plan_small_tile_at_wide_rows(k, kp):
    """Up to 64 centroids take the label body's 64-centroid tile at wide
    rows, so none is padded past 64; more pad to a multiple of 128. Both
    instances keep two blocks on an SM: their shared memory (a ring of four
    (64-centroid tile) or three stages of an x box and a centroid box, or
    the resident x tile of up to 128 columns and the centroid boxes) fits
    half of one."""
    for d in (768, 770, 1536):
        for lloyd in (False, True):
            plan = kernels.kmeans_plan(1_000_000, k, d, lloyd)
            assert (plan.route, plan.kp) == ("tiled", kp)
    tn = min(kp, kernels.TILE_CENTROIDS)
    stages = kernels.label_stages(tn)
    assert stages == (4 if tn == 64 else 3)
    smem = kernels.label_smem_bytes(tn, 768)
    assert smem == 1024 + 4 * stages * (128 * 32 + 32 * tn) + 16 * stages
    assert 2 * (smem + BLOCK_RESERVED_BYTES) <= SM_SMEM_BYTES
    for dpad in (32, 128):
        smem = kernels.label_smem_bytes(tn, dpad)
        assert smem == 128 + 4 * (dpad * 128 + stages * 32 * tn) + 16 * stages
        assert 2 * (smem + BLOCK_RESERVED_BYTES) <= SM_SMEM_BYTES


# shapes of the tiled route, where the fused tile does not fit: (n, d, k);
# d = 770 rows are no multiple of 16 bytes, which the card copies by
# cp.async in place of TMA
TILED_ASSIGN = [(2048, 768, 64), (1030, 1536, 40), (1030, 770, 1),
                (1030, 770, 65)]
TILED_LLOYD = [(2048, 768, 64), (1500, 512, 100), (1030, 770, 1),
               (1030, 770, 65)]


@pytest.mark.parametrize("n,d,k", TILED_ASSIGN)
def test_assign_nearest_on_the_tiled_route_matches_pallas(n, d, k):
    assert kernels.kmeans_plan(n, k, d, False).route == "tiled"
    x, c, _ = _separated(n + d + k, n, d, k)
    want = np.asarray(pk.assign_nearest(x, c, interpret=True))
    got = kernels.assign_nearest(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,d,k", TILED_LLOYD)
def test_lloyd_partial_sums_on_the_tiled_route_matches_pallas(n, d, k):
    plan = kernels.kmeans_plan(n, k, d, True)
    assert plan.route == "tiled"
    x, c, rng = _separated(7 * n + d, n, d, k)
    v = (rng.random(n) >= 0.1).astype(np.float32)
    want = np.asarray(pk.lloyd_partial_sums(x, v, c, interpret=True))
    xt, vt, ct = torch.from_numpy(x), torch.from_numpy(v), torch.from_numpy(c)
    got = kernels.lloyd_partial_sums(xt, vt, ct).numpy()
    np.testing.assert_allclose(got[:, :-1], want[:, :-1], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[:, -1], want[:, -1])
    # the tiled route's stages, each by its plain twin
    labels = kernels.assign_nearest_plain(xt, ct)
    offs, order = kernels.sort_by_label_plain(labels, k, plan.chunk_rows)
    staged, _ = kernels.piece_sums_plain(xt, vt, labels, order, offs,
                                         plan.nchunks, plan.piece_rows)
    np.testing.assert_allclose(staged[:, :-1].numpy(), want[:, :-1],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(staged[:, -1].numpy(), want[:, -1])


@pytest.mark.parametrize("n,d,k", [(1_000_000, 100, 10), (3000, 100, 1000),
                                   (2048, 768, 64), (1030, 1536, 40)])
def test_cuda_tensors_take_the_planned_route(monkeypatch, n, d, k):
    """On a CUDA tensor (simulated) each wrapper launches the route its plan
    names, counts one launch, and only the fused Lloyd route adds its
    reduce_partials."""
    x, c = torch.zeros((4, d)), torch.zeros((k, d))
    v = torch.ones(4)
    calls = []
    plan = kernels.kmeans_plan  # the plan of n rows, for the 4 rows given
    monkeypatch.setattr(kernels, "_is_cuda", lambda t: True)
    monkeypatch.setattr(kernels, "kmeans_plan",
                        lambda _, k_, d_, lloyd: plan(n, k_, d_, lloyd))
    monkeypatch.setattr(kernels, "_launch_assign",
                        lambda *a: calls.append("fused-assign") or
                        torch.zeros(4, dtype=torch.int32))
    monkeypatch.setattr(kernels, "_launch_assign_tiled",
                        lambda *a: calls.append("tiled-assign") or
                        torch.zeros(4, dtype=torch.int32))
    monkeypatch.setattr(kernels, "_launch_lloyd_partials",
                        lambda *a: calls.append("fused-lloyd") or
                        torch.zeros((3, k, d + 1)))
    monkeypatch.setattr(kernels, "_launch_lloyd_sorted",
                        lambda *a: calls.append("tiled-lloyd") or
                        (torch.zeros((k, d + 1)), {}))
    monkeypatch.setattr(kernels, "_launch_reduce",
                        lambda p: calls.append("reduce") or p.sum(0))
    kernels.reset_launch_counts()
    try:
        kernels.assign_nearest(x, c)
        kernels.lloyd_partial_sums(x, v, c)
        counts = dict(kernels.launch_counts)
    finally:
        kernels.reset_launch_counts()
    assign, lloyd = plan(n, k, d, False).route, plan(n, k, d, True).route
    want = [f"{assign}-assign", f"{lloyd}-lloyd"]
    if lloyd == "fused":
        want.append("reduce")
    assert calls == want
    assert counts["assign_nearest"] == counts["lloyd_partial_sums"] == 1
    assert counts["reduce_partials"] == (lloyd == "fused")


def test_library_key_covers_the_shared_headers(tmp_path, monkeypatch):
    """A source's library name hashes every header of csrc/ too, so an
    edited tile_engine.cuh builds kmeans_kernels.cu and knn_kernels.cu
    anew instead of loading a stale library."""
    from flink_ml_tpu_torch.ops import _build

    for source in (kernels.KMEANS_SOURCE, kernels.KNN_SOURCE):
        text = (_build.CSRC_DIR / f"{source}.cu").read_text()
        assert '#include "tile_engine.cuh"' in text
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.library_path("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path("k") != first
    (tmp_path / "h.cuh").write_text("// one\n")
    assert _build.library_path("k") == first
    (tmp_path / "other.cuh").write_text("// three\n")
    assert _build.library_path("k") != first
