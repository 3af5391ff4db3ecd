"""The port's segment sums at the FTRL sparse path's layouts, and the plan
its kernels follow on the card, held on the CPU.

The same numpy inputs, made from a seed, go through the JAX package's
Pallas ``segment_reduce_sum`` in interpret mode (as
tests/test_pallas_kernels.py runs it) and the port's wrapper on CPU tensors,
which runs the kernel's plain version. The plan (:func:`segment_plan_plain`,
the mirror of what ``csrc/segment_kernels.cu`` computes on the card) is
checked for what the kernels rely on: every row with an in-range id lies in
exactly one item of its tile, inside the item's segment range; a chunk that
misses a tile holds no id of it; and the items' sums, combined as the
combine kernel does, give the plain sums.

Tolerances: segment sums rtol 1e-5, atol 1e-5 (float32 sums of up to a few
hundred terms in another order; the plain version sums in float64); sums of
small integers, which every order adds exactly, are compared exactly.
"""

import numpy as np
import pytest
import torch

from flink_ml_tpu.ops import pallas_kernels as pk
from flink_ml_tpu_torch.ops import kernels

SUM_RTOL, SUM_ATOL = 1e-5, 1e-5
#: tile blocks an H100 holds at once: 3 a SM at the segment kernel's 64 KB
#: accumulators, 16 a SM for small ones (thread-bound)
RESIDENT_WIDE, RESIDENT_SMALL = 396, 2112


def _ftrl_dots_ids(rows, nnz_per_row, n, rng=None):
    """The per-row dots' ids as ``_pack_csr_shards`` lays them out: each
    row's stored values in row order, then padding slots with id 0 (their
    values are 0), n in all; and the number of stored values. ``rng`` draws
    a ragged count of values per row."""
    if rng is None:
        counts = np.full(rows, nnz_per_row)
    else:
        counts = rng.integers(1, 2 * nnz_per_row, size=rows)
    ids = np.repeat(np.arange(rows, dtype=np.int32), counts)
    assert ids.size <= n
    return np.concatenate([ids, np.zeros(n - ids.size, np.int32)]), ids.size


def _ftrl_case(case, rng):
    n = 8192
    if case == "dots":  # 700 rows of 10 values, u = 1,024, padding to 8,192
        ids, stored = _ftrl_dots_ids(700, 10, n)
    elif case == "dots ragged rows":
        ids, stored = _ftrl_dots_ids(900, 8, n, rng)
    if case.startswith("dots"):
        vals = rng.normal(size=n).astype(np.float32)
        vals[stored:] = 0.0
        return vals, ids, 1024
    # the per-coordinate gradient and weight sums: two value columns
    ids = rng.integers(0, 50, size=n).astype(np.int32)
    return rng.normal(size=(n, 2)).astype(np.float32), ids, 50


@pytest.mark.parametrize("case", ["dots", "dots ragged rows", "gradient"])
def test_segment_reduce_matches_pallas_at_ftrl_layouts(case):
    vals, ids, u = _ftrl_case(case, np.random.default_rng(41))
    want = np.asarray(pk.segment_reduce_sum(vals, ids, u, interpret=True))
    got = kernels.segment_reduce_sum(torch.from_numpy(vals),
                                     torch.from_numpy(ids), u)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=SUM_RTOL,
                               atol=SUM_ATOL)


def _plan_cases():
    rng = np.random.default_rng(5)
    n = 50_000
    sorted_pad, _ = _ftrl_dots_ids(4_000, 11, n)
    wide = rng.integers(-3, (1 << 15) + 3, size=n).astype(np.int32)
    clustered = np.sort(rng.integers(0, 20_000, size=n)).astype(np.int32)
    clustered[::97] = -1  # -1 padding scattered through sorted ids
    clustered[5::101] = 25_000  # out of range
    return [
        ("sorted rows + padding", sorted_pad, 8_192, 1, RESIDENT_WIDE),
        ("sorted rows + padding, 2 columns", sorted_pad, 8_192, 2,
         RESIDENT_WIDE),
        ("random wide domain", wide, 1 << 15, 1, RESIDENT_WIDE),
        ("sorted with -1 and out-of-range", clustered, 20_000, 1,
         RESIDENT_WIDE),
        ("one tile", rng.integers(-1, 90, size=n).astype(np.int32), 80, 2,
         RESIDENT_SMALL),
        ("few rows", np.array([3, 9_000, -1, 9_000, 17], np.int32), 9_001, 1,
         RESIDENT_WIDE),
    ]


@pytest.mark.parametrize("tag,ids,u,c,resident", _plan_cases(),
                         ids=[case[0] for case in _plan_cases()])
def test_segment_plan_covers_every_row_once(tag, ids, u, c, resident):
    plan = kernels.segment_plan_plain(torch.from_numpy(ids), u, c, resident)
    assert len(plan.items) == plan.tiles
    rows = plan.rows_per_chunk
    chunk_of = np.arange(ids.size) // rows
    for t, items in enumerate(plan.items):
        s0, s1 = t * plan.ut, min(u, (t + 1) * plan.ut)
        in_tile = (ids >= s0) & (ids < s1)
        touched = set(chunk_of[in_tile].tolist())
        assert len(items) <= plan.slots
        if touched:
            assert items
        met = [b for part, _, _, _ in items for b in part]
        # the items cut the chunks that meet the tile, in order, once each
        assert met == sorted(set(met))
        if plan.ranges is not None:
            lo, hi = plan.ranges[:, 0].numpy(), plan.ranges[:, 1].numpy()
            assert met == [b for b in range(plan.chunks)
                           if lo[b] < s1 and hi[b] >= s0]
        # a chunk that misses the tile holds no id of it
        assert touched <= set(met)
        for part, a, e, _ in items:
            assert part and 0 <= a < e <= s1 - s0
            rows_in = np.isin(chunk_of, part) & in_tile
            local = ids[rows_in] - s0
            assert local.size == 0 or (local.min() >= a and local.max() < e)


@pytest.mark.parametrize("tag,ids,u,c,resident", _plan_cases(),
                         ids=[case[0] for case in _plan_cases()])
def test_segment_plan_sums_equal_the_plain_sums(tag, ids, u, c, resident):
    # small integers: every order of adding gives the same float32 sums
    rng = np.random.default_rng(ids.size + u)
    vals = rng.integers(-20, 20, size=(ids.size, c)).astype(np.float32)
    plan = kernels.segment_plan_plain(torch.from_numpy(ids), u, c, resident)
    rows = plan.rows_per_chunk
    chunk_of = np.arange(ids.size) // rows
    out = np.zeros((u, c))
    for t, items in enumerate(plan.items):
        s0, s1 = t * plan.ut, min(u, (t + 1) * plan.ut)
        for part, a, e, _ in items:
            # the item's slab: its chunks' rows with ids in [s0 + a, s0 + e)
            slab = np.zeros((e - a, c))
            keep = np.isin(chunk_of, part) & (ids >= s0 + a) & (ids < s0 + e)
            np.add.at(slab, ids[keep] - s0 - a, vals[keep])
            out[s0 + a:s0 + e] += slab
    want = kernels.segment_reduce_sum(torch.from_numpy(vals),
                                      torch.from_numpy(ids), u)
    np.testing.assert_array_equal(out, want.numpy())


def test_segment_plan_reads_sorted_ids_a_bounded_number_of_times():
    # the FTRL per-row dots: 100,000 rows of 10 values, padded with id 0 to
    # 1,048,576 slots, over 131,072 segments
    ids = torch.from_numpy(_ftrl_dots_ids(100_000, 10, 1 << 20)[0])
    plan = kernels.segment_plan_plain(ids, 1 << 17, 1, RESIDENT_WIDE)
    assert (plan.tiles, plan.chunks, plan.slots) == (32, 1024, 25)
    met = np.zeros(plan.chunks, int)
    for items in plan.items:
        for part, _, _, scan in items:
            met[list(part)] += 1
            # ten values a row, padding: long runs, summed by scans
            assert scan
    # a chunk is read once for every tile it meets: once or twice, except
    # the one chunk that holds the last row and the first padding slots
    assert met.min() == 1 and int((met > 2).sum()) == 1
    assert met.sum() <= plan.chunks + plan.tiles + 25
    # every tile with rows spreads its work over several items
    assert all(len(items) >= 2 for items in plan.items[:24])
    # a random wide domain: every chunk meets every tile, slots per tile
    wide = torch.from_numpy(np.random.default_rng(1).integers(
        0, 1 << 18, size=1 << 20).astype(np.int32))
    plan = kernels.segment_plan_plain(wide, 1 << 18, 1, RESIDENT_WIDE)
    assert all(len(items) == plan.slots for items in plan.items)
    # random ids: runs of one row, no scans
    assert not any(scan for items in plan.items for *_, scan in items)
    assert plan.tiles * plan.slots >= 2 * RESIDENT_WIDE
