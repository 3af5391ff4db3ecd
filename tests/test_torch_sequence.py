"""Sequence-parallel attention of the port against the JAX package: ring and
Ulysses attention over 8 virtual ``seq`` shards against JAX's
``full_attention`` and ``sharded_attention`` (L = 64, H = 8, D = 16, and a
causal L = 512), at rtol 5e-4, atol 5e-5, the JAX test's tolerance for the
long sequence; and the same over two gloo ranks, where the rotation is
``batch_isend_irecv`` and the all-to-all ``all_to_all_single``."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_ml_tpu.parallel import create_mesh as jax_create_mesh
from flink_ml_tpu.parallel.sequence import full_attention as jax_full
from flink_ml_tpu.parallel.sequence import sharded_attention as jax_sharded

from flink_ml_tpu_torch.parallel import create_mesh
from flink_ml_tpu_torch.parallel import distributed as dist_mod
from flink_ml_tpu_torch.parallel.sequence import (full_attention,
                                                  ring_attention,
                                                  sharded_attention)

RTOL, ATOL = 5e-4, 5e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _qkv(seed, L, H=8, D=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(L, H, D)).astype(np.float32)
                 for _ in range(3))


@pytest.fixture(scope="module")
def seq8():
    return create_mesh((8,), ("seq",), devices=["cpu"] * 8)


def _jax_full(q, k, v, causal):
    return np.asarray(jax_full(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal))


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("L,causal", [(64, False), (64, True), (512, True)])
def test_sharded_attention_matches_jax(seq8, kind, L, causal):
    q, k, v = _qkv(L + causal, L)
    want = _jax_full(q, k, v, causal)
    got = sharded_attention(seq8, q, k, v, kind=kind, causal=causal)
    assert got.shape == (L, 8, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    jax_got = np.asarray(jax_sharded(jax_create_mesh(axis_names=("seq",)),
                                     q, k, v, kind=kind, causal=causal))
    np.testing.assert_allclose(got.numpy(), jax_got, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_full_attention_matches_jax(causal):
    q, k, v = _qkv(3, 64)
    got = full_attention(*(torch.as_tensor(t) for t in (q, k, v)),
                         causal=causal)
    np.testing.assert_allclose(got.numpy(), _jax_full(q, k, v, causal),
                               rtol=RTOL, atol=ATOL)


def test_ring_blocks_stay_local(seq8):
    """Ring attention's shards take (L/P, H, Dh) blocks and give blocks
    back; no (L, L) score matrix is formed."""
    q, k, v = (torch.as_tensor(t) for t in _qkv(5, 64))
    blocks = [list(t.split(8)) for t in (q, k, v)]
    out = ring_attention(*blocks, seq8, causal=True)
    assert [tuple(o.shape) for o in out] == [(8, 8, 16)] * 8
    np.testing.assert_allclose(torch.cat(out).numpy(),
                               full_attention(q, k, v, causal=True).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_errors_match_jax(seq8):
    q, k, v = _qkv(0, 64)
    with pytest.raises(ValueError, match="unknown attention kind"):
        sharded_attention(seq8, q, k, v, kind="flash")
    odd = [t[:60] for t in (q, k, v)]
    with pytest.raises(ValueError, match="divisible"):
        sharded_attention(seq8, *odd)
    few = [t[:, :4] for t in (q, k, v)]
    with pytest.raises(ValueError, match="ulysses"):
        sharded_attention(seq8, *few, kind="ulysses")
    # ring takes heads that do not divide the axis
    got = sharded_attention(seq8, *few, kind="ring")
    np.testing.assert_allclose(got.numpy(), _jax_full(*few, False),
                               rtol=RTOL, atol=ATOL)


_RANK_PROGRAM = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from flink_ml_tpu_torch.parallel import distributed
from flink_ml_tpu_torch.parallel.mesh import Mesh
from flink_ml_tpu_torch.parallel.sequence import sharded_attention

assert distributed.init_from_env()
rank = distributed.process_index()
mesh = Mesh(["cpu"] * 2, ("seq",), group=dist.group.WORLD, rank=rank,
            processes=2)
data = np.load(sys.argv[1])
out = {}
for kind in ("ring", "ulysses"):
    for causal in (False, True):
        got = sharded_attention(mesh, data["q"], data["k"], data["v"],
                                kind=kind, causal=causal)
        out[f"{kind}-{int(causal)}"] = got.numpy()
np.savez(sys.argv[2] + f"-{rank}.npz", **out)
dist.destroy_process_group()
"""


def test_two_gloo_ranks_ring_and_ulysses(tmp_path):
    """Two launched CPU ranks: ring attention rotates K/V with
    batch_isend_irecv, Ulysses re-shards with all_to_all_single; both agree
    with the JAX oracle on every rank."""
    q, k, v = _qkv(9, 64)
    np.savez(tmp_path / "qkv.npz", q=q, k=k, v=v)
    # one intra-op thread a rank: the blocks are tiny
    env = {"PYTHONPATH": os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]), "OMP_NUM_THREADS": "1"}
    records = dist_mod.launch(
        [sys.executable, "-c", _RANK_PROGRAM, str(tmp_path / "qkv.npz"),
         str(tmp_path / "out")], 2, env=env, timeout=60.0, device="cpu")
    assert [r["returncode"] for r in records] == [0, 0], json.dumps(
        [r["stderr"][-1500:] for r in records])
    for rank in range(2):
        with np.load(tmp_path / f"out-{rank}.npz") as got:
            for key in got.files:
                want = _jax_full(q, k, v, key.endswith("1"))
                np.testing.assert_allclose(got[key], want, rtol=RTOL,
                                           atol=ATOL, err_msg=key)
