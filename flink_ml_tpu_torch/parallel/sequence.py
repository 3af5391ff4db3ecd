"""Sequence parallelism: ring attention and Ulysses all-to-all attention.

The port of ``flink_ml_tpu/parallel/sequence.py:40-187``. The reference has
no sequence models; this is the long-context capability the JAX package
adds. The sequence dim of q, k and v, each (L, H, Dh), is split over the
``seq`` axis of a mesh (``create_mesh((P,), ("seq",), devices=...)``):

- :func:`ring_attention`: each shard folds one K/V block a step into an
  online-softmax state (running max, denominator, weighted sum) while the
  blocks rotate one hop around the ring; causal masks come from global
  positions. No shard ever holds more than an (H, L/P, L/P) score block.
- :func:`ulysses_attention`: an all-to-all from sequence-parallel to
  head-parallel (H/P heads of the whole sequence a shard), dense attention,
  and the all-to-all back; needs ``H % P == 0``.
- :func:`full_attention`: the one-device oracle.

The functions take and return lists of this process's shards' (L/P, H, Dh)
blocks. On an in-process mesh (virtual shards on one card or on the CPU)
the rotation and the all-to-all are re-indexing of the shards' tensors: the
block resident at shard ``i`` after ``j`` steps is shard ``(i - j) % P``'s.
Under ``torch.distributed`` a rank holds ``P / ranks`` consecutive shards.
A ring hop between two shards of one rank is a re-index; the hop across
ranks is one ``batch_isend_irecv`` a step, which sends the rank's last
shard's block to the next rank and receives its first shard's from the
previous one, every send and receive of the step posted in one batch.
Ulysses' all-to-all is one ``all_to_all_single`` a step over the rank's
shard chunks, laid out in the global shard order. gloo takes CUDA tensors
for the all-to-all but not for send/recv, so on a gloo group the ring's
hops of CUDA blocks go through pinned host buffers, each counted in
``ml.collective stagedOps{op="send_recv"}``.
No Pallas kernel exists for this path in the JAX package, so the port's
einsum and softmax are plain PyTorch, as the JAX package's are plain XLA.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from flink_ml_tpu_torch.parallel import collective as _c
from flink_ml_tpu_torch.parallel.mesh import SEQ_AXIS, Mesh

__all__ = ["SEQ_AXIS", "ring_attention", "ulysses_attention",
           "full_attention", "sharded_attention"]


def _block_scores(q, k_blk, scale, mask):
    """(H, L, M) attention scores of local q against one K block."""
    scores = torch.einsum("lhd,mhd->hlm", q, k_blk) * scale
    if mask is not None:
        scores = torch.where(mask, scores, float("-inf"))
    return scores


def _fold(q, k_blk, v_blk, m, l, o, scale, mask):
    """Fold one K/V block into the online-softmax state ``(m, l, o)``."""
    scores = _block_scores(q, k_blk, scale, mask)            # (H, L, M)
    m_new = torch.maximum(m, scores.amax(dim=-1))            # (H, L)
    # guard fully-masked rows (m_new == -inf)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    correction = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                       float("-inf")))
    probs = torch.exp(scores - m_safe[:, :, None])
    probs = torch.where(torch.isfinite(scores), probs, 0.0)
    l_new = l * correction + probs.sum(dim=-1)
    o_new = (o * correction[:, :, None]
             + torch.einsum("hlm,mhd->hld", probs, v_blk))
    return m_new, l_new, o_new


def _axis_size(mesh: Mesh, axis_name: str) -> int:
    return mesh.shape[axis_name]


def _rotate(mesh: Mesh, k_blk, v_blk):
    """One hop of the ring under ``torch.distributed``: send to the next
    rank, receive from the previous one. gloo's send/recv does not take
    CUDA tensors, so on a gloo group CUDA blocks hop through pinned host
    buffers, counted."""
    import torch.distributed as dist

    p = mesh.processes
    nxt, prv = (mesh.rank + 1) % p, (mesh.rank - 1) % p
    send = [k_blk.contiguous(), v_blk.contiguous()]
    staged = k_blk.is_cuda and not _c._is_nccl(mesh)
    if staged:
        send = [torch.empty(t.shape, dtype=t.dtype,
                            pin_memory=True).copy_(t) for t in send]
    recv = [torch.empty_like(t) for t in send]
    ops = ([dist.P2POp(dist.isend, t, nxt, group=mesh.group) for t in send]
           + [dist.P2POp(dist.irecv, t, prv, group=mesh.group)
              for t in recv])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        _c._collective_group().counter("stagedOps",
                                       labels={"op": "send_recv"})
        recv = [t.to(k_blk.device) for t in recv]
    return recv[0], recv[1]


def _hop(mesh: Mesh, resident: list) -> list:
    """One hop of the ring over this rank's shards' resident (k, v)
    blocks: each moves to the next shard, a re-index inside the rank; the
    last shard's goes to the next rank and the first shard takes the
    previous rank's (the rank's own last block when it is alone)."""
    first = (_rotate(mesh, *resident[-1]) if mesh.processes > 1
             else resident[-1])
    return [first] + resident[:-1]


def ring_attention(q: List[torch.Tensor], k: List[torch.Tensor],
                   v: List[torch.Tensor], mesh: Mesh,
                   axis_name: str = SEQ_AXIS,
                   causal: bool = False) -> List[torch.Tensor]:
    """Exact attention over a sequence split on ``axis_name``: q, k, v are
    this process's shards' (L_local, H, Dh) blocks; returns their output
    blocks. Per step every shard folds its resident K/V block into its
    online-softmax state, then the blocks rotate one hop; the last resident
    block folds without a rotation after it."""
    p = _axis_size(mesh, axis_name)
    l_local, heads, d_head = q[0].shape
    scale = 1.0 / math.sqrt(d_head)
    states = [(torch.full((heads, l_local), float("-inf"), dtype=qi.dtype,
                          device=qi.device),
               torch.zeros((heads, l_local), dtype=qi.dtype,
                           device=qi.device),
               torch.zeros((heads, l_local, d_head), dtype=qi.dtype,
                           device=qi.device)) for qi in q]
    resident = list(zip(k, v))
    for step in range(p):
        for i, qi in enumerate(q):
            me = mesh.local_shards[i]
            src = (me - step) % p  # where the resident block started
            if mesh.distributed:
                k_blk, v_blk = resident[i]
            else:
                k_blk, v_blk = k[src].to(qi.device), v[src].to(qi.device)
            mask = None
            if causal:
                q_pos = me * l_local + torch.arange(l_local,
                                                    device=qi.device)
                k_pos = src * l_local + torch.arange(l_local,
                                                     device=qi.device)
                mask = (q_pos[:, None] >= k_pos[None, :])[None]
            states[i] = _fold(qi, k_blk, v_blk, *states[i], scale, mask)
        if mesh.distributed and step < p - 1:
            resident = _hop(mesh, resident)
    # back to (L, H, Dh)
    return [(o / torch.clamp_min(l, 1e-30)[:, :, None]).permute(
        1, 0, 2).contiguous() for _, l, o in states]


def _all_to_all(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``all_to_all_single`` of a (P, ...) tensor: row ``j`` goes to rank
    ``j``, and row ``j`` of the result came from rank ``j``."""
    import torch.distributed as dist

    send = x.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    return recv


def _dense(q, k, v, causal: bool, offset: int = 0):
    """(L, h, Dh) dense attention of one head group."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("lhd,mhd->hlm", q, k) * scale
    if causal:
        pos = torch.arange(q.shape[0], device=q.device)
        scores = torch.where(pos[None, :, None] >= pos[None, None, :],
                             scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("hlm,mhd->lhd", probs, v)


def ulysses_attention(q: List[torch.Tensor], k: List[torch.Tensor],
                      v: List[torch.Tensor], mesh: Mesh,
                      axis_name: str = SEQ_AXIS,
                      causal: bool = False) -> List[torch.Tensor]:
    """Sequence→head re-sharding attention (the DeepSpeed-Ulysses pattern):
    shard ``j`` takes heads ``[j*H/P, (j+1)*H/P)`` of the whole sequence,
    runs dense attention on them and hands each shard its sequence block
    back. q, k, v: this process's (L_local, H, Dh) blocks, H % P == 0."""
    p = _axis_size(mesh, axis_name)
    l_local, heads, d_head = q[0].shape
    hp = heads // p
    per, ranks = len(q), p // len(q)
    if not mesh.distributed:
        def head_group(blocks, j):
            dev = blocks[j].device
            return torch.cat([b[:, j * hp:(j + 1) * hp].to(dev)
                              for b in blocks])

        outs = [_dense(head_group(q, j), head_group(k, j), head_group(v, j),
                       causal) for j in range(p)]
        return [torch.cat([outs[j][i * l_local:(i + 1) * l_local].to(
            q[i].device) for j in range(p)], dim=1) for i in range(p)]

    def to_heads(blocks):
        # this rank's shards i, head group (rank, j) → send[rank][j][i]; the
        # received [rank][j][i] is, for each local head group j, the whole
        # sequence in global shard order (rank, i)
        x = torch.stack(blocks).reshape(per, l_local, ranks, per, hp, d_head)
        recv = _all_to_all(mesh, x.permute(2, 3, 0, 1, 4, 5))
        return recv.permute(1, 0, 2, 3, 4, 5).reshape(
            per, ranks * per * l_local, hp, d_head)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    out = torch.stack([_dense(qh[j], kh[j], vh[j], causal)
                       for j in range(per)])
    # head group j's rows of shard (rank, i) → send[rank][j][i]; the
    # received [rank][j][i] is shard i's head group (rank, j)
    back = _all_to_all(mesh, out.reshape(
        per, ranks, per, l_local, hp, d_head).permute(1, 0, 2, 3, 4, 5))
    return list(back.permute(2, 3, 0, 1, 4, 5).reshape(
        per, l_local, heads, d_head).unbind(0))


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False) -> torch.Tensor:
    """One-device reference attention (the oracle): (L, H, Dh)."""
    return _dense(q, k, v, causal)


def sharded_attention(mesh: Mesh, q, k, v, kind: str = "ring",
                      causal: bool = False,
                      axis_name: Optional[str] = None) -> torch.Tensor:
    """Host-level entry: q, k, v are the whole (L, H, Dh) tensors (or host
    arrays, placed as float32 on the shards' device); the sequence dim is
    split over the mesh's sequence axis and attention runs with the chosen
    strategy. Returns the whole (L, H, Dh) output (gathered over the ranks
    under ``torch.distributed``)."""
    if axis_name is None:
        axis_name = (SEQ_AXIS if SEQ_AXIS in mesh.axis_names
                     else mesh.axis_names[0])
    if kind not in ("ring", "ulysses"):
        raise ValueError(f"unknown attention kind {kind!r}")
    p = mesh.shape[axis_name]
    if q.shape[0] % p:
        raise ValueError(
            f"sequence length {q.shape[0]} must be divisible by the "
            f"{axis_name!r} axis size {p} (pad the sequence)")
    if kind == "ulysses" and q.shape[1] % p:
        raise ValueError(
            f"ulysses attention needs heads ({q.shape[1]}) divisible by the "
            f"{axis_name!r} axis size {p}; use kind='ring' instead")
    blocks = [_c.ensure_on_mesh(mesh, t, dtype=(
        t.dtype if isinstance(t, torch.Tensor) else torch.float32)).parts
        for t in (q, k, v)]
    fn = ring_attention if kind == "ring" else ulysses_attention
    out = fn(*blocks, mesh, axis_name=axis_name, causal=causal)
    return _c.all_gather(out, mesh)
