"""Cross-replica sharding of the weight update and the optimizer state.

The port of ``flink_ml_tpu/parallel/update_sharding.py:55-218``
("Automatic Cross-Replica Sharding of Weight Update in Data-Parallel
Training", arXiv:2004.13336). In plain data parallelism every shard sums the
full gradient and applies the same full update; the sharded update splits
it::

    per-shard partial gradients  g_i        (full length, padded)
               │ reduce_scatter             each shard keeps its 1/N slice
               ▼
    g_slice ──▶ apply_fn(g_slice, param_slice, opt_state_slice)
               │ all_gather                 opt-state slices stay sharded
               ▼
    replicated parameters       new opt-state slices

Optimizer state (moments, FTRL's z/n) lives as :class:`Sharded` leaves:
each shard's slice is its own tensor, so a shard holds 1/N of the state and
:func:`record_state_bytes` measures 1/N. In-process, :func:`sharded_apply`
calls ``apply_fn`` once per shard's slice.

Enabling: the fits read :func:`enabled`, the JAX package's own switch
``FLINK_ML_TPU_UPDATE_SHARDING=1``. Off by default; the sharded and the
replicated fits agree up to float reassociation (on an in-process mesh they
sum in the same order, so they agree bit for bit).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np
import torch

from flink_ml_tpu_torch.parallel import collective as C
from flink_ml_tpu_torch.parallel.mesh import Mesh

#: env var: arm the cross-replica sharded update in every fit family
ENV = "FLINK_ML_TPU_UPDATE_SHARDING"

__all__ = [
    "ENV", "enabled", "padded_len", "pad_leading", "owned_slice", "Sharded",
    "sharded_apply", "apply_slices", "place_opt_state", "record_state_bytes",
    "last_state_bytes", "reset_last", "provenance",
]


def enabled() -> bool:
    """True when ``FLINK_ML_TPU_UPDATE_SHARDING`` arms the sharded update
    (1/true/on/yes)."""
    return os.environ.get(ENV, "").strip().lower() in (
        "1", "true", "on", "yes")


def padded_len(n: int, n_shards: int) -> int:
    """``n`` rounded up to a multiple of the shard count: the dim-0 length
    reduce-scatter needs. Zero padding is inert through every update rule
    here (zero gradient → zero update; FTRL's soft-threshold keeps a zero
    coordinate zero)."""
    n_shards = max(int(n_shards), 1)
    return int(n) + (-int(n)) % n_shards


def pad_leading(x: torch.Tensor, target: int, dim: int = 0) -> torch.Tensor:
    """``x`` zero-padded along ``dim`` up to ``target`` (``x`` itself when
    it is long enough)."""
    pad = int(target) - x.shape[dim]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def owned_slice(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This process's shards' 1/N slices of a replicated tensor, an (L,
    chunk, ...) stack in the order of :func:`collective.reduce_scatter`, so
    each slice pairs with the gradient slice it is updated by."""
    p = mesh.size
    if x.shape[0] % p:
        raise ValueError(f"owned_slice: dim 0 of {x.shape[0]} is not a "
                         f"multiple of the {p} shards")
    slices = x.reshape((p, x.shape[0] // p) + tuple(x.shape[1:]))
    return slices[list(mesh.local_shards)] if mesh.distributed else slices


class Sharded:
    """A dim-0-sharded tensor: ``slices[i]`` is the slice of shard
    ``mesh.local_shards[i]``, each a tensor of its own on its shard's
    device. Its global view (:meth:`global_view`) is the concatenation of
    every shard's slice, which is what a checkpoint holds."""

    def __init__(self, mesh: Mesh, slices: List[torch.Tensor]):
        self.mesh = mesh
        self.slices = list(slices)

    @property
    def shape(self) -> tuple:
        first = self.slices[0]
        return (self.mesh.size * first.shape[0],) + tuple(first.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.slices[0].dtype

    @classmethod
    def place(cls, mesh: Mesh, full) -> "Sharded":
        """Cut a full (padded) array or tensor into the mesh's slices, each
        copied to its shard's device."""
        full = torch.as_tensor(full)
        chunk = full.shape[0] // mesh.size
        if chunk * mesh.size != full.shape[0]:
            raise ValueError(f"Sharded.place: dim 0 of {full.shape[0]} is "
                             f"not a multiple of the {mesh.size} shards")
        return cls(mesh, [full[s * chunk:(s + 1) * chunk].to(
            mesh.devices[s]).clone() for s in mesh.local_shards])

    def global_view(self) -> torch.Tensor:
        """The whole tensor (a gather over the ranks under
        ``torch.distributed``)."""
        return C.all_gather(self.slices, self.mesh)

    def like_global(self, host) -> "Sharded":
        """A host array of this leaf's global shape re-placed on its layout,
        in its dtype (checkpoint restore)."""
        return Sharded.place(self.mesh, torch.as_tensor(host,
                                                        dtype=self.dtype))

    def map(self, fn: Callable, *others) -> "Sharded":
        """``fn`` slice by slice over this leaf and ``others`` (Sharded
        leaves of the same layout)."""
        return Sharded(self.mesh, [fn(*parts) for parts in zip(
            self.slices, *(o.slices for o in others))])


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a tuple/list/dict tree (``None`` stays
    ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, *parts)
                          for parts in zip(tree, *rest))
    return fn(tree, *rest)


def apply_slices(mesh: Mesh, g_slices, params, opt_state,
                 apply_fn: Callable):
    """The update half of :func:`sharded_apply`, from gradients already
    reduce-scattered (``g_slices``: a tree of (L, chunk, ...) stacks):
    ``apply_fn`` once per local shard on its slices, then the parameters
    all-gathered and the optimizer state kept as :class:`Sharded` slices
    (replicated opt leaves, such as adam's step, from the first shard)."""
    p_slices = _tree_map(lambda a: owned_slice(a, mesh), params)
    outs = []
    for i, _ in enumerate(mesh.local_shards):
        g_i = _tree_map(lambda a: a[i], g_slices)
        p_i = _tree_map(lambda a: a[i], p_slices)
        o_i = _tree_map(lambda a: a.slices[i] if isinstance(a, Sharded)
                        else a, opt_state)
        outs.append(apply_fn(g_i, p_i, o_i))
    new_p = _tree_map(lambda *parts: C.all_gather(list(parts), mesh),
                      *[o[0] for o in outs])
    if opt_state is None:
        return new_p, outs[0][1]
    new_opt = _tree_map(
        lambda old, *parts: (Sharded(mesh, list(parts))
                             if isinstance(old, Sharded) else parts[0]),
        opt_state, *[o[1] for o in outs])
    return new_p, new_opt


def sharded_apply(mesh: Mesh, grads, params, opt_state,
                  apply_fn: Callable):
    """One cross-replica sharded update step.

    - ``grads``: a tree of per-shard partial gradients, (L, dp, ...) stacks
      of this process's shards with dp padded to the shard multiple
      (:func:`padded_len`);
    - ``params``: a tree of replicated (dp, ...) parameters; each shard
      updates only its slice;
    - ``opt_state``: a tree of :class:`Sharded` optimizer-state leaves (and
      replicated ones, such as adam's step), or ``None``;
    - ``apply_fn(grad_slices, param_slices, opt_state_slices) ->
      (new_param_slices, new_opt_state)``: the update rule on one shard's
      slices, elementwise along dim 0.

    Returns ``(new_params, new_opt_state)``: the parameters all-gathered
    back to replicated, the optimizer state still sharded."""
    g_slices = _tree_map(lambda a: C.reduce_scatter(a, mesh), grads)
    return apply_slices(mesh, g_slices, params, opt_state, apply_fn)


def place_opt_state(mesh: Mesh, tree):
    """Full-length (padded) optimizer-state arrays placed on the mesh as
    :class:`Sharded` leaves, each shard holding its 1/N slice."""
    return _tree_map(lambda a: Sharded.place(mesh, a), tree)


# -- accounting ---------------------------------------------------------------
#: last per-algo record: {"algo": {"bytesPerReplica", "sharded", "shards"}}
_last: dict = {}


def _leaf_bytes_per_replica(leaf) -> int:
    """Bytes one shard holds for ``leaf``, measured from its buffers: the
    first slice of a :class:`Sharded` leaf, the whole of a replicated
    tensor or host array."""
    if isinstance(leaf, Sharded):
        leaf = leaf.slices[0]
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(np.asarray(leaf).nbytes)


def record_state_bytes(algo: str, leaves, n_shards: int,
                       sharded: bool) -> int:
    """Record the per-replica bytes of a fit's update state (parameters and
    optimizer accumulators), measured from the leaves' buffers: replicated
    leaves report their full size even when the sharded update ran, and
    :class:`Sharded` leaves their slice. Feeds the benchmark provenance
    (``optStateBytesPerReplica``). Returns the byte count."""
    per_replica = int(sum(_leaf_bytes_per_replica(leaf) for leaf in leaves))
    _last[algo] = {"bytesPerReplica": per_replica, "sharded": bool(sharded),
                   "shards": int(n_shards)}
    _last["__latest__"] = _last[algo]
    return per_replica


def last_state_bytes(algo: Optional[str] = None) -> Optional[int]:
    """The most recently recorded per-replica state bytes (for ``algo``, or
    of whichever fit recorded last)."""
    rec = _last.get(algo or "__latest__")
    return None if rec is None else rec["bytesPerReplica"]


def reset_last() -> None:
    """Forget the recorded state bytes (the runner calls this before each
    benchmark, so a row carries only its own run's provenance)."""
    _last.clear()


def provenance() -> dict:
    """Benchmark-row provenance: whether the sharded update is armed, the
    last recorded per-replica state bytes (absent if nothing has recorded
    yet), and the elastic-run fields (``elasticEvents`` /
    ``participationMin``, ``parallel/elastic.py``)."""
    out = {"updateSharding": enabled()}
    b = last_state_bytes()
    if b is not None:
        out["optStateBytesPerReplica"] = b
    from flink_ml_tpu_torch.parallel import elastic

    out.update(elastic.provenance())
    return out
