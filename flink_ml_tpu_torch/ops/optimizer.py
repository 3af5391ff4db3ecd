"""SGD: the training loop of the linear models.

The port of the dense, all-device fit of ``flink_ml_tpu/ops/optimizer.py``
(ref: flink-ml-lib/.../common/optimizer/SGD.java:67), with the same
semantics:

- the rows are split over a mesh's data shards as contiguous blocks of
  ``ceil(n/p)`` rows (``parallel/``); each shard takes a local batch of
  ``globalBatchSize/p`` rows (+1 for the first ``globalBatchSize%p``
  shards), sliced in order from its own rows with clip-at-end and
  wrap-to-zero (SGD.java:206-213, 262-284): the window of the last round
  before a wrap is pulled back to end at the shard's last row, and the rows
  it repeats weigh 0;
- per round: the shards' ``[Σ grad | Σ w | Σ loss]`` summed over the mesh,
  then the update rule (sgd, momentum or adam), then regularization
  (SGD.java:231-243); a round whose weights sum to 0 changes neither the
  coefficients nor the moments. With the sharded update the gradient is
  reduce-scattered and each shard updates its slice of the coefficients and
  of the moments, which stay sharded (``parallel/update_sharding.py``);
- termination: ``maxIter`` rounds, or the round whose data loss
  ``loss / Σ w`` falls below ``tol``.

The schedule depends only on (n, p, batch), so it is Python ints
(:class:`ShardSchedule`), and the fit is a Python loop of rounds over device
tensors: one ``sgd_batch_terms`` call (``ops/kernels.py``) per shard, the
cross-shard sum, and the shared update tail per round. The tol stop is a
mask, as in the JAX package's unrolled program: rounds after it run and are
discarded by ``torch.where``, so the fit never waits for the device until it
fetches the final coefficients and loss, once. The JAX package's while
program for more than 64 rounds gives the same results by construction, so
this one loop serves every ``maxIter``. The default mesh is one shard, whose
fit is the one-device fit, launch for launch.

With an ``IterationConfig`` the same rounds run through the iteration
runtime (``iteration/iteration.py``): K-round segments between checkpoints,
each a masked loop like the plain fit's with one boundary fetch, or host
rounds of one round each with listeners, checkpoints and a stop fetch a
round. Every mode launches ``sgd_batch_terms`` with the same windows in the
same order, so each gives the plain fit's bits.

With health telemetry armed (``observability/health.py``: a trace dir or
``FLINK_ML_TPU_HEALTH``) each round also computes its float32 ``[loss,
update norm, parameter norm]`` row on the device; the rows ride the fit's
final fetch (all-device), each segment's boundary fetch (segments), or a
listener that fetches them once at termination (host rounds), so no round
waits for the device on their account, and the series lands in
``ml.health``. Unarmed, no row is computed.

Sparse features (a scipy CSR matrix, :meth:`SGD.optimize_csr`) run the same
rounds, schedule and update tail: the matrix goes to the device once per
fit, split into the same row shards (``indptr`` int64, ``indices`` int32,
``data`` float32 and each stored value's row id), and a shard's window of
rows is one contiguous range of stored values. Its terms are two
``segment_reduce_sum`` launches (``ops/kernels.py``): the per-row dots
(values ``data·coeffs[indices]`` by the row ids local to the window), then,
after the loss terms, the gradient (values ``data·mult[row]`` by
``indices``, over the feature width). The JAX package computes this path in
float64 scipy on the host; here it is float32 on the device (``cuda-csr``),
and on the CPU the segment sums' plain versions (``torch-csr``).

Tensor parallelism (a mesh with a ``model`` axis, ``optimizer.py:211-219``
and ``:741-800`` of the JAX package): the feature dimension is padded to a
multiple of the model-axis size and split over it; model shard ``m`` of data
shard ``s`` holds the columns ``[m*dm, (m+1)*dm)`` of the shard's rows (a
view on the shard's device) and the same slice of the coefficients and of
the moments. Per round each model shard computes its partial margins
``xb_m @ coeffs_m``; they are summed over the model axis
(``collective.all_reduce_sum(..., axes=("model",))``: ``reduce_partials``
on the card), the loss terms run, each model shard computes its local
gradient ``xb_m.T @ mult``, and the data shard's ``[grad | Σw | Σloss]`` is
summed over the data axes only. The JAX package launches no Pallas kernel
on this path (its ``use_kernel and model_axis is None``), so the partial
dots and the gradient products are ``torch.matmul`` here too: the path is
``cuda-tp`` / ``torch-tp``, and its kernels are the ``reduce_partials``
launches of the sums. The cross-replica sharded update stays off on such a
mesh, as in the JAX package (the model axis already splits the state).

Over processes (a ``torch.distributed`` mesh with a ``model`` axis) a rank
places only its own (data shard, model shard) column blocks, as a
data-parallel rank places only its rows. The margins' sum over the model
axis is ``reduce_partials`` over the rank's model shards, then an
``all_reduce`` on the ranks that hold the data shard's other model shards;
the data shards' ``[grad | Σw | Σloss]`` sum runs on the ranks that hold
the same model shards. A rank that holds only some model shards has zeros
in the other slices of its gradient, so one more sum over the model axis
(:meth:`TPColumns.gather`) gives every rank the whole gradient, exactly,
and the coefficients stay replicated: every rank applies the same update.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from flink_ml_tpu_torch.device import DeviceLike
from flink_ml_tpu_torch.iteration import iteration
from flink_ml_tpu_torch.observability import health as _health
from flink_ml_tpu_torch.observability import meshstats, tracing
from flink_ml_tpu_torch.ops import kernels
from flink_ml_tpu_torch.ops.losses import LossFunc
from flink_ml_tpu_torch.ops.regularization import regularize
from flink_ml_tpu_torch.parallel import collective as C
from flink_ml_tpu_torch.parallel import update_sharding as _upd
from flink_ml_tpu_torch.parallel.mesh import (MODEL_AXIS, Mesh,
                                              model_axis_of, resolve_mesh)

#: ``batch_terms(xl, yl, wl, coeffs, start, clip, lb, loss_name) -> (d+2,)``
BatchTerms = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SGDParams:
    """Ref: the SGDParams POJO consumed by SGD (SGD.java:67), with the
    stateful update rules of the JAX package (``method``): the reference's
    stateless ``w -= lr/totalW · grad``, heavy-ball ``momentum``, ``adam``."""
    learning_rate: float = 0.1
    global_batch_size: int = 32
    max_iter: int = 20
    tol: float = 1e-6
    reg: float = 0.0
    elastic_net: float = 0.0
    #: update rule: "sgd" (stateless), "momentum", "adam"
    method: str = "sgd"
    momentum: float = 0.9
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8


#: moment vectors each rule carries (adam also carries its step counter)
_OPT_VECTORS = {"sgd": 0, "momentum": 1, "adam": 2}


def _check_method(prm: SGDParams) -> None:
    if prm.method not in _OPT_VECTORS:
        raise ValueError(
            f"SGDParams.method must be one of {sorted(_OPT_VECTORS)}, "
            f"got {prm.method!r}")


def _update_rule(prm: SGDParams):
    """The per-coordinate update rule ``rule(grad_sum, total_w, w, opt) ->
    (w_new, opt_new)``. ``opt`` is the rule's moment state: ``()`` for sgd,
    ``(m,)`` for momentum, ``(m, v, t)`` for adam (t, a 0-dim tensor, is the
    bias-correction step counter). Regularization is applied by the caller
    after the rule (SGD.java:231-243)."""
    _check_method(prm)
    lr = prm.learning_rate
    if prm.method == "sgd":
        def rule(grad, total_w, w, opt):
            return w - (lr / torch.clamp_min(total_w, 1e-30)) * grad, opt
    elif prm.method == "momentum":
        mu = prm.momentum

        def rule(grad, total_w, w, opt):
            g = grad / torch.clamp_min(total_w, 1e-30)
            m = mu * opt[0] + g
            return w - lr * m, (m,)
    else:  # adam
        b1, b2, eps = prm.beta1, prm.beta2, prm.eps

        def rule(grad, total_w, w, opt):
            g = grad / torch.clamp_min(total_w, 1e-30)
            m, v, t = opt
            t = t + 1.0
            m = b1 * m + (1.0 - b1) * g
            v = b2 * v + (1.0 - b2) * (g * g)
            m_hat = m / (1.0 - b1 ** t)
            v_hat = v / (1.0 - b2 ** t)
            return w - lr * m_hat / (torch.sqrt(v_hat) + eps), (m, v, t)
    return rule


def _init_opt(prm: SGDParams, d: int, device: torch.device, mesh=None,
              sharded: bool = False) -> tuple:
    """The rule's zero moment state, float32: (d,) vectors on ``device``,
    or, with ``sharded``, :class:`~update_sharding.Sharded` vectors of
    ``d`` (padded) rows cut over ``mesh``; adam's step is a replicated
    scalar either way."""
    def vector():
        if not sharded:
            return torch.zeros(d, dtype=torch.float32, device=device)
        return _upd.Sharded(mesh, [
            torch.zeros(d // mesh.size, dtype=torch.float32,
                        device=mesh.devices[s]) for s in mesh.local_shards])

    opt = tuple(vector() for _ in range(_OPT_VECTORS[prm.method]))
    if prm.method == "adam":
        opt += (torch.zeros((), dtype=torch.float32, device=device),)
    return opt


def _apply_packed(prm: SGDParams, rule, coeffs: torch.Tensor, opt: tuple,
                  packed: torch.Tensor):
    """The update tail of one round, from its packed ``[Σ grad | Σ w |
    Σ loss]``: the update rule, regularization, and no change at all when
    the weights sum to 0 → ``(coeffs, opt, mean_loss)``. The JAX package's
    ``apply_packed`` on one device."""
    grad, total_w, total_loss = packed[:-2], packed[-2], packed[-1]
    # ref updateModel (SGD.java:231-243); skip when no weight
    updated, new_opt = rule(grad, total_w, coeffs, opt)
    updated, _ = regularize(updated, prm.reg, prm.elastic_net,
                            prm.learning_rate)
    has_weight = total_w > 0
    coeffs_out = torch.where(has_weight, updated, coeffs)
    # a zero-weight round must leave the moments untouched too
    opt_out = tuple(torch.where(has_weight, n, o) for n, o in zip(new_opt, opt))
    mean_loss = total_loss / torch.clamp_min(total_w, 1e-30)
    return coeffs_out, opt_out, mean_loss


def _next_offset(local_n: int, lb: int, offset: int) -> int:
    """The window offset after a round that started at ``offset``."""
    return 0 if offset + lb >= local_n else offset + lb


class ShardSchedule:
    """The per-shard minibatch schedule of a p-shard mesh, as Python ints
    (the JAX package's ``_sgd_round_math``, SGD.java:206-213, 262-284).

    Shard ``s`` holds ``real[s]`` rows of a padded length ``ls``. Its local
    batch is ``lb_s = gb//p + (s < gb%p)`` rows (capped at ``ls``): the low
    shard ids take the remainder. Each round it weighs its real rows in
    ``[offset_s, offset_s + lb_s)``, and its offset wraps to 0 at ``ls``. At
    p = 1 this is the one-device schedule, window for window."""

    def __init__(self, global_batch_size: int, n_shards: int, ls: int,
                 real):
        lb_base, lb_rem = divmod(int(global_batch_size), int(n_shards))
        self.ls = int(ls)
        self.real = list(real)
        self.lb_max = min(lb_base + (1 if lb_rem else 0), self.ls)
        self.lbs = [min(lb_base + (1 if s < lb_rem else 0), self.ls)
                    for s in range(n_shards)]

    def window(self, shard: int, offset: int) -> Tuple[int, int, int]:
        """The ``sgd_batch_terms`` window ``(start, clip, lb)`` of shard
        ``shard`` at ``offset``, over its real rows: the JAX window of
        ``lb_max`` rows starts at ``min(offset, ls - lb_max)``, its rows
        below ``clip = offset - start`` weigh 0, and it ends where the
        shard's batch or its real rows end. ``lb <= clip`` means that no
        real row is in the batch."""
        start = min(offset, self.ls - self.lb_max)
        end = min(offset + self.lbs[shard], self.real[shard])
        return start, offset - start, end - start

    def windows(self, shards, offsets, rounds: int) -> list:
        """The windows of ``rounds`` rounds from ``offsets``: per round, one
        :meth:`window` per shard of ``shards``."""
        offsets = [int(o) for o in offsets]
        out = []
        for _ in range(rounds):
            out.append([self.window(s, offsets[s]) for s in shards])
            offsets = [_next_offset(self.ls, lb, o)
                       for lb, o in zip(self.lbs, offsets)]
        return out

    def advance(self, offsets, rounds: int = 1) -> np.ndarray:
        """Every shard's offset after ``rounds`` rounds, (p,) int32."""
        out = [int(o) for o in offsets]
        for s, lb in enumerate(self.lbs):
            for _ in range(rounds):
                out[s] = _next_offset(self.ls, lb, out[s])
        return np.asarray(out, np.int32)


class ShardData(NamedTuple):
    """A fit's rows split over the mesh (``collective.ensure_on_mesh``)."""
    x: C.RowShards
    y: C.RowShards
    w: C.RowShards

    @classmethod
    def place(cls, mesh, features, labels, weights=None) -> "ShardData":
        x = C.ensure_on_mesh(mesh, features)
        return cls(x, *cls._labels(mesh, x.n, labels, weights))

    @classmethod
    def place_csr(cls, mesh, features, labels, weights=None) -> "ShardData":
        """A scipy CSR matrix split as :meth:`place` splits dense rows:
        each local shard's rows as one :class:`CsrShard` on its device."""
        n = features.shape[0]
        ls = C.shard_len(n, mesh.size)
        real = [max(0, min(ls, n - s * ls)) for s in range(mesh.size)]
        m = features.tocsr()
        parts = [CsrShard(m[s * ls:s * ls + real[s]], mesh.devices[s])
                 for s in mesh.local_shards]
        x = C.RowShards(parts, n, ls, real)
        return cls(x, *cls._labels(mesh, n, labels, weights))

    @staticmethod
    def _labels(mesh, n: int, labels, weights):
        y = C.ensure_on_mesh(mesh, labels)
        w = (C.ones_on_mesh(mesh, n) if weights is None
             else C.ensure_on_mesh(mesh, weights))
        return y, w


class CsrShard:
    """One shard's rows of a CSR matrix on its device: ``indices`` int32,
    ``data`` float32 and ``rows`` int32, the shard-local row of each stored
    value (from ``indptr``, which goes to the device for that). The host
    keeps ``indptr_host`` (int64), where the rounds' windows are cut.
    ``shape`` and ``device`` are those of the dense rows it stands for."""

    def __init__(self, m, device: torch.device):
        m = m.tocsr()
        self.shape = m.shape
        self.device = device
        self.indptr_host = np.asarray(m.indptr, np.int64)
        indptr = torch.as_tensor(self.indptr_host, device=device)
        self.indices = torch.as_tensor(m.indices.astype(np.int32),
                                       device=device)
        self.data = torch.as_tensor(m.data.astype(np.float32), device=device)
        self.rows = torch.repeat_interleave(
            torch.arange(m.shape[0], dtype=torch.int32, device=device),
            indptr[1:] - indptr[:-1])


def csr_batch_terms(x: CsrShard, yl: torch.Tensor, wl: torch.Tensor,
                    coeffs: torch.Tensor, start: int, clip: int, lb: int,
                    loss_name: str) -> torch.Tensor:
    """:func:`kernels.sgd_batch_terms` of a CSR shard: the window's real
    rows ``[start + clip, start + lb)`` are one range of stored values, and
    its ``[Σ mult·x | Σ w | Σ loss]`` comes from two segment sums, the
    per-row dots (ids local to the window) and the gradient (ids the
    feature indices)."""
    a, b = start + clip, start + lb
    if b <= a:  # no real row in the window
        return torch.zeros(x.shape[1] + 2, dtype=torch.float32,
                           device=x.device)
    lo, hi = int(x.indptr_host[a]), int(x.indptr_host[b])
    vals, cols = x.data[lo:hi], x.indices[lo:hi]
    local = x.rows[lo:hi] - a
    dots = kernels.segment_reduce_sum(vals * coeffs.index_select(0, cols),
                                      local, b - a)
    yb, wb = yl[a:b], wl[a:b]
    loss_sum, mult = LossFunc.by_name(loss_name).terms(dots, yb, wb)
    grad = kernels.segment_reduce_sum(vals * mult.index_select(0, local),
                                      cols, x.shape[1])
    return torch.cat([grad, wb.sum()[None], loss_sum[None]])


def _round_partials(batch_terms: BatchTerms, loss_name: str, mesh, shards,
                    windows, coeffs: torch.Tensor) -> list:
    """Every local shard's ``[Σ grad | Σ w | Σ loss]`` for one round: one
    ``batch_terms`` launch per shard whose window holds a real row, zeros
    for the others, each followed by the shard's ready mark
    (``meshstats.mark_shard_ready``, armed only). ``shards`` are the local
    shards' (x, y, w) rows, ``windows`` their ``(start, clip, lb)`` this
    round."""
    parts = []
    for s, (x, y, w), (start, clip, lb) in zip(mesh.local_shards, shards,
                                               windows):
        d = x.shape[1]
        if lb > clip:
            # the kernel sees the true width: coeffs may carry the sharded
            # update's padding, and a shard may live on another device
            c = coeffs if coeffs.shape[0] == d else coeffs[:d]
            if c.device != x.device:
                c = c.to(x.device)
            parts.append(batch_terms(x, y, w, c, start, clip, lb, loss_name))
        else:
            parts.append(torch.zeros(d + 2, dtype=torch.float32,
                                     device=x.device))
        meshstats.mark_shard_ready(mesh, s, parts[-1])
    return parts


class TPColumns:
    """The model-axis column blocks of a fit's rows: ``blocks[i][j]`` is
    model shard ``models[j]``'s columns ``[m*dm, min((m+1)*dm, d))`` of
    local data shard ``i``'s rows, on the model shard's device; ``dm`` is
    ``dp / M`` with ``dp`` the padded feature width. ``models`` are the
    model shards this process holds: all of them in-process, where a block
    is a view of the placed rows when it lives on their device; a rank's
    own under ``torch.distributed``, where only its blocks are placed
    (:meth:`place`)."""

    def __init__(self, mesh, d: int, blocks: list):
        self.m = mesh.model_size
        self.models = mesh.local_models
        self.d = int(d)
        self.dp = _upd.padded_len(self.d, self.m)
        self.dm = self.dp // self.m
        self.blocks = blocks

    def cols(self, m: int) -> slice:
        """Model shard ``m``'s columns of the true width."""
        return slice(min(m * self.dm, self.d), min((m + 1) * self.dm, self.d))

    @classmethod
    def place(cls, mesh, features) -> Tuple["TPColumns", C.RowShards]:
        """The rows of ``features`` (n, d) split over the data shards and
        their columns over the model shards → (columns, the row split
        whose ``parts[i]`` is ``blocks[i]``). In-process the rows are
        placed as for a data-parallel fit and cut into views; under
        ``torch.distributed`` each local (data, model) block of a host
        array or tensor goes to the device on its own."""
        cols = cls(mesh, features.shape[1], [])
        if isinstance(features, C.ShardedColumn) and mesh.distributed:
            features = features.whole()
        if not mesh.distributed:
            x = C.ensure_on_mesh(mesh, features)
            for s, part in zip(mesh.local_shards, x.parts):
                devs = mesh.model_devices(s)
                cols.blocks.append([part[:, cols.cols(m)].to(devs[m])
                                    for m in cols.models])
            return cols, x
        n = int(features.shape[0])
        ls = C.shard_len(n, mesh.size)
        real = [max(0, min(ls, n - s * ls)) for s in range(mesh.size)]
        for s in mesh.local_shards:
            devs = mesh.model_devices(s)
            cols.blocks.append([torch.as_tensor(
                features[s * ls:s * ls + real[s], cols.cols(m)],
                dtype=torch.float32, device=devs[m]).contiguous()
                for m in cols.models])
        return cols, C.RowShards(cols.blocks, n, ls, real)

    def gather(self, mesh, packed: torch.Tensor) -> torch.Tensor:
        """The data-summed ``[grad | Σ w | Σ loss]`` with every model
        shard's gradient slice: a rank that holds some of the model shards
        has zeros in the others' slices, so their sum over the model axis
        is exact; ``Σ w`` and ``Σ loss`` are the same on every model
        shard."""
        if len(self.models) == self.m:
            return packed
        grad = C.all_reduce_sum(packed[None, :-2], mesh, axes=(MODEL_AXIS,))
        return torch.cat([grad, packed[-2:]])


def _tp_round_partials(loss_name: str, mesh, cols: TPColumns, shards,
                       windows, coeffs: torch.Tensor) -> list:
    """Every local data shard's ``[grad | Σ w | Σ loss]`` (dp + 2) for one
    round on a tensor-parallel mesh: the model shards' partial margins
    summed over the model axis, the loss terms, then each model shard's
    gradient slice (zeros past the true width), as the JAX package's
    ``_sgd_update_math`` computes them under ``model_axis``."""
    loss = LossFunc.by_name(loss_name)
    parts = []
    for i, (s, (_, y, w), (start, clip, lb)) in enumerate(zip(
            mesh.local_shards, shards, windows)):
        dev = y.device
        if lb <= clip:  # no real row in the window
            parts.append(torch.zeros(cols.dp + 2, dtype=torch.float32,
                                     device=dev))
            meshstats.mark_shard_ready(mesh, s, parts[-1])
            continue
        yb, wb = y[start:start + lb], w[start:start + lb]
        if clip:
            wb = torch.where(torch.arange(lb, device=dev) >= clip, wb, 0.0)
        xbs = [blk[start:start + lb] for blk in cols.blocks[i]]
        cms = [coeffs[m * cols.dm:m * cols.dm + xb.shape[1]].to(xb.device)
               for m, xb in zip(cols.models, xbs)]
        dots = C.all_reduce_sum(
            torch.stack([(xb @ c).to(dev) for xb, c in zip(xbs, cms)]),
            mesh, axes=(MODEL_AXIS,))
        loss_sum, mult = loss.terms(dots, yb, wb)
        # the slices of model shards held elsewhere stay zero here
        grads = [torch.zeros(cols.dm, dtype=torch.float32, device=dev)
                 ] * cols.m
        for m, xb in zip(cols.models, xbs):
            g = (xb.T @ mult.to(xb.device)).to(dev)
            grads[m] = _upd.pad_leading(g, cols.dm)
        parts.append(torch.cat(grads + [wb.sum()[None], loss_sum[None]]))
        meshstats.mark_shard_ready(mesh, s, parts[-1])
    return parts


def _apply_round(prm: SGDParams, rule, mesh, sharded: bool,
                 coeffs: torch.Tensor, opt: tuple, parts: list,
                 tp: Optional[TPColumns] = None):
    """The update tail of a round from the local shards' (d+2,) partials →
    (coeffs, opt, mean_loss): the stack all-reduced (over the data axes,
    then, with ``tp``, the gradient slices over the model axis:
    :meth:`TPColumns.gather`) and :func:`_apply_packed`; or, with
    ``sharded``, the JAX package's sharded tail: ``[Σ w | Σ loss]``
    all-reduced, the gradient reduce-scattered, each shard's coefficient
    and moment slices updated, the coefficients all-gathered."""
    if not sharded:
        packed = C.sum_shards(parts, mesh)
        if tp is not None:
            packed = tp.gather(mesh, packed)
        return _apply_packed(prm, rule, coeffs, opt, packed)
    stack = C.stack_shards(mesh, parts)
    tail = C.all_reduce_sum(stack[:, -2:], mesh)
    total_w, total_loss = tail[0], tail[1]
    has_weight = total_w > 0

    def apply_fn(g_slice, c_slice, opt_slice):
        upd, new_opt = rule(g_slice, total_w, c_slice, opt_slice)
        upd, _ = regularize(upd, prm.reg, prm.elastic_net,
                            prm.learning_rate)
        # a zero-weight round leaves coefficients and moments as they are
        return (torch.where(has_weight, upd, c_slice),
                tuple(torch.where(has_weight, n, o)
                      for n, o in zip(new_opt, opt_slice)))

    grads = _upd.pad_leading(stack[:, :-2], coeffs.shape[0], dim=1)
    coeffs, opt = _upd.sharded_apply(mesh, grads, coeffs, opt, apply_fn)
    return coeffs, opt, total_loss / torch.clamp_min(total_w, 1e-30)


def _where(active: torch.Tensor, new, old):
    """``torch.where(active, new, old)``, slice by slice for a
    :class:`~update_sharding.Sharded` leaf."""
    if isinstance(new, _upd.Sharded):
        return new.map(lambda n, o: torch.where(active, n, o), old)
    return torch.where(active, new, old)


def _masked_rounds(batch_terms: BatchTerms, loss_name: str, prm: SGDParams,
                   mesh, sharded: bool, data: ShardData,
                   coeffs: torch.Tensor, opt: tuple, offsets, rounds: int,
                   rows: Optional[list] = None,
                   tp: Optional[TPColumns] = None):
    """``rounds`` rounds from the shards' window ``offsets`` with the tol
    stop as a mask → (coeffs, opt, mean_loss at the stopping round, rounds
    run, stop), all tensors on the device; nothing here waits for the
    device. A round after the stop changes nothing. With ``rows`` (health
    armed) each round appends its :func:`~health.health_row` as a device
    tensor; the caller keeps the rows of the rounds run. With ``tp`` (a
    tensor-parallel mesh) each round's partials come from
    :func:`_tp_round_partials` instead of ``batch_terms``."""
    sched = ShardSchedule(prm.global_batch_size, mesh.size, data.x.ls,
                          data.x.real)
    shards = list(zip(data.x.parts, data.y.parts, data.w.parts))
    rule = _update_rule(prm)
    mean_loss = torch.full((), float("inf"), dtype=torch.float32,
                           device=coeffs.device)
    ran = torch.zeros((), dtype=torch.int32, device=coeffs.device)
    stop = torch.zeros((), dtype=torch.bool, device=coeffs.device)
    for windows in sched.windows(mesh.local_shards, offsets, rounds):
        if tp is not None:
            parts = _tp_round_partials(loss_name, mesh, tp, shards, windows,
                                       coeffs)
        else:
            parts = _round_partials(batch_terms, loss_name, mesh, shards,
                                    windows, coeffs)
        updated, new_opt, new_loss = _apply_round(prm, rule, mesh, sharded,
                                                  coeffs, opt, parts, tp)
        # the tol stop as a mask: a round after it changes nothing
        active = torch.logical_not(stop)
        if rows is not None:
            # rows after the stop are cut off on the host (by rounds run)
            rows.append(_health.health_row(new_loss, coeffs, updated))
        coeffs = torch.where(active, updated, coeffs)
        opt = tuple(_where(active, nw, old) for nw, old in zip(new_opt, opt))
        mean_loss = torch.where(active, new_loss, mean_loss)
        ran = ran + active.to(torch.int32)
        stop = torch.logical_or(stop, torch.logical_and(active,
                                                        new_loss < prm.tol))
    return coeffs, opt, mean_loss, ran, stop


def sgd_rounds(batch_terms: BatchTerms, loss_name: str, prm: SGDParams,
               x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               coeffs: torch.Tensor, mesh=None) -> Tuple[torch.Tensor,
                                                         torch.Tensor,
                                                         torch.Tensor]:
    """Every round of a replicated fit on device tensors, with each round's
    terms from ``batch_terms`` (:func:`kernels.sgd_batch_terms` or its
    plain version), on ``mesh`` (default: one shard on x's device) →
    (coeffs, mean_loss at the stopping round, rounds run), all tensors on
    the device; nothing here waits for the device."""
    mesh = mesh if mesh is not None else Mesh([x.device])
    opt = _init_opt(prm, coeffs.shape[0], coeffs.device)
    coeffs, _, mean_loss, ran, _ = _masked_rounds(
        batch_terms, loss_name, prm, mesh, False,
        ShardData.place(mesh, x, y, w), coeffs, opt,
        np.zeros(mesh.size, np.int32), prm.max_iter)
    return coeffs, mean_loss, ran


def _on_device(values, device: torch.device) -> torch.Tensor:
    """A contiguous float32 tensor on ``device``: host arrays are placed
    once; a tensor already there is used as it is."""
    return torch.as_tensor(values, dtype=torch.float32,
                           device=device).contiguous()


def _finish_fit_health(algo: str, health_on: bool, hist, epochs: int,
                       mean_loss, coeffs_host, epoch0: int = 0) -> None:
    """The shared health tail of the SGD fit paths (the JAX package's
    ``_finish_fit_health``): armed, record the executed slice ``[epoch0,
    epochs)`` of the (max_iter, 3) host series and classify divergence
    (raising the terminal NonFiniteState on a non-finite row); otherwise
    run the cheap always-on guard over the already-fetched final state."""
    if health_on and hist is not None:
        h = np.asarray(hist, np.float64)
        lo = min(int(epoch0), h.shape[0])
        hi = min(int(epochs), h.shape[0])
        _health.check_fit(
            algo, {"loss": h[lo:hi, 0], "updateNorm": h[lo:hi, 1],
                   "paramNorm": h[lo:hi, 2]},
            finite=bool(np.isfinite(h[lo:hi]).all()), epoch0=lo)
    else:
        _health.guard_final_state(algo, coeffs_host, loss=mean_loss)


class SGD:
    """Ref: Optimizer/SGD: optimize(initModel, trainData) → fitted coeffs."""

    def __init__(self, params: SGDParams):
        self.params = params
        self.last_execution_path = None

    def _iterate(self, batch_terms: BatchTerms, loss_name: str, mesh,
                 sharded: bool, data: ShardData, init, seg_k: int, config,
                 listeners, algo: str, health_on: bool,
                 tp: Optional[TPColumns] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
        """The rounds through the iteration runtime → (coeffs, mean_loss,
        health state), device tensors. The carry is the JAX package's, leaf
        for leaf: ``(coeffs f32, offsets (p,) int32, mean_loss f32, opt)``,
        with the coefficients and moments padded and the moments
        :class:`~update_sharding.Sharded` under the sharded update, so the
        two packages' checkpoints hold the same leaves. ``offsets`` (the
        shards' window offsets) is a host numpy array: the schedule is
        Python ints, so a restored offset needs no device read. Each call
        builds a fresh carry, and no carry tensor is updated in place.

        With health armed a segment's rows ride its boundary fetch into
        the health state's (max_iter, 3) host ``hist`` (a non-finite row
        fails the fit at that boundary), and host rounds gain a
        :class:`~health.ConvergenceListener`; the health state stays
        outside the checkpointed carry, so a snapshot is the same with
        telemetry on or off."""
        prm = self.params
        sched = ShardSchedule(prm.global_batch_size, mesh.size, data.x.ls,
                              data.x.real)
        hstate = {"hist": None, "first": None, "epoch": 0}

        if seg_k:
            if health_on:
                hstate["hist"] = np.full((prm.max_iter, 3), np.nan,
                                         np.float32)

            def run_segment(carry, epoch0, limit):
                coeffs, offsets, _, opt = carry
                if hstate["first"] is None:
                    hstate["first"] = epoch0
                rows = [] if health_on else None
                coeffs, opt, mean_loss, ran, stop = _masked_rounds(
                    batch_terms, loss_name, prm, mesh, sharded, data, coeffs,
                    opt, offsets, limit - epoch0, rows, tp)
                # the boundary's one fetch: [epoch, stop], then the
                # segment's health rows as their float32 bits
                boundary = torch.stack([ran + epoch0, stop.to(torch.int32)])
                if rows:
                    boundary = torch.cat([boundary, torch.stack(rows).view(
                        torch.int32).flatten()])
                vals = iteration.read_boundary(boundary)
                epoch, stop = int(vals[0]), bool(vals[1])
                if rows:
                    got = np.asarray(vals[2:], np.int32).view(
                        np.float32).reshape(-1, 3)[:epoch - epoch0]
                    hstate["hist"][epoch0:epoch] = got
                    hstate["epoch"] = epoch
                    if not np.isfinite(got).all():
                        # a NaN state fails the fit at this boundary
                        _finish_fit_health(algo, True, hstate["hist"], epoch,
                                           None, None, hstate["first"])
                return ((coeffs, sched.advance(offsets, epoch - epoch0),
                         mean_loss, opt), epoch, stop)

            final = iteration.run_segmented(run_segment, init, prm.max_iter,
                                            seg_k, config.checkpoint_manager)
        else:
            def body(carry, epoch):
                # one round of the segments' own function, so every mode
                # runs the same update
                coeffs, offsets, _, opt = carry
                coeffs, opt, mean_loss, _, _ = _masked_rounds(
                    batch_terms, loss_name, prm, mesh, sharded, data, coeffs,
                    opt, offsets, 1, tp=tp)
                return coeffs, sched.advance(offsets), mean_loss, opt

            if health_on:
                # host rounds: the series rides a listener that reads the
                # lagged carries and fetches its rows once, at termination
                listeners = tuple(listeners) + (
                    _health.ConvergenceListener.for_params(algo, init[0]),)
            final = iteration.iterate_bounded(
                init, body, max_iter=prm.max_iter,
                terminate=lambda carry, epoch: carry[2] < prm.tol,
                config=config, listeners=listeners)
        coeffs, _, mean_loss, _ = final
        return coeffs, mean_loss, hstate

    def optimize(self, loss_func: LossFunc, init_coeffs,
                 features, labels, weights=None,
                 device: DeviceLike = None,
                 config=None, listeners=(),
                 tag: Optional[str] = None,
                 mesh=None) -> Tuple[np.ndarray, float]:
        """Returns (coeffs (d,) float64 np.ndarray, final mean loss float).

        ``features`` (n, d), ``labels`` and ``weights`` (n,) are numpy arrays,
        tensors or split columns (``collective.ShardedColumn``: one split
        as ``mesh`` splits rows is used as it is, another is split again on
        the device); ``weights=None`` means ones. The rows are split over
        ``mesh`` (``parallel/mesh.py``; default :func:`resolve_mesh`: the
        default mesh when one was set, else one shard on ``device``, the
        CUDA card by default) as contiguous views: a tensor already on the
        shards' device stays there, a host array is placed once as float32.
        Each shard takes its own local batch of the global batch per round
        (:class:`ShardSchedule`) and the shards' terms are summed before the
        update; with ``FLINK_ML_TPU_UPDATE_SHARDING=1`` the update is the
        cross-replica sharded one (``parallel/update_sharding.py``). Rounds
        run the ``sgd_batch_terms`` kernel on the card (``cuda-sgd``), one
        launch per shard, and its plain PyTorch version on the CPU
        (``torch-sgd``).

        A scipy CSR ``features`` matrix takes :meth:`optimize_csr`.

        With ``config``/``listeners`` (an ``IterationConfig`` with host
        hooks) the rounds run through the iteration runtime, resumable from
        a checkpoint with the all-device fit's results: K-round segments
        when the only hook is a device-mode checkpoint interval
        (``-segments``), host rounds otherwise (``-rounds``).
        ``tag`` names the fit in a :class:`NonFiniteState` error and in the
        state-bytes record (the estimator's class name; ``SGD[<loss>]`` by
        default).
        """
        _check_method(self.params)
        if sp.issparse(features):
            return self.optimize_csr(loss_func, init_coeffs, features, labels,
                                     weights, device=device, config=config,
                                     listeners=listeners, tag=tag, mesh=mesh)
        if not isinstance(features, (np.ndarray, torch.Tensor,
                                     C.ShardedColumn)):
            raise TypeError("features must be a numpy array, a tensor, a "
                            "split column or a "
                            f"scipy CSR matrix, got {type(features).__name__}")
        mesh = resolve_mesh(mesh, device)
        tp = None
        if model_axis_of(mesh) is not None:
            # tensor parallelism: the feature dim padded to the model-axis
            # size and split over it
            tp, x = TPColumns.place(mesh, features)
            data = ShardData(x, *ShardData._labels(mesh, x.n, labels,
                                                   weights))
        else:
            data = ShardData.place(mesh, features, labels, weights)
        return self._fit(loss_func, init_coeffs, mesh, data,
                         kernels.sgd_batch_terms, "sgd", config, listeners,
                         tag, tp)

    def optimize_csr(self, loss_func: LossFunc, init_coeffs, features_csr,
                     labels, weights=None, device: DeviceLike = None,
                     config=None, listeners=(), tag: Optional[str] = None,
                     mesh=None) -> Tuple[np.ndarray, float]:
        """:meth:`optimize` of a scipy CSR ``features_csr`` (n, d): wide
        sparse input (HashingTF at 2^18 dims) is never densified (ref:
        SGD.java trains SparseVector natively, BLAS.java:78).

        The same rounds as the dense fit on the same mesh: the same
        ``ceil(n/p)`` row shards, per-shard batch share, clip at the shard
        end and offset wrap (:class:`ShardSchedule`), the same update tail,
        tol stop, iteration modes and checkpoints. The matrix goes to the
        shards' devices once; each round runs two ``segment_reduce_sum``
        launches per shard whose window holds a stored value
        (:func:`csr_batch_terms`): ``cuda-csr`` on the card (``-segments``
        / ``-rounds`` with hooks), ``torch-csr`` with the plain segment sums
        on the CPU. The JAX package runs this path in float64 on the host;
        the port's is float32, as its dense path is."""
        _check_method(self.params)
        mesh = resolve_mesh(mesh, device)
        data = ShardData.place_csr(mesh, features_csr, labels, weights)
        return self._fit(loss_func, init_coeffs, mesh, data, csr_batch_terms,
                         "csr", config, listeners, tag)

    def _fit(self, loss_func: LossFunc, init_coeffs, mesh, data: ShardData,
             batch_terms: BatchTerms, kind: str, config, listeners,
             tag: Optional[str], tp: Optional[TPColumns] = None
             ) -> Tuple[np.ndarray, float]:
        """The fit of :meth:`optimize` and :meth:`optimize_csr` on placed
        data, each round's terms from ``batch_terms`` (from ``tp``'s
        column blocks on a tensor-parallel mesh); the execution path is
        ``cuda-<kind>`` or ``torch-<kind>``, with its mode's suffix."""
        prm = self.params
        p = mesh.size
        d = tp.d if tp is not None else data.x.parts[0].shape[1]
        if tracing.tracer.enabled:
            # per-shard row counts at the fit boundary (the JAX package
            # records them for KMeans; the port for every mesh fit)
            meshstats.record_shard_rows(mesh, data.x.n)
        device = mesh.devices[mesh.local_shards[0]]
        coeffs = _on_device(init_coeffs, device)
        if coeffs.shape != (d,):
            raise ValueError(f"features are ({data.x.n}, {d}), so the "
                             f"coefficients must be ({d},), got "
                             f"{tuple(coeffs.shape)}")
        # the cross-replica sharded update: the coefficient carry padded to
        # the shard multiple (padded coordinates stay exactly zero); off on
        # a tensor-parallel mesh, as in the JAX package
        sharded = _upd.enabled() and tp is None
        dp = (tp.dp if tp is not None
              else _upd.padded_len(d, p) if sharded else d)
        coeffs = _upd.pad_leading(coeffs, dp)
        algo = tag or f"SGD[{loss_func.NAME}]"
        # a fresh carry per call, the JAX package's make_init: the opt tuple
        # rides at the end so a method="sgd" carry keeps the stateless leaves
        init = (coeffs, np.zeros(p, np.int32),
                torch.full((), float("inf"), dtype=torch.float32,
                           device=device),
                _init_opt(prm, dp, device, mesh, sharded))
        opt_leaves = list(init[3])
        state_leaves = [coeffs] + opt_leaves
        if tp is not None:
            # a model shard holds its dm-slice of each vector
            state_leaves = [v[:tp.dm] if v.ndim else v for v in state_leaves]
            kind = "tp"
        if opt_leaves:
            _upd.record_state_bytes(f"{algo}.moments", state_leaves[1:], p,
                                    sharded)
        _upd.record_state_bytes(algo, state_leaves, p, sharded)

        base = ("cuda-" if device.type == "cuda" else "torch-") + kind
        health_on = _health.armed()
        seg_k = iteration.device_checkpoint_segment(config, listeners)
        hstate = {"hist": None, "first": None, "epoch": 0}
        rows = None
        host_rounds = not seg_k and iteration.needs_host_loop(config,
                                                              listeners)
        if not seg_k and not host_rounds:
            rows = [] if health_on and prm.max_iter > 0 else None
            coeffs, _, mean_loss, ran, _ = _masked_rounds(
                batch_terms, loss_func.NAME, prm, mesh, sharded, data,
                init[0], init[3], init[1], prm.max_iter, rows, tp)
            path = base
        else:
            coeffs, mean_loss, hstate = self._iterate(
                batch_terms, loss_func.NAME, mesh, sharded, data, init, seg_k,
                config, listeners, algo, health_on, tp)
            path = base + ("-segments" if seg_k else "-rounds")
        # benchmark provenance (runner.py executionPath)
        self.last_execution_path = path

        # the one host synchronisation of the fit (the health rows and the
        # rounds run ride along when armed)
        parts = [coeffs, mean_loss[None]]
        if rows:
            parts += [ran.to(torch.float32)[None], torch.stack(rows).flatten()]
        final = torch.cat(parts).cpu().numpy()
        dp = coeffs.shape[0]
        out = final[:d].astype(np.float64)
        loss = float(final[dp])
        if rows:
            hstate = {"hist": final[dp + 2:].reshape(-1, 3),
                      "first": 0, "epoch": int(final[dp + 1])}
        if not (health_on and host_rounds):  # their listener reported
            _finish_fit_health(algo, health_on, hstate["hist"],
                               hstate["epoch"], loss, out,
                               hstate["first"] or 0)
        return out, loss
