"""Collectives over a mesh's shards, and row placement.

The port of ``flink_ml_tpu/parallel/collective.py:100-297,432-479`` (ref:
AllReduceImpl.java:71-102 for the sum, BroadcastUtils.java:65 for broadcast,
SharedProgressAligner.java:277-292 for the termination vote).

A primitive takes the values of this process's shards, stacked on dim 0: all
N shards on an in-process mesh, the rank's own under ``torch.distributed``
(so ``x[i]`` is the value of shard ``mesh.local_shards[i]``). A sum may name
the axes it runs over (``axes``, default the mesh's data axes): on an
in-process N-D mesh the stack then holds the positions along those axes,
row-major, e.g. the model shards of one data shard for a sum over
``("model",)``. The two backends behind the one interface:

- **in-process**: the cross-shard sum of float32 values is
  ``kernels.reduce_partials`` on the stack: the hand-written kernel on the
  card, in its fixed two-level order, so reruns give the same bits, and its
  plain version on the CPU. Other dtypes add the shards in shard order.
  ``reduce_scatter`` is that sum cut into N dim-0 slices in
  :func:`shard_index` order, and ``all_gather`` a concatenation. At one
  shard every primitive is the identity and launches nothing.
- **torch.distributed**: a rank first sums its own shards (as above), then
  ``all_reduce``, ``all_gather_into_tensor`` and ``reduce_scatter_tensor``
  on NCCL; gloo takes ``all_reduce`` plus the owned slices for the scatter
  and ``all_gather`` of a list for the gather. Each runs on the ranks that
  share this rank's coordinates off the axes it spans
  (``Mesh.axis_group``): the whole group for a sum over every axis, a
  subgroup for a subset (the model axis of a tensor-parallel fit, its data
  axis), and no call at all when this rank is alone on them, so a sum over
  axes whose shards all live here is ``reduce_partials`` only. CUDA tensors
  go to gloo as they are: every gloo collective the port calls takes them
  (:data:`GLOO_CUDA_OPS`). The one gloo op that does not, ring attention's
  send/recv, is staged in ``sequence.py``.

**The two-level reduce** (``_hier_psum`` of the JAX package,
arXiv:1903.06701): a sum over two or more axes, the slow outer one first
(``("dcn", "data")``), may reduce near the data: a reduce-scatter over the
inner axes, a sum over the outer axis at ``1/local_N`` of the payload (the
only inter-level traffic), an all-gather over the inner axes.
``FLINK_ML_TPU_HIER_REDUCE`` forces it on (``1``) or off (``0``); unset, it
is on exactly when the runtime spans processes. In-process the legs are two
``reduce_partials`` launches (the inner sums of every outer row at once,
then the outer sum); the all-gather is the identity. It equals the flat sum
up to float reassociation. Across processes the port's flat sum is already
two-level: a rank holds its whole inner row, sums it in-process and puts
the full payload on the process group's ``all_reduce``, so both routes are
that one sum there.

Each reduce over two or more axes records its per-level payload,
``ml.collective levelOps{op=,level=,axis=}`` and ``levelPayloadBytes{...}``.
Across processes the inter level is what the rank hands to the group: the
full payload, whichever route. In-process nothing crosses a slow link, and
the record is the JAX package's per-shard accounting of a mesh whose shards
are devices of their own: the full payload on the inter level when flat,
the ``1/local_N`` slice when hierarchical. That ratio is a model of such a
mesh, not traffic the port measured.

Placement (:func:`ensure_on_mesh`) never pads a tensor by copying it: shard
``s`` is the contiguous row view ``x[s*ls : min((s+1)*ls, n)]`` with ``ls =
ceil(n / p)``, and the rows a padded last shard lacks are left to the window
arithmetic of the fits.

Accounting, the JAX package's host-collective one (``_HostOp``): inside a
traced call (a span open on the thread), each cross-shard primitive and
each placement records the mesh's topology once
(``observability/meshstats.py``, ``mesh.json``) and opens a
``collective.host`` span (``op``, ``devices``, ``payload_bytes``: one
shard's bytes) on the caller's thread and records ``ml.collective
opMs{op=,devices=}`` and ``payloadBytes{op=,devices=}`` (a primitive on
one in-process shard, the identity, records nothing). The JAX package's
trace-time ``tracedOps`` count of in-program collectives has no eager
counterpart. Unarmed, a call costs one env check.
"""

from __future__ import annotations

import functools
import math
import os
import time
from typing import List, NamedTuple, Optional, Sequence

import torch

from flink_ml_tpu_torch.common.metrics import ML_GROUP, metrics
from flink_ml_tpu_torch.observability import meshstats, tracing
from flink_ml_tpu_torch.ops import kernels
from flink_ml_tpu_torch.parallel.mesh import Mesh

#: byte-shaped histogram bounds for collective payloads (the default
#: buckets are latency-shaped)
PAYLOAD_BUCKETS = (256.0, 4096.0, 65536.0, 1048576.0, 16777216.0,
                   268435456.0, 4294967296.0)

#: env var: force the two-level reduce on ("1") or off ("0"); unset or
#: other = auto (on when the runtime spans processes); the JAX package's
HIER_ENV = "FLINK_ML_TPU_HIER_REDUCE"

#: the gloo collectives the port calls on CUDA tensors as they are, by the
#: names of ``scripts/port_gloo_cuda_probe.py``; ``chip_smoke.py`` phase 19
#: checks on the card that gloo takes each of them (torch 2.11 on the H100
#: does; its send/recv does not, and aborts its process with "Bad address",
#: so ``sequence.py`` stages the ring's hops through pinned host buffers)
GLOO_CUDA_OPS = frozenset({
    "all_reduce", "broadcast", "all_gather", "all_to_all_single"})


def _collective_group():
    return metrics.group(ML_GROUP, "collective")

class _HostOp:
    """Time one host-side collective or placement op into ``ml.collective
    opMs{op=,devices=}`` (+ ``payloadBytes``), inside a ``collective.host``
    span when a trace dir is armed. Also the seam that records the mesh
    topology: a host op is proof the mesh is in use."""

    __slots__ = ("op", "mesh", "devices", "nbytes", "_t0", "_span_cm")

    def __init__(self, op: str, mesh: Mesh, nbytes: int = 0):
        self.op = op
        self.mesh = mesh
        self.devices = mesh.size
        self.nbytes = int(nbytes)
        self._span_cm = None

    def __enter__(self):
        try:  # an unwritable trace dir must not sink the data path
            meshstats.ensure_mesh_recorded(self.mesh)
        except Exception:
            pass
        if tracing.tracer.enabled:
            self._span_cm = tracing.tracer.span(
                "collective.host", op=self.op, devices=self.devices,
                payload_bytes=self.nbytes)
            self._span_cm.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        ms = (time.perf_counter() - self._t0) * 1000.0
        labels = {"op": self.op, "devices": str(self.devices)}
        group = metrics.group(ML_GROUP, "collective")
        group.histogram("opMs", labels=labels).observe(ms)
        if self.nbytes:
            group.histogram("payloadBytes", buckets=PAYLOAD_BUCKETS,
                            labels=labels).observe(self.nbytes)
        if self._span_cm is not None:
            self._span_cm.__exit__(*exc)
        return False


def _accounted(op: str):
    """Decorate a primitive ``fn(x, mesh, ...)`` (``x`` an (L, ...) stack
    or a list of this process's shard values; its payload is one shard's
    bytes) with a :class:`_HostOp` inside a traced call (a span open on
    this thread) when the op crosses shards; otherwise the call costs an
    attribute check (at one in-process shard every primitive is the
    identity) or a thread-local read."""

    def wrap(fn):
        @functools.wraps(fn)
        def accounted(x, mesh: Mesh, *args, **kwargs):
            if ((mesh.size == 1 and not mesh.distributed)
                    or tracing.tracer.current() is None):
                return fn(x, mesh, *args, **kwargs)
            first = x[0] if len(x) else None
            nbytes = (0 if first is None
                      else first.numel() * first.element_size())
            with _HostOp(op, mesh, nbytes):
                return fn(x, mesh, *args, **kwargs)

        return accounted

    return wrap


def _is_nccl(mesh: Mesh) -> bool:
    import torch.distributed as dist

    return dist.get_backend(mesh.group) == "nccl"


def _dist_all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    import torch.distributed as dist

    if op is None:
        dist.all_reduce(t, group=group)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def _stack_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over dim 0 of an in-process stack, in a fixed order."""
    n = x.shape[0]
    if n == 1:
        return x[0]
    if x.dtype == torch.float32:
        out = kernels.reduce_partials(x.reshape(n, -1).contiguous())
        return out.reshape(x.shape[1:])
    out = x[0].clone()
    for i in range(1, n):
        out = out + x[i]
    return out


def stack_shards(mesh: Mesh, values: Sequence[torch.Tensor]) -> torch.Tensor:
    """This process's per-shard values as one (L, ...) stack on the first
    local shard's device (the collectives' input)."""
    dev = mesh.devices[mesh.local_shards[0]]
    values = [v if v.device == dev else v.to(dev) for v in values]
    return values[0][None] if len(values) == 1 else torch.stack(values)


# -- the two-level reduce -----------------------------------------------------

def hier_reduce_forced() -> Optional[bool]:
    """The ``FLINK_ML_TPU_HIER_REDUCE`` override: True/False when the env
    forces the two-level or the flat sum, None for auto."""
    raw = os.environ.get(HIER_ENV, "").strip().lower()
    if raw in ("1", "true", "on", "yes"):
        return True
    if raw in ("0", "false", "off", "no"):
        return False
    return None


def _hier_active(axes) -> bool:
    """Whether a sum over ``axes`` takes the two-level route: it needs a
    (slow, fast) split of two or more axes; then the env decides, else it
    is on exactly when the runtime spans processes (one process's outer
    axis is as fast as its inner one, so the flat sum is as good there)."""
    if len(axes) < 2:
        return False
    forced = hier_reduce_forced()
    if forced is not None:
        return forced
    import torch.distributed as dist

    return bool(dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1)


def _note_level(op: str, level: str, nbytes: int, axes) -> None:
    """Per-level payload accounting of a sum over two or more axes
    (``ml.collective levelOps`` / ``levelPayloadBytes{op=,level=,axis=}``):
    ``inter`` bytes cross the slow outer axis, ``intra`` bytes stay on
    the inner ones; ``nbytes`` is one shard's payload of the leg (across
    processes, the rank's payload on the group)."""
    labels = {"op": op, "level": level, "axis": ",".join(axes)}
    group = _collective_group()
    group.counter("levelOps", labels=labels)
    group.histogram("levelPayloadBytes", buckets=PAYLOAD_BUCKETS,
                    labels=labels).observe(nbytes)


def _sum_axes(mesh: Mesh, axes) -> tuple:
    if axes is None:
        return mesh.shard_axes
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    missing = [a for a in axes if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"axes {missing} are not axes of {mesh}")
    return axes


def _hier_sum(x: torch.Tensor, mesh: Mesh, axes: tuple) -> torch.Tensor:
    """The two-level sum of an in-process stack ``x`` over ``axes`` (outer
    axis first): the inner sums of every outer row in one
    ``reduce_partials`` call, then their sum over the outer axis in
    another; recorded with the per-shard accounting of the module
    docstring."""
    value = tuple(x.shape[1:])
    itemsize = x.element_size()
    local_n = math.prod(mesh.shape[a] for a in axes[1:])
    if local_n <= 1 or not value:
        # no fast axis to scatter over, or a scalar: one flat sum with the
        # full payload on the inter level
        _note_level("psum", "inter", math.prod(value) * itemsize, axes)
        return _flat_sum(x, mesh, axes)
    n0 = value[0]
    rest = math.prod(value[1:])
    padded = n0 + (-n0) % local_n
    chunk_bytes = padded // local_n * rest * itemsize
    _note_level("reduce_scatter", "intra", padded * rest * itemsize, axes)
    _note_level("psum", "inter", chunk_bytes, axes)
    _note_level("all_gather", "intra", chunk_bytes, axes)
    outer = x.shape[0] // local_n
    m = math.prod(value)
    inner = x.reshape(outer, local_n, m).transpose(0, 1).reshape(
        local_n, outer * m)
    return _stack_sum(_stack_sum(inner).reshape(outer, m)).reshape(value)


def _flat_sum(x: torch.Tensor, mesh: Mesh, axes: tuple) -> torch.Tensor:
    """This process's stack summed, then over the ranks that share its
    coordinates off ``axes`` (none when it is alone on them)."""
    local = _stack_sum(x)
    group = mesh.axis_group(axes) if mesh.distributed else None
    if group is None:
        return local
    return _dist_all_reduce(local.clone(), group)


@_accounted("all_reduce_sum")
def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axes=None) -> torch.Tensor:
    """The sum over ``axes`` (default: the data axes; every axis of a mesh
    without one), the same on each shard (ref: AllReduceImpl.java:54
    allReduceSum). Over two or more axes it may take the two-level route
    (see the module docstring)."""
    axes = _sum_axes(mesh, axes)
    if _hier_active(axes) and not mesh.distributed:
        return _hier_sum(x, mesh, axes)
    if len(axes) > 1:
        # the flat sum over a mesh with a slow outer axis, or any sum over
        # processes: the full payload crosses the inter level
        _note_level("psum", "inter", x[0].numel() * x.element_size(), axes)
    return _flat_sum(x, mesh, axes)


def sum_shards(values: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """:func:`all_reduce_sum` of this process's per-shard values given as a
    list; the one value itself on a one-shard in-process mesh (no stack is
    built: the default mesh's fits pay nothing for the layer)."""
    if len(values) == 1 and not mesh.distributed:
        return values[0]
    return all_reduce_sum(stack_shards(mesh, values), mesh)


def all_reduce_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return all_reduce_sum(x, mesh) / mesh.size


@_accounted("all_reduce_max")
def all_reduce_max(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    local = x[0] if x.shape[0] == 1 else x.amax(dim=0)
    group = mesh.axis_group() if mesh.distributed else None
    if group is None:
        return local
    import torch.distributed as dist

    return _dist_all_reduce(local.clone(), group, op=dist.ReduceOp.MAX)


@_accounted("reduce_scatter")
def reduce_scatter(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over every shard, each shard keeping its own 1/N slice of dim
    0: an (L, chunk, ...) stack of this process's slices. Dim 0 of a value
    must be a multiple of the shard count (pad with zeros: a zero gradient
    is inert through every update rule here); the slices are in
    :func:`shard_index` order, so :func:`all_gather` of them rebuilds the
    sum."""
    p = mesh.size
    rows = x.shape[1]
    if rows % p:
        raise ValueError(f"reduce_scatter: dim 0 of {rows} is not a multiple "
                         f"of the {p} shards (pad it with padded_len)")
    chunk = rows // p
    tail = tuple(x.shape[2:])
    group = mesh.axis_group() if mesh.distributed else None
    if group is None:
        return _stack_sum(x).reshape((p, chunk) + tail)
    import torch.distributed as dist

    local = _stack_sum(x).contiguous()
    per = len(mesh.local_shards)
    if _is_nccl(mesh):
        out = x.new_empty((per * chunk,) + tail)
        dist.reduce_scatter_tensor(out, local, group=group)
        return out.reshape((per, chunk) + tail)
    total = _dist_all_reduce(local.clone(), group)
    lo = mesh.local_shards[0] * chunk
    return total[lo:lo + per * chunk].reshape((per, chunk) + tail)


@_accounted("all_gather")
def all_gather(x, mesh: Mesh, axes=None) -> torch.Tensor:
    """This process's (L, chunk, ...) slices (a stack or a list) gathered
    over ``axes`` (default: the shard axes) into the whole, in row-major
    order over those axes: the ranks of a gather hold consecutive
    positions along them, in rank order."""
    parts = list(x)
    block = parts[0] if len(parts) == 1 else torch.cat(parts)
    group = (mesh.axis_group(_sum_axes(mesh, axes)) if mesh.distributed
             else None)
    if group is None:
        return block
    import torch.distributed as dist

    ranks = len(mesh.axis_ranks(_sum_axes(mesh, axes)))
    block = block.contiguous()
    if _is_nccl(mesh):
        out = block.new_empty((ranks * block.shape[0],)
                              + tuple(block.shape[1:]))
        dist.all_gather_into_tensor(out, block, group=group)
        return out
    gathered = [torch.empty_like(block) for _ in range(ranks)]
    dist.all_gather(gathered, block, group=group)
    return torch.cat(gathered)


def shard_index(mesh: Mesh) -> tuple:
    """The shards this process computes, in the order of dim 0 of the
    primitives' stacks; the slice order of :func:`reduce_scatter`."""
    return mesh.local_shards


@_accounted("broadcast")
def broadcast_from(x: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Shard ``src``'s value, on every shard (ref: the .broadcast() edges)."""
    group = mesh.axis_group() if mesh.distributed else None
    if group is None:
        return x[src - mesh.local_shards[0]]
    import torch.distributed as dist

    per = len(mesh.local_shards)
    owner = mesh.axis_ranks()[src // per]
    out = (x[src - mesh.local_shards[0]] if owner == mesh.rank
           else x[0]).clone()
    dist.broadcast(out, owner, group=group)
    return out


def termination_vote(local_count: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """True iff the global count is zero: the reference coordinator's
    termination rule (SharedProgressAligner.java:277-292) as one sum."""
    return all_reduce_sum(local_count, mesh) == 0


def renormalized_sum(x: torch.Tensor, include: torch.Tensor,
                     mesh: Mesh) -> torch.Tensor:
    """Partial-participation sum (arXiv:2208.09740): a shard whose 0/1
    ``include`` (one per local shard) is 0 adds zero, and the sum is scaled
    by ``n_shards / participants`` so the expected update stays unbiased.
    With every shard included it equals :func:`all_reduce_sum` bit for
    bit (a factor of exactly 1)."""
    dtype = x.dtype if x.is_floating_point() else torch.float32
    inc = include.to(dtype)
    total = all_reduce_sum(x.to(dtype) * inc.reshape(
        (-1,) + (1,) * (x.ndim - 1)), mesh)
    participants = all_reduce_sum(inc.reshape(-1, 1), mesh)[0]
    return total * (mesh.size / torch.clamp_min(participants, 1.0))


# -- row placement ------------------------------------------------------------

def shard_len(n: int, n_shards: int) -> int:
    """Rows per shard, the last one padded: ``ceil(n / p)`` (1 for n = 0)."""
    return -(-int(n) // int(n_shards)) if n else 1


class RowShards(NamedTuple):
    """A table's rows split over a mesh: ``parts[i]`` is the contiguous row
    view of shard ``mesh.local_shards[i]``, on its device; ``n`` the rows of
    the whole table, ``ls`` the rows per shard (:func:`shard_len`), and
    ``real[s]`` the rows shard ``s`` really holds (``ls`` but for a short
    last shard or empty ones past the end)."""
    parts: List[torch.Tensor]
    n: int
    ls: int
    real: List[int]


def _real_rows(n: int, ls: int, n_shards: int) -> List[int]:
    return [max(0, min(ls, n - s * ls)) for s in range(n_shards)]


def ensure_on_mesh(mesh: Mesh, array, dtype=torch.float32) -> RowShards:
    """Place a host array or a tensor on the mesh, split by rows. A tensor
    already on the shards' device with ``dtype`` is viewed, not copied; a
    host array goes to the device once (under ``torch.distributed``, only
    the rank's own rows)."""
    if tracing.tracer.current() is None:
        return _ensure_on_mesh(mesh, array, dtype)
    nbytes = (array.numel() * array.element_size()
              if isinstance(array, torch.Tensor)
              else int(getattr(array, "nbytes", 0)))
    with _HostOp("ensure_on_mesh", mesh, nbytes):
        return _ensure_on_mesh(mesh, array, dtype)


def _ensure_on_mesh(mesh: Mesh, array, dtype) -> RowShards:
    n = int(array.shape[0])
    p = mesh.size
    if p == 1 and not mesh.distributed:
        return RowShards([torch.as_tensor(array, dtype=dtype,
                                          device=mesh.devices[0]).contiguous()],
                         n, n or 1, [n])
    ls = shard_len(n, p)
    real = _real_rows(n, ls, p)
    local = mesh.local_shards
    devices = {str(mesh.devices[s]) for s in local}
    if len(devices) == 1 and not mesh.distributed:
        full = torch.as_tensor(array, dtype=dtype,
                               device=mesh.devices[local[0]]).contiguous()
        parts = [full[s * ls:s * ls + real[s]] for s in local]
    else:
        parts = [torch.as_tensor(array[s * ls:s * ls + real[s]], dtype=dtype,
                                 device=mesh.devices[s]).contiguous()
                 for s in local]
    return RowShards(parts, n, ls, real)


def ones_on_mesh(mesh: Mesh, n: int, dtype=torch.float32) -> RowShards:
    """A length-``n`` ones column split as :func:`ensure_on_mesh` splits
    ``n`` rows: the default sample weights, made on the devices."""
    p = mesh.size
    ls = shard_len(n, p)
    real = _real_rows(n, ls, p)
    parts = [torch.ones(real[s], dtype=dtype, device=mesh.devices[s])
             for s in mesh.local_shards]
    return RowShards(parts, int(n), ls, real)

