"""The mesh: the shards a fit splits its work over, their axes and devices.

The port of ``flink_ml_tpu/parallel/mesh.py:120,166-291``. The reference's
"parallelism" knob (the number of subtasks) becomes the number of shards on
the data axes. A :class:`Mesh` is a grid of ``torch.device`` entries with
named axes, as ``jax.sharding.Mesh`` is:

- ``("data",)``: data parallelism, the reference's only parallelism;
- ``("data", "model")``: tensor parallelism, the feature dimension of a
  linear fit split over the ``model`` axis (``ops/optimizer.py``);
- ``("dcn", "data")``: the hybrid mesh (:func:`create_hybrid_mesh`), the
  slow outer axis first; the fits shard rows over both axes
  (:func:`data_axes`), and the cross-shard sum may take the two-level
  route (``collective.py``);
- ``("seq",)``: sequence parallelism for attention (``sequence.py``).

A mesh runs its collectives on one of two backends:

- **in-process** (no process group): every shard lives in this process.
  Shards may name the same device, which gives N virtual shards on one card
  (``create_mesh((8,), devices=[dev] * 8)``): the per-shard semantics of an
  N-device fit, with the work of all N shards on one device.
- **torch.distributed** (:func:`init_distributed`): the grid positions are
  split over the ranks in row-major order over the axes, ``len(grid) //
  processes`` consecutive positions to a rank, all on the rank's device
  (the JAX package's device order, where a process's devices are
  consecutive); the collectives go through the process group (NCCL for a
  rank alone on its card, gloo for the CPU and for ranks that share a card,
  ``distributed.py``). A rank holds whole rows of the model axis or some
  model shards of one data shard, so its positions are its data shards
  (``local_shards``) times its model shards (``local_models``). A sum over
  a subset of the axes runs on the ranks that share the other coordinates
  (:meth:`Mesh.axis_ranks`): a ``torch.distributed`` subgroup made for
  every such rank set of two or more ranks, short of the whole world, when
  the mesh is built, by every rank in the same order. The mesh keeps only
  the rank sets; :meth:`Mesh.axis_group` looks the group up where it is
  used, and :func:`shutdown_distributed` destroys every subgroup.

The default mesh is one shard on the default device (``device.py``), so a fit
that asks for no mesh runs as it did before the mesh existed; after
:func:`init_distributed` it is every rank's shards on the ``data`` axis.
There is no silent CPU fallback: an unusable device raises where it is
named.
"""

from __future__ import annotations

import datetime
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from flink_ml_tpu_torch.device import DeviceLike, resolve_device

DATA_AXIS = "data"    # data parallelism (the reference's only parallelism)
MODEL_AXIS = "model"  # tensor parallelism: the feature dim of a linear fit
DCN_AXIS = "dcn"      # the slow outer axis of a hybrid mesh
SEQ_AXIS = "seq"      # sequence parallelism of attention (sequence.py)

_AXES = (DCN_AXIS, DATA_AXIS, MODEL_AXIS, SEQ_AXIS)
#: a mesh's stand-in for the default process group (see :class:`Mesh`)
_WORLD = "WORLD"


class Mesh:
    """A grid of shards with named axes: ``grid`` lists one device per
    position in row-major order over ``axis_names`` (sizes ``axis_sizes``).

    The *shards* of a fit are the positions along its data axes
    (:func:`data_axes`, the outer axis first), or along every axis of a
    mesh without one: ``size`` of them, shard ``s`` on ``devices[s]`` (the
    device at its coordinates, 0 on the other axes), so that the fits see a
    ``("data", "model")`` mesh as its data shards, each replicated over the
    model axis, as the JAX package's ``P(data_axes)`` specs do.

    ``group`` is the ``torch.distributed`` process group of a mesh split
    over ``processes`` ranks (``rank`` is this process), or ``None`` for an
    in-process mesh, whose shards all live here. A mesh over the default
    group does not hold it: :attr:`group` looks it up where it is used, so
    no mesh keeps the group alive after ``destroy_process_group`` (a gloo
    group freed only at interpreter exit can abort the process there)."""

    def __init__(self, devices: Sequence[DeviceLike],
                 axis_names: Sequence[str] = (DATA_AXIS,), group=None,
                 rank: int = 0, shape: Optional[Sequence[int]] = None,
                 processes: Optional[int] = None):
        axis_names = _check_axes(axis_names)
        devices = list(devices)
        if not devices:
            raise ValueError("a mesh needs at least one shard")
        if shape is None:
            if len(axis_names) != 1:
                raise ValueError(f"a mesh over the axes {axis_names} needs "
                                 "its shape")
            shape = (len(devices),)
        shape = tuple(int(n) for n in shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} does not match the axes "
                             f"{axis_names}")
        if math.prod(shape) != len(devices) or min(shape) < 1:
            raise ValueError(f"shape {shape} needs {math.prod(shape)} "
                             f"devices, got {len(devices)}")
        self.grid: Tuple[torch.device, ...] = tuple(
            _indexed(d) for d in devices)
        self.axis_names = axis_names
        self.axis_sizes = shape
        self.shard_axes = tuple(
            a for a in axis_names if a in (DCN_AXIS, DATA_AXIS)) or axis_names
        #: the number of shards (the reference's parallelism)
        self.size = math.prod(self.shape[a] for a in self.shard_axes)
        self.devices: Tuple[torch.device, ...] = tuple(
            self.grid[self._flat(self.shard_coords(s))]
            for s in range(self.size))
        self._group = group
        if group is not None:
            import torch.distributed as dist

            if group is dist.group.WORLD:
                self._group = _WORLD
        self.rank = int(rank)
        #: this rank's group's ranks for each axis subset (sorted axes)
        self._axis_ranks: Dict[tuple, Tuple[int, ...]] = {}
        if group is None:
            self.processes = 1
            #: the grid positions this process holds, row-major
            self.positions: Tuple[int, ...] = tuple(range(len(self.grid)))
            #: the shards this process computes: all of them in-process,
            #: the rank's own under ``torch.distributed``
            self.local_shards: Tuple[int, ...] = tuple(range(self.size))
            #: the model-axis coordinates this process holds
            self.local_models: Tuple[int, ...] = tuple(
                range(self.model_size))
            return
        self.processes = (len(self.grid) if processes is None
                          else int(processes))
        if self.processes < 1 or len(self.grid) % self.processes:
            raise ValueError(f"{len(self.grid)} grid positions do not split "
                             f"over {self.processes} processes")
        if not 0 <= self.rank < self.processes:
            raise ValueError(f"rank {rank} is not a process of a "
                             f"{self.processes}-process mesh")
        for r in range(self.processes):
            held = self._held(r)
            shards = tuple(sorted({s for s, _ in held}))
            models = tuple(sorted({m for _, m in held}))
            if len(shards) * len(models) != len(held):
                raise ValueError(
                    f"rank {r} of {self} would hold positions that are "
                    f"neither whole model rows nor model shards of one data "
                    f"shard")
            if r == self.rank:
                self.positions = self._rank_positions(r)
                self.local_shards, self.local_models = shards, models
        for axes in _axis_subsets(self.axis_names):
            parts = self._partition(axes)
            self._axis_ranks[axes] = next(
                p for p in parts if self.rank in p)
            if self._group is _WORLD:
                for ranks in parts:
                    if 1 < len(ranks) < self.processes:
                        _subgroup(ranks)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, as ``jax.sharding.Mesh.shape`` gives it."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def model_size(self) -> int:
        """Shards on the ``model`` axis (1 without one)."""
        return self.shape.get(MODEL_AXIS, 1)

    @property
    def group(self):
        """The mesh's process group (None in-process); the default group
        as ``torch.distributed`` holds it now (None once destroyed)."""
        if self._group is _WORLD:
            import torch.distributed as dist

            return dist.group.WORLD
        return self._group

    @property
    def distributed(self) -> bool:
        """True when the shards are split over the ranks of a process
        group."""
        return self._group is not None

    @property
    def device_count(self) -> int:
        """Distinct physical devices under the shards: one per rank under
        ``torch.distributed``, the distinct ``grid`` devices in-process (1
        for virtual shards on one card)."""
        if self.distributed:
            return self.processes
        return len({str(d) for d in self.grid})

    def _rank_positions(self, rank: int) -> Tuple[int, ...]:
        per = len(self.grid) // self.processes
        return tuple(range(rank * per, (rank + 1) * per))

    def _coords(self, position: int) -> Dict[str, int]:
        out = {}
        for axis, n in zip(reversed(self.axis_names),
                           reversed(self.axis_sizes)):
            position, out[axis] = divmod(position, n)
        return out

    def _held(self, rank: int) -> list:
        """The (data shard, model coordinate) of each grid position rank
        ``rank`` holds, row-major."""
        out = []
        for pos in self._rank_positions(rank):
            coords = self._coords(pos)
            shard = 0
            for axis in self.shard_axes:
                shard = shard * self.shape[axis] + coords[axis]
            out.append((shard, coords.get(MODEL_AXIS, 0)))
        return out

    def _partition(self, axes: tuple) -> list:
        """The ranks grouped by the coordinates off ``axes`` they hold: the
        rank sets a sum over ``axes`` runs on, in order of their lowest
        rank. Raises when two ranks hold overlapping, unequal sets."""
        others = [a for a in self.axis_names if a not in axes]
        held = {}
        for r in range(self.processes):
            held[r] = frozenset(
                tuple(self._coords(p)[a] for a in others)
                for p in self._rank_positions(r))
        parts = []
        for r in range(self.processes):
            for part in parts:
                if held[part[0]] == held[r]:
                    part.append(r)
                    break
                if held[part[0]] & held[r]:
                    raise ValueError(f"the ranks of {self} do not split "
                                     f"evenly over the axes {axes}")
            else:
                parts.append([r])
        return [tuple(p) for p in parts]

    def axis_ranks(self, axes=None) -> Tuple[int, ...]:
        """The ranks a sum over ``axes`` (default: the shard axes) runs on
        from this rank: those that hold the same coordinates on the other
        axes, sorted (this process alone in-process)."""
        if axes is None:
            axes = self.shard_axes
        key = tuple(a for a in self.axis_names if a in axes)
        if not self.distributed:
            return (self.rank,)
        return self._axis_ranks[key]

    def axis_group(self, axes=None):
        """The process group of :meth:`axis_ranks`, looked up where it is
        used: the mesh's own group for every rank (a world of one too),
        None for a rank alone among several (no call is made), else the
        subgroup made when the mesh was built."""
        ranks = self.axis_ranks(axes)
        if len(ranks) == self.processes:
            return self.group
        if len(ranks) == 1:
            return None
        if self._group is not _WORLD:
            raise ValueError(f"{self} sums over a subset of its axes only "
                             f"over the default process group")
        group = _SUBGROUPS.get(ranks)
        if group is None:
            raise RuntimeError(f"the subgroup of ranks {ranks} is gone "
                               f"(shutdown_distributed destroyed it)")
        return group

    def _flat(self, coords: Dict[str, int]) -> int:
        index = 0
        for axis, n in zip(self.axis_names, self.axis_sizes):
            index = index * n + int(coords.get(axis, 0))
        return index

    def shard_coords(self, shard: int) -> Dict[str, int]:
        """Axis → coordinate of shard ``shard`` on the shard axes (the
        outer axis first, as :func:`data_axes` orders them)."""
        out = {}
        for axis in reversed(self.shard_axes):
            shard, out[axis] = divmod(shard, self.shape[axis])
        return {a: out[a] for a in self.shard_axes}

    def model_devices(self, shard: int) -> Tuple[torch.device, ...]:
        """The devices of shard ``shard`` along the model axis, in model
        order (the one shard device on a mesh without one)."""
        coords = self.shard_coords(shard)
        return tuple(self.grid[self._flat({**coords, MODEL_AXIS: m})]
                     for m in range(self.model_size))

    def __repr__(self) -> str:
        kind = (f"rank {self.rank} of {self.processes} processes"
                if self.distributed else "in-process")
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes}, {kind}, {list(self.grid)})"


def _axis_subsets(axis_names: tuple) -> list:
    """Every non-empty subset of ``axis_names``, in a fixed order, each in
    the mesh's axis order."""
    n = len(axis_names)
    return [tuple(a for i, a in enumerate(axis_names) if bits >> i & 1)
            for bits in range(1, 1 << n)]


#: the subgroups of meshes over processes, by their sorted ranks; a mesh
#: keeps only rank sets, so :func:`shutdown_distributed` leaves none alive
_SUBGROUPS: Dict[Tuple[int, ...], object] = {}


def _subgroup(ranks: Tuple[int, ...]) -> None:
    """Make the subgroup of ``ranks`` once. Every rank of the world calls
    this for every rank set, its own or not, in the same order:
    ``new_group`` is a collective of the whole world."""
    if ranks in _SUBGROUPS:
        return
    import torch.distributed as dist

    _SUBGROUPS[ranks] = dist.new_group(list(ranks))


def _indexed(device: DeviceLike) -> torch.device:
    """``device`` with its index: ``"cuda"`` is the current card, so that a
    shard's device compares equal to the device of the tensors on it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _check_axes(axis_names: Sequence[str]) -> tuple:
    axis_names = tuple(axis_names)
    unknown = [a for a in axis_names if a not in _AXES]
    if unknown or len(set(axis_names)) != len(axis_names) or not axis_names:
        raise ValueError(f"mesh axes must be distinct names among {_AXES}, "
                         f"got {axis_names}")
    if SEQ_AXIS in axis_names and len(axis_names) > 1:
        raise ValueError(f"the {SEQ_AXIS!r} axis makes a mesh of its own, "
                         f"got {axis_names}")
    return axis_names


_default_mesh: Optional[Mesh] = None


def _cuda_devices(devices):
    if devices is not None:
        return list(devices)
    resolve_device(None)  # raises without a card
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def local_device_count() -> int:
    """The CUDA cards this process sees (every card, as
    :func:`create_mesh` lays them out by default); raises without one, as
    every entry point does."""
    return len(_cuda_devices(None))


def create_mesh(shape: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = (DATA_AXIS,),
                devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """An in-process mesh over ``devices`` (default: every CUDA device),
    laid out row-major over ``shape``.

    ``create_mesh()`` is one shard per card; ``create_mesh((8,),
    devices=["cuda"] * 8)`` is eight virtual shards on one card, and
    ``devices=["cpu"] * 8`` the same on the CPU; ``create_mesh((4, 2),
    ("data", "model"), devices=...)`` a tensor-parallel mesh and
    ``create_mesh((8,), ("seq",), devices=...)`` a sequence mesh."""
    devices = _cuda_devices(devices)
    return Mesh(devices, axis_names,
                shape=(len(devices),) if shape is None else shape)


def create_hybrid_mesh(ici_shape: Optional[Sequence[int]] = None,
                       dcn_shape: Optional[Sequence[int]] = None,
                       axis_names: Optional[Sequence[str]] = None,
                       devices: Optional[Sequence[DeviceLike]] = None
                       ) -> Mesh:
    """A mesh with the slow outer axis first: ``create_hybrid_mesh(
    ici_shape=(4,), dcn_shape=(2,))`` over 8 devices is a ``("dcn",
    "data")`` mesh of shape (2, 4) (``flink_ml_tpu/parallel/mesh.py:181``).
    The fits shard rows over both axes and sum over both; the two-level
    reduce (``collective.py``) uses the split. One process has no slice
    topology, so the axes are laid over the device list as given (the JAX
    package's single-slice branch)."""
    devices = _cuda_devices(devices)
    dcn_shape = tuple(int(n) for n in (dcn_shape or (1,)))
    if ici_shape is None:
        ici_shape = (len(devices) // max(math.prod(dcn_shape), 1),)
    ici_shape = tuple(int(n) for n in ici_shape)
    if axis_names is None:
        if len(dcn_shape) != 1 or len(ici_shape) != 1:
            raise ValueError(
                "default axis_names only cover 1 dcn + 1 ici axis; pass "
                "axis_names explicitly for higher-rank hybrid meshes")
        axis_names = (DCN_AXIS, DATA_AXIS)
    return create_mesh(dcn_shape + ici_shape, axis_names, devices)


def data_axes(mesh: Mesh) -> tuple:
    """The axes that together form the data-parallel domain, the ``dcn``
    axis first: a flat ``("data",)`` mesh and a ``("dcn", "data")`` mesh of
    as many shards run the same fit."""
    axes = tuple(a for a in (DCN_AXIS, DATA_AXIS) if a in mesh.axis_names)
    if not axes:
        raise ValueError(
            f"mesh has no data-parallel axis: expected {DATA_AXIS!r} "
            f"(optionally with {DCN_AXIS!r}) among {mesh.axis_names}")
    return axes


def data_shard_count(mesh: Mesh) -> int:
    """Total data-parallel shard count (the reference's parallelism)."""
    return math.prod(mesh.shape[a] for a in data_axes(mesh))


def data_pspec(mesh: Mesh):
    """The dim-0 entry of a row-sharded operand's partition spec in the
    JAX package: the one data axis of a flat mesh, the ``(dcn, data)``
    tuple of a hybrid one."""
    axes = data_axes(mesh)
    return axes[0] if len(axes) == 1 else axes


def model_axis_of(mesh: Mesh) -> Optional[str]:
    """The tensor-parallel axis name, or None on a mesh without one."""
    return MODEL_AXIS if MODEL_AXIS in mesh.axis_names else None


def default_mesh() -> Mesh:
    """The mesh set by :func:`set_default_mesh` or :func:`init_distributed`;
    else one shard on the default device (the card)."""
    if _default_mesh is not None:
        return _default_mesh
    return Mesh([resolve_device(None)])


def set_default_mesh(mesh: Optional[Mesh]) -> None:
    """Make ``mesh`` every fit's default (``None`` restores one shard on the
    default device)."""
    global _default_mesh, _local_mesh
    _default_mesh = mesh
    _local_mesh = None


def resolve_mesh(mesh: Optional[Mesh] = None,
                 device: DeviceLike = None) -> Mesh:
    """The mesh a fit runs on: ``mesh`` when given; else the default mesh
    when one was set (:func:`set_default_mesh`, :func:`init_distributed`);
    else one shard on ``device`` (``None``: the card)."""
    if mesh is not None:
        return mesh
    if _default_mesh is not None:
        return _default_mesh
    return Mesh([resolve_device(device)])


#: the local mesh of a distributed default mesh, made once for it
_local_mesh: Optional[Tuple[Mesh, Mesh]] = None


def local_mesh() -> Mesh:
    """The mesh the transform tier places batches on: the default mesh in
    one process, an in-process mesh of this rank's own shards under
    ``torch.distributed`` (each process scores its own traffic), made once
    for a default mesh."""
    global _local_mesh
    mesh = default_mesh()
    if not mesh.distributed:
        return mesh
    if _local_mesh is None or _local_mesh[0] is not mesh:
        _local_mesh = (mesh, Mesh([mesh.devices[s]
                                   for s in mesh.local_shards]))
    return _local_mesh[1]


def column_mesh() -> Optional[Mesh]:
    """The mesh the feature columns are placed on (``ops/columnar.py``):
    :func:`local_mesh` once a default mesh is set (by
    :func:`set_default_mesh` or :func:`init_distributed`), so that under
    ``torch.distributed`` a rank's columns split over its own shards only;
    None without one, and a column is then one tensor on its stage's
    device."""
    if _default_mesh is None:
        return None
    return local_mesh()


def _rank_mesh(dev: torch.device, world: int, rank: int,
               local_shards: int, group) -> Mesh:
    """The default mesh of a rank: ``world * local_shards`` shards on the
    ``data`` axis, ``local_shards`` of them this rank's, all on ``dev``."""
    return Mesh([dev] * (int(world) * int(local_shards)), group=group,
                rank=int(rank), processes=int(world))


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     device: DeviceLike = None,
                     store=None,
                     timeout_s: float = 600.0,
                     local_shards: int = 1,
                     backend: Optional[str] = None) -> bool:
    """Join a ``torch.distributed`` process group and make the default mesh
    the ranks' shards on the ``data`` axis (``local_shards`` virtual shards
    a rank, one by default). Returns True when the group spans processes.

    ``init_method`` is a rendezvous URL (``file:///path`` works without a
    port; ``tcp://host:port`` too) or ``store`` a ``torch.distributed``
    store (a ``FileStore``); ``world_size`` and ``rank`` are required with
    either. ``device`` is this rank's device (default: the card).
    ``backend`` is the process group's backend; by default NCCL for a CUDA
    device and gloo for the CPU. Ranks that share one card must ask for
    ``"gloo"``: NCCL refuses two ranks on one device. A failed join raises;
    it never falls back to the in-process mesh. Calling it again in a
    process that already joined is a no-op. Child processes must be started
    by spawn, not fork, once CUDA is initialized."""
    import torch.distributed as dist

    global _default_mesh
    if dist.is_initialized():
        if _default_mesh is None or not _default_mesh.distributed:
            _default_mesh = _rank_mesh(
                resolve_device(device), dist.get_world_size(),
                dist.get_rank(), local_shards, dist.group.WORLD)
        return dist.get_world_size() > 1
    if world_size is None or rank is None:
        raise ValueError("init_distributed needs world_size and rank")
    if (init_method is None) == (store is None):
        raise ValueError("init_distributed needs one of init_method (a "
                         "file:// or tcp:// URL) and store")
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, got {dev}")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, store=store,
        world_size=int(world_size), rank=int(rank),
        timeout=datetime.timedelta(seconds=timeout_s))
    _default_mesh = _rank_mesh(dev, world_size, rank, local_shards,
                               dist.group.WORLD)
    return int(world_size) > 1


def shutdown_distributed(barrier_timeout_s: float = 60.0) -> None:
    """Leave the process group and restore the one-shard default mesh.

    Across gloo processes every rank first waits at a ``monitored_barrier``
    of at most ``barrier_timeout_s``, so that no rank tears its connections
    down while a peer is still finishing its last collective. A rank whose
    peer is gone raises there, naming the missing ranks, within that bound,
    and has left the group all the same. An NCCL group is left without a
    barrier."""
    import torch.distributed as dist

    global _default_mesh
    try:
        if dist.is_initialized():
            try:
                if (dist.get_world_size() > 1
                        and dist.get_backend() == "gloo"):
                    dist.monitored_barrier(
                        timeout=datetime.timedelta(
                            seconds=barrier_timeout_s),
                        wait_all_ranks=True)
            finally:
                while _SUBGROUPS:
                    dist.destroy_process_group(
                        _SUBGROUPS.popitem()[1])
                dist.destroy_process_group()
    finally:
        _SUBGROUPS.clear()
        if _default_mesh is not None and _default_mesh.distributed:
            _default_mesh = None
