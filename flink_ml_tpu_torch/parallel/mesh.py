"""The mesh: the data shards a fit splits its rows over, and their devices.

The port of ``flink_ml_tpu/parallel/mesh.py:120,166-291``. The reference's
"parallelism" knob (the number of subtasks) becomes the number of shards on
the ``data`` axis. A :class:`Mesh` names one ``torch.device`` per shard, and
runs its collectives on one of two backends:

- **in-process** (no process group): every shard lives in this process.
  Shards may name the same device, which gives N virtual shards on one card
  (``create_mesh((8,), devices=[dev] * 8)``): the per-shard semantics of an
  N-device fit, with the work of all N shards on one device.
- **torch.distributed** (:func:`init_distributed`): one shard per rank, the
  rank's own device; the collectives go through the process group (NCCL on
  CUDA, gloo on the CPU).

The default mesh is one shard on the default device (``device.py``), so a fit
that asks for no mesh runs as it did before the mesh existed; after
:func:`init_distributed` it is one shard per rank. Tensor parallelism (a
``model`` axis) and the hybrid multi-slice mesh (a ``dcn`` axis) are not
ported yet and raise. There is no silent CPU fallback: an unusable device
raises where it is named.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence, Tuple

import torch

from flink_ml_tpu_torch.device import DeviceLike, resolve_device

DATA_AXIS = "data"    # data parallelism (the reference's only parallelism)
MODEL_AXIS = "model"  # tensor parallelism: not ported yet
DCN_AXIS = "dcn"      # the cross-slice axis of a hybrid mesh: not ported yet


class Mesh:
    """The data shards of a fit: ``devices[s]`` holds shard ``s``.

    ``group`` is the ``torch.distributed`` process group of a mesh with one
    shard per rank (``rank`` is this process's shard), or ``None`` for an
    in-process mesh, whose shards all live here."""

    def __init__(self, devices: Sequence[DeviceLike],
                 axis_names: Sequence[str] = (DATA_AXIS,), group=None,
                 rank: int = 0):
        axis_names = _check_axes(axis_names)
        if not devices:
            raise ValueError("a mesh needs at least one shard")
        self.devices: Tuple[torch.device, ...] = tuple(
            _indexed(d) for d in devices)
        self.axis_names = axis_names
        self.group = group
        self.rank = int(rank)
        if group is not None and not 0 <= self.rank < len(self.devices):
            raise ValueError(f"rank {rank} is not a shard of a "
                             f"{len(self.devices)}-shard mesh")
        #: the shards this process computes: all of them in-process, the
        #: rank's own under ``torch.distributed``
        self.local_shards: Tuple[int, ...] = (
            (self.rank,) if group is not None
            else tuple(range(len(self.devices))))

    @property
    def size(self) -> int:
        """The number of data shards (the reference's parallelism)."""
        return len(self.devices)

    @property
    def shape(self) -> dict:
        """Axis name → size, as ``jax.sharding.Mesh.shape`` gives it."""
        return {DATA_AXIS: self.size}

    @property
    def distributed(self) -> bool:
        """True when the shards are the ranks of a process group."""
        return self.group is not None

    @property
    def device_count(self) -> int:
        """Distinct physical devices under the shards: one per rank under
        ``torch.distributed``, the distinct ``devices`` in-process (1 for
        virtual shards on one card)."""
        if self.distributed:
            return self.size
        return len({str(d) for d in self.devices})

    def __repr__(self) -> str:
        kind = f"rank {self.rank} of a process group" if self.distributed \
            else "in-process"
        return f"Mesh({DATA_AXIS}={self.size}, {kind}, {list(self.devices)})"


def _indexed(device: DeviceLike) -> torch.device:
    """``device`` with its index: ``"cuda"`` is the current card, so that a
    shard's device compares equal to the device of the tensors on it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _check_axes(axis_names: Sequence[str]) -> tuple:
    axis_names = tuple(axis_names)
    unported = [a for a in axis_names if a in (MODEL_AXIS, DCN_AXIS)]
    if unported:
        raise NotImplementedError(
            f"mesh axes {unported}: tensor parallelism and the hybrid mesh "
            "come with a later slice of the port; use a 1-D "
            f"({DATA_AXIS!r},) mesh")
    if axis_names != (DATA_AXIS,):
        raise ValueError(f"a mesh has the one axis {DATA_AXIS!r}, got "
                         f"{axis_names}")
    return axis_names


_default_mesh: Optional[Mesh] = None


def create_mesh(shape: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = (DATA_AXIS,),
                devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """An in-process mesh over ``devices`` (default: every CUDA device).

    ``create_mesh()`` is one shard per card; ``create_mesh((8,),
    devices=["cuda"] * 8)`` is eight virtual shards on one card, and
    ``devices=["cpu"] * 8`` the same on the CPU."""
    axis_names = _check_axes(axis_names)
    if devices is None:
        resolve_device(None)  # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if shape is not None:
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} does not match the axes "
                             f"{axis_names}")
        if shape[0] != len(devices):
            raise ValueError(f"shape {shape} needs {shape[0]} devices, got "
                             f"{len(devices)}")
    return Mesh(devices, axis_names)


def data_axes(mesh: Mesh) -> tuple:
    """The axes that form the data-parallel domain: ``("data",)``."""
    if DATA_AXIS not in mesh.axis_names:
        raise ValueError(f"mesh has no data-parallel axis {DATA_AXIS!r}")
    return (DATA_AXIS,)


def data_shard_count(mesh: Mesh) -> int:
    """Total data-parallel shard count (the reference's parallelism)."""
    return mesh.size


def default_mesh() -> Mesh:
    """The mesh set by :func:`set_default_mesh` or :func:`init_distributed`;
    else one shard on the default device (the card)."""
    if _default_mesh is not None:
        return _default_mesh
    return Mesh([resolve_device(None)])


def set_default_mesh(mesh: Optional[Mesh]) -> None:
    """Make ``mesh`` every fit's default (``None`` restores one shard on the
    default device)."""
    global _default_mesh
    _default_mesh = mesh


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


def local_mesh() -> Mesh:
    """The mesh the transform tier places batches on: the default mesh in
    one process, this rank's own device under ``torch.distributed`` (each
    process scores its own traffic)."""
    mesh = default_mesh()
    if not mesh.distributed:
        return mesh
    return Mesh([mesh.devices[mesh.rank]])


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     device: DeviceLike = None,
                     store=None,
                     timeout_s: float = 600.0) -> bool:
    """Join a ``torch.distributed`` process group and make the default mesh
    one shard per rank. Returns True when the group spans processes.

    ``init_method`` is a rendezvous URL (``file:///path`` works without a
    port; ``tcp://host:port`` too) or ``store`` a ``torch.distributed``
    store (a ``FileStore``); ``world_size`` and ``rank`` are required with
    either. ``device`` is this rank's device (default: the card): NCCL for
    a CUDA device, gloo for the CPU. A failed join raises; it never falls
    back to the in-process mesh. Calling it again in a process that already
    joined is a no-op. Child processes must be started by spawn, not fork,
    once CUDA is initialized."""
    import torch.distributed as dist

    global _default_mesh
    if dist.is_initialized():
        if _default_mesh is None or not _default_mesh.distributed:
            dev = resolve_device(device)
            _default_mesh = Mesh([dev] * dist.get_world_size(),
                                 group=dist.group.WORLD,
                                 rank=dist.get_rank())
        return dist.get_world_size() > 1
    if world_size is None or rank is None:
        raise ValueError("init_distributed needs world_size and rank")
    if (init_method is None) == (store is None):
        raise ValueError("init_distributed needs one of init_method (a "
                         "file:// or tcp:// URL) and store")
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, store=store,
        world_size=int(world_size), rank=int(rank),
        timeout=datetime.timedelta(seconds=timeout_s))
    _default_mesh = Mesh([dev] * int(world_size), group=dist.group.WORLD,
                         rank=int(rank))
    return int(world_size) > 1


def shutdown_distributed() -> None:
    """Leave the process group and restore the one-shard default mesh."""
    import torch.distributed as dist

    global _default_mesh
    if dist.is_initialized():
        dist.destroy_process_group()
    if _default_mesh is not None and _default_mesh.distributed:
        _default_mesh = None
