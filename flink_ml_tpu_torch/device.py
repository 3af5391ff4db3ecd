"""Where the port computes.

Every entry point runs on the CUDA card unless its caller names another
device: a stage, model or generator takes ``device=`` ("cpu", "cuda",
"cuda:1", a ``torch.device``), and ``None`` means :func:`default_device`.
Without a card the default raises; nothing quietly moves the work to the
CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    """The CUDA card; a clear error when this machine has none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "flink_ml_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return torch.device("cuda")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is :func:`default_device`."""
    return default_device() if device is None else torch.device(device)


def name_thread_device(device, named: Optional[torch.device] = None
                       ) -> Optional[torch.device]:
    """Make the CUDA ``device`` the calling thread's current device, unless
    ``named`` (the device this thread named last) already is it; returns
    the device the thread has named. PyTorch keeps the current device, and
    the cuBLAS handles that go with it, per thread, so a thread that
    launches work for a servable names the servable's card first. A host
    device (or None) names nothing."""
    if (isinstance(device, torch.device) and device.type == "cuda"
            and device != named):
        torch.cuda.set_device(device)
        return device
    return named


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
