"""The device on-ramp of the dense feature transformers.

The port of ``flink_ml_tpu/ops/columnar.py``. Dense numeric feature
transforms (the scalers, Normalizer, ElementwiseProduct,
PolynomialExpansion, DCT, Binarizer, Bucketizer, Interaction, the slicers
and selectors) run as one module-level torch function per op over the whole
(n, d) column, on the stage's device (the CUDA card unless the stage names
another).

Residency: outputs stay tensors inside the Table, so chained Pipeline
stages (scale → normalize → classify) hand device tensors to each other
with no host round trip; the host off-ramp happens only when a consumer
reads rows or asks for numpy.

Dtype policy (the JAX package's): device transforms compute in float32,
so host float arrays are cast to float32 on their way in, while the fit
statistics of a host column stay float64 numpy. The fit statistics of a
tensor column are computed where the tensor lives, in its dtype
(:func:`fit_vectors`).

The JAX module shards the column over a mesh's data axis; the port keeps
one tensor on the stage's device (mesh placement of feature columns is
later work).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.device import DeviceLike, resolve_device


def is_device_array(x) -> bool:
    """A tensor column (on the card or on the CPU): it keeps its place."""
    return isinstance(x, torch.Tensor)


def to_device(x, device: DeviceLike = None) -> torch.Tensor:
    """A column as a tensor on ``device``: a tensor already there passes
    through untouched; a host array is cast to float32 when it is a float
    array (the module's dtype policy) and copied over once."""
    device = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x if x.device == device else x.to(device)
    x = np.asarray(x)
    if x.dtype.kind == "f" and x.dtype != np.float32:
        x = x.astype(np.float32)
    return torch.as_tensor(x, device=device)


def replicated(c, device: DeviceLike = None) -> torch.Tensor:
    """Model statistics and constants as a tensor on ``device`` (float32
    for float values)."""
    if isinstance(c, torch.Tensor):
        return to_device(c, device)
    return to_device(np.asarray(c), device)


def apply(fn, x, consts: Sequence = (), static: Tuple = (),
          device: DeviceLike = None):
    """``fn(x, *consts, *static)`` on ``device``: ``x`` is the column (a
    tensor, or a host array placed there), ``consts`` the model statistics,
    ``static`` plain Python arguments (flags, dims)."""
    return apply_multi(fn, (x,), consts, static, device)


def apply_multi(fn, xs: Sequence, consts: Sequence = (), static: Tuple = (),
                device: DeviceLike = None):
    """Like :func:`apply`, with several row-aligned inputs (the Interaction
    op's columns, a label column): ``fn(*xs, *consts, *static)``."""
    device = resolve_device(device)
    xs_d = tuple(to_device(x, device) for x in xs)
    consts_d = tuple(replicated(c, device) for c in consts)
    return fn(*xs_d, *consts_d, *static)


def fit_vectors(table, col: str):
    """The fit statistics' on-ramp: ``(x, torch)`` for a tensor column, which
    stays where it is (the statistics are computed there, in float32), and
    ``(x float64, np)`` for a host column (the float64 host contract). The
    namespace tells the caller which path it got."""
    raw = table.column(col)
    if is_device_array(raw):
        return (raw if raw.ndim == 2 else raw[:, None]), torch
    return table.vectors(col, np.float64), np


def input_vectors(table, col: str, device: DeviceLike = None) -> torch.Tensor:
    """Table → (n, d) tensor on ``device`` (the on-ramp for vector columns;
    a tensor column a previous stage left there passes through)."""
    raw = table.column(col)
    if is_device_array(raw):
        return to_device(raw if raw.ndim == 2 else raw[:, None], device)
    return to_device(table.vectors(col, np.float32), device)


def input_scalars(table, col: str, device: DeviceLike = None) -> torch.Tensor:
    raw = table.column(col)
    if is_device_array(raw):
        return to_device(raw, device)
    return to_device(table.scalars(col, np.float32), device)


def to_host(x) -> np.ndarray:
    """Explicit off-ramp (one device-to-host copy)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def head_rows(x, n: int):
    """The first ``n`` rows of a tensor (a view)."""
    return x[:int(min(n, x.shape[0]))]


def dynamic_rows(x, start: int, size: int):
    """Rows ``[start, start + size)`` of a tensor (a view)."""
    return x[start:start + size]


def take_dims(x, dims):
    """The columns ``dims`` of an (n, d) tensor, gathered on its device."""
    return x.index_select(1, torch.as_tensor([int(d) for d in dims],
                                             dtype=torch.int64,
                                             device=x.device))
