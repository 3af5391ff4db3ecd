"""Frozen copies of the port's device generators (``DenseVectorGenerator``
and ``LabeledPointWithWeightGenerator`` of
``flink_ml_tpu_torch/benchmark/datagen.py``, their device path), so that no
change to the program changes the benchmark's inputs.

Every column is float32, uniform in [0, 1), drawn on ``device`` by a
``torch.Generator`` seeded with ``seed + stream * STREAM_STRIDE`` (mod
2**64): stream 0 the features, 1 the label, 2 the weight. A column of arity
``a > 0`` is ``floor(u * a)``. The same seed gives the same tables, in a few
large calls on the device.
"""

from __future__ import annotations

import torch

#: seed offset between the column streams of one generator
STREAM_STRIDE = 0x9E3779B97F4A7C15


def _uniform(shape, seed: int, stream: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed((seed + stream * STREAM_STRIDE) % (1 << 64))
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=device)


def _arity(u: torch.Tensor, arity: int) -> torch.Tensor:
    return torch.floor_(u.mul_(arity)) if arity else u


def dense_vectors(params: dict, seed: int, device) -> dict:
    """``numValues`` rows of ``vectorDim`` floats (DenseVectorGenerator)."""
    (name,) = params["colNames"][0]
    return {name: _uniform((params["numValues"], params["vectorDim"]), seed,
                           0, device)}


def labeled_points_with_weight(params: dict, seed: int, device) -> dict:
    """Features, label and weight (LabeledPointWithWeightGenerator):
    ``featureArity`` and ``labelArity`` 0 give continuous values, ``a > 0``
    integers in [0, a); the weight is continuous."""
    f_name, l_name, w_name = params["colNames"][0]
    n, d = params["numValues"], params["vectorDim"]
    return {f_name: _arity(_uniform((n, d), seed, 0, device),
                           params.get("featureArity", 2)),
            l_name: _arity(_uniform((n,), seed, 1, device),
                           params.get("labelArity", 2)),
            w_name: _uniform((n,), seed, 2, device)}


GENERATORS = {
    "DenseVectorGenerator": dense_vectors,
    "LabeledPointWithWeightGenerator": labeled_points_with_weight,
}


def generate(input_data: dict, seed: int, device) -> dict:
    """The columns of a config's ``inputData`` (its ``className``, Java or
    short, and ``paramMap``) drawn from ``seed``: name → tensor."""
    short = input_data["className"].rsplit(".", 1)[-1]
    return GENERATORS[short](input_data["paramMap"], seed, device)
