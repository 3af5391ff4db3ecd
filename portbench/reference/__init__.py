"""Plain references of the cells' algorithms, in PyTorch and NumPy alone.

Nothing here imports ``jax``, ``flink_ml_tpu`` or ``flink_ml_tpu_torch``:
each module works out the algorithm itself from the inputs the benchmark
made, and reads the program's outputs only to judge them.
"""

from __future__ import annotations

import torch


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """A float32 copy of ``t`` rounded to TF32's 10 mantissa bits (nearest,
    ties to even): the operands a TF32 tensor-core product sees. Products of
    two such values are exact in float32, so a float32 product of rounded
    operands has TF32's numerics on any device."""
    bits = t.to(torch.float32).clone().view(torch.int32)
    bits += 0xFFF + ((bits >> 13) & 1)
    bits &= ~0x1FFF
    return bits.view(torch.float32)
