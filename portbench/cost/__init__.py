"""Frozen arithmetic: the published peaks of one H100 and the bytes and
operations of the port's kernels.

``launch_cost`` is a copy of ``flink_ml_tpu_torch/ops/kernels.py``'s, for the
kernels the cells run: each float32 input read once, each output written
once, and the operations the function does on its inputs. The peaks are
NVIDIA's data sheet figures for the H100 SXM at 700 W: float32 outside the
tensor cores, and HBM3 bandwidth. Nothing here reads the environment.
``cost/<algorithm>.py`` gives the bytes and operations of one whole fit.
"""

from __future__ import annotations

from typing import Tuple

#: float32 FLOP/s of one H100 SXM outside the tensor cores
PEAK_FLOPS_F32 = 67e12
#: HBM3 bytes/s of one H100 SXM
PEAK_BYTES_PER_S = 3.35e12


def launch_cost(name: str, **dims: int) -> Tuple[int, int]:
    """``(bytes, operations)`` of one call of the kernel ``name``:

    - ``lloyd_partial_sums``: ``n`` rows, ``k`` centroids, ``d`` columns;
    - ``reduce_partials``: ``blocks`` partials of ``inner`` floats each;
    - ``sgd_batch_terms``: a window of ``lb`` rows of ``d`` features.
    """
    g = dims.get
    if name == "lloyd_partial_sums":
        n, k, d = g("n"), g("k"), g("d")
        return (4 * (n * d + n + k * d + k + k * (d + 1)),
                2 * n * k * d + 2 * n * (d + 1))
    if name == "reduce_partials":
        blocks, inner = g("blocks"), g("inner")
        return 4 * (blocks + 1) * inner, blocks * inner
    if name == "sgd_batch_terms":
        lb, d = g("lb"), g("d")
        return 4 * (lb * d + 2 * lb + d + d + 2), 4 * lb * d
    raise KeyError(f"launch_cost: unknown kernel {name!r}")


def floor_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the byte and the
    operation bound at the published peaks."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS_F32)
