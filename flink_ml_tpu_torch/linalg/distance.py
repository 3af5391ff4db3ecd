"""Distance measures.

The port of ``flink_ml_tpu/linalg/distance.py`` (ref:
flink-ml-servable-core/.../common/distance/DistanceMeasure.java and its
Euclidean/Manhattan/Cosine implementations). Every measure provides a
batched ``pairwise(X, C) -> (n, k)`` on torch tensors, computed on the
tensors' device with the same formulas as the JAX package. These are plain
PyTorch: the fused euclidean assignment lives in ``ops/kernels.py``.
"""

from __future__ import annotations

import torch


class DistanceMeasure:
    """Pluggable distance; instances are stateless singletons by name."""

    NAME = None
    _registry = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if cls.NAME:
            DistanceMeasure._registry[cls.NAME] = cls()

    @staticmethod
    def get_instance(name: str) -> "DistanceMeasure":
        try:
            return DistanceMeasure._registry[name]
        except KeyError:
            raise ValueError(f"Unknown distance measure {name!r}; "
                             f"choose from {sorted(DistanceMeasure._registry)}")

    def pairwise(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """(n, d), (k, d) → (n, k) distances, on the inputs' device."""
        raise NotImplementedError


class EuclideanDistanceMeasure(DistanceMeasure):
    NAME = "euclidean"

    def pairwise(self, x, c):
        # ||x - c||² = ||x||² − 2 x·cᵀ + ||c||²: one matmul + rank-1 adds
        x2 = torch.sum(x * x, dim=-1, keepdim=True)
        c2 = torch.sum(c * c, dim=-1)[None, :]
        cross = x @ c.T
        sq = torch.clamp_min(x2 - 2.0 * cross + c2, 0.0)
        return torch.sqrt(sq)


class ManhattanDistanceMeasure(DistanceMeasure):
    NAME = "manhattan"

    def pairwise(self, x, c):
        return torch.sum(torch.abs(x[:, None, :] - c[None, :, :]), dim=-1)


class CosineDistanceMeasure(DistanceMeasure):
    NAME = "cosine"

    def pairwise(self, x, c):
        xn = x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True), 1e-12)
        cn = c / torch.clamp_min(torch.linalg.norm(c, dim=-1, keepdim=True), 1e-12)
        return 1.0 - xn @ cn.T
