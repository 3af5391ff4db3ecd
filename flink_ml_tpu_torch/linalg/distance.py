"""Distance measures.

The port of ``flink_ml_tpu/linalg/distance.py`` (ref:
flink-ml-servable-core/.../common/distance/DistanceMeasure.java and its
Euclidean/Manhattan/Cosine implementations). Every measure provides a
batched ``pairwise(X, C) -> (n, k)`` on torch tensors, computed on the
tensors' device with the same formulas as the JAX package, and the
reference's per-point host calls ``distance`` and ``find_closest`` (float64
on the CPU). These are plain PyTorch: the fused euclidean assignment lives
in ``ops/kernels.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from flink_ml_tpu_torch.linalg.vectors import Vector, VectorWithNorm


def _host_row(v) -> torch.Tensor:
    """A vector (a Vector, a VectorWithNorm or an array) as a float64 CPU
    row."""
    if isinstance(v, VectorWithNorm):
        v = v.vector
    arr = v.to_array() if isinstance(v, Vector) else np.asarray(v)
    return torch.as_tensor(np.asarray(arr, np.float64))


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

    # -- host scalar path (servable parity) ---------------------------------
    def distance(self, a, b) -> float:
        """The distance of two vectors (ref: DistanceMeasure.distance)."""
        return float(self.pairwise(_host_row(a)[None, :],
                                   _host_row(b)[None, :])[0, 0])

    def find_closest(self, centroids, point) -> int:
        """Index of the closest centroid, the first on ties (ref:
        DistanceMeasure.findClosest)."""
        c = torch.stack([_host_row(x) for x in centroids])
        return int(torch.argmin(self.pairwise(_host_row(point)[None, :],
                                              c)[0]))

    # -- batched device path ------------------------------------------------
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
