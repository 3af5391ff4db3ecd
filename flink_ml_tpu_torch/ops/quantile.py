"""ε-approximate quantiles and exact order statistics.

The port of ``flink_ml_tpu/ops/quantile.py`` (ref: flink-ml-lib/.../common/
util/QuantileSummary.java:42, the Greenwald-Khanna summary behind the
``relativeError`` param of RobustScaler, Imputer and KBinsDiscretizer):

- :class:`QuantileSummary`: the GK sketch for streaming and merging;
- :func:`approx_quantiles`: the batch path on the host, exact numpy
  quantiles with ``method='lower'`` (an exact answer meets any ε bound);
- :func:`rank_select_device`: the same order statistics of a tensor, on
  its device, from a sort of the order-preserving int32 keys of float32;
  a column split over a mesh's shards is gathered onto its first shard's
  device first (rank selection does not decompose over shards).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class _Tuple:
    value: float
    g: int       # rank gap to the previous tuple
    delta: int   # max rank uncertainty


class QuantileSummary:
    """Greenwald-Khanna ε-approximate quantile sketch
    (ref: QuantileSummary.java — defaultCompressThreshold 10000)."""

    COMPRESS_THRESHOLD = 10000

    def __init__(self, relative_error: float = 0.001,
                 compress_threshold: int = COMPRESS_THRESHOLD):
        if not 0 < relative_error <= 1:
            raise ValueError("relative_error must be in (0, 1]")
        self.eps = relative_error
        self.compress_threshold = compress_threshold
        self._sampled: List[_Tuple] = []
        self._buffer: List[float] = []
        self.count = 0

    # -- build ---------------------------------------------------------------
    def insert(self, value: float) -> None:
        self._buffer.append(value)
        if len(self._buffer) >= self.compress_threshold:
            self._flush()

    def insert_all(self, values) -> None:
        for v in np.asarray(values, np.float64).ravel():
            self.insert(float(v))

    def _flush(self) -> None:
        if not self._buffer:
            return
        self._buffer.sort()
        sampled = self._sampled
        merged: List[_Tuple] = []
        threshold = 2 * self.eps * max(self.count + len(self._buffer), 1)
        si, n_new = 0, len(self._buffer)
        for bi, value in enumerate(self._buffer):
            while si < len(sampled) and sampled[si].value <= value:
                merged.append(sampled[si])
                si += 1
            # head/tail inserts get delta 0 so min/max queries stay exact
            # (ref QuantileSummary.java insertion rule)
            is_min = not merged
            is_max = bi == n_new - 1 and si >= len(sampled)
            if is_min or is_max:
                delta = 0
            else:
                delta = max(int(np.floor(threshold)) - 1, 0)
            merged.append(_Tuple(value, 1, delta))
        merged.extend(sampled[si:])
        self.count += n_new
        self._buffer = []
        self._sampled = merged
        self._compress()

    def _compress(self) -> None:
        if len(self._sampled) < 2:
            return
        threshold = 2 * self.eps * self.count
        out = [self._sampled[0]]
        for t in self._sampled[1:-1]:
            last = out[-1]
            if last is not self._sampled[0] and \
                    last.g + t.g + t.delta < threshold:
                out[-1] = _Tuple(t.value, last.g + t.g, t.delta)
            else:
                out.append(t)
        out.append(self._sampled[-1])
        self._sampled = out

    def merge(self, other: "QuantileSummary") -> "QuantileSummary":
        result = QuantileSummary(min(self.eps, other.eps),
                                 self.compress_threshold)
        for s in (self, other):
            s._flush()
        merged = sorted(self._sampled + other._sampled,
                        key=lambda t: t.value)
        result._sampled = merged
        result.count = self.count + other.count
        result._compress()
        return result

    # -- query ---------------------------------------------------------------
    def query(self, prob: float) -> float:
        if not 0 <= prob <= 1:
            raise ValueError("prob must be in [0, 1]")
        self._flush()
        if not self._sampled:
            raise ValueError("query on empty summary")
        rank = prob * (self.count - 1) + 1
        # boundary ranks are exact (head/tail tuples carry delta 0)
        if rank <= 1:
            return self._sampled[0].value
        if rank >= self.count:
            return self._sampled[-1].value
        margin = self.eps * self.count
        min_rank = 0
        for t in self._sampled:
            min_rank += t.g
            max_rank = min_rank + t.delta
            if max_rank - margin <= rank <= min_rank + margin:
                return t.value
        return self._sampled[-1].value

    def query_all(self, probs: Sequence[float]) -> np.ndarray:
        return np.asarray([self.query(p) for p in probs])


def approx_quantiles(x: np.ndarray, probs: Sequence[float],
                     relative_error: float = 0.001) -> np.ndarray:
    """Per-column quantiles of a (n, d) array → (len(probs), d).

    Batch path: numpy's exact linear-interpolation-free 'lower' quantile
    matches the GK sketch's behavior of returning an actual data value.
    """
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    return np.quantile(x, np.asarray(probs), axis=0, method="lower")


#: the low 31 bits: xor-ing them into a negative float's int32 bits (and
#: nothing into a non-negative one's) gives a signed int32 whose order is
#: IEEE float order, -0.0 just below +0.0 and NaNs past the infinities
_LOW31 = 0x7FFFFFFF


def _order_keys(x: torch.Tensor) -> torch.Tensor:
    """The order-preserving int32 image of a float32 tensor (an involution:
    applied to the keys it gives back the float bits)."""
    b = x.contiguous().view(torch.int32)
    return b ^ ((b >> 31) & _LOW31)


#: keys sorted in one call at most: a sort's values and its int64 indices
#: take three times its keys' bytes
_SORT_ELEMS = 1 << 28


def rank_select_device(x, probs: Sequence[float]) -> torch.Tensor:
    """Per-column order statistics of a float32 (n, d) tensor → (m, d)
    float32 tensor on its device.

    The columns' order-preserving int32 keys (the sign-magnitude flip radix
    sort uses; the JAX package orders the same keys as uint32, shifted by
    2^31) are sorted a group of columns at a time, and the
    floor(q·(n−1))-th smallest key of each column is mapped back to its
    float: exactly the element numpy's ``method='lower'`` and the
    reference's GK summary return, whatever the column's range. NaN bit
    patterns sort past the infinities (negative-payload NaNs below -inf),
    as a sort-based quantile's ends would. The JAX package finds the same
    keys by 32 bisection rounds a rank; on an H100 at 10,000,000 × 100,
    three ranks, the rounds took 867 ms and the sort 97 ms
    (``scripts/port_rank_select_ab.py``). A split column is gathered onto
    its first shard's device (``collective.all_gather``) and selected
    there, with the bits of the one-tensor column."""
    if getattr(x, "is_sharded_column", False):
        from flink_ml_tpu_torch.parallel import collective as C

        dev = x.device
        x = C.all_gather([p.to(dev) for p in x.parts], x.mesh)
    x = x if x.dtype == torch.float32 else x.to(torch.float32)
    n, d = int(x.shape[0]), int(x.shape[1])
    ranks = torch.as_tensor(
        np.floor(np.asarray(probs, np.float64) * (n - 1)).astype(np.int64),
        device=x.device)
    keys = _order_keys(x).t()
    step = max(1, _SORT_ELEMS // max(n, 1))
    out = torch.empty((len(ranks), d), dtype=torch.int32, device=x.device)
    for c in range(0, d, step):
        block = torch.sort(keys[c:c + step].contiguous(), dim=1).values
        out[:, c:c + step] = block[:, ranks].t()
    return _order_keys(out.view(torch.float32)).view(torch.float32)
