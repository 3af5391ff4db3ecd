"""Discrete/categorical encoders.

The port of ``flink_ml_tpu/models/feature/discrete.py`` (ref: flink-ml-lib
feature/{stringindexer,onehotencoder,kbinsdiscretizer,vectorindexer}/).

StringIndexer, IndexToString and OneHotEncoder work on host columns (a
tensor column comes to the host first); OneHotEncoder's output is one CSR
column (``linalg/sparse.py``). KBinsDiscretizer fits on the first
subSamples rows (only those leave the card) and bins a tensor column on
its device; VectorIndexer finds a tensor column's categorical dimensions
by a column-wise sort and change mark on its device and maps them there.
Host columns keep the JAX package's numpy paths and float64 outputs;
tensor columns give float32 tensors on their device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.api.stage import Estimator, Model
from flink_ml_tpu_torch.common.table import Table
from flink_ml_tpu_torch.params.param import (
    BooleanParam,
    IntParam,
    ParamValidators,
    StringParam,
)
from flink_ml_tpu_torch.params.shared import (
    HasHandleInvalid,
    HasInputCol,
    HasInputCols,
    HasOutputCol,
    HasOutputCols,
)
from flink_ml_tpu_torch.utils import io as rw


def _host_column(col):
    """A column as a host array (a tensor column's one host copy)."""
    return col.detach().cpu().numpy() if isinstance(col, torch.Tensor) \
        else col


# ---------------------------------------------------------------------------
# StringIndexer / IndexToString
# ---------------------------------------------------------------------------

class StringIndexerModelParams(HasInputCols, HasOutputCols, HasHandleInvalid):
    pass


class StringIndexerParams(StringIndexerModelParams):
    ARBITRARY_ORDER = "arbitrary"
    FREQUENCY_DESC_ORDER = "frequencyDesc"
    FREQUENCY_ASC_ORDER = "frequencyAsc"
    ALPHABET_DESC_ORDER = "alphabetDesc"
    ALPHABET_ASC_ORDER = "alphabetAsc"

    STRING_ORDER_TYPE = StringParam(
        "stringOrderType", "How to order strings of each column.",
        ARBITRARY_ORDER,
        ParamValidators.in_array(
            ARBITRARY_ORDER, FREQUENCY_DESC_ORDER, FREQUENCY_ASC_ORDER,
            ALPHABET_DESC_ORDER, ALPHABET_ASC_ORDER))


class StringIndexerModel(Model, StringIndexerModelParams):
    """Maps strings to learned indices; handleInvalid: error raises, skip
    drops the row, keep maps unseen values to len(vocab)
    (ref: StringIndexerModel.java)."""

    def __init__(self, string_arrays: Optional[List[List[str]]] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self.string_arrays = string_arrays

    def transform(self, table: Table) -> Tuple[Table]:
        if self.string_arrays is None:
            raise ValueError("StringIndexerModel has no model data")
        outs, invalid_any = {}, np.zeros(table.num_rows, bool)
        for name, out_name, vocab in zip(self.input_cols, self.output_cols,
                                         self.string_arrays):
            index = {v: i for i, v in enumerate(vocab)}
            col = _host_column(table.column(name))
            if isinstance(col, np.ndarray) and col.dtype != object:
                # homogeneous column: one lookup per DISTINCT value, then
                # a gather — 100M rows cost one factorization, not 100M
                # dict probes ('<U' columns hash-factorize inside
                # _token_codes; other dtypes fall back to np.unique there)
                from flink_ml_tpu_torch.models.feature.text import _token_codes
                uniq, inv = _token_codes(col, sort=False)
                ids = np.fromiter(
                    (index.get(str(v), -1) for v in uniq), np.int64,
                    len(uniq))
                mapped = ids[inv.reshape(-1)]
                miss = mapped < 0
                invalid_any |= miss
                outs[out_name] = np.where(miss, len(vocab),
                                          mapped).astype(np.float64)
                continue
            vals = np.empty(len(col), np.float64)
            for i, v in enumerate(col):
                j = index.get(str(v))
                if j is None:
                    invalid_any[i] = True
                    vals[i] = len(vocab)  # the "keep" bucket
                else:
                    vals[i] = j
            outs[out_name] = vals
        if invalid_any.any():
            if self.handle_invalid == self.ERROR_INVALID:
                raise ValueError("unseen string values encountered "
                                 "(handleInvalid=error)")
            if self.handle_invalid == self.SKIP_INVALID:
                keep = np.nonzero(~invalid_any)[0]
                kept = {k: v[keep] for k, v in outs.items()}
                return (table.take(keep).with_columns(**kept),)
        return (table.with_columns(**outs),)

    def set_model_data(self, model_data: Table):
        self.string_arrays = [list(arr)
                              for arr in model_data.column("stringArrays")]
        return self

    def get_model_data(self) -> Tuple[Table]:
        col = np.empty(len(self.string_arrays), dtype=object)
        for i, arr in enumerate(self.string_arrays):
            col[i] = list(arr)
        return (Table.from_columns(stringArrays=col),)

    def _save_extra(self, path: str) -> None:
        rw.save_model_json(path, "model",
                           {"stringArrays": self.string_arrays})

    def _load_extra(self, path: str, meta: dict) -> None:
        self.string_arrays = rw.load_model_json(path, "model")["stringArrays"]


def _si_shard_counts(col: np.ndarray, lo: int, hi: int):
    """Per-shard StringIndexer partial: (distinct values, counts, first
    global occurrence index) over rows [lo, hi) — the per-task count map
    of StringIndexer.java:117-122, merged by :func:`_merge_si_counts`.
    '<U' columns hash-factorize (no string sort of the shard); first
    occurrence comes from one reversed scatter (last write wins → first
    occurrence survives)."""
    from flink_ml_tpu_torch.models.feature.text import _token_codes

    sub = col[lo:hi]
    if sub.dtype.kind == "U" and len(sub):
        uniq, codes = _token_codes(sub, sort=False)
        cnts = np.bincount(codes, minlength=len(uniq))
        first_idx = np.empty(len(uniq), np.int64)
        first_idx[codes[::-1]] = np.arange(hi - lo - 1, -1, -1,
                                           dtype=np.int64)
    else:
        uniq, first_idx, cnts = np.unique(
            sub, return_index=True, return_counts=True)
    return uniq, cnts.astype(np.int64, copy=False), first_idx + lo


def _merge_si_counts(parts):
    """Reduce-merge of per-shard (values, counts, first index) — the
    reference's DataStreamUtils.reduce map merge
    (StringIndexer.java:125-142). Counts sum; first occurrence is the
    minimum global index. The merged distinct set comes back sorted
    (np.unique), matching the single-shard _token_codes order."""
    if len(parts) == 1:
        return parts[0]
    all_u = np.concatenate([p[0] for p in parts])
    uniq, inv = np.unique(all_u, return_inverse=True)
    cnts = np.zeros(len(uniq), np.int64)
    first = np.full(len(uniq), np.iinfo(np.int64).max)
    k = 0
    for pu, pc, pf in parts:
        idx = inv[k:k + len(pu)]
        np.add.at(cnts, idx, pc)
        np.minimum.at(first, idx, pf)
        k += len(pu)
    return uniq, cnts, first


class StringIndexer(Estimator, StringIndexerParams):
    """Learns per-column string→index dictionaries (ref: StringIndexer.java:
    per-task count maps → global merge → ordering by freq/alphabet). The
    per-task shape is literal here: homogeneous columns fan over the host
    pool on row shards; per-shard count maps merge reduce-style."""

    def fit(self, table: Table) -> StringIndexerModel:
        from flink_ml_tpu_torch.common.hostpool import map_row_shards

        arrays = []
        order = self.string_order_type
        for name in self.input_cols:
            col = _host_column(table.column(name))
            if isinstance(col, np.ndarray) and col.dtype != object:
                # homogeneous column: count/order once per DISTINCT value,
                # counted per shard in forked workers, merged reduce-style
                uniq, cnts, first_idx = _merge_si_counts(map_row_shards(
                    lambda lo, hi: _si_shard_counts(col, lo, hi),
                    len(col)))
                svals = np.array([str(v) for v in uniq])
                if order == self.FREQUENCY_DESC_ORDER:
                    pick = np.lexsort((svals, -cnts))
                elif order == self.FREQUENCY_ASC_ORDER:
                    pick = np.lexsort((svals, cnts))
                elif order == self.ALPHABET_DESC_ORDER:
                    pick = np.argsort(svals)[::-1]
                elif order == self.ALPHABET_ASC_ORDER:
                    pick = np.argsort(svals)
                else:  # arbitrary: first-seen order
                    pick = np.argsort(first_idx)
                arrays.append([str(v) for v in svals[pick]])
                continue
            counts = {}
            first_seen = {}
            for i, v in enumerate(col):
                v = str(v)
                counts[v] = counts.get(v, 0) + 1
                if v not in first_seen:
                    first_seen[v] = i
            if order == self.FREQUENCY_DESC_ORDER:
                vocab = sorted(counts, key=lambda v: (-counts[v], v))
            elif order == self.FREQUENCY_ASC_ORDER:
                vocab = sorted(counts, key=lambda v: (counts[v], v))
            elif order == self.ALPHABET_DESC_ORDER:
                vocab = sorted(counts, reverse=True)
            elif order == self.ALPHABET_ASC_ORDER:
                vocab = sorted(counts)
            else:  # arbitrary: first-seen order
                vocab = sorted(counts, key=lambda v: first_seen[v])
            arrays.append(vocab)
        model = StringIndexerModel(string_arrays=arrays, device=self._device)
        return self.copy_params_to(model)


class IndexToStringModel(Model, StringIndexerModelParams):
    """Reverse mapping: index → string, sharing StringIndexerModelData
    (ref: IndexToStringModel.java)."""

    def __init__(self, string_arrays: Optional[List[List[str]]] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self.string_arrays = string_arrays

    def transform(self, table: Table) -> Tuple[Table]:
        if self.string_arrays is None:
            raise ValueError("IndexToStringModel has no model data")
        outs = {}
        for name, out_name, vocab in zip(self.input_cols, self.output_cols,
                                         self.string_arrays):
            col = np.asarray(_host_column(table.column(name)), np.int64)
            if (col < 0).any() or (col >= len(vocab)).any():
                raise ValueError(f"index out of range for column {name!r}")
            outs[out_name] = np.asarray(vocab, dtype=object)[col]
        return (table.with_columns(**outs),)

    set_model_data = StringIndexerModel.set_model_data
    get_model_data = StringIndexerModel.get_model_data
    _save_extra = StringIndexerModel._save_extra
    _load_extra = StringIndexerModel._load_extra


IndexToString = IndexToStringModel


# ---------------------------------------------------------------------------
# OneHotEncoder
# ---------------------------------------------------------------------------

class OneHotEncoderParams(HasInputCols, HasOutputCols, HasHandleInvalid):
    DROP_LAST = BooleanParam("dropLast", "Whether to drop the last category.",
                             True)


class OneHotEncoderModel(Model, OneHotEncoderParams):
    """Encodes integer category indices as one-hot sparse vectors
    (ref: OneHotEncoderModel.java); model data = category counts per column."""

    def __init__(self, category_sizes: Optional[List[int]] = None, **kwargs):
        super().__init__(**kwargs)
        self.category_sizes = (None if category_sizes is None
                               else [int(c) for c in category_sizes])

    def transform(self, table: Table) -> Tuple[Table]:
        if self.category_sizes is None:
            raise ValueError("OneHotEncoderModel has no model data")
        outs, invalid_any = {}, np.zeros(table.num_rows, bool)
        for name, out_name, n_cats in zip(self.input_cols, self.output_cols,
                                          self.category_sizes):
            vals = np.asarray(_host_column(table.column(name)), np.float64)
            ints = vals.astype(np.int64)
            invalid = (vals != ints) | (ints < 0) | (ints >= n_cats)
            invalid_any |= invalid
            size = n_cats - 1 if self.drop_last else n_cats
            if self.handle_invalid == self.KEEP_INVALID:
                size += 1  # extra category for invalid values
            # one-hot rows have 0 or 1 entries: compute the entry index for
            # every row vectorized, then emit ONE CSR for the whole column
            # (no 10M-object loop; rows materialize lazily)
            entry = ints.copy()
            has_entry = (~invalid & (ints < size)
                         & ~(self.drop_last & (ints == n_cats - 1)))
            if self.handle_invalid == self.KEEP_INVALID:
                entry[invalid] = size - 1  # the extra invalid category
                has_entry |= invalid
            from flink_ml_tpu_torch.linalg.sparse import build_csr_column

            rows = np.nonzero(has_entry)[0]
            outs[out_name] = build_csr_column(
                len(vals), size, rows, entry[rows], np.ones(len(rows)))
        if invalid_any.any() and self.handle_invalid == self.ERROR_INVALID:
            raise ValueError("invalid category values encountered "
                             "(handleInvalid=error)")
        if invalid_any.any() and self.handle_invalid == self.SKIP_INVALID:
            keep = np.nonzero(~invalid_any)[0]
            kept = {k: v[keep] for k, v in outs.items()}
            return (table.take(keep).with_columns(**kept),)
        return (table.with_columns(**outs),)

    def set_model_data(self, model_data: Table):
        self.category_sizes = [int(v)
                               for v in model_data.column("categorySizes")]
        return self

    def get_model_data(self) -> Tuple[Table]:
        return (Table.from_columns(
            categorySizes=np.asarray(self.category_sizes, np.float64)),)

    def _save_extra(self, path: str) -> None:
        rw.save_model_json(path, "model",
                           {"categorySizes": self.category_sizes})

    def _load_extra(self, path: str, meta: dict) -> None:
        self.category_sizes = rw.load_model_json(path, "model")[
            "categorySizes"]


class OneHotEncoder(Estimator, OneHotEncoderParams):
    def fit(self, table: Table) -> OneHotEncoderModel:
        sizes = []
        for name in self.input_cols:
            vals = np.asarray(_host_column(table.column(name)), np.float64)
            ints = vals.astype(np.int64)
            if (vals != ints).any() or (ints < 0).any():
                raise ValueError(
                    f"column {name!r} must contain non-negative integers")
            sizes.append(int(ints.max()) + 1 if len(ints) else 0)
        model = OneHotEncoderModel(category_sizes=sizes, device=self._device)
        return self.copy_params_to(model)


# ---------------------------------------------------------------------------
# KBinsDiscretizer
# ---------------------------------------------------------------------------

class KBinsDiscretizerModelParams(HasInputCol, HasOutputCol):
    pass


class KBinsDiscretizerParams(KBinsDiscretizerModelParams):
    UNIFORM = "uniform"
    QUANTILE = "quantile"
    KMEANS = "kmeans"

    STRATEGY = StringParam(
        "strategy", "Strategy used to define the width of the bin.", QUANTILE,
        ParamValidators.in_array(UNIFORM, QUANTILE, KMEANS))
    NUM_BINS = IntParam("numBins", "Number of bins to produce.", 5,
                        ParamValidators.gt_eq(2))
    SUB_SAMPLES = IntParam(
        "subSamples", "Maximum number of samples used to fit the model.",
        200000, ParamValidators.gt_eq(2))


class KBinsDiscretizerModel(Model, KBinsDiscretizerModelParams):
    def __init__(self, bin_edges: Optional[List[np.ndarray]] = None, **kwargs):
        super().__init__(**kwargs)
        self.bin_edges = (None if bin_edges is None
                          else [np.asarray(e, np.float64) for e in bin_edges])

    def transform(self, table: Table) -> Tuple[Table]:
        if self.bin_edges is None:
            raise ValueError("KBinsDiscretizerModel has no model data")
        raw = table.column(self.input_col)
        if isinstance(raw, torch.Tensor):
            # on the column's device: each value widens to float64 (exact)
            # and is placed among the float64 interior edges, as the host
            # path places it; bin ids are exact in float32
            x = raw if raw.ndim == 2 else raw[:, None]
            out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
            for j, edges in enumerate(self.bin_edges):
                inner = torch.as_tensor(edges[1:-1], dtype=torch.float64,
                                        device=x.device)
                out[:, j] = torch.searchsorted(
                    inner, x[:, j].to(torch.float64).contiguous(),
                    right=True).to(torch.float32)
            return (table.with_column(self.output_col, out),)
        x = table.vectors(self.input_col, np.float64)
        out = np.empty_like(x)
        for j, edges in enumerate(self.bin_edges):
            # interior edges define the bins; clamp outside values
            bins = np.searchsorted(edges[1:-1], x[:, j], side="right")
            out[:, j] = bins
        return (table.with_column(self.output_col, out),)

    def set_model_data(self, model_data: Table):
        self.bin_edges = [np.asarray(e, np.float64)
                          for e in model_data.column("binEdges")]
        return self

    def get_model_data(self) -> Tuple[Table]:
        col = np.empty(len(self.bin_edges), dtype=object)
        for i, e in enumerate(self.bin_edges):
            col[i] = e
        return (Table.from_columns(binEdges=col),)

    def _save_extra(self, path: str) -> None:
        rw.save_model_json(path, "model", {
            "binEdges": [e.tolist() for e in self.bin_edges]})

    def _load_extra(self, path: str, meta: dict) -> None:
        self.bin_edges = [np.asarray(e, np.float64) for e in
                          rw.load_model_json(path, "model")["binEdges"]]


class KBinsDiscretizer(Estimator, KBinsDiscretizerParams):
    """Per-dimension binning by uniform width / quantiles / 1-D k-means
    (ref: KBinsDiscretizer.java; fit on at most subSamples rows)."""

    def fit(self, table: Table) -> KBinsDiscretizerModel:
        from flink_ml_tpu_torch.ops import columnar

        raw = table.column(self.input_col)
        if columnar.is_device_array(raw):
            # slice before the host off-ramp: only subSamples rows leave
            # the card (the reference likewise fits on the subsample)
            n = min(raw.shape[0], self.sub_samples)
            x = columnar.to_host(columnar.head_rows(raw, n)).astype(
                np.float64)
            if x.ndim == 1:
                x = x[:, None]
        else:
            x = table.vectors(self.input_col, np.float64)
            if x.shape[0] > self.sub_samples:
                x = x[: self.sub_samples]
        k = self.num_bins
        edges_per_dim = []
        for j in range(x.shape[1]):
            col = x[:, j]
            if self.strategy == self.UNIFORM:
                # dedupe equal edges so a constant column maps to bin 0
                edges = np.unique(np.linspace(col.min(), col.max(), k + 1))
            elif self.strategy == self.QUANTILE:
                qs = np.linspace(0, 1, k + 1)
                edges = np.unique(np.quantile(col, qs))
            else:  # 1-D k-means: bin edges midway between sorted centroids
                uniq = np.unique(col)
                kk = min(k, len(uniq))
                centroids = np.sort(
                    uniq[np.linspace(0, len(uniq) - 1, kk).astype(int)]
                ).astype(np.float64)
                for _ in range(20):
                    assign = np.argmin(
                        np.abs(col[:, None] - centroids[None, :]), axis=1)
                    for c in range(kk):
                        pts = col[assign == c]
                        if len(pts):
                            centroids[c] = pts.mean()
                    centroids = np.sort(centroids)
                mids = (centroids[:-1] + centroids[1:]) / 2.0
                edges = np.concatenate([[col.min()], mids, [col.max()]])
            edges_per_dim.append(edges)
        model = KBinsDiscretizerModel(bin_edges=edges_per_dim,
                                      device=self._device)
        return self.copy_params_to(model)


# ---------------------------------------------------------------------------
# VectorIndexer
# ---------------------------------------------------------------------------

class VectorIndexerModelParams(HasInputCol, HasOutputCol, HasHandleInvalid):
    pass


class VectorIndexerParams(VectorIndexerModelParams):
    MAX_CATEGORIES = IntParam(
        "maxCategories", "Threshold for the number of values a categorical "
        "feature can take (>= 2).", 20, ParamValidators.gt_eq(2))


class VectorIndexerModel(Model, VectorIndexerModelParams):
    """Per-dimension categorical maps; continuous dims pass through
    (ref: VectorIndexerModel.java). category_maps: {dim: {value: index}}."""

    def __init__(self, category_maps=None, **kwargs):
        super().__init__(**kwargs)
        self.category_maps = category_maps

    def transform(self, table: Table) -> Tuple[Table]:
        """Each categorical dimension's value → its index, an unseen value
        (NaN included: no NaN key ever matches) → the keep bucket
        ``len(mapping)``, vectorized over sorted keys: on the column's
        device for a tensor column, with numpy for a host one."""
        if self.category_maps is None:
            raise ValueError("VectorIndexerModel has no model data")
        raw = table.column(self.input_col)
        on_device = isinstance(raw, torch.Tensor)
        if on_device:
            x = (raw if raw.ndim == 2 else raw[:, None]).clone()
            invalid_any = torch.zeros(x.shape[0], dtype=torch.bool,
                                      device=x.device)
        else:
            x = table.vectors(self.input_col, np.float64).copy()
            invalid_any = np.zeros(x.shape[0], bool)
        for dim, mapping in self.category_maps.items():
            # NaN keys (which never match) sort last, as searchsorted
            # expects
            items = sorted(mapping.items(),
                           key=lambda kv: (np.isnan(kv[0]), kv[0]))
            keys = np.asarray([kv[0] for kv in items], np.float64)
            ids = np.asarray([kv[1] for kv in items], np.float64)
            if on_device:
                col = x[:, dim].to(torch.float64)
                keys_t = torch.as_tensor(keys, device=x.device)
                pos = torch.searchsorted(keys_t, col).clamp_(
                    max=max(len(keys) - 1, 0))
                hit = (keys_t[pos] == col) if len(keys) else \
                    torch.zeros_like(col, dtype=torch.bool)
                new = torch.where(hit, torch.as_tensor(
                    ids, device=x.device)[pos] if len(keys) else col,
                    float(len(mapping)))
                x[:, dim] = new.to(x.dtype)
            else:
                col = x[:, dim]
                pos = np.minimum(np.searchsorted(keys, col),
                                 max(len(keys) - 1, 0))
                hit = (keys[pos] == col) if len(keys) else \
                    np.zeros(len(col), bool)
                x[:, dim] = np.where(hit, ids[pos] if len(keys) else col,
                                     float(len(mapping)))
            invalid_any |= ~hit
        if bool(invalid_any.any()):
            if self.handle_invalid == self.ERROR_INVALID:
                raise ValueError("unseen categorical values encountered "
                                 "(handleInvalid=error)")
            if self.handle_invalid == self.SKIP_INVALID:
                if on_device:
                    keep = torch.nonzero(~invalid_any).squeeze(1)
                else:
                    keep = np.nonzero(~invalid_any)[0]
                return (table.take(keep).with_column(self.output_col,
                                                     x[keep]),)
        return (table.with_column(self.output_col, x),)

    def set_model_data(self, model_data: Table):
        raw = model_data.column("categoryMaps")[0]
        self.category_maps = {
            int(dim): {float(v): int(i) for v, i in mapping.items()}
            for dim, mapping in raw.items()}
        return self

    def get_model_data(self) -> Tuple[Table]:
        col = np.empty(1, dtype=object)
        col[0] = {int(d): dict(m) for d, m in self.category_maps.items()}
        return (Table.from_columns(categoryMaps=col),)

    def _save_extra(self, path: str) -> None:
        rw.save_model_json(path, "model", {
            "categoryMaps": {str(d): {str(v): i for v, i in m.items()}
                             for d, m in self.category_maps.items()}})

    def _load_extra(self, path: str, meta: dict) -> None:
        raw = rw.load_model_json(path, "model")["categoryMaps"]
        self.category_maps = {
            int(d): {float(v): int(i) for v, i in m.items()}
            for d, m in raw.items()}


def _distinct_per_dim(x: torch.Tensor, k: int):
    """The categorical-discovery pass on the column's device: each
    dimension sorted, its changes marked (equal neighbours are one value,
    NaNs collapse to one), giving per dimension the count of distinct
    values, a has-non-finite flag, and the distinct values themselves
    where there are at most ``k`` (as float64 numpy; None elsewhere). The
    torch twin of the JAX package's ``jnp.unique(size=k+1)`` per column."""
    s = torch.sort(x, dim=0).values
    change = torch.ones_like(s, dtype=torch.bool)
    change[1:] = (s[1:] != s[:-1]) & ~(torch.isnan(s[1:])
                                        & torch.isnan(s[:-1]))
    counts = change.sum(dim=0).cpu().numpy()
    nonfinite = (~torch.isfinite(x)).any(dim=0).cpu().numpy()
    values = [s[:, j][change[:, j]].cpu().numpy().astype(np.float64)
              if counts[j] <= k else None for j in range(x.shape[1])]
    return counts, nonfinite, values


class VectorIndexer(Estimator, VectorIndexerParams):
    def fit(self, table: Table) -> VectorIndexerModel:
        from flink_ml_tpu_torch.ops import columnar

        x, xp = columnar.fit_vectors(table, self.input_col)
        k = self.max_categories
        maps = {}
        if xp is not np:
            # sample screen: a dim whose first rows already show more than
            # k distinct values cannot be categorical (subset distinct <=
            # whole-column distinct), so continuous dims never pay the
            # full-column sort or any host off-ramp
            n, d = x.shape
            s_counts, _, _ = _distinct_per_dim(
                columnar.head_rows(x, min(n, 4096)), k)
            possible = [dim for dim in range(d) if s_counts[dim] <= k]
            if possible:
                # surviving dims: distinct values per dim over the full
                # column; only up to k candidates a dim reach the host.
                # Invariant: maps must equal the host path run on the
                # same column values. Integral candidates satisfy that
                # directly; dims with non-finite or fractional values
                # re-fit from one shared host copy so NaN/inf and
                # fractional keys get exact np.unique semantics.
                sub = columnar.take_dims(x, possible)
                counts, nonfinite, cand = _distinct_per_dim(sub, k)
                sub_h = None
                for j, dim in enumerate(possible):
                    vals = cand[j]
                    if counts[j] > k and not nonfinite[j]:
                        continue
                    if nonfinite[j] or not (vals == np.floor(vals)).all():
                        if sub_h is None:
                            sub_h = columnar.to_host(sub).astype(np.float64)
                        vals = np.unique(sub_h[:, j])
                    if len(vals) <= k:
                        maps[dim] = {float(v): i
                                     for i, v in enumerate(sorted(vals))}
        else:
            n = x.shape[0]
            for dim in range(x.shape[1]):
                if n > 8192 and len(np.unique(x[:8192, dim])) > k:
                    continue  # same sample screen, host tier
                uniq = np.unique(x[:, dim])
                if len(uniq) <= k:
                    maps[dim] = {float(v): i
                                 for i, v in enumerate(sorted(uniq))}
        model = VectorIndexerModel(category_maps=maps, device=self._device)
        return self.copy_params_to(model)
