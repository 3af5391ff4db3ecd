"""Stateless vector transformers.

The port of ``flink_ml_tpu/models/feature/vectorops.py`` (ref: flink-ml-lib
feature/{normalizer,elementwiseproduct,polynomialexpansion,dct,interaction,
vectorassembler,vectorslicer,binarizer,bucketizer}/): record-wise transforms
in the reference, here one torch function per op over the column where
``ops/columnar.py`` places it (the stage's device, or once per shard of a
column split over a default mesh), the output left a tensor or a split
column for the next stage. CSR columns keep their O(nnz) host branches.

Two ops go further than the JAX package on tensor columns, so that a column
on the card never goes to the host: VectorAssembler concatenates tensor
columns on their device (the JAX package off-ramps them and assembles on
the host), and the skip/error modes of VectorAssembler and Bucketizer find
and drop invalid rows on the device (one scalar crosses to the host to
decide whether any row is invalid). Host columns take the JAX package's
host paths, float64 outputs included.
"""

from __future__ import annotations

import itertools
import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.api.stage import Transformer
from flink_ml_tpu_torch.common.table import Table
from flink_ml_tpu_torch.linalg import sparse as sp_mod
from flink_ml_tpu_torch.ops import columnar
from flink_ml_tpu_torch.params.param import (
    BooleanParam,
    FloatArrayArrayParam,
    FloatArrayParam,
    FloatParam,
    IntArrayParam,
    IntParam,
    ParamValidator,
    ParamValidators,
    VectorParam,
)
from flink_ml_tpu_torch.params.shared import (
    HasHandleInvalid,
    HasInputCol,
    HasInputCols,
    HasOutputCol,
    HasOutputCols,
)


def _normalizer_kernel(x, p):
    if math.isinf(p):
        norms = x.abs().amax(dim=1)
    elif p == 2.0:
        norms = (x * x).sum(dim=1).sqrt()
    elif p == 1.0:
        norms = x.abs().sum(dim=1)
    else:
        norms = (x.abs() ** p).sum(dim=1) ** (1.0 / p)
    return x / torch.where(norms > 0, norms, torch.ones_like(norms))[:, None]


class Normalizer(Transformer, HasInputCol, HasOutputCol):
    """v → v/‖v‖_p (ref: feature/normalizer/Normalizer.java; p ≥ 1, default 2)."""

    P = FloatParam("p", "The p norm value.", 2.0, ParamValidators.gt_eq(1.0))

    def transform(self, table: Table) -> Tuple[Table]:
        col = table.column(self.input_col)
        if sp_mod.is_sparse_column(col):
            # O(nnz): per-row p-norm over stored values, structure shared
            import scipy.sparse as sp

            m = sp_mod.column_to_csr(col)
            p = float(self.p)
            if np.isinf(p):  # max-abs norm, like the dense kernel
                norms = np.asarray(abs(m).max(axis=1).todense()).ravel()
            else:
                norms = np.power(
                    np.asarray(abs(m).power(p).sum(axis=1)).ravel(),
                    1.0 / p)
            # zero-norm rows stay unscaled (divide by 1), as in the kernel
            row_scale = np.repeat(1.0 / np.where(norms > 0, norms, 1.0),
                                  np.diff(m.indptr))
            out = sp.csr_matrix((m.data * row_scale, m.indices, m.indptr),
                                shape=m.shape)
            return (table.with_column(self.output_col,
                                      sp_mod.CsrVectorColumn(out)),)
        device = self.device
        x = columnar.input_vectors(table, self.input_col, device)
        out = columnar.apply(_normalizer_kernel, x, (), (float(self.p),),
                             device)
        return (table.with_column(self.output_col, out),)


def _scale_kernel(x, s):
    return x * s[None, :]


class ElementwiseProduct(Transformer, HasInputCol, HasOutputCol):
    """v → v ∘ scalingVec (ref: feature/elementwiseproduct/)."""

    SCALING_VEC = VectorParam("scalingVec", "The scaling vector.", None)

    def transform(self, table: Table) -> Tuple[Table]:
        if self.scaling_vec is None:
            raise ValueError("scalingVec must be set")
        col = table.column(self.input_col)
        if sp_mod.is_sparse_column(col):
            # O(nnz): scale stored values by their coordinate's factor
            import scipy.sparse as sp

            m = sp_mod.column_to_csr(col)
            s = self.scaling_vec.to_array()
            if s.shape[0] != m.shape[1]:
                raise ValueError(
                    f"scalingVec has size {s.shape[0]}, input vectors "
                    f"have size {m.shape[1]}")
            out = sp.csr_matrix((m.data * s[m.indices], m.indices,
                                 m.indptr), shape=m.shape)
            return (table.with_column(self.output_col,
                                      sp_mod.CsrVectorColumn(out)),)
        device = self.device
        x = columnar.input_vectors(table, self.input_col, device)
        out = columnar.apply(_scale_kernel, x,
                             (self.scaling_vec.to_array(),), (), device)
        return (table.with_column(self.output_col, out),)


@lru_cache(maxsize=None)
def _poly_plan(d: int, degree: int):
    """Per degree level k ≥ 2: the index of each monomial's level-(k−1)
    prefix and its last feature (combinations with replacement, in order)."""
    level_combos = list(itertools.combinations_with_replacement(range(d), 1))
    plan = []
    for deg in range(2, degree + 1):
        combos = list(itertools.combinations_with_replacement(range(d), deg))
        prev_pos = {c: i for i, c in enumerate(level_combos)}
        plan.append((np.asarray([prev_pos[c[:-1]] for c in combos], np.int64),
                     np.asarray([c[-1] for c in combos], np.int64)))
        level_combos = combos
    return plan


def _poly_kernel(x, degree):
    """All monomials up to ``degree``, ordered by total degree then by
    combination order. One gather and one multiply per degree level (each
    level-k monomial is its level-(k−1) prefix times one feature)."""
    levels = [x]
    for prefix_idx, feat_idx in _poly_plan(int(x.shape[1]), int(degree)):
        prefix = torch.as_tensor(prefix_idx, device=x.device)
        feat = torch.as_tensor(feat_idx, device=x.device)
        levels.append(levels[-1].index_select(1, prefix)
                      * x.index_select(1, feat))
    return torch.cat(levels, dim=1) if len(levels) > 1 else levels[0]


class PolynomialExpansion(Transformer, HasInputCol, HasOutputCol):
    """All monomials of the input features up to ``degree``
    (ref: feature/polynomialexpansion/; degree ≥ 1, default 2). Monomials are
    ordered by total degree, then by combination order over feature indices."""

    DEGREE = IntParam("degree", "Degree of the polynomial expansion.", 2,
                      ParamValidators.gt_eq(1))

    def transform(self, table: Table) -> Tuple[Table]:
        device = self.device
        x = columnar.input_vectors(table, self.input_col, device)
        out = columnar.apply(_poly_kernel, x, (), (int(self.degree),), device)
        return (table.with_column(self.output_col, out),)


@lru_cache(maxsize=None)
def _dct_matrix(d: int) -> np.ndarray:
    """The orthonormal DCT-II matrix D (d × d), float64: y = D·x, and the
    inverse (DCT-III) x = Dᵀ·y."""
    k = np.arange(d)[:, None]
    j = np.arange(d)[None, :]
    mat = np.cos(np.pi * (2 * j + 1) * k / (2 * d)) * np.sqrt(2.0 / d)
    mat[0] /= np.sqrt(2.0)
    return mat


def _dct_kernel(x, inverse):
    """Orthonormal DCT-II (or its inverse) of each row, as one float32
    product with the DCT matrix (torch has no DCT; the JAX package's
    ``jax.scipy.fft.dct`` is not a Pallas kernel either)."""
    mat = torch.as_tensor(_dct_matrix(int(x.shape[1])), dtype=x.dtype,
                          device=x.device)
    return x @ mat if inverse else x @ mat.T


class DCT(Transformer, HasInputCol, HasOutputCol):
    """Orthonormal DCT-II (or its inverse) per vector (ref: feature/dct/)."""

    INVERSE = BooleanParam(
        "inverse", "Whether to perform the inverse DCT (true) or forward "
        "DCT (false).", False)

    def transform(self, table: Table) -> Tuple[Table]:
        device = self.device
        x = columnar.input_vectors(table, self.input_col, device)
        out = columnar.apply(_dct_kernel, x, (), (bool(self.inverse),),
                             device)
        return (table.with_column(self.output_col, out),)


def _interaction_kernel(*mats):
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, :, None] * m[:, None, :]).reshape(
            out.shape[0], out.shape[1] * m.shape[1])
    return out


def _sparse_outer_fold(a, b):
    """Per-row flattened outer product of two CSR matrices: row i of the
    result has indices a_idx*size_b + b_idx over the cartesian product of
    the rows' stored entries (a-major, so per-row order stays ascending).
    O(total output nnz), fully vectorized."""
    import scipy.sparse as sp

    n = a.shape[0]
    na, nb = np.diff(a.indptr), np.diff(b.indptr)
    per_a_entry = np.repeat(nb, na)        # b-count for each stored a entry
    a_idx = np.repeat(a.indices.astype(np.int64), per_a_entry)
    a_val = np.repeat(a.data, per_a_entry)
    out_nnz = na * nb
    total = int(out_nnz.sum())
    out_indptr = np.zeros(n + 1, np.int64)
    np.cumsum(out_nnz, out=out_indptr[1:])
    # b side: within each row, the b block tiles once per a entry
    out_row = np.repeat(np.arange(n, dtype=np.int64), out_nnz)
    pos = np.arange(total, dtype=np.int64) - out_indptr[out_row]
    b_pos = b.indptr[out_row] + pos % np.maximum(nb[out_row], 1)
    out_idx = a_idx * b.shape[1] + b.indices.astype(np.int64)[b_pos]
    out_val = a_val * b.data[b_pos]
    return sp.csr_matrix((out_val, out_idx, out_indptr),
                         shape=(n, a.shape[1] * b.shape[1]))


class Interaction(Transformer, HasInputCols, HasOutputCol):
    """Flattened outer product of the input columns' values
    (ref: feature/interaction/ — scalar columns count as 1-dim vectors)."""

    def transform(self, table: Table) -> Tuple[Table]:
        sparse_flags = [sp_mod.is_sparse_column(table.column(n))
                        for n in self.input_cols]
        if any(sparse_flags):
            return self._transform_sparse(table, sparse_flags)
        mats = []
        for name in self.input_cols:
            col = table.column(name)
            if columnar.is_device_array(col):
                mats.append(columnar.as_matrix(col))
            elif col.dtype == object or col.ndim == 2:
                mats.append(table.vectors(name, np.float32))
            else:
                mats.append(np.asarray(col, np.float32)[:, None])
        out = columnar.apply_multi(_interaction_kernel, mats,
                                   device=self.device)
        return (table.with_column(self.output_col, out),)

    def _transform_sparse(self, table: Table, sparse_flags) -> Tuple[Table]:
        """Any sparse input → fold per-row outer products over CSR blocks,
        O(output nnz): a wide hashed column interacted with scalars never
        densifies."""
        import scipy.sparse as sp

        out = None
        for name, is_sparse in zip(self.input_cols, sparse_flags):
            col = table.column(name)
            if is_sparse:
                block = sp_mod.column_to_csr(col)
            elif getattr(col, "ndim", 1) == 2 or col.dtype == object:
                block = sp.csr_matrix(table.vectors(name, np.float64))
            else:
                block = sp.csr_matrix(
                    np.asarray(col, np.float64)[:, None])
            out = block if out is None else _sparse_outer_fold(out, block)
        return (table.with_column(self.output_col,
                                  sp_mod.CsrVectorColumn(out)),)


def _assemble_kernel(*cols):
    """Tensor columns side by side as float32, and each row's NaN flag."""
    out = torch.cat([(c if c.ndim == 2 else c[:, None]).to(torch.float32)
                     for c in cols], dim=1)
    return out, torch.isnan(out).any(dim=1)


class VectorAssembler(Transformer, HasInputCols, HasOutputCol,
                      HasHandleInvalid):
    """Concatenate scalar/vector columns into one vector
    (ref: feature/vectorassembler/). handleInvalid: error (default) raises on
    NaN, skip drops the row, keep passes NaN through. inputSizes optionally
    declares the expected width of every input (scalars are width 1); a
    mismatch raises, except in skip mode where the offending rows are
    dropped (ref: VectorAssemblerParams.java INPUT_SIZES + sizesValidator,
    VectorAssembler.java:99-144 checkSize).

    When every input is a tensor column, the columns are assembled on the
    stage's device into a float32 tensor (a tensor column has one width
    for every row, so the size check is on its shape); otherwise on the
    host into float64, as the JAX package does."""

    INPUT_SIZES = IntArrayParam(
        "inputSizes", "Sizes of the input elements to be assembled.", None,
        ParamValidator(
            lambda sizes: sizes is None
            or (len(sizes) > 0 and all(s > 0 for s in sizes)),
            "unset, or a non-empty array of positive sizes"))

    @staticmethod
    def _row_size(value) -> int:
        if hasattr(value, "to_array"):  # Dense/SparseVector objects
            return int(value.size)
        return np.asarray(value, np.float64).reshape(-1).shape[0]

    def transform(self, table: Table) -> Tuple[Table]:
        sizes = self.input_sizes
        if sizes is not None and len(sizes) != len(self.input_cols):
            raise ValueError("inputSizes must match inputCols length")
        if all(columnar.is_device_array(table.column(n))
               for n in self.input_cols):
            return self._assemble_device(table, sizes)
        if sizes is not None:
            # per-row size check BEFORE stacking, so ragged object columns
            # are skipped/reported row by row like checkSize in the
            # reference rather than failing inside np.stack
            bad = np.zeros(table.num_rows, dtype=bool)
            first_mismatch = None
            for i, name in enumerate(self.input_cols):
                col = table.column(name)
                if sp_mod.is_csr_column(col):
                    row_sizes = np.full(len(col), col.to_csr().shape[1])
                elif col.dtype == object:
                    row_sizes = np.fromiter(
                        (self._row_size(v) for v in col), dtype=np.int64,
                        count=len(col))
                elif col.ndim == 2:
                    row_sizes = np.full(len(col), col.shape[1])
                else:
                    row_sizes = np.ones(len(col), dtype=np.int64)
                mismatch = row_sizes != sizes[i]
                if mismatch.any() and first_mismatch is None:
                    r = int(np.nonzero(mismatch)[0][0])
                    first_mismatch = (name, i, int(row_sizes[r]))
                bad |= mismatch
            if bad.any():
                if self.handle_invalid != self.SKIP_INVALID:
                    name, i, got = first_mismatch
                    raise ValueError(
                        f"input column {name!r} has size {got}, "
                        f"declared inputSizes[{i}]={sizes[i]}")
                table = table.take(np.nonzero(~bad)[0])
                if table.num_rows == 0:
                    return (table.with_column(
                        self.output_col, np.zeros((0, sum(sizes)))),)
        sparse_flags = [sp_mod.is_sparse_column(table.column(n))
                        for n in self.input_cols]
        if any(sparse_flags):
            return self._assemble_sparse(table, sparse_flags)
        mats = []
        for name in self.input_cols:
            col = table.column(name)
            if col.dtype == object or col.ndim == 2:
                mats.append(table.vectors(name, np.float64))
            else:
                mats.append(np.asarray(col, np.float64)[:, None])
        out = np.concatenate(mats, axis=1)
        invalid = np.isnan(out).any(axis=1)
        if invalid.any():
            if self.handle_invalid == self.ERROR_INVALID:
                raise ValueError(
                    f"Encountered NaN while assembling rows "
                    f"{np.nonzero(invalid)[0][:5].tolist()}... "
                    f"(handleInvalid=error)")
            if self.handle_invalid == self.SKIP_INVALID:
                keep = ~invalid
                return (table.take(np.nonzero(keep)[0])
                        .with_column(self.output_col, out[keep]),)
        return (table.with_column(self.output_col, out),)

    def _assemble_device(self, table: Table, sizes) -> Tuple[Table]:
        """Tensor columns → one float32 tensor on the stage's device; NaN
        rows raise or are dropped there."""
        cols = [table.column(n) for n in self.input_cols]
        if sizes is not None:
            for i, (name, col) in enumerate(zip(self.input_cols, cols)):
                width = 1 if col.ndim == 1 else int(col.shape[1])
                if width != sizes[i]:
                    if self.handle_invalid != self.SKIP_INVALID:
                        raise ValueError(
                            f"input column {name!r} has size {width}, "
                            f"declared inputSizes[{i}]={sizes[i]}")
                    # every row of the column is the wrong size
                    empty = table.take(slice(0, 0))
                    return (empty.with_column(self.output_col, torch.zeros(
                        (0, sum(sizes)), device=self.device)),)
        out, invalid = columnar.apply_multi(_assemble_kernel, cols,
                                            device=self.device)
        if self.handle_invalid == self.KEEP_INVALID:
            return (table.with_column(self.output_col, out),)
        invalid = columnar.joined(invalid)
        if not bool(invalid.any()):
            return (table.with_column(self.output_col, out),)
        if self.handle_invalid == self.ERROR_INVALID:
            rows = torch.nonzero(invalid).flatten()[:5].tolist()
            raise ValueError(f"Encountered NaN while assembling rows "
                             f"{rows}... (handleInvalid=error)")
        keep = torch.nonzero(~invalid).flatten()
        return (table.take(keep).with_column(
            self.output_col, columnar.take_rows(out, keep)),)

    def _assemble_sparse(self, table: Table, sparse_flags) -> Tuple[Table]:
        """Any sparse input → CSR output via block hstack, O(total nnz);
        a wide HashingTF column plus scalar columns never densifies.
        NaN policy applies to STORED values (implicit zeros are valid)."""
        import scipy.sparse as sp

        blocks = []
        for name, is_sparse in zip(self.input_cols, sparse_flags):
            col = table.column(name)
            if is_sparse:
                blocks.append(sp_mod.column_to_csr(col))
            elif col.dtype == object or col.ndim == 2:
                blocks.append(sp.csr_matrix(table.vectors(name, np.float64)))
            else:
                blocks.append(sp.csr_matrix(
                    np.asarray(col, np.float64)[:, None]))
        out = sp.hstack(blocks, format="csr")
        nan_pos = np.nonzero(np.isnan(out.data))[0]
        if len(nan_pos):
            rows_nan = np.unique(np.searchsorted(
                out.indptr, nan_pos, side="right") - 1)
            if self.handle_invalid == self.ERROR_INVALID:
                raise ValueError(
                    f"Encountered NaN while assembling rows "
                    f"{rows_nan[:5].tolist()}... (handleInvalid=error)")
            if self.handle_invalid == self.SKIP_INVALID:
                keep = np.ones(out.shape[0], bool)
                keep[rows_nan] = False
                kept_idx = np.nonzero(keep)[0]
                return (table.take(kept_idx).with_column(
                    self.output_col,
                    sp_mod.CsrVectorColumn(out[kept_idx])),)
        return (table.with_column(self.output_col,
                                  sp_mod.CsrVectorColumn(out)),)


def _gather_cols_kernel(x, idx):
    return x.index_select(1, torch.as_tensor(idx, dtype=torch.int64,
                                             device=x.device))


class VectorSlicer(Transformer, HasInputCol, HasOutputCol):
    """Select sub-vector by indices (ref: feature/vectorslicer/)."""

    INDICES = IntArrayParam(
        "indices", "An array of indices to select features from a vector "
        "column.", None, ParamValidators.non_empty_array())

    def transform(self, table: Table) -> Tuple[Table]:
        idx = np.asarray(self.indices, np.int64)
        if (idx < 0).any():
            raise ValueError("indices must be non-negative")
        col = table.column(self.input_col)
        if sp_mod.is_sparse_column(col):
            m = sp_mod.column_to_csr(col)
            if (idx >= m.shape[1]).any():
                raise IndexError(
                    f"indices {idx[idx >= m.shape[1]].tolist()} out of "
                    f"range for vectors of size {m.shape[1]}")
            # scipy column selection keeps CSR; O(nnz of the slice)
            return (table.with_column(
                self.output_col,
                sp_mod.CsrVectorColumn(m[:, idx].tocsr())),)
        device = self.device
        x = columnar.input_vectors(table, self.input_col, device)
        if (idx >= x.shape[1]).any():
            raise IndexError(
                f"indices {idx[idx >= x.shape[1]].tolist()} out of range "
                f"for vectors of size {x.shape[1]}")
        out = columnar.apply(_gather_cols_kernel, x, (),
                             (tuple(int(i) for i in idx),), device)
        return (table.with_column(self.output_col, out),)


def _binarize_kernel(x, thr):
    return (x > thr).to(torch.float32)


class Binarizer(Transformer, HasInputCols, HasOutputCols):
    """Per-column thresholding to {0,1}; value > threshold → 1
    (ref: feature/binarizer/ — works on scalar and vector columns)."""

    THRESHOLDS = FloatArrayParam(
        "thresholds", "The thresholds used to binarize continuous features.",
        None, ParamValidators.non_empty_array())

    def transform(self, table: Table) -> Tuple[Table]:
        if self.thresholds is None or \
                len(self.thresholds) != len(self.input_cols):
            raise ValueError("thresholds must match inputCols length")
        device = self.device
        out = {}
        for name, out_name, thr in zip(self.input_cols, self.output_cols,
                                       self.thresholds):
            col = table.column(name)
            if sp_mod.is_sparse_column(col) and float(thr) >= 0.0:
                # implicit zeros stay 0 (0 > thr is false for thr >= 0):
                # sparse in, sparse out, O(nnz). Negative thresholds turn
                # zeros into ones, inherently dense, handled below.
                import scipy.sparse as sp

                m = sp_mod.column_to_csr(col)
                keep = m.data > float(thr)
                # drop failing entries instead of storing explicit zeros
                # (output nnz = number of ones); built fresh, never
                # writing into buffers shared with the input
                kept_cumsum = np.concatenate(
                    ([0], np.cumsum(keep, dtype=np.int64)))
                out[out_name] = sp_mod.CsrVectorColumn(sp.csr_matrix(
                    (np.ones(int(kept_cumsum[-1])), m.indices[keep],
                     kept_cumsum[m.indptr]), shape=m.shape))
                continue
            if sp_mod.is_sparse_column(col):
                x = sp_mod.column_to_csr(col).toarray()
            elif columnar.is_device_array(col):
                x = col  # keep its rank: scalar columns stay 1-D
            elif col.dtype == object or col.ndim == 2:
                x = columnar.input_vectors(table, name, device)
            else:
                x = columnar.input_scalars(table, name, device)
            out[out_name] = columnar.apply(_binarize_kernel, x, (),
                                           (float(thr),), device)
        return (table.with_columns(**out),)


def _bucketize_kernel(x, splits):
    if x.dtype != splits.dtype:
        x = x.to(splits.dtype)
    n_splits = splits.shape[0]
    bucket = torch.searchsorted(splits, x.contiguous(), right=True) - 1
    # the top boundary belongs to the last bucket
    bucket = torch.where(x == splits[-1], n_splits - 2, bucket)
    invalid = (x < splits[0]) | (x > splits[-1]) | torch.isnan(x)
    bucket = torch.where(invalid, n_splits - 1, bucket)
    return bucket.to(torch.float32), invalid


class Bucketizer(Transformer, HasInputCols, HasOutputCols, HasHandleInvalid):
    """Map continuous scalars to bucket indices by split points
    (ref: feature/bucketizer/ — splitsArray is one strictly-increasing split
    array per input column; value in [splits[i], splits[i+1]) → bucket i.
    handleInvalid: keep → extra bucket numBuckets, skip → drop row,
    error → raise). The skip and error modes decide on the device; only
    whether any row is invalid comes to the host."""

    SPLITS_ARRAY = FloatArrayArrayParam(
        "splitsArray", "Array of split points for mapping continuous "
        "features into buckets.", None, ParamValidators.non_empty_array())

    def transform(self, table: Table) -> Tuple[Table]:
        splits_array = self.splits_array
        if splits_array is None or len(splits_array) != len(self.input_cols):
            raise ValueError("splitsArray must match inputCols length")
        device = self.device
        outs, invalids = {}, []
        for name, out_name, splits in zip(self.input_cols, self.output_cols,
                                          splits_array):
            splits = np.asarray(splits, np.float64)
            if len(splits) < 3 or not (np.diff(splits) > 0).all():
                raise ValueError(
                    f"splits for {name!r} must be strictly increasing with "
                    f"at least 3 points")
            if not (np.diff(splits.astype(np.float32)) > 0).all():
                raise ValueError(
                    f"splits for {name!r} collapse at float32 precision; "
                    "the device bucketize computes in float32 — widen the "
                    "split gaps")
            v = columnar.input_scalars(table, name, device)
            bucket, invalid = columnar.apply(_bucketize_kernel, v,
                                             (splits,), (), device)
            outs[out_name] = bucket
            invalids.append(invalid)
        if self.handle_invalid != self.KEEP_INVALID:
            invalid_any = columnar.joined(invalids[0])
            for inv in invalids[1:]:
                invalid_any = invalid_any | columnar.joined(inv)
            if bool(invalid_any.any()):
                if self.handle_invalid == self.ERROR_INVALID:
                    raise ValueError(
                        "invalid values encountered in Bucketizer "
                        "(handleInvalid=error)")
                keep = torch.nonzero(~invalid_any).flatten()
                kept = {k: columnar.take_rows(v, keep)
                        for k, v in outs.items()}
                return (table.take(keep).with_columns(**kept),)
        return (table.with_columns(**outs),)
