"""Feature↔label statistical tests.

The port of ``flink_ml_tpu/ops/stats.py`` (ref: the numeric cores of
flink-ml-lib stats/{chisqtest,anovatest,fvaluetest} and the univariate
feature selector). Each function takes features (n, d) and labels (n,) and
returns (statistics (d,), p_values (d,), degrees_of_freedom (d,)) as numpy
arrays.

Host arrays take the JAX package's float64 scipy path. A feature tensor
reduces on its own device, as the JAX package's device arrays do (ANOVA
and F-value in two float32 passes); the chi-squared contingency tables are
counted there too (the JAX package counts them on the host). Only (c, d)
or (d,)-sized statistics cross to the host, where the F, χ² and p math
runs in float64. A label tensor stays on its device. A feature column
split over a mesh's shards (``ops/columnar.py``) reduces per shard, the
shards' partials added by ``collective.all_reduce_sum`` (ANOVA and
F-value; the labels are split alike on the way); the chi-squared tables
are counted over the joined column.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy import stats as sstats

from flink_ml_tpu_torch.ops import columnar

Arrays = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _is_device(x) -> bool:
    return columnar.is_device_array(x)


def _labels_on(labels, device: torch.device) -> torch.Tensor:
    if columnar.is_device_array(labels):
        return columnar.joined(labels).to(device)
    return torch.as_tensor(np.asarray(labels), device=device)


def _chi2_contingency(table: np.ndarray):
    chi2, p, dof, _ = sstats.chi2_contingency(table, correction=False)
    return chi2, p, dof


def chi_square_test(features, labels) -> Arrays:
    """Pearson chi-squared independence test per feature column
    (ref: stats/chisqtest/ChiSqTest.java — categorical feature vs
    categorical label). A feature tensor counts each column's (value,
    label) contingency table on its device; only the table comes to the
    host."""
    stats_, ps, dofs = [], [], []
    if _is_device(features):
        features = columnar.joined(features)
        y = _labels_on(labels, features.device)
        l_vals, l_idx = torch.unique(y, return_inverse=True)
        n_l = int(l_vals.shape[0])
        for j in range(features.shape[1]):
            f_vals, f_idx = torch.unique(features[:, j], return_inverse=True)
            n_f = int(f_vals.shape[0])
            counts = torch.bincount(f_idx * n_l + l_idx,
                                    minlength=n_f * n_l)
            table = counts.cpu().numpy().astype(np.float64).reshape(n_f, n_l)
            chi2, p, dof = _chi2_contingency(table)
            stats_.append(chi2)
            ps.append(p)
            dofs.append(dof)
        return np.asarray(stats_), np.asarray(ps), np.asarray(dofs, np.int64)
    features = np.asarray(features)
    labels = np.asarray(labels)
    for j in range(features.shape[1]):
        col = features[:, j]
        f_vals, f_idx = np.unique(col, return_inverse=True)
        l_vals, l_idx = np.unique(labels, return_inverse=True)
        table = np.zeros((len(f_vals), len(l_vals)))
        np.add.at(table, (f_idx, l_idx), 1.0)
        chi2, p, dof = _chi2_contingency(table)
        stats_.append(chi2)
        ps.append(p)
        dofs.append(dof)
    return np.asarray(stats_), np.asarray(ps), np.asarray(dofs, np.int64)


def _reduced(kernel, x, y, consts=(), static=()):
    """``kernel(x, y, *consts, *static)`` over a tensor, or its per-shard
    partials over a split ``x`` (``y`` split alike) added across the
    shards."""
    if not columnar.is_sharded(x):
        return kernel(x, y, *consts, *static)
    return columnar.sum_over_shards(
        kernel, [x, columnar.to_device(y, x.mesh)], consts, static)


def _group_sums_kernel(x, y, c):
    """(c, d+1): per class [count | feature sums], one one-hot product."""
    oh = torch.nn.functional.one_hot(y, c).to(x.dtype)  # (n, c)
    return torch.cat([oh.sum(dim=0)[:, None], oh.T @ x], dim=1)


def _group_ssw_kernel(x, y, means):
    centered = x - means[y]
    return (centered * centered).sum(dim=0)


def anova_f_test(features, labels) -> Arrays:
    """One-way ANOVA F-test per feature (ref: stats/anovatest/ANOVATest.java
    — continuous feature vs categorical label).

    A feature tensor reduces on its device in two passes: class counts and
    sums, then the centered within-class sum of squares against the class
    means; only the (c, d) statistics cross to the host, where the F and p
    math runs in float64."""
    if _is_device(features):
        n, d = features.shape
        y = _labels_on(labels, features.device)
        classes, y_idx = torch.unique(y, return_inverse=True)
        c = int(classes.shape[0])
        packed = _reduced(_group_sums_kernel, features, y_idx, (), (c,)) \
            .cpu().numpy().astype(np.float64)
        counts, sums = packed[:, 0], packed[:, 1:]
        means = sums / np.maximum(counts[:, None], 1.0)
        ssw = _reduced(_group_ssw_kernel, features, y_idx, (
            torch.as_tensor(means, dtype=features.dtype,
                            device=features.device),)
        ).cpu().numpy().astype(np.float64)
        grand = sums.sum(axis=0) / n
        ssb = (counts[:, None] * (means - grand[None, :]) ** 2).sum(axis=0)
        dfb, dfw = c - 1, n - c
        # IEEE semantics mirror scipy.f_oneway: ssw = 0 with signal → F =
        # inf (p = 0); 0/0 (a constant feature) → NaN, as on the host path
        with np.errstate(divide="ignore", invalid="ignore"):
            f = (ssb / dfb) / (ssw / dfw)
        p = sstats.f.sf(f, dfb, dfw)
        return f, p, np.full(d, dfw, np.int64)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    features = np.asarray(features, np.float64)
    stats_, ps, dofs = [], [], []
    n = features.shape[0]
    for j in range(features.shape[1]):
        groups = [features[labels == cl, j] for cl in classes]
        f, p = sstats.f_oneway(*groups)
        stats_.append(f)
        ps.append(p)
        dofs.append(n - len(classes))
    return np.asarray(stats_), np.asarray(ps), np.asarray(dofs, np.int64)


def _sums_kernel(x, y):
    return torch.cat([x.sum(dim=0), y.sum()[None]])


def _centered_products_kernel(x, y, xmean, ymean):
    xc = x - xmean[None, :]
    yc = y - ymean
    return torch.stack([(xc * yc[:, None]).sum(dim=0),
                        (xc * xc).sum(dim=0),
                        (yc * yc).sum().expand(x.shape[1])])


def _f_from_corr(sxy, sxx, syy, dof) -> np.ndarray:
    denom = np.sqrt(sxx * syy)
    corr = np.where(denom > 0, sxy / np.where(denom > 0, denom, 1.0), 0.0)
    corr = np.clip(corr, -1.0, 1.0)
    return np.where(corr ** 2 < 1.0,
                    corr ** 2 / np.maximum(1.0 - corr ** 2, 1e-300) * dof,
                    np.inf)


def f_value_test(features, labels) -> Arrays:
    """Univariate linear-regression F-test per feature
    (ref: stats/fvaluetest/FValueTest.java — continuous vs continuous).

    A feature tensor reduces on its device in two float32 passes; the
    (d,)-sized correlation → F → p tail runs in float64 on the host."""
    if _is_device(features):
        n, d = features.shape
        y = _labels_on(labels, features.device).to(features.dtype)
        sums = _reduced(_sums_kernel, features, y).cpu().numpy().astype(
            np.float64)
        xmean, ymean = sums[:-1] / n, sums[-1] / n
        packed = _reduced(_centered_products_kernel, features, y, (
            torch.as_tensor(xmean, dtype=features.dtype,
                            device=features.device),
            torch.as_tensor(ymean, dtype=features.dtype,
                            device=features.device)),
        ).cpu().numpy().astype(np.float64)
        sxy, sxx, syy = packed[0], packed[1], packed[2][0]
        dof = n - 2
        f = _f_from_corr(sxy, sxx, syy, dof)
        p = sstats.f.sf(f, 1, dof)
        return f, p, np.full(d, dof, np.int64)
    x = np.asarray(features, np.float64)
    y = np.asarray(labels, np.float64)
    n, d = x.shape
    dof = n - 2
    xc = x - x.mean(axis=0)
    yc = y - y.mean()
    f = _f_from_corr((xc * yc[:, None]).sum(axis=0), (xc * xc).sum(axis=0),
                     (yc * yc).sum(), dof)
    p = sstats.f.sf(f, 1, dof)
    return f, p, np.full(d, dof, np.int64)
