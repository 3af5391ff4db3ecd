"""Feature-label statistical tests as AlgoOperators.

The port of ``flink_ml_tpu/models/stats/tests.py`` (ref: flink-ml-lib
stats/{chisqtest/ChiSqTest.java, anovatest/ANOVATest.java,
fvaluetest/FValueTest.java}), all sharing (featuresCol, labelCol, flatten):
flatten=false emits a single row ("pValues" vector, "degreesOfFreedom",
"statistics"); flatten=true emits one row per feature ("featureIndex",
"pValue", "degreeOfFreedom", "statistic"). The numeric cores are
``ops/stats.py``: a host column is tested in float64 on the host, as the
JAX package tests every column; a tensor column on its device, a split
column per shard.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.api.stage import AlgoOperator
from flink_ml_tpu_torch.common.table import Table, as_dense_vector_column
from flink_ml_tpu_torch.ops import columnar
from flink_ml_tpu_torch.ops.stats import anova_f_test, chi_square_test, f_value_test
from flink_ml_tpu_torch.params.shared import HasFeaturesCol, HasFlatten, HasLabelCol


class _StatTestBase(AlgoOperator, HasFeaturesCol, HasLabelCol, HasFlatten):
    _test: Callable = None

    def transform(self, table: Table) -> Tuple[Table]:
        x, _ = columnar.fit_vectors(table, self.features_col)
        y = table.column(self.label_col)
        if not columnar.is_device_array(y):
            y = np.asarray(y)
        statistics, p_values, dofs = type(self)._test(x, y)
        if self.flatten:
            d = len(p_values)
            return (Table.from_columns(
                featureIndex=np.arange(d, dtype=np.int64),
                pValue=p_values.astype(np.float64),
                degreeOfFreedom=dofs.astype(np.int64),
                statistic=statistics.astype(np.float64)),)
        return (Table.from_columns(
            pValues=as_dense_vector_column(p_values[None, :]),
            degreesOfFreedom=[dofs.astype(np.int64)],
            statistics=as_dense_vector_column(statistics[None, :])),)


class ChiSqTest(_StatTestBase):
    """Pearson chi-squared independence test (ref: ChiSqTest.java:79)."""
    _test = staticmethod(chi_square_test)


class ANOVATest(_StatTestBase):
    """One-way ANOVA F-test (ref: ANOVATest.java)."""
    _test = staticmethod(anova_f_test)


class FValueTest(_StatTestBase):
    """Univariate regression F-test (ref: FValueTest.java)."""
    _test = staticmethod(f_value_test)
