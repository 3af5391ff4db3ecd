"""Agglomerative (hierarchical) clustering.

The port of ``flink_ml_tpu/models/clustering/agglomerative.py`` (ref:
flink-ml-lib clustering/agglomerativeclustering/AgglomerativeClustering.java):
local hierarchical clustering with ward, complete, single or average linkage;
outputs the clustered rows and the merge table (the dendrogram). A host
algorithm in both packages: ``scipy.cluster.hierarchy``'s C implementation
on float64 rows (the reference is a pure-Java nested loop), so both packages
give the same labels and merge table. The labels are a host int64 column.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy.cluster import hierarchy

from flink_ml_tpu_torch.api.stage import AlgoOperator
from flink_ml_tpu_torch.common.table import Table
from flink_ml_tpu_torch.params.param import (
    BooleanParam,
    FloatParam,
    IntParam,
    ParamValidators,
    StringParam,
)
from flink_ml_tpu_torch.params.shared import (
    HasDistanceMeasure,
    HasFeaturesCol,
    HasPredictionCol,
    HasWindows,
)


class AgglomerativeClustering(AlgoOperator, HasDistanceMeasure,
                              HasFeaturesCol, HasPredictionCol, HasWindows):
    LINKAGE_WARD = "ward"
    LINKAGE_COMPLETE = "complete"
    LINKAGE_SINGLE = "single"
    LINKAGE_AVERAGE = "average"

    NUM_CLUSTERS = IntParam("numClusters", "The max number of clusters to "
                            "create.", 2)
    DISTANCE_THRESHOLD = FloatParam(
        "distanceThreshold", "Threshold to decide whether two clusters "
        "should be merged.", None)
    LINKAGE = StringParam(
        "linkage", "Criterion for computing distance between two clusters.",
        LINKAGE_WARD,
        ParamValidators.in_array(LINKAGE_WARD, LINKAGE_COMPLETE,
                                 LINKAGE_AVERAGE, LINKAGE_SINGLE))
    COMPUTE_FULL_TREE = BooleanParam(
        "computeFullTree", "Whether computes the full tree after "
        "convergence.", False)

    def transform(self, table: Table) -> Tuple[Table, Table]:
        if (self.num_clusters is None) == (self.distance_threshold is None):
            raise ValueError(
                "exactly one of numClusters and distanceThreshold must be set")
        x = table.vectors(self.features_col, np.float64)
        if isinstance(x, torch.Tensor):  # a float64 tensor column
            x = x.cpu().numpy()
        metric = {"euclidean": "euclidean", "manhattan": "cityblock",
                  "cosine": "cosine"}[self.distance_measure]
        if self.linkage == self.LINKAGE_WARD and metric != "euclidean":
            raise ValueError("ward linkage requires euclidean distance")
        if x.shape[0] < 2:
            labels = np.zeros(x.shape[0], np.int64)
            merges = Table.from_columns(
                clusterId1=np.asarray([], np.float64),
                clusterId2=np.asarray([], np.float64),
                distance=np.asarray([], np.float64),
                sizeOfMergedCluster=np.asarray([], np.float64))
            return (table.with_column(self.prediction_col, labels), merges)

        z = hierarchy.linkage(x, method=self.linkage, metric=metric)
        if self.num_clusters is not None:
            labels = hierarchy.fcluster(z, t=self.num_clusters,
                                        criterion="maxclust") - 1
        else:
            labels = hierarchy.fcluster(z, t=self.distance_threshold,
                                        criterion="distance") - 1
        out = table.with_column(self.prediction_col,
                                labels.astype(np.int64))
        # merge-info output (ref: the side output of cluster merges)
        merges = Table.from_columns(
            clusterId1=z[:, 0], clusterId2=z[:, 1], distance=z[:, 2],
            sizeOfMergedCluster=z[:, 3])
        return (out, merges)
