"""Swing item-item recommendation.

The port of ``flink_ml_tpu/models/recommendation/swing.py`` (ref:
flink-ml-lib recommendation/swing/Swing.java:60): item similarity from
(Long user, Long item) purchase pairs,

    w(i,j) = Σ_{u,v ∈ U_i∩U_j} 1/(α₁+|I_u|)^β · 1/(α₁+|I_v|)^β · 1/(α₂+|I_u∩I_v|)

Users outside [minUserBehavior, maxUserBehavior] purchases are dropped; per
item at most maxUserNumPerItem users are considered; the output rows are
(itemCol, outputCol) with outputCol the top-k "item,score" pairs joined by
';' (ComputingSimilarItems).

A host algorithm (set intersections over ragged id lists): the groupings
are dicts, the scoring is the native C++ kernel (``native.swing_similarity``,
``csrc/host/swing_kernel.cpp``), the only path. Kernel or raise: without a
``g++`` the transform raises ``KernelBuildError``. ``_score_python`` is the
kernel's test oracle.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from flink_ml_tpu_torch import native
from flink_ml_tpu_torch.api.stage import AlgoOperator
from flink_ml_tpu_torch.common.table import Table
from flink_ml_tpu_torch.params.param import (
    FloatParam,
    IntParam,
    ParamValidators,
    StringParam,
)
from flink_ml_tpu_torch.params.shared import HasOutputCol


class Swing(AlgoOperator, HasOutputCol):
    USER_COL = StringParam("userCol", "User column name.", "user",
                           ParamValidators.not_null())
    ITEM_COL = StringParam("itemCol", "Item column name.", "item",
                           ParamValidators.not_null())
    MAX_USER_NUM_PER_ITEM = IntParam(
        "maxUserNumPerItem",
        "The max number of users(purchasers) for each item.", 1000,
        ParamValidators.gt(0))
    K = IntParam("k", "The max number of similar items to output for each "
                 "item.", 100, ParamValidators.gt(0))
    MIN_USER_BEHAVIOR = IntParam(
        "minUserBehavior", "The min number of items that a user purchases.",
        10, ParamValidators.gt(0))
    MAX_USER_BEHAVIOR = IntParam(
        "maxUserBehavior", "The max number of items that a user purchases.",
        1000, ParamValidators.gt(0))
    ALPHA1 = IntParam("alpha1", "Smooth factor for number of users that "
                      "have purchased one item.", 15,
                      ParamValidators.gt_eq(0))
    ALPHA2 = IntParam("alpha2", "Smooth factor for number of users that "
                      "have purchased the two target items.", 0,
                      ParamValidators.gt_eq(0))
    BETA = FloatParam("beta", "Decay factor for number of users that have "
                      "purchased one item.", 0.3, ParamValidators.gt_eq(0))

    def transform(self, table: Table) -> Tuple[Table]:
        if self.max_user_behavior < self.min_user_behavior:
            raise ValueError(
                f"The maxUserBehavior must be greater than or equal to "
                f"minUserBehavior. The current setting: maxUserBehavior="
                f"{self.max_user_behavior}, minUserBehavior="
                f"{self.min_user_behavior}.")
        users = table.scalars(self.user_col, np.int64)
        items = table.scalars(self.item_col, np.int64)

        groups = self._groupings(users, items)
        ranked = self._score_native(*groups, self.alpha2)

        out_items, out_recs = [], []
        for item, top in ranked:
            if not top:
                continue
            out_items.append(item)
            out_recs.append(";".join(f"{j},{s}" for j, s in top))
        return (Table.from_columns(**{
            self.item_col: np.asarray(out_items, np.int64),
            self.output_col: np.asarray(out_recs, dtype=object)}),)

    def _groupings(self, users: np.ndarray, items: np.ndarray):
        """(user → sorted distinct items, kept within the behavior bounds;
        item → its purchasers in insertion order, capped at
        maxUserNumPerItem; user → 1/(alpha1 + |items|)^beta), the inputs
        of both scorers."""
        user_items: dict = {}
        for u, i in zip(users.tolist(), items.tolist()):
            user_items.setdefault(u, set()).add(i)
        user_items = {u: np.asarray(sorted(s), np.int64)
                      for u, s in user_items.items()
                      if self.min_user_behavior <= len(s)
                      <= self.max_user_behavior}
        item_users: dict = {}
        for u in user_items:
            for i in user_items[u].tolist():
                lst = item_users.setdefault(i, [])
                if len(lst) < self.max_user_num_per_item:
                    lst.append(u)
        weights = {u: 1.0 / (self.alpha1 + len(s)) ** self.beta
                   for u, s in user_items.items()}
        return user_items, item_users, weights

    # -- scoring backends ----------------------------------------------------
    def _score_python(self, user_items, item_users, weights, alpha2):
        """The native kernel's test oracle in pure Python (never a
        fallback): the same pairs in the same order, so the same sums."""
        ranked = []
        for item, purchasers in item_users.items():
            scores: dict = {}
            for a in range(len(purchasers)):
                for b in range(a + 1, len(purchasers)):
                    u, v = purchasers[a], purchasers[b]
                    inter = np.intersect1d(user_items[u], user_items[v],
                                           assume_unique=True)
                    if len(inter) == 0:
                        continue
                    sim = weights[u] * weights[v] / (alpha2 + len(inter))
                    for j in inter.tolist():
                        if j != item:
                            scores[j] = scores.get(j, 0.0) + sim
            top = sorted(scores.items(),
                         key=lambda t: (-t[1], t[0]))[: self.k]
            ranked.append((item, top))
        return ranked

    def _score_native(self, user_items, item_users, weights, alpha2):
        """CSR-pack the groupings and run the C++ kernel
        (``csrc/host/swing_kernel.cpp``)."""
        users = list(user_items)
        user_index = {u: i for i, u in enumerate(users)}
        u_offsets = np.zeros(len(users) + 1, np.int64)
        for i, u in enumerate(users):
            u_offsets[i + 1] = u_offsets[i] + len(user_items[u])
        u_flat = (np.concatenate([user_items[u] for u in users])
                  if users else np.zeros(0, np.int64))
        w = np.asarray([weights[u] for u in users], np.float64)

        items = list(item_users)
        i_offsets = np.zeros(len(items) + 1, np.int64)
        for i, it in enumerate(items):
            i_offsets[i + 1] = i_offsets[i] + len(item_users[it])
        i_flat = (np.asarray([user_index[u] for it in items
                              for u in item_users[it]], np.int64)
                  if items else np.zeros(0, np.int64))

        out_items, out_scores, out_counts = native.swing_similarity(
            u_flat, u_offsets, w, i_flat, i_offsets,
            np.asarray(items, np.int64), float(alpha2), int(self.k))
        ranked = []
        for i, item in enumerate(items):
            n = int(out_counts[i])
            ranked.append((item, [(int(out_items[i, r]),
                                   float(out_scores[i, r]))
                                  for r in range(n)]))
        return ranked
