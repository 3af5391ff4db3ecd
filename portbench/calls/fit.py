"""A call that fits the cell's stage on the table made in set-up and reads
its model data back to the host; the reference's ``judge`` holds the
answers against its own rounds."""

from __future__ import annotations

import importlib

import numpy as np
import torch

from portbench.harness.trace import SPAN_PREFIX


def make(cell, inputs: dict, params: dict):
    """``call(**changed)``: the stage fitted on a table of ``inputs`` with
    ``params`` (some changed) → its model data as the reference reads it
    (the configuration's ``answer`` columns, float64 on the host), inside
    the harness's spans."""
    table_cls = importlib.import_module(
        "flink_ml_tpu_torch.common.table").Table
    stage = cell.config["stage"]
    stage_cls = getattr(importlib.import_module(stage["module"]),
                        stage["class"])
    table = table_cls.from_columns(**inputs)
    columns = cell.config["answer"]

    def call(**changed):
        est = stage_cls(device=cell.device)
        est.params_from_json({**params, **changed}, strict=True)
        with torch.profiler.record_function(SPAN_PREFIX + "fit"):
            model = est.fit(table)
        with torch.profiler.record_function(SPAN_PREFIX + "model_data"):
            data = model.get_model_data()[0]
            out = {}
            for name, kind in columns.items():
                if kind == "vectors":
                    out[name] = np.asarray(data.vectors(name,
                                                        dtype=np.float64))
                elif kind == "scalars":
                    out[name] = data.scalars(name, np.float64)
                else:
                    raise ValueError(f"unknown answer kind {kind!r}")
            return out

    return call


def judge(cell, run):
    """The reference's numbers for the run's answers → (numbers, failed)."""
    return cell.reference.judge(run)


def cost(cell, inputs: dict, params: dict):
    """``(bytes, operations)`` of one fit (``cost/<algorithm>.py``)."""
    first = next(iter(inputs.values()))
    return cell.cost.fit_cost(params, first.shape[0], first.shape[1])
