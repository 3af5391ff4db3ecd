"""Stage persistence.

The port of ``flink_ml_tpu/utils/io.py``, with the same on-disk layout
(ref: ReadWriteUtils.java saveMetadata:89, loadStage:268, saveModelData:298,
loadModelData:317):

    <path>/metadata.json          {"className", "timestamp", "paramMap", "extra"}
    <path>/data/<name>.npz        numeric model arrays
    <path>/data/<name>.json       non-numeric model data
    <path>/stages/<i>/...         nested stages (Pipeline, Graph)

A model saved by the JAX package names a ``flink_ml_tpu.`` class; loading it
here resolves the class of the same path in ``flink_ml_tpu_torch`` instead,
so JAX-saved models load in the port without importing the JAX package.
"""

from __future__ import annotations

import importlib
import json
import os
import time
from typing import Any, Dict

import numpy as np

_JAX_PACKAGE = "flink_ml_tpu."
_PORT_PACKAGE = "flink_ml_tpu_torch."


def _class_path(obj_or_cls) -> str:
    cls = obj_or_cls if isinstance(obj_or_cls, type) else type(obj_or_cls)
    return f"{cls.__module__}.{cls.__qualname__}"


def port_class_path(path: str) -> str:
    """The port's class path for a saved ``className``: a JAX-package path
    maps onto the port's module of the same name; others stay as they are."""
    if path.startswith(_JAX_PACKAGE):
        return _PORT_PACKAGE + path[len(_JAX_PACKAGE):]
    return path


def load_class(path: str):
    path = port_class_path(path)
    module, _, name = path.rpartition(".")
    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError as e:
        raise ValueError(
            f"cannot load {path!r}: module {module!r} is not part of the "
            "port yet") from e
    obj = mod
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def save_metadata(stage, path: str, extra: Dict[str, Any] = None) -> None:
    """Ref: ReadWriteUtils.saveMetadata:89."""
    os.makedirs(path, exist_ok=True)
    meta = {
        "className": _class_path(stage),
        "timestamp": int(time.time() * 1000),
        "paramMap": stage.params_to_json(),
        "extra": extra or {},
    }
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)


def load_metadata(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "metadata.json")) as f:
        return json.load(f)


def load_stage(path: str, device=None):
    """Instantiate the saved class and restore params (ref: loadStage:268),
    through the class's own ``load``."""
    meta = load_metadata(path)
    cls = load_class(meta["className"])
    return cls.load(path, device=device)


def load_stage_params(path: str, device=None):
    """Instantiate + params only — helper for custom ``load`` overrides."""
    meta = load_metadata(path)
    cls = load_class(meta["className"])
    stage = cls(device=device)
    stage.params_from_json(meta["paramMap"])
    return stage, meta


def stage_path(path: str, index: int) -> str:
    """The directory of a pipeline's ``index``-th stage."""
    return os.path.join(path, "stages", str(index))


def save_model_arrays(path: str, name: str, arrays: Dict[str, np.ndarray]) -> None:
    """Numeric model data under <path>/data (ref: saveModelData:298)."""
    missing = [k for k, v in arrays.items() if v is None]
    if missing:
        # a None would silently pickle into an unloadable object array —
        # fail at save time with the real cause instead
        raise ValueError(
            f"model has no model data (missing: {', '.join(missing)}); "
            "fit it or set_model_data first")
    data_dir = os.path.join(path, "data")
    os.makedirs(data_dir, exist_ok=True)
    np.savez(os.path.join(data_dir, name + ".npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})


def load_model_arrays(path: str, name: str) -> Dict[str, np.ndarray]:
    with np.load(os.path.join(path, "data", name + ".npz"), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def save_model_json(path: str, name: str, data: Any) -> None:
    """Non-numeric model data under <path>/data (NaiveBayes's tables)."""
    data_dir = os.path.join(path, "data")
    os.makedirs(data_dir, exist_ok=True)
    with open(os.path.join(data_dir, name + ".json"), "w") as f:
        json.dump(data, f)


def load_model_json(path: str, name: str) -> Any:
    with open(os.path.join(path, "data", name + ".json")) as f:
        return json.load(f)
