"""Stage / AlgoOperator / Transformer / Model / Estimator.

The port of ``flink_ml_tpu/api/stage.py`` (ref: flink-ml-core/.../ml/api/):

    Stage (savable, has params, runs on one device)
      └─ AlgoOperator.transform(*tables) -> (table, ...)
           └─ Transformer (one-in-one-out semantics)
                └─ Model (.set_model_data / .get_model_data)
      └─ Estimator.fit(*tables) -> Model

Every stage takes ``device=`` (see ``flink_ml_tpu_torch.device``): ``None``
runs on the CUDA card. An estimator also takes ``mesh=``, the data shards
its fit splits the rows over (``parallel/mesh.py``; a runtime setting like
the device, not a param, not saved); ``None`` is the default mesh, one shard
on the stage's device unless
:func:`~flink_ml_tpu_torch.parallel.set_default_mesh` or
``init_distributed`` set another. Every concrete ``fit`` and ``transform``
runs inside :func:`_profiled`, the JAX package's observability wrapper.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Tuple

import torch

from flink_ml_tpu_torch.common import locks
from flink_ml_tpu_torch.common.metrics import PROFILE_DIR_ENV, profile
from flink_ml_tpu_torch.common.table import Table
from flink_ml_tpu_torch.device import DeviceLike, resolve_device
from flink_ml_tpu_torch.observability import (compilestats, profiling, server,
                                              tracing)
from flink_ml_tpu_torch.params.param import WithParams
from flink_ml_tpu_torch.utils import io as rw


def _profiled(method, kind: str):
    """Wrap a fit/transform implementation with the observability hooks of
    the JAX package (``flink_ml_tpu/api/stage.py`` ``_profiled``). Two
    independent, composing arms — ``FLINK_ML_TPU_PROFILE_DIR`` records a
    ``torch.profiler`` trace of the call (common/metrics.py ``profile``),
    ``FLINK_ML_TPU_TRACE_DIR`` opens a tracer span (host-side structure:
    fit→segment/epoch→checkpoint nesting). Two env checks of overhead when
    both are off. Traces nest safely: a stage called inside another
    stage's call records a child span and a wall-time gauge only.

    A traced call also arms build accounting (compilestats.install), the
    one-shot device profile of ``FLINK_ML_TPU_PROFILE_CAPTURE=1``
    (profiling.maybe_profile_fit), and a device-memory watermark sampled
    as the ROOT span closes (a no-op while CUDA is uninitialised); the
    outermost call snapshots the registry into the trace dir. Every call
    first starts the env-armed live metrics endpoint
    (``server.maybe_start()``, ``FLINK_ML_TPU_METRICS_PORT``; one dict
    lookup when unarmed). The JAX package's recompile-storm window has no
    counterpart (nothing is traced per shape)."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        # arming the endpoint flips tracer.active, so spans reach the
        # /spans/recent ring even without a trace dir
        server.maybe_start()
        trace_dir = os.environ.get(PROFILE_DIR_ENV)
        tracer = tracing.tracer
        if not trace_dir and not tracer.active:
            return method(self, *args, **kwargs)
        region = f"{type(self).__name__}.{kind}"
        # a telemetry-armed run is exactly the run whose daemon threads
        # must not die silently
        locks.install_thread_excepthook()
        try:
            with contextlib.ExitStack() as stack:
                sp = None
                if tracer.active:
                    if tracer.enabled:
                        compilestats.install()
                    sp = stack.enter_context(tracer.span(
                        region, kind=kind, stage=type(self).__name__))
                    if tracer.enabled:
                        stack.enter_context(
                            profiling.maybe_profile_fit(region))
                if trace_dir:
                    stack.enter_context(profile(
                        os.path.join(trace_dir, region), name=region))
                result = method(self, *args, **kwargs)
                if sp is not None and sp.parent_id is None:
                    compilestats.sample_memory(f"root:{kind}", span=sp)
                return result
        finally:
            # an outermost stage closing its root span snapshots the
            # registry beside the spans
            tracing.maybe_dump_root_metrics()

    wrapper._profiled = True
    return wrapper


class Stage(WithParams):
    """A node with params that can be saved/loaded (ref: api/Stage.java)."""

    def __init__(self, device: DeviceLike = None, **kwargs):
        super().__init__(**kwargs)
        self._device = device

    @property
    def device(self) -> torch.device:
        """The device this stage computes on, resolved at each call."""
        return resolve_device(self._device)

    def save(self, path: str) -> None:
        rw.save_metadata(self, path)
        self._save_extra(path)

    @classmethod
    def load(cls, path: str, device: DeviceLike = None):
        stage, meta = rw.load_stage_params(path, device=device)
        if not isinstance(stage, cls):
            raise TypeError(f"saved stage {type(stage).__name__} is not a {cls.__name__}")
        stage._load_extra(path, meta)
        return stage

    # hooks for subclasses with model data / nested stages
    def _save_extra(self, path: str) -> None:
        pass

    def _load_extra(self, path: str, meta: dict) -> None:
        pass


class AlgoOperator(Stage):
    """A Stage computing output tables from input tables (ref: AlgoOperator.java)."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        impl = cls.__dict__.get("transform")
        if impl is not None and not getattr(impl, "_profiled", False):
            cls.transform = _profiled(impl, "transform")

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        raise NotImplementedError


class Transformer(AlgoOperator):
    """Marker for record-wise transforms (ref: Transformer.java)."""


class Model(Transformer):
    """A Transformer with model data (ref: Model.java)."""

    def set_model_data(self, *model_data: Table):
        raise NotImplementedError(f"{type(self).__name__} has no model data")

    def get_model_data(self) -> Tuple[Table, ...]:
        raise NotImplementedError(f"{type(self).__name__} has no model data")


class Estimator(Stage):
    """fit(*tables) -> Model (ref: Estimator.java)."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        impl = cls.__dict__.get("fit")
        if impl is not None and not getattr(impl, "_profiled", False):
            cls.fit = _profiled(impl, "fit")

    def __init__(self, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self._mesh = mesh

    @property
    def mesh(self):
        """The mesh this estimator fits on, resolved at each call
        (``parallel.mesh.resolve_mesh``)."""
        from flink_ml_tpu_torch.parallel.mesh import resolve_mesh

        return resolve_mesh(self._mesh, self._device)

    def fit(self, *inputs: Table) -> Model:
        raise NotImplementedError
