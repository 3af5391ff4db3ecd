"""Graph / GraphBuilder / GraphModel.

The port of ``flink_ml_tpu/api/graph.py`` (ref: flink-ml-core/.../ml/builder/{GraphBuilder.java:39, Graph.java:54,
GraphModel.java:50, GraphNode.java, TableId.java, GraphData.java} and the
topological ready-queue executor (GraphExecutionHelper.java:36-60).

DAG generalization of Pipeline: stages are wired by symbolic ``TableId``
edges; ``build_estimator`` produces a Graph whose ``fit`` executes estimator
nodes topologically and returns a GraphModel of the fitted transform twins.
Model-data edges (set_model_data_on_estimator / get_model_data) are supported
the same way. Saved as the JAX package saves a graph (its node edges in
``metadata.json``, each stage in ``stages/<i>/``), so either package loads
the other's; ``load`` places every stage on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from flink_ml_tpu_torch.api.stage import AlgoOperator, Estimator, Model, Stage
from flink_ml_tpu_torch.common.table import Table
from flink_ml_tpu_torch.device import DeviceLike
from flink_ml_tpu_torch.utils import io as rw


@dataclasses.dataclass(frozen=True)
class TableId:
    """Symbolic table handle (ref: TableId.java:29)."""
    id: int

    def __repr__(self):
        return f"TableId({self.id})"


@dataclasses.dataclass
class GraphNode:
    """One stage + its symbolic edges (ref: GraphNode.java:33)."""
    stage: Stage
    estimator_inputs: Optional[Tuple[TableId, ...]]  # fit() args
    algoop_inputs: Tuple[TableId, ...]               # transform() args
    outputs: Tuple[TableId, ...]
    input_model_data: Optional[Tuple[TableId, ...]] = None
    output_model_data: Optional[Tuple[TableId, ...]] = None


class GraphBuilder:
    """Ref: GraphBuilder.java:39 (addEstimator:124, setModelDataOnEstimator:169,
    buildEstimator:286...)."""

    def __init__(self):
        self._next_id = 0
        self._nodes: List[GraphNode] = []
        self._model_data_on_estimator: Dict[int, Tuple[TableId, ...]] = {}

    def create_table_id(self) -> TableId:
        tid = TableId(self._next_id)
        self._next_id += 1
        return tid

    def _new_outputs(self, n: int) -> Tuple[TableId, ...]:
        return tuple(self.create_table_id() for _ in range(n))

    def add_estimator(self, estimator: Estimator,
                      inputs: Sequence[TableId],
                      fit_inputs: Sequence[TableId] = None,
                      num_outputs: int = 1) -> Tuple[TableId, ...]:
        """Add an Estimator node; returns the model's transform outputs.
        ``fit_inputs`` defaults to ``inputs`` (ref addEstimator overloads)."""
        outputs = self._new_outputs(num_outputs)
        self._nodes.append(GraphNode(
            stage=estimator,
            estimator_inputs=tuple(fit_inputs if fit_inputs is not None else inputs),
            algoop_inputs=tuple(inputs),
            outputs=outputs))
        return outputs

    def add_algo_operator(self, op: AlgoOperator, inputs: Sequence[TableId],
                          num_outputs: int = 1) -> Tuple[TableId, ...]:
        outputs = self._new_outputs(num_outputs)
        self._nodes.append(GraphNode(
            stage=op, estimator_inputs=None, algoop_inputs=tuple(inputs),
            outputs=outputs))
        return outputs

    add_stage = add_algo_operator

    def set_model_data_on_estimator(self, estimator: Estimator,
                                    *model_data: TableId) -> None:
        """Ref: setModelDataOnEstimator:169 — the fitted model will have its
        model data replaced by these tables at GraphModel execution time."""
        for node in self._nodes:
            if node.stage is estimator:
                node.input_model_data = tuple(model_data)
                return
        raise ValueError("estimator not found in graph")

    def set_model_data_on_model(self, model: Model, *model_data: TableId) -> None:
        for node in self._nodes:
            if node.stage is model:
                node.input_model_data = tuple(model_data)
                return
        raise ValueError("model not found in graph")

    def get_model_data(self, estimator_or_model: Stage,
                       num_tables: int = 1) -> Tuple[TableId, ...]:
        """Ref: getModelDataOnEstimator/Model — expose the fitted model's
        model-data tables as graph outputs."""
        for node in self._nodes:
            if node.stage is estimator_or_model:
                tids = self._new_outputs(num_tables)
                node.output_model_data = tids
                return tids
        raise ValueError("stage not found in graph")

    def build_estimator(self, inputs: Sequence[TableId],
                        outputs: Sequence[TableId]) -> "Graph":
        return Graph(list(self._nodes), tuple(inputs), tuple(outputs))

    def build_algo_operator(self, inputs: Sequence[TableId],
                            outputs: Sequence[TableId]) -> "GraphModel":
        return GraphModel(list(self._nodes), tuple(inputs), tuple(outputs))

    build_model = build_algo_operator


def _execute(nodes: List[GraphNode], env: Dict[TableId, Table],
             fit_mode: bool) -> List[Optional[AlgoOperator]]:
    """Topological ready-queue execution (ref: GraphExecutionHelper.java:36-60):
    run any node whose input tables are all constructed, until none remain."""
    fitted: List[Optional[AlgoOperator]] = [None] * len(nodes)
    remaining = set(range(len(nodes)))
    progress = True
    while remaining and progress:
        progress = False
        for i in sorted(remaining):
            node = nodes[i]
            needed = set(node.algoop_inputs)
            if fit_mode and node.estimator_inputs is not None:
                needed |= set(node.estimator_inputs)
            if node.input_model_data:
                needed |= set(node.input_model_data)
            if not needed.issubset(env):
                continue
            # ready: fit (if estimator & fit_mode) then transform
            stage = node.stage
            if fit_mode and isinstance(stage, Estimator):
                op = stage.fit(*[env[t] for t in node.estimator_inputs])
            else:
                op = stage  # already an AlgoOperator / fitted model
            if node.input_model_data:
                op.set_model_data(*[env[t] for t in node.input_model_data])
            out_tables = op.transform(*[env[t] for t in node.algoop_inputs])
            for tid, tbl in zip(node.outputs, out_tables):
                env[tid] = tbl
            if node.output_model_data:
                for tid, tbl in zip(node.output_model_data, op.get_model_data()):
                    env[tid] = tbl
            fitted[i] = op
            remaining.discard(i)
            progress = True
    if remaining:
        raise ValueError(f"graph has unsatisfiable dependencies at nodes {sorted(remaining)}")
    return fitted


class Graph(Estimator):
    """An Estimator over a DAG of stages (ref: Graph.java:54)."""

    def __init__(self, nodes: List[GraphNode] = None,
                 inputs: Tuple[TableId, ...] = (),
                 outputs: Tuple[TableId, ...] = (), **kwargs):
        super().__init__(**kwargs)
        self.nodes = nodes or []
        self.inputs = tuple(inputs)
        self.outputs = tuple(outputs)

    def fit(self, *input_tables: Table) -> "GraphModel":
        env: Dict[TableId, Table] = dict(zip(self.inputs, input_tables))
        fitted = _execute(self.nodes, env, fit_mode=True)
        model_nodes = [
            GraphNode(stage=op, estimator_inputs=None,
                      algoop_inputs=n.algoop_inputs, outputs=n.outputs,
                      input_model_data=n.input_model_data,
                      output_model_data=n.output_model_data)
            for n, op in zip(self.nodes, fitted)]
        return GraphModel(model_nodes, self.inputs, self.outputs,
                          device=self._device)

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        _save_graph(self, path)

    @classmethod
    def load(cls, path: str, device: DeviceLike = None) -> "Graph":
        nodes, inputs, outputs, meta = _load_graph(path, device)
        graph = cls(nodes, inputs, outputs, device=device)
        graph.params_from_json(meta["paramMap"])
        return graph


class GraphModel(Model):
    """A Model over a DAG of fitted stages (ref: GraphModel.java:50)."""

    def __init__(self, nodes: List[GraphNode] = None,
                 inputs: Tuple[TableId, ...] = (),
                 outputs: Tuple[TableId, ...] = (), **kwargs):
        super().__init__(**kwargs)
        self.nodes = nodes or []
        self.inputs = tuple(inputs)
        self.outputs = tuple(outputs)

    def transform(self, *input_tables: Table) -> Tuple[Table, ...]:
        env: Dict[TableId, Table] = dict(zip(self.inputs, input_tables))
        _execute(self.nodes, env, fit_mode=False)
        return tuple(env[t] for t in self.outputs)

    def save(self, path: str) -> None:
        _save_graph(self, path)

    @classmethod
    def load(cls, path: str, device: DeviceLike = None) -> "GraphModel":
        nodes, inputs, outputs, meta = _load_graph(path, device)
        model = cls(nodes, inputs, outputs, device=device)
        model.params_from_json(meta["paramMap"])
        return model


def _save_graph(graph, path: str) -> None:
    def tids(x):
        return None if x is None else [t.id for t in x]
    node_meta = [{
        "estimatorInputs": tids(n.estimator_inputs),
        "algoOpInputs": tids(n.algoop_inputs),
        "outputs": tids(n.outputs),
        "inputModelData": tids(n.input_model_data),
        "outputModelData": tids(n.output_model_data),
    } for n in graph.nodes]
    rw.save_metadata(graph, path, extra={
        "numStages": len(graph.nodes),
        "nodes": node_meta,
        "inputs": tids(graph.inputs),
        "outputs": tids(graph.outputs),
    })
    for i, node in enumerate(graph.nodes):
        node.stage.save(rw.stage_path(path, i))


def _load_graph(path: str, device: DeviceLike = None):
    meta = rw.load_metadata(path)
    extra = meta["extra"]

    def ids(x):
        return None if x is None else tuple(TableId(i) for i in x)
    nodes = []
    for i, nm in enumerate(extra["nodes"]):
        stage = rw.load_stage(rw.stage_path(path, i), device=device)
        nodes.append(GraphNode(
            stage=stage,
            estimator_inputs=ids(nm["estimatorInputs"]),
            algoop_inputs=ids(nm["algoOpInputs"]) or (),
            outputs=ids(nm["outputs"]) or (),
            input_model_data=ids(nm["inputModelData"]),
            output_model_data=ids(nm["outputModelData"])))
    return nodes, ids(extra["inputs"]), ids(extra["outputs"]), meta
