"""The port's public surface against the JAX package's, as an AST check of
both trees, and the behaviour of the names that closed the gap.

Every name a JAX subpackage's ``__init__`` exports (its imports, its own
definitions and its star imports expanded), and every public top-level
name and every public method of a public class of each JAX module, has a
counterpart of the same name in the port's module of the same path (its
definitions, imports, ``__all__`` or a lazily loaded name), or an entry in
:data:`ALLOWED` with the reason it has none: each of those exists only for
``jax.jit``/XLA or for a JAX-only backend, or has a twin by another name.
The exports are also resolved on the imported port package.

Behaviour against the JAX package: ``DenseVectorArrayGenerator`` (the same
seed gives the same values), ``DistanceMeasure.distance`` and
``find_closest`` (rtol 1e-6: float64 in the port, float32 in JAX),
``shard_batch`` and ``replicate`` on 8 shards (values and ``n``; the port
does not pad), ``MapReduceProgram.replicate``/``data_spec``,
``profiling.provenance`` on trace dirs, ``native.available``,
``local_device_count`` (it raises without a card) and the helpers of
``models/common.py``.
"""

import ast
import importlib
import json
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "flink_ml_tpu")
PORT_ROOT = os.path.join(REPO, "flink_ml_tpu_torch")

_JIT = "exists only for jax.jit/XLA"
#: "module path:name" → why the port has no counterpart of that name
ALLOWED = {
    "ops/pallas_kernels.py:*": "the Pallas kernels' twins are CUDA C++ "
                               "under csrc/, bound in ops/kernels.py",
    "observability/__init__.py:aot_compile": _JIT + " (ahead-of-time "
                                             "lowering of a jitted fn)",
    "observability/__init__.py:instrumented_jit": _JIT,
    "observability/compilestats.py:aot_compile": _JIT,
    "observability/compilestats.py:instrumented_jit": _JIT,
    "observability/compilestats.py:abstract_signature": _JIT + " (the "
                                                        "jit cache key)",
    "observability/compilestats.py:fit_window": _JIT + " (the recompile "
                                                "window of a fit)",
    "observability/compilestats.py:storm_threshold": _JIT + " (the "
                                                     "recompile storm)",
    "observability/compilestats.py:STORM_ENV": _JIT,
    "observability/compilestats.py:DEFAULT_STORM_THRESHOLD": _JIT,
    "observability/compilestats.py:CompileStats.fit_window": _JIT,
    "observability/compilestats.py:CompileStats.note_compile": _JIT + " ("
        "the port counts nvcc builds in ml.compile instead)",
    "observability/compilestats.py:CompileStats.reset": _JIT,
    "parallel/collective.py:row_major_format": "pins an XLA device layout; "
                                               "torch tensors are row-major",
    "parallel/collective.py:local_valid_mask": "the padding mask inside a "
        "JAX shard_map; the port's is mapreduce.local_valid_mask",
    "parallel/mesh.py:reset_backend_fallback": "undoes the JAX CPU "
        "fallback; the port has none (kernel or raise)",
    "iteration/iteration.py:segment_fusion_enabled": "the JAX unfused "
        "segment path is a listed deviation (fused boundaries only)",
    "native/__init__.py:make_lock": "the JAX module's import for its build "
        "lock; the port's build is guarded by functools.lru_cache",
    "analysis/rules/tracing.py:TracerLeakRule": "JL101 tracer-leak is "
        "TL101 CaptureLeakRule",
    "analysis/rules/tracing.py:TracerLeakRule.check": "the check of "
        "TracerLeakRule, replaced with its rule",
    "analysis/rules/metrics_in_jit.py:MetricInJitRule": "JL107 "
        "metric-in-jit is TL107 MetricInCaptureRule",
    "analysis/rules/metrics_in_jit.py:MetricInJitRule.check": "the check "
        "of MetricInJitRule, replaced with its rule",
    "analysis/rules/recompile.py:RecompileHazardRule": "JL102 "
        "recompile-hazard is TL102 RebuildHazardRule",
    "analysis/rules/recompile.py:RecompileHazardRule.check": "the check "
        "of RecompileHazardRule, replaced with its rule",
    "analysis/rules/rng.py:RngReuseRule": "JL103 rng-reuse (jax.random "
        "keys) is TL103 ImplicitRngRule",
    "analysis/rules/rng.py:RngReuseRule.check": "the check of "
        "RngReuseRule, replaced with its rule",
    "analysis/rules/_shared.py:JIT_NAMES": _JIT + " (the jit wrappers the "
        "rules look for; the port's are FUNCTION_CAPTURES)",
    "analysis/rules/_shared.py:COMPOSE_NAMES": _JIT + " (MapReduceProgram"
        ".build as a jit wrapper)",
    "analysis/rules/_shared.py:jit_decorator_statics": _JIT + " (static "
        "argnums of a jit decorator)",
    "analysis/rules/_shared.py:jitted_functions": _JIT + " (the port's "
        "are captured_functions)",
    "analysis/rules/_shared.py:traced_params": _JIT + " (the port's are "
        "captured_params)",
}


def _modules():
    for root, _, files in os.walk(JAX_ROOT):
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(root, f)
                yield os.path.relpath(path, JAX_ROOT).replace(os.sep, "/")


MODULES = sorted(_modules())


def _tree(root, rel):
    with open(os.path.join(root, rel), encoding="utf-8") as f:
        return ast.parse(f.read())


def _public_api(tree):
    """(top-level public names, "Class.method" public methods)."""
    tops, methods = set(), set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            tops.add(node.name)
            if isinstance(node, ast.ClassDef):
                methods |= {f"{node.name}.{b.name}" for b in node.body
                            if isinstance(b, (ast.FunctionDef,
                                              ast.AsyncFunctionDef))
                            and not b.name.startswith("_")}
        elif isinstance(node, ast.Assign):
            tops |= {t.id for t in node.targets if isinstance(t, ast.Name)
                     and not t.id.startswith("_")}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            if not node.target.id.startswith("_"):
                tops.add(node.target.id)
    return tops, methods


def _all_names(tree):
    """The string entries of a module's ``__all__`` (and of a lazy
    ``_LAZY`` table's keys)."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            if any(isinstance(t, ast.Name) and t.id in ("__all__", "_LAZY")
                   for t in targets) and node.value is not None:
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.Constant) and isinstance(
                            sub.value, str):
                        out.add(sub.value)
    return out


def _defined(root, rel):
    """Every name a module binds at its top level or lists in ``__all__``,
    and its classes' methods (for the port side)."""
    tree = _tree(root, rel)
    names = set(_all_names(tree))
    methods = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        if isinstance(node, ast.ClassDef):
            methods |= {f"{node.name}.{b.name}" for b in node.body
                        if isinstance(b, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        if isinstance(node, ast.Import):
            names |= {(a.asname or a.name).split(".")[0]
                      for a in node.names}
        if isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names, methods


def _exports(root, rel):
    """A package ``__init__``'s exports: its imported and defined names,
    ``__all__``, and its star imports' public names."""
    tree = _tree(root, rel)
    out = set(_all_names(tree))
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.name != "*":
                    out.add(a.asname or a.name)
                    continue
                star = node.module.split(".", 1)[1].replace(".", "/") + ".py"
                tops, _ = _public_api(_tree(root, star))
                out |= tops
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
    return {n for n in out if not n.startswith("_")}


def _missing(rel):
    if f"{rel}:*" in ALLOWED:
        return []
    port_path = os.path.join(PORT_ROOT, rel)
    assert os.path.exists(port_path), f"no port module for {rel}"
    names, methods = _defined(PORT_ROOT, rel)
    want_tops, want_methods = _public_api(_tree(JAX_ROOT, rel))
    if rel.endswith("__init__.py"):
        want_tops |= _exports(JAX_ROOT, rel)
        names |= _exports(PORT_ROOT, rel)
    gaps = sorted(want_tops - names) + sorted(want_methods - methods)
    return [g for g in gaps if f"{rel}:{g}" not in ALLOWED]


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_name_has_a_port_counterpart(rel):
    assert _missing(rel) == [], rel


def test_every_allow_list_entry_gives_a_reason_and_is_needed():
    for key, why in ALLOWED.items():
        assert isinstance(why, str) and len(why.split()) >= 4, key
        rel, name = key.split(":")
        if name == "*":
            continue
        jax_tops, jax_methods = _public_api(_tree(JAX_ROOT, rel))
        if rel.endswith("__init__.py"):
            jax_tops |= _exports(JAX_ROOT, rel)
        assert name in jax_tops | jax_methods, f"{key} is not a JAX name"
        names, methods = _defined(PORT_ROOT, rel)
        assert name not in names | methods, f"{key} has a port twin now"


@pytest.mark.parametrize("rel", [m for m in MODULES
                                 if m.endswith("__init__.py")])
def test_subpackage_exports_resolve_on_the_port(rel):
    pkg = "flink_ml_tpu_torch" + (
        "." + os.path.dirname(rel).replace("/", ".") if os.path.dirname(rel)
        else "")
    mod = importlib.import_module(pkg)
    for name in sorted(_exports(JAX_ROOT, rel)):
        if f"{rel}:{name}" in ALLOWED:
            continue
        assert hasattr(mod, name), f"{pkg}.{name}"


def test_the_issue_imports():
    from flink_ml_tpu_torch.benchmark import (DenseVectorArrayGenerator,
                                              run_benchmark)
    from flink_ml_tpu_torch.ops import SGD
    from flink_ml_tpu_torch.parallel import (all_reduce_sum,
                                             local_device_count, replicate,
                                             shard_batch)
    from flink_ml_tpu_torch.params import HasFeaturesCol

    assert callable(run_benchmark) and callable(shard_batch)
    assert callable(replicate) and callable(all_reduce_sum)
    assert callable(local_device_count)
    assert SGD.__module__ == "flink_ml_tpu_torch.ops.optimizer"
    assert HasFeaturesCol.__module__ == "flink_ml_tpu_torch.params.shared"
    assert DenseVectorArrayGenerator.__module__.endswith("datagen")


# -- behaviour against the JAX package --------------------------------------

@pytest.mark.parametrize("seed,n,size,dim", [(0, 5, 3, 4), (7, 12, 1, 2)])
def test_dense_vector_array_generator_draws_jax_values(seed, n, size, dim):
    from flink_ml_tpu.benchmark import DenseVectorArrayGenerator as J

    from flink_ml_tpu_torch.benchmark import DenseVectorArrayGenerator as P

    kw = dict(seed=seed, num_values=n, array_size=size, vector_dim=dim,
              col_names=[["a"]])
    want = J(**kw).get_data().column("a")
    got = P(device="cpu", **kw).get_data().column("a")
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert isinstance(g, list) and len(g) == len(w) == size
        for gv, wv in zip(g, w):
            np.testing.assert_array_equal(gv.to_array(), wv.to_array())


def test_benchmark_config_naming_the_array_generator_resolves():
    from flink_ml_tpu_torch.benchmark import resolve_generator

    cls = resolve_generator("org.apache.flink.ml.benchmark.datagenerator."
                            "common.DenseVectorArrayGenerator")
    assert cls.__name__ == "DenseVectorArrayGenerator"


@pytest.mark.parametrize("measure", ["euclidean", "manhattan", "cosine"])
def test_distance_and_find_closest_match_jax(measure):
    from flink_ml_tpu.linalg.distance import DistanceMeasure as J
    from flink_ml_tpu.linalg.vectors import DenseVector as JV
    from flink_ml_tpu.linalg.vectors import VectorWithNorm as JVN

    from flink_ml_tpu_torch.linalg.distance import DistanceMeasure as P
    from flink_ml_tpu_torch.linalg.vectors import DenseVector as PV
    from flink_ml_tpu_torch.linalg.vectors import VectorWithNorm as PVN

    rng = np.random.default_rng(3)
    pts = rng.normal(size=(6, 5))
    jm, pm = J.get_instance(measure), P.get_instance(measure)
    for a, b in [(pts[0], pts[1]), (pts[2], pts[2]), (pts[3], -pts[4])]:
        np.testing.assert_allclose(pm.distance(PV(a), b),
                                   jm.distance(JV(a), b), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(pm.distance(PVN(PV(a)), PV(b)),
                                   jm.distance(JVN(JV(a)), JV(b)),
                                   rtol=1e-6, atol=1e-6)
    cents = list(pts[1:])
    for p in (pts[0], pts[3] + 0.01, rng.normal(size=5)):
        assert pm.find_closest([PV(c) for c in cents], PV(p)) == \
            jm.find_closest([JV(c) for c in cents], JV(p))


@pytest.fixture
def meshes():
    from flink_ml_tpu.parallel import mesh as jax_mesh

    from flink_ml_tpu_torch.parallel import mesh as M

    import jax

    return (jax_mesh.create_mesh(devices=jax.devices()[:8]),
            M.create_mesh((8,), devices=["cpu"] * 8))


@pytest.mark.parametrize("n", [16, 13, 5])
def test_shard_batch_and_replicate_match_jax(meshes, n):
    from flink_ml_tpu.parallel import collective as JC

    from flink_ml_tpu_torch.parallel import collective as C

    jmesh, pmesh = meshes
    x = np.random.default_rng(n).normal(size=(n, 3))
    jarr, jn = JC.shard_batch(jmesh, x)
    placed, pn = C.shard_batch(pmesh, x)
    assert pn == jn == n
    assert isinstance(placed, C.ShardedColumn) and placed.dtype == \
        torch.float32 and len(placed.parts) == 8
    np.testing.assert_array_equal(np.asarray(placed),
                                  np.asarray(jarr)[:n])
    # the JAX package pads to a multiple of the shards; the port never pads
    assert np.asarray(jarr).shape[0] == -(-n // 8) * 8
    assert sum(placed.rows.real) == n
    ints, _ = C.shard_batch(pmesh, np.arange(n))
    assert ints.dtype == torch.int64
    with pytest.raises(ValueError, match="shard axes"):
        C.shard_batch(pmesh, x, "model")
    tree = {"w": x[0], "b": [np.float64(2.5), np.arange(3)]}
    want = JC.replicate(jmesh, tree)
    got = C.replicate(pmesh, tree)
    assert isinstance(got["w"], torch.Tensor) and got["w"].dtype == \
        torch.float32
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["b"][0].numpy(),
                                  np.asarray(want["b"][0]))
    np.testing.assert_array_equal(got["b"][1].numpy(),
                                  np.asarray(want["b"][1]))


def test_map_reduce_program_replicate_and_data_spec(meshes):
    from flink_ml_tpu.parallel.mapreduce import MapReduceProgram as J
    from flink_ml_tpu.parallel.mesh import create_hybrid_mesh

    from flink_ml_tpu_torch.parallel import mesh as M
    from flink_ml_tpu_torch.parallel.mapreduce import MapReduceProgram as P

    import jax

    jmesh, pmesh = meshes
    for ndim in (1, 2, 3):
        assert tuple(P(pmesh).data_spec(ndim)) == \
            tuple(J(jmesh).data_spec(ndim))
    jh = create_hybrid_mesh((4,), (2,), devices=jax.devices()[:8])
    ph = M.create_hybrid_mesh((4,), (2,), devices=["cpu"] * 8)
    assert tuple(P(ph).data_spec(2)) == tuple(J(jh).data_spec(2))
    c = np.arange(4.0)
    np.testing.assert_array_equal(P(pmesh).replicate({"c": c})["c"].numpy(),
                                  np.asarray(J(jmesh).replicate({"c": c})["c"]))


def _write_profile(trace_dir, fns, source, costs):
    """A trace dir with ``profile.json`` and a metrics snapshot holding
    each kernel's per-launch ``ml.device programBytes/programFlops``."""
    from flink_ml_tpu_torch.common.metrics import ML_GROUP, metrics
    from flink_ml_tpu_torch.observability import exporters
    from flink_ml_tpu_torch.observability.compilestats import DEVICE_GROUP

    os.makedirs(trace_dir, exist_ok=True)
    with open(os.path.join(trace_dir, "profile.json"), "w") as f:
        json.dump({"source": source, "fns": fns, "ops": [],
                   "totalMs": sum(r["deviceMs"] for r in fns)}, f)
    grp = metrics.group(ML_GROUP, DEVICE_GROUP)
    for fn, (nbytes, flops) in costs.items():
        grp.gauge("programBytes", nbytes, labels={"fn": fn})
        grp.gauge("programFlops", flops, labels={"fn": fn})
    exporters.dump_metrics(trace_dir)


def test_provenance_matches_jax_on_trace_dirs(tmp_path):
    from flink_ml_tpu.observability import profiling as J

    from flink_ml_tpu_torch.observability import profiling as P

    none = {"profileSource": None, "utilization": None,
            "achievedFlops": None}
    for d in (str(tmp_path / "missing"), str(tmp_path)):
        assert P.provenance(d) == J.provenance(d) == none
    fns = [{"fn": "prov_lloyd", "deviceMs": 2.0},
           {"fn": "prov_reduce", "deviceMs": 0.5}]
    costs = {"prov_lloyd": (1.0e8, 5.0e8), "prov_reduce": (2.5e5, 2.5e5)}
    dev = str(tmp_path / "device")
    _write_profile(dev, fns, "device", costs)
    got, want = P.provenance(dev), J.provenance(dev)
    assert got["profileSource"] == want["profileSource"] == "device"
    # the hottest row's achieved rate is the measurement's own; its
    # utilization is against each package's peak (the H100's in the port)
    assert got["achievedFlops"] == want["achievedFlops"] == 5.0e8 / 2.0e-3
    top = P.efficiency_report(dev)["fns"][0]
    assert got["utilization"] == top["utilization"] > 0
    host = str(tmp_path / "host")
    _write_profile(host, fns, "host-fallback", costs)
    assert P.provenance(host) == J.provenance(host) == dict(
        none, profileSource="host-fallback")


def test_native_available_and_local_device_count():
    from flink_ml_tpu_torch import native
    from flink_ml_tpu_torch.parallel import mesh as M

    assert native.available() is True  # g++ builds the host library here
    if not torch.cuda.is_available():
        with pytest.raises(Exception):
            M.local_device_count()


def test_prediction_helpers_match_jax():
    from flink_ml_tpu.models import common as J

    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.models import common as P

    pairs = np.asarray([[0.25, 0.75], [1.0, 0.0]])
    got, want = P.raw_prediction_vectors(pairs), \
        J.raw_prediction_vectors(pairs)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.to_array(), w.to_array())
    t = P.prediction_output(Table.from_columns(a=np.arange(2.0)), "p",
                            np.asarray([1.0, 0.0]))
    np.testing.assert_array_equal(t.column("p"), [1.0, 0.0])
