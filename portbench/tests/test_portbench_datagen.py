"""The frozen generators draw the port's tables."""

import pytest
import torch

from portbench.harness import datagen


@pytest.fixture
def device_path(monkeypatch):
    """The port's generators on their device path at any size."""
    from flink_ml_tpu_torch.benchmark import datagen as port

    monkeypatch.setattr(port, "_DEVICE_DATAGEN_MIN_BYTES", 0)
    return port


@pytest.mark.parametrize("seed", [0, 2, 3_000_000_123, (1 << 64) - 5])
def test_dense_vectors_are_the_ports(device_path, seed):
    params = {"colNames": [["features"]], "numValues": 300, "vectorDim": 17}
    ours = datagen.generate(
        {"className": "org.apache.flink.ml.benchmark.datagenerator.common."
                      "DenseVectorGenerator", "paramMap": params},
        seed, "cpu")
    gen = device_path.DenseVectorGenerator(device="cpu")
    gen.params_from_json({**params, "seed": seed}, strict=True)
    theirs = gen.get_data()
    assert torch.equal(ours["features"], theirs.column("features"))


@pytest.mark.parametrize("seed", [1, 3_000_000_321])
@pytest.mark.parametrize("arity", [(0, 2), (3, 0)])
def test_labeled_points_are_the_ports(device_path, seed, arity):
    params = {"colNames": [["features", "label", "weight"]],
              "featureArity": arity[0], "labelArity": arity[1],
              "numValues": 200, "vectorDim": 33}
    ours = datagen.generate({"className": "LabeledPointWithWeightGenerator",
                             "paramMap": params}, seed, "cpu")
    gen = device_path.LabeledPointWithWeightGenerator(device="cpu")
    gen.params_from_json({**params, "seed": seed}, strict=True)
    theirs = gen.get_data()
    for name in ("features", "label", "weight"):
        assert torch.equal(ours[name], theirs.column(name)), name
    assert ours["features"].dtype == torch.float32


def test_the_same_seed_gives_the_same_table():
    spec = {"className": "DenseVectorGenerator",
            "paramMap": {"colNames": [["x"]], "numValues": 64,
                         "vectorDim": 8}}
    a = datagen.generate(spec, 7, "cpu")["x"]
    assert torch.equal(a, datagen.generate(spec, 7, "cpu")["x"])
    assert not torch.equal(a, datagen.generate(spec, 8, "cpu")["x"])
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
