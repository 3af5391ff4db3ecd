"""What a look at the files can check: imports, names, resolution."""

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "flink_ml_tpu"}


def _imports(path: Path):
    """The top-level names of every module ``path`` imports."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def _sources(*parts):
    return sorted((BENCH.joinpath(*parts)).rglob("*.py"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_import(path):
    found = set(_imports(path)) & FORBIDDEN
    assert not found, f"{path} imports {sorted(found)}"


@pytest.mark.parametrize("path", _sources("reference") + _sources("cost"),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_yardstick_imports_nothing_of_the_program(path):
    assert "flink_ml_tpu_torch" not in set(_imports(path))


def test_top_level_names_are_compared_whole(tmp_path):
    path = tmp_path / "probe.py"
    path.write_text("import flink_ml_tpu_torch.ops\n"
                    "from flink_ml_tpu_torch import x\nimport jax.numpy\n")
    assert set(_imports(path)) == {"flink_ml_tpu_torch", "jax"}
    assert set(_imports(path)) & FORBIDDEN == {"jax"}


def test_spec_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    for word in SPEC["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/")
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    assert len(json.dumps(SPEC)) <= 64 << 10


def _all_names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            yield entry["name"]
    for w in SPEC["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in SPEC["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_all_names())))
def test_name_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_unit_and_text_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    for key in ("layer",):
        if key in metric:
            text = metric[key]
            assert 1 <= len(text) <= 200 and "\n" not in text \
                and "\t" not in text


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_by_name(cell):
    """Each cell's configuration, traffic (with its loop and call),
    reference, cost and metric files are where the harness looks for them,
    and every metric the cell reports has a reader."""
    assert 1 <= len(cell["why"]) <= 200
    configs = {c["name"]: c for c in SPEC["configs"]}
    entry = configs[cell["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    traffic = json.loads(
        (BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (BENCH / "loops" / f"{traffic['loop']}.py").is_file()
    assert (BENCH / "calls" / f"{traffic['call']}.py").is_file()
    assert (BENCH / "reference" / f"{config['algorithm']}.py").is_file()
    assert (BENCH / "cost" / f"{config['algorithm']}.py").is_file()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        if cell["name"] in m.get("workloads", [cell["name"]]):
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for name in config["limits"]:
        assert NAME.match(name)


def test_every_config_is_used_and_has_its_own_file():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))


def test_per_layer_cells_report_what_they_move():
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in moved.get("workloads", cells)
