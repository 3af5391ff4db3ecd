"""torchlint, the port's static analyzer, against its fixtures and against
``jaxlint`` on what the two share.

Every TL rule has positive fixtures (must fire) and a negative fixture
(must stay silent) under tests/fixtures/torchlint/; the meta rules, the
concurrency rules TL109-TL112, the JSON report and the exit codes are held
against the JAX package's analyzer on the same sources (the JAX fixtures
are read, never edited, with only the suppression prefix rewritten); and
the port itself — the package, chip_smoke.py and scripts/port_*.py — must
lint clean, the gate chip_smoke.py's phase 20 also runs on the card's host.
The visualize twin draws the JAX module's bars.
"""

import glob
import json
import os
import re
import subprocess
import sys

import pytest

from flink_ml_tpu.analysis import analyze_source as jax_analyze_source
from flink_ml_tpu.analysis import all_rules as jax_all_rules
from flink_ml_tpu.analysis import cli as jax_cli
from flink_ml_tpu_torch.analysis import (
    Report,
    all_rules,
    analyze_file,
    analyze_paths,
    analyze_source,
    cli,
)
from flink_ml_tpu_torch.analysis.core import META_RULES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torchlint")
JAX_FIXTURES = os.path.join(REPO, "tests", "fixtures", "jaxlint")

#: fixture filename prefix -> rule name
RULE_OF_PREFIX = {
    "capture_leak": "capture-leak",
    "rebuild_hazard": "rebuild-hazard",
    "implicit_rng": "implicit-rng",
    "host_sync": "host-sync",
    "native_contract": "native-contract",
    "alias_mutation": "alias-mutation",
    "metric_in_capture": "metric-in-capture",
    "raw_collective": "raw-collective",
    "unguarded_shared_state": "unguarded-shared-state",
    "lock_order": "lock-order",
    "blocking_under_lock": "blocking-under-lock",
    "fork_unsafe_state": "fork-unsafe-state",
}

#: each JL rule's TL counterpart (same number: JL104 -> TL104)
TL_OF_JL = {
    "tracer-leak": "capture-leak",
    "recompile-hazard": "rebuild-hazard",
    "rng-reuse": "implicit-rng",
    "host-sync": "host-sync",
    "native-contract": "native-contract",
    "alias-mutation": "alias-mutation",
    "metric-in-jit": "metric-in-capture",
    "raw-collective": "raw-collective",
    "unguarded-shared-state": "unguarded-shared-state",
    "lock-order": "lock-order",
    "blocking-under-lock": "blocking-under-lock",
    "fork-unsafe-state": "fork-unsafe-state",
}

CONCURRENCY_RULES = ["unguarded-shared-state", "lock-order",
                     "blocking-under-lock", "fork-unsafe-state"]

#: the three targets of the port's lint gate
PORT_TARGETS = ["flink_ml_tpu_torch/", "chip_smoke.py",
                *sorted(os.path.relpath(p, REPO) for p in glob.glob(
                    os.path.join(REPO, "scripts", "port_*.py")))]


def _fixtures(kind: str, root: str = FIXTURES, prefixes=RULE_OF_PREFIX):
    out = []
    for base, _dirs, files in os.walk(root):
        for name in sorted(files):
            m = re.match(r"(.+)_(pos|neg)\d+\.py$", name)
            if m and m.group(2) == kind and m.group(1) in prefixes:
                out.append((os.path.join(base, name), prefixes[m.group(1)]))
    return sorted(out)


def _jax_concurrency_fixtures():
    prefixes = {p: p.replace("_", "-") for p in
                ("unguarded_shared_state", "lock_order",
                 "blocking_under_lock", "fork_unsafe_state")}
    return [p for p, _ in _fixtures("pos", JAX_FIXTURES, prefixes)
            + _fixtures("neg", JAX_FIXTURES, prefixes)]


def _id(v):
    return os.path.basename(v) if isinstance(v, str) and v.endswith(".py") \
        else v


def _run(main, argv, capsys):
    """One in-process CLI run: (exit code, stdout); argparse's usage
    errors exit through SystemExit(2)."""
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    return rc, capsys.readouterr().out


def _keys(findings):
    return sorted((f.rule, f.line, f.col) for f in findings)


def _as_torchlint(source: str) -> str:
    return source.replace("jaxlint:", "torchlint:")


# -- the registry and the fixture corpus -------------------------------------
def test_every_jl_rule_has_its_tl_counterpart():
    """One TL rule per JL rule, numbered alike (JL104 -> TL104), and the
    four meta rules; the registry holds exactly the shipped rules."""
    jl, tl = jax_all_rules(), all_rules()
    assert set(TL_OF_JL) == set(jl)
    assert set(TL_OF_JL.values()) == set(tl) == set(RULE_OF_PREFIX.values())
    for jl_name, tl_name in TL_OF_JL.items():
        assert tl[tl_name].code == "TL" + jl[jl_name].code[2:], tl_name
    assert META_RULES == ("bare-suppression", "unknown-rule",
                          "unused-suppression", "parse-error")


def test_fixture_inventory_covers_all_rules():
    """>= 2 positive + >= 1 negative fixture per TL rule."""
    pos, neg = _fixtures("pos"), _fixtures("neg")
    for rule in RULE_OF_PREFIX.values():
        assert sum(1 for _, r in pos if r == rule) >= 2, rule
        assert sum(1 for _, r in neg if r == rule) >= 1, rule


@pytest.mark.parametrize("path,rule", _fixtures("pos"), ids=_id)
def test_positive_fixture_fires(path, rule):
    hits = [f for f in analyze_file(path)
            if f.rule == rule and not f.suppressed]
    assert hits, f"{os.path.basename(path)} produced no {rule} finding"


@pytest.mark.parametrize("path,rule", _fixtures("neg"), ids=_id)
def test_negative_fixture_stays_silent(path, rule):
    hits = [f for f in analyze_file(path) if not f.suppressed]
    assert not hits, [f.render() for f in hits]


@pytest.mark.parametrize("path,rule", _fixtures("pos"), ids=_id)
def test_cli_exits_one_on_positive_fixture(path, rule, capsys):
    rc, out = _run(cli.main, [path], capsys)
    assert rc == 1, out
    assert rule in out


@pytest.mark.parametrize("path,rule", _fixtures("neg"), ids=_id)
def test_cli_exits_zero_on_negative_fixture(path, rule, capsys):
    rc, out = _run(cli.main, [path], capsys)
    assert rc == 0, out
    assert "torchlint: 0 finding(s)" in out


def test_analyze_paths_walks_directories():
    rules_seen = {f.rule for f in analyze_paths([FIXTURES])}
    assert set(RULE_OF_PREFIX.values()) <= rules_seen


# -- the gate ----------------------------------------------------------------
def test_cli_clean_on_port_package(capsys, monkeypatch):
    """The port lints clean — the package, chip_smoke.py and every
    scripts/port_*.py — with every suppression justified and used."""
    monkeypatch.chdir(REPO)
    rc, out = _run(cli.main, PORT_TARGETS, capsys)
    assert rc == 0, out
    assert out.strip().splitlines()[-1].startswith("torchlint: 0 finding(s)")
    from flink_ml_tpu_torch.analysis.core import collect_suppressions

    audit = collect_suppressions(PORT_TARGETS)
    assert audit and all(s.justification and s.used for _, s in audit)


def test_suppressions_audit_gives_the_host_sync_inventory(tmp_path, capsys):
    """The audit phase 20 reads its per-module host-sync counts from:
    every suppression with its rules, justification and use."""
    hot = tmp_path / "iteration"
    hot.mkdir()
    (hot / "loop.py").write_text(
        "def f(xs):\n"
        "    for x in xs:\n"
        "        x.item()  # torchlint: disable=host-sync -- one a round\n"
        "        x.cpu()  # torchlint: disable=host-sync -- and another\n"
        "    return xs\n")
    (tmp_path / "cold.py").write_text(
        "x = 1  # torchlint: disable=host-sync -- stale: nothing here\n")
    rc, out = _run(cli.main, ["--suppressions", "--format", "json",
                              str(tmp_path)], capsys)
    audit = json.loads(out)
    assert rc == 0 and audit["counts"] == {"total": 3, "stale": 1}
    used = {}
    for s in audit["suppressions"]:
        if "host-sync" in s["rules"] and s["used"]:
            used[s["path"]] = used.get(s["path"], 0) + 1
    assert used == {str(hot / "loop.py"): 2}


def test_linter_imports_neither_jax_nor_the_jax_package():
    """The analyzer is pure ast and never imports the JAX package: run in
    a fresh interpreter over the port, neither is loaded afterwards."""
    paths = [os.path.join(FIXTURES, "suppression_justified.py"),
             os.path.join(REPO, "flink_ml_tpu_torch", "analysis")]
    code = (
        "import sys\n"
        "from flink_ml_tpu_torch.analysis import cli\n"
        f"rc = cli.main({paths!r})\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'flink_ml_tpu' "
        "or m.startswith('flink_ml_tpu.'))\n"
        "print('BAD', bad, 'RC', rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "BAD [] RC 0" in proc.stdout, proc.stdout


def test_module_entry_point_and_list_rules():
    proc = subprocess.run(
        [sys.executable, "-m", "flink_ml_tpu_torch.analysis.cli",
         "--list-rules"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    for rule in all_rules().values():
        assert f"{rule.code}  {rule.name}:" in proc.stdout


# -- parity with jaxlint: meta rules -----------------------------------------
META_SOURCES = {
    "unknown": "x = 1  # jaxlint: disable=no-such-rule -- oops\n",
    "unused": "x = 1  # jaxlint: disable=host-sync -- hazard was removed\n",
    "bare_unused": "x = 1  # jaxlint: disable=lock-order\n",
    "parse": "def broken(:\n",
    "docstring": ('"""Docs: write `# jaxlint: disable=host-sync -- why` '
                  'to suppress."""\nx = 1\n'),
    "mixed": ("y = 2  # jaxlint: disable=host-sync,bogus -- two names\n"
              "z = 3  # jaxlint: disable=fork-unsafe-state\n"),
    "wrong_rule": (
        "import threading\n"
        "_a = threading.Lock()\n"
        "_b = threading.Lock()\n"
        "def f():\n"
        "    with _a:\n"
        "        with _b:  # jaxlint: disable=host-sync -- wrong rule\n"
        "            return 1\n"
        "def g():\n"
        "    with _b:\n"
        "        with _a:  # jaxlint: disable=lock-order -- the fixture\n"
        "            return 2\n"),
}


@pytest.mark.parametrize("name", sorted(META_SOURCES))
def test_meta_rules_match_jaxlint(name):
    """The same source gives the same (rule, line, col) findings in both
    analyzers, with only the comment prefix rewritten."""
    src = META_SOURCES[name]
    jl = jax_analyze_source(src, path="m.py")
    tl = analyze_source(_as_torchlint(src), path="m.py")
    assert _keys(tl) == _keys(jl)
    assert [f.suppressed for f in sorted(tl, key=lambda f: f.line)] == \
        [f.suppressed for f in sorted(jl, key=lambda f: f.line)]
    assert {f.rule for f in tl} <= set(META_RULES) | set(CONCURRENCY_RULES)


def test_subset_run_does_not_report_unused_like_jaxlint():
    src = "x = 1  # jaxlint: disable=host-sync -- hazard was removed\n"
    assert jax_analyze_source(src, rules=["lock-order"]) == []
    assert analyze_source(_as_torchlint(src), rules=["lock-order"]) == []


def test_justified_and_bare_suppressions():
    findings = analyze_file(os.path.join(FIXTURES,
                                         "suppression_justified.py"))
    (rng,) = findings
    assert rng.suppressed and "the point of this test file" in \
        rng.justification
    assert Report(findings).exit_code == 0
    findings = analyze_file(os.path.join(FIXTURES, "suppression_bare.py"))
    assert {f.rule for f in findings if not f.suppressed} == \
        {"bare-suppression"}
    assert all(f.suppressed for f in findings if f.rule == "implicit-rng")
    assert Report(findings).exit_code == 1


# -- parity with jaxlint: the concurrency rules ------------------------------
@pytest.mark.parametrize("path", _jax_concurrency_fixtures(), ids=_id)
def test_concurrency_rules_match_jaxlint_on_its_fixtures(path):
    """TL109-TL112 give JL109-JL112's (rule, line, col) findings on every
    JAX concurrency fixture, read as it is."""
    with open(path) as f:
        src = f.read()
    jl = jax_analyze_source(src, path, rules=CONCURRENCY_RULES)
    tl = analyze_source(_as_torchlint(src), path, rules=CONCURRENCY_RULES)
    assert _keys(tl) == _keys(jl)
    if os.path.basename(path).split("_")[-1].startswith("pos"):
        assert jl  # the positives do fire


# -- parity with jaxlint: the report and the exit codes ----------------------
def test_json_report_matches_jaxlint(tmp_path, capsys):
    paths = [p for p in _jax_concurrency_fixtures() if "pos" in p][:4]
    copies = []
    for p in paths:
        dst = tmp_path / os.path.basename(p)
        dst.write_text(_as_torchlint(open(p).read()))
        copies.append(str(dst))
    args = ["--format", "json", "--rules", ",".join(CONCURRENCY_RULES)]
    rc_j, out_j = _run(jax_cli.main, copies + args, capsys)
    rc_t, out_t = _run(cli.main, copies + args, capsys)
    jd, td = json.loads(out_j), json.loads(out_t)
    assert rc_j == rc_t == 1
    assert set(td) == set(jd) == {"findings", "counts"}
    assert td["counts"] == jd["counts"]
    assert [set(f) for f in td["findings"]] == \
        [set(f) for f in jd["findings"]]
    assert [(f["rule"], f["path"], f["line"], f["col"])
            for f in td["findings"]] == \
        [(f["rule"], f["path"], f["line"], f["col"])
         for f in jd["findings"]]
    out = tmp_path / "report.json"
    _run(cli.main, copies + args + ["--output", str(out)], capsys)
    assert json.loads(out.read_text()) == td


@pytest.mark.parametrize("case", ["clean", "findings", "no_paths",
                                  "unknown_rule", "list_rules"])
def test_exit_codes_match_jaxlint(case, tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    pos = os.path.join(JAX_FIXTURES, "lock_order_pos1.py")
    argv = {"clean": [str(clean)], "findings": [pos], "no_paths": [],
            "unknown_rule": [str(clean), "--rules", "no-such-rule"],
            "list_rules": ["--list-rules"]}[case]
    rc_j, _ = _run(jax_cli.main, argv, capsys)
    rc_t, _ = _run(cli.main, argv, capsys)
    assert rc_t == rc_j == {"clean": 0, "findings": 1, "no_paths": 2,
                            "unknown_rule": 2, "list_rules": 0}[case]


def test_suppressions_audit_is_nonblocking(tmp_path, capsys):
    stale = tmp_path / "stale.py"
    stale.write_text(
        "x = 1  # torchlint: disable=implicit-rng -- hazard was removed\n")
    rc, out = _run(cli.main, ["--suppressions", str(stale), os.path.join(
        FIXTURES, "suppression_justified.py")], capsys)
    assert rc == 0 and "STALE" in out
    assert out.rstrip().endswith("2 suppression(s), 1 stale")
    rc, out = _run(cli.main, ["--suppressions", "--format", "json",
                              str(stale)], capsys)
    data = json.loads(out)
    assert rc == 0 and data["counts"] == {"total": 1, "stale": 1}
    assert data["suppressions"][0]["rules"] == ["implicit-rng"]


# -- behaviors worth pinning beyond the fixtures -----------------------------
def test_capture_taint_flows_and_rebinding_clears():
    src = ("import torch\n"
           "import numpy as np\n"
           "@torch.compile\n"
           "def f(x):\n"
           "    y = x * 2\n"
           "    z = np.asarray(y)\n"    # derived from x: finding
           "    y = 3.0\n"              # rebound to a host constant
           "    w = np.asarray(y)\n"    # no longer captured: clean
           "    return z, w\n")
    assert [f.line for f in analyze_source(src)
            if f.rule == "capture-leak"] == [6]


def test_capture_wrappers_resolve_through_imports():
    """`from torch import compile as tc` still captures; `re.compile`
    and an unrelated `compile` never do."""
    body = ("def step(x):\n"
            "    if x.sum() > 0:\n"
            "        return x\n"
            "    return -x\n")
    captured = "from torch import compile as tc\n" + body + "g = tc(step)\n"
    assert [f for f in analyze_source(captured)
            if f.rule == "capture-leak"]
    for wrap in ("import re\n" + body + "g = re.compile(step)\n",
                 body + "g = compile(step, 'f', 'exec')\n"):
        assert not [f for f in analyze_source(wrap)
                    if f.rule == "capture-leak"]


def test_raw_collective_exempts_the_parallel_layer():
    src = ("import torch.distributed as dist\n"
           "def f(x):\n"
           "    dist.all_reduce(x)\n"
           "    return x\n")
    hits = [f for f in analyze_source(src, "flink_ml_tpu_torch/models/m.py")
            if f.rule == "raw-collective"]
    assert hits and "all_reduce_sum" in hits[0].message
    assert not [f for f in analyze_source(
        src, "flink_ml_tpu_torch/parallel/collective.py")
        if f.rule == "raw-collective"]
    unknown = "def f(x):\n    return all_reduce(x)\n"  # unresolvable
    assert not analyze_source(unknown, "m.py")


def test_host_sync_scope_is_the_hot_loop_modules():
    src = ("def f(xs):\n"
           "    for x in xs:\n"
           "        x.item()\n"
           "    return xs[0].item()\n")  # after the loop: clean
    for path, n in (("flink_ml_tpu_torch/ops/optimizer.py", 1),
                    ("flink_ml_tpu_torch/models/online.py", 1),
                    ("flink_ml_tpu_torch/iteration/streaming.py", 1),
                    ("flink_ml_tpu_torch/models/clustering/kmeans.py", 0)):
        assert len([f for f in analyze_source(src, path)
                    if f.rule == "host-sync"]) == n, path


def test_alias_rule_is_forward_and_rebind_sensitive():
    src = ("def f(t):\n"
           "    c = [0]\n"
           "    c[0] = 1\n"              # before any view exists: clean
           "    view = t.head(4)\n"
           "    c = view.column('x')\n"
           "    c[0] = 1\n"              # through the view: finding
           "    c = c.clone()\n"         # owned storage
           "    c.add_(1)\n"             # clean
           "    d = view['y']\n"
           "    d.mul_(2)\n"             # in place on a column: finding
           "    return c, d\n")
    assert [f.line for f in analyze_source(src)
            if f.rule == "alias-mutation"] == [6, 10]


def test_kernel_or_raise_accepts_reraise_with_context():
    src = ("from flink_ml_tpu_torch.ops import kernels as K\n"
           "def f(x, c):\n"
           "    try:\n"
           "        return K.assign_nearest(x, c)\n"
           "    except RuntimeError as e:\n"
           "        raise RuntimeError('assign at ' + str(x.shape)) from e\n"
           "def g(x, c):\n"
           "    try:\n"
           "        return K.assign_nearest(x, c)\n"
           "    except RuntimeError:\n"
           "        return K.assign_nearest_plain(x, c)\n")
    assert [f.line for f in analyze_source(src)
            if f.rule == "native-contract"] == [10]


# -- benchmark/visualize.py --------------------------------------------------
VIZ_RESULTS = {
    "KMeans-1": {"stage": {}, "results": {
        "totalTimeMs": 100.0, "inputRecordNum": 1000,
        "inputThroughput": 10000.0, "outputRecordNum": 1000,
        "outputThroughput": 10000.0}},
    "Broken-1": {"exception": "ValueError: nope"},
}


def test_visualize_draws_the_jax_modules_bars(tmp_path, monkeypatch):
    """On the JAX module's test inputs both packages draw the same bars
    (labels and heights, spied on Axes.bar) and the same tick labels, and
    each writes a PNG."""
    pytest.importorskip("matplotlib")
    from matplotlib.axes import Axes

    from flink_ml_tpu.benchmark import visualize as jax_viz
    from flink_ml_tpu_torch.benchmark import visualize

    assert visualize.VALID_METRICS == jax_viz.VALID_METRICS
    p1 = tmp_path / "r1.json"
    p1.write_text(json.dumps(VIZ_RESULTS))
    p2 = tmp_path / "b" / "r1.json"
    p2.parent.mkdir()
    p2.write_text(json.dumps({"KMeans-1": {"results": {
        "inputThroughput": 5.0}}, "KNN-1": {"results": {
            "inputThroughput": 7.0}}}))
    assert visualize.load_results(str(p1)) == jax_viz.load_results(str(p1))
    drawn = {}
    real_bar, real_ticks = Axes.bar, Axes.set_xticklabels

    def spy_bar(self, xs, ys, *a, **kw):
        drawn.setdefault("bars", []).append(
            (list(xs), list(ys), kw.get("label")))
        return real_bar(self, xs, ys, *a, **kw)

    def spy_ticks(self, labels, *a, **kw):
        drawn.setdefault("ticks", []).append(list(labels))
        return real_ticks(self, labels, *a, **kw)

    monkeypatch.setattr(Axes, "bar", spy_bar)
    monkeypatch.setattr(Axes, "set_xticklabels", spy_ticks)
    got = {}
    for pkg, mod in (("jax", jax_viz), ("port", visualize)):
        for files, metric in (([p1, p1], "inputThroughput"),
                              ([p1, p2], "inputThroughput"),
                              ([p1], "totalTimeMs")):
            drawn.clear()
            out = tmp_path / f"{pkg}-{metric}-{len(got)}.png"
            assert mod.main([*map(str, files), "--metric", metric,
                             "--output-file", str(out)]) == 0
            assert out.exists() and out.stat().st_size > 0
            got.setdefault(pkg, []).append(
                (drawn["bars"], drawn["ticks"]))
    assert got["port"] == got["jax"]
    bars, ticks = got["port"][1]
    assert [b[1] for b in bars] == [[10000.0, 0.0], [5.0, 7.0]]
    assert ticks == [["KMeans-1", "KNN-1"]]


def test_visualize_without_matplotlib_raises_the_named_error(tmp_path,
                                                            monkeypatch):
    """Where matplotlib is missing (the card's machine), main raises an
    ImportError naming matplotlib and the viz extra, and writes nothing."""
    from flink_ml_tpu_torch.benchmark import visualize

    for name in [m for m in sys.modules
                 if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    p1 = tmp_path / "r1.json"
    p1.write_text(json.dumps(VIZ_RESULTS))
    out = tmp_path / "chart.png"
    with pytest.raises(ImportError, match="matplotlib") as err:
        visualize.main([str(p1), "--output-file", str(out)])
    assert "viz" in str(err.value)
    assert not out.exists()
    assert visualize.load_results(str(p1)) == {
        "KMeans-1": VIZ_RESULTS["KMeans-1"]["results"]}
