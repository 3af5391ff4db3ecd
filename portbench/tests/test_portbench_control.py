"""The control: each cell's reference put in the program's place in TF32,
the next precision below the configurations' float32, has to come out as
not correct. Here at sizes a test run holds; on the card at the cells' own
sizes with ``python3 portbench/control.py``."""

import copy

import pytest

from portbench import control
from portbench.harness import bench

SIZES = {"kmeans-fit": ("kmeans-1m-d100", {"numValues": 20_000}),
         "lr-fit": ("lr-10m-d100", {"numValues": 20_000})}


def _config(workload):
    name, sizes = SIZES[workload]
    config = copy.deepcopy(bench.load_json(
        bench.ROOT / "portbench" / "configs" / f"{name}.json"))
    config["inputData"]["paramMap"].update(sizes)
    return config


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_control_fails_a_limit(workload):
    config = _config(workload)
    _, ctl = control.readings(workload, [], [11, 12, 13], device="cpu",
                              config=config, out=lambda line: None)
    for numbers in ctl:
        assert any(numbers[name] > limit
                   for name, limit in config["limits"].items()), numbers


def test_program_reads_below_the_control():
    """The LR cell's program reading at this size is far under its
    control's, in round 1 and in the later rounds alike (KMeans at this
    size is not: one tie flip moves a centroid of 2,000 rows a cluster by
    5e-4)."""
    prog, ctl = control.readings("lr-fit", [21, 22], [23, 24],
                                 device="cpu", config=_config("lr-fit"),
                                 out=lambda line: None)
    for name in ("step_gap", "first_step_gap", "late_step_gap"):
        assert max(p[name] for p in prog) * 10 < min(c[name] for c in ctl)
