#!/usr/bin/env python3
"""Count gloo teardown aborts of two-rank CPU groups under host load.

A gloo process group that something keeps alive after
``destroy_process_group`` is freed only at interpreter exit, where the rank
can abort with "terminate called without an active exception" (rc -6). The
abort is rare and needs a loaded host, so this starts many rank pairs beside
busy processes and counts nonzero exits per variant, the variants
interleaved round by round so that they share the load:

- ``pure``: plain ``torch.distributed`` (a ``FileStore`` join, three
  collectives, ``destroy_process_group``), no reference kept;
- ``pure-held``: the same, with a reference to the group kept past
  ``destroy_process_group``;
- ``port``: the port's join (``parallel.distributed.init_from_env``, which
  makes the default mesh over the group), the same collectives, then
  ``mesh.shutdown_distributed()`` with the default mesh kept in a variable,
  as the test suites' rank programs keep it.

``port`` runs this checkout's package; each ``--repo name=path`` adds a
``port@name`` variant that runs another checkout's (e.g. a parent commit
unpacked with ``git archive``)::

    python scripts/port_gloo_teardown_check.py --pairs 6 --rounds 40 \\
        --hogs 4 --repo parent=/path/to/parent

Prints a line a round and a last JSON line ``{variant: [aborts, ranks]}``.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HEAD = r"""
import datetime, os, sys
rank, root = int(sys.argv[1]), sys.argv[2]
"""
_COLLECTIVES = r"""
x = torch.full((4,), float(rank + 1))
dist.all_reduce(x)
dist.all_gather([torch.empty(4) for _ in range(2)], x)
dist.broadcast(x, 0)
"""
_BODY = _COLLECTIVES + "dist.destroy_process_group()\n"
_PURE = _HEAD + r"""
import torch, torch.distributed as dist
dist.init_process_group(
    "gloo", store=dist.FileStore(os.path.join(root, "store"), 2),
    world_size=2, rank=rank, timeout=datetime.timedelta(seconds=60))
"""
PROGRAMS = {
    "pure": _PURE + _BODY,
    "pure-held": _PURE + "held = dist.group.WORLD\n" + _BODY,
    "port": _HEAD + r"""
os.environ.update({
    "FLINK_ML_TPU_COORDINATOR": "file://" + os.path.join(root, "store"),
    "FLINK_ML_TPU_NUM_PROCESSES": "2", "FLINK_ML_TPU_PROCESS_ID": str(rank),
    "FLINK_ML_TPU_DIST_DEVICE": "cpu", "FLINK_ML_TPU_DIST_BACKEND": "gloo"})
import torch, torch.distributed as dist
from flink_ml_tpu_torch.parallel import distributed, mesh as M
assert distributed.init_from_env()
mesh = M.default_mesh()
""" + _COLLECTIVES + "M.shutdown_distributed()\n",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=6,
                    help="rank pairs started at once")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--hogs", type=int, default=4,
                    help="busy processes beside the ranks")
    ap.add_argument("--repo", action="append", default=[],
                    help="name=path of another checkout to run 'port' from")
    args = ap.parse_args(argv)

    variants = [(name, PROGRAMS[name], REPO) for name in PROGRAMS]
    for spec in args.repo:
        name, path = spec.split("=", 1)
        variants.append((f"port@{name}", PROGRAMS["port"],
                         os.path.abspath(path)))
    aborts = {name: [0, 0] for name, _, _ in variants}
    work = tempfile.mkdtemp(prefix="gloo-teardown-")
    hogs = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(args.hogs)]
    try:
        for rnd in range(args.rounds):
            for name, program, path in variants:
                env = dict(os.environ, PYTHONPATH=path)
                groups = []
                for _ in range(args.pairs):
                    root = tempfile.mkdtemp(dir=work)
                    groups.append((root, [subprocess.Popen(
                        [sys.executable, "-c", program, str(r), root],
                        env=env, stdout=subprocess.PIPE,
                        stderr=subprocess.STDOUT) for r in range(2)]))
                for root, procs in groups:
                    for proc in procs:
                        out = proc.communicate(timeout=180)[0].decode()
                        aborts[name][1] += 1
                        if proc.returncode != 0:
                            aborts[name][0] += 1
                            print(f"{name}: rc {proc.returncode}: "
                                  f"{out.strip()[-200:]}", flush=True)
                    shutil.rmtree(root, ignore_errors=True)
            print(f"round {rnd}: " + ", ".join(
                f"{n} {a}/{t}" for n, (a, t) in aborts.items()), flush=True)
    finally:
        for hog in hogs:
            hog.kill()
            hog.wait()
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(aborts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
