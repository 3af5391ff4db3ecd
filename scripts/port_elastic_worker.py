#!/usr/bin/env python3
"""One rank of an elastic multi-process LogisticRegression fit on the
PyTorch port, started by ``flink_ml_tpu_torch.parallel.distributed.launch``
or ``elastic.run_elastic``:

    python -m flink_ml_tpu_torch.parallel.distributed -n 2 --device cpu -- \\
        scripts/port_elastic_worker.py --rows 4000 --cols 10 \\
        --ckpt /tmp/ck --out /tmp/out

Each rank joins the process group from the launcher's env, builds the
``(dcn, data)`` mesh (``distributed.build_mesh``), makes the whole table
from the seed (the rows of a benchmark config with ``--config``, else
seeded normal features with a linear labelling) and fits LogisticRegression
on its own rows in checkpointed segments (``--interval`` rounds) through an
``ElasticCheckpointManager`` in ``--ckpt``. A relaunch (``FLINK_ML_TPU_
ELASTIC_ATTEMPT`` > 0) first copies the checkpoints it resumes from to
``<out>/frozen-attempt-<a>``, so a caller can resume a one-rank fit from the
same snapshot. Process 0 writes ``<out>/result-attempt-<a>.json``: the
coefficients (float32 bits as integers), world size, mesh shape, fit ms,
the wall-clock start, the execution path, the kernel launches of the fit
and the bytes its sums put on the inter level (``ml.collective
levelPayloadBytes{level="inter"}``); every rank writes its kernel launches so far to
``<out>/launches-attempt-<a>-p<k>.json`` at each checkpoint save and after
the fit (a rank killed mid-fit leaves its count at its last save).
"""

import argparse
import json
import os
import shutil
import sys
import time

STARTED = time.time()

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _inter_bytes(metrics) -> float:
    hists = metrics.snapshot().get("ml.collective", {}).get("histograms", {})
    return sum(float(h.get("sum", 0.0)) for k, h in hists.items()
               if k.startswith("levelPayloadBytes") and 'level="inter"' in k)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", help="a benchmark config (its inputData "
                    "generator and its stage's params)")
    ap.add_argument("--rows", type=int, default=4000)
    ap.add_argument("--cols", type=int, default=10)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--max-iter", type=int, default=12)
    ap.add_argument("--batch", type=int, default=400)
    ap.add_argument("--interval", type=int, default=3)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.benchmark import runner
    from flink_ml_tpu_torch.common.metrics import metrics
    from flink_ml_tpu_torch.iteration.iteration import IterationConfig
    from flink_ml_tpu_torch.models.classification import LogisticRegression
    from flink_ml_tpu_torch.ops import kernels
    from flink_ml_tpu_torch.parallel import distributed, elastic
    from flink_ml_tpu_torch.parallel.mesh import (set_default_mesh,
                                                  shutdown_distributed)

    distributed.init_from_env()
    mesh = distributed.build_mesh()
    set_default_mesh(mesh)
    device = mesh.devices[mesh.local_shards[0]]
    attempt = int(os.environ.get(elastic.ATTEMPT_ENV, "0"))
    me = distributed.process_index()
    os.makedirs(args.out, exist_ok=True)
    if attempt and me == 0 and os.path.isdir(args.ckpt):
        frozen = os.path.join(args.out, f"frozen-attempt-{attempt}")
        shutil.rmtree(frozen, ignore_errors=True)
        shutil.copytree(args.ckpt, frozen)

    if args.config:
        specs = runner.load_config(args.config)
        spec = next(iter(specs.values()))
        table = runner.build_generator(spec, device).get_data()
        est = runner.build_stage(spec, device, mesh)
    else:
        rng = np.random.default_rng(args.seed)
        x = rng.normal(size=(args.rows, args.cols)).astype(np.float32)
        y = (x @ rng.normal(size=args.cols) > 0).astype(np.float32)
        table = Table.from_columns(features=x, label=y)
        est = LogisticRegression(device=device, mesh=mesh,
                                 max_iter=args.max_iter,
                                 global_batch_size=args.batch)
    launches_path = os.path.join(args.out,
                                 f"launches-attempt-{attempt}-p{me}.json")

    def dump_launches():
        with open(launches_path, "w") as f:
            json.dump({k: v for k, v in kernels.launch_counts.items() if v},
                      f)

    class CountingManager(elastic.ElasticCheckpointManager):
        def save(self, carry, epoch, extras=None):
            dump_launches()
            return super().save(carry, epoch, extras=extras)

    mgr = CountingManager(args.ckpt)
    est.set_iteration_config(IterationConfig(
        checkpoint_interval=args.interval, checkpoint_manager=mgr))
    kernels.reset_launch_counts()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    start = time.perf_counter()
    model = est.fit(table)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    fit_ms = (time.perf_counter() - start) * 1e3
    launches = {k: v for k, v in kernels.launch_counts.items() if v}
    dump_launches()
    if me == 0:
        coef = np.asarray(model.coefficients, np.float32)
        with open(os.path.join(args.out, f"result-attempt-{attempt}.json"),
                  "w") as f:
            json.dump({"attempt": attempt,
                       "processes": distributed.process_count(),
                       "mesh": mesh.shape, "fit_ms": fit_ms,
                       "started": STARTED,
                       "path": est.last_execution_path,
                       "launches": launches,
                       "interBytes": _inter_bytes(metrics),
                       "coef_bits": coef.view(np.int32).tolist()}, f)
    print(json.dumps({"process": me, "attempt": attempt, "fit_ms": fit_ms}),
          flush=True)
    shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
