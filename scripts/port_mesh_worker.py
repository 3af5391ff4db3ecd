#!/usr/bin/env python3
"""One rank of the PyTorch port's meshes over processes, started by
``flink_ml_tpu_torch.parallel.distributed.launch``:

    python -m flink_ml_tpu_torch.parallel.distributed -n 2 -d 2 \\
        --device cpu -- scripts/port_mesh_worker.py --jobs jobs.json \\
        --out /tmp/out

Each rank joins the process group from the launcher's env and runs the
jobs of ``--jobs`` (a JSON list) in order, every rank the same list:

- ``{"kind": "fit", "name", "shape", "axes", "local", ...}``: a linear fit
  (``"loss"``: ``"lr"`` LogisticRegression or ``"svc"`` LinearSVC) on the
  mesh ``distributed.build_mesh(local, shape, axes)``, e.g. a ``(data,
  model)`` mesh whose model axis spans ranks or lies inside one. The rows
  are a benchmark config's (``"config"``: its generator and its stage's
  params, on the rank's device) or seeded normal features with a linear
  labelling (``"rows"``, ``"cols"``, ``"seed"``, with ``"max_iter"``,
  ``"batch"``, ``"lr"``, ``"reg"``, ``"elastic_net"``, ``"method"``),
  fitted ``"reps"`` times (1 by default; each rerun must give the same
  bits, ``ms`` is the best and the launches are all the fits').
- ``{"kind": "attention", "name", "shape", "local", "L", "H", "D",
  "seed", "reps"}``: ring and Ulysses attention, causal and not, on a
  ``seq`` mesh of ``local`` shards a rank, over q, k, v drawn from a
  ``torch.Generator`` seeded on the rank's device, each run ``"reps"``
  times (the same bits each time). Rank 0 saves the outputs to
  ``<out>/<name>.npz``; every rank reports each output's sha256.

Every rank writes ``<out>/result-p<k>.json``: per job the host-clock ms
(synchronized on the card), ``max_memory_allocated`` above the memory held
before it (0 on the CPU), the kernel launches, the staged send/recv hops
(``ml.collective stagedOps``), and
for a fit the execution path and the coefficients as float32 bits; then,
per mesh, every axis subset's ranks and whether its group is a process
group here, and after ``shutdown_distributed()`` how many subgroups are
left and whether a mesh still holds a process group.
"""

import argparse
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _staged(metrics) -> int:
    snap = metrics.snapshot().get("ml.collective", {}).get("counters", {})
    return int(sum(v for key, v in snap.items()
                   if key.startswith("stagedOps")
                   and 'op="send_recv"' in key))


class _Run:
    """Time one job's call on the rank's device: host ms around a
    synchronized call, peak device bytes above those held before, the
    launches and staged hops it made."""

    def __init__(self, device, kernels, metrics):
        self.device, self.kernels, self.metrics = device, kernels, metrics

    def __call__(self, fn):
        cuda = self.device.type == "cuda"
        before = dict(self.kernels.launch_counts)
        staged = _staged(self.metrics)
        if cuda:
            torch.cuda.synchronize(self.device)
            base = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        start = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize(self.device)
        ms = (time.perf_counter() - start) * 1e3
        peak = (torch.cuda.max_memory_allocated(self.device) - base
                if cuda else 0)
        return out, {"ms": ms, "peak_bytes": int(peak),
                     "staged_send_recv": _staged(self.metrics) - staged,
                     "launches": {k: v - before.get(k, 0) for k, v in
                                  self.kernels.launch_counts.items()
                                  if v - before.get(k, 0)}}


def _groups(mesh) -> dict:
    import itertools

    import torch.distributed as dist

    out = {}
    for r in range(1, len(mesh.axis_names) + 1):
        for axes in itertools.combinations(mesh.axis_names, r):
            group = mesh.axis_group(axes)
            out[",".join(axes)] = {
                "ranks": list(mesh.axis_ranks(axes)),
                "group": isinstance(group, dist.ProcessGroup)}
    return out


def _fit(job, mesh, device, run, cache):
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.benchmark import runner
    from flink_ml_tpu_torch.models.classification import (LinearSVC,
                                                          LogisticRegression)

    if job.get("config"):
        spec = next(iter(runner.load_config(job["config"]).values()))
        if job["config"] not in cache:
            cache.clear()  # one config's table at a time
            cache[job["config"]] = runner.build_generator(
                spec, device).get_data()
        table = cache[job["config"]]
        est = runner.build_stage(spec, device, mesh)
    else:
        rng = np.random.default_rng(job.get("seed", 0))
        x = rng.normal(size=(job["rows"], job["cols"])).astype(np.float32)
        y = (x @ rng.normal(size=job["cols"]) > 0).astype(np.float32)
        table = Table.from_columns(features=x, label=y)
        cls = LinearSVC if job.get("loss") == "svc" else LogisticRegression
        est = cls(device=device, mesh=mesh,
                  max_iter=job.get("max_iter", 8),
                  global_batch_size=job.get("batch", 100),
                  learning_rate=job.get("lr", 0.1),
                  reg=job.get("reg", 0.0),
                  elastic_net=job.get("elastic_net", 0.0),
                  optimizer=job.get("method", "sgd"), tol=0.0)
    model, rec = run(lambda: est.fit(table))
    coef = np.asarray(model.coefficients, np.float32)
    rec["runs_ms"] = [rec["ms"]]
    for _ in range(job.get("reps", 1) - 1):
        again, more = run(lambda: est.fit(table))
        if not np.array_equal(np.asarray(again.coefficients, np.float32),
                              coef):
            raise AssertionError(f"{job['name']}: a rerun gave other bits")
        rec["runs_ms"].append(more["ms"])
        for kern, c in more["launches"].items():
            rec["launches"][kern] = rec["launches"].get(kern, 0) + c
    rec.update({"ms": min(rec["runs_ms"]), "path": est.last_execution_path,
                "coef_bits": coef.view(np.int32).tolist()})
    return rec


def _attention(job, mesh, device, run):
    from flink_ml_tpu_torch.parallel.sequence import sharded_attention

    gen = torch.Generator(device=device).manual_seed(job.get("seed", 0))
    q, k, v = (torch.randn((job["L"], job["H"], job["D"]), generator=gen,
                           device=device) for _ in range(3))
    rec, outs = {}, {}
    for kind in ("ring", "ulysses"):
        for causal in (False, True):
            key = f"{kind}-{int(causal)}"
            got, rec[key] = run(lambda: sharded_attention(
                mesh, q, k, v, kind=kind, causal=causal))
            rec[key]["runs_ms"] = [rec[key]["ms"]]
            for _ in range(job.get("reps", 1) - 1):
                again, more = run(lambda: sharded_attention(
                    mesh, q, k, v, kind=kind, causal=causal))
                if not torch.equal(again, got):
                    raise AssertionError(f"{key}: a rerun gave other bits")
                rec[key]["runs_ms"].append(more["ms"])
                rec[key]["staged_send_recv"] += more["staged_send_recv"]
                del again
            rec[key]["ms"] = min(rec[key]["runs_ms"])
            host = got.cpu().numpy()
            rec[key]["sha256"] = hashlib.sha256(host.tobytes()).hexdigest()
            outs[key] = host
            del got
    return rec, outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", required=True, help="a JSON list of jobs")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    from flink_ml_tpu_torch.common.metrics import metrics
    from flink_ml_tpu_torch.ops import kernels
    from flink_ml_tpu_torch.parallel import distributed
    from flink_ml_tpu_torch.parallel import mesh as M

    with open(args.jobs) as f:
        jobs = json.load(f)
    if not distributed.init_from_env():
        raise SystemExit("port_mesh_worker needs two or more ranks")
    me = distributed.process_index()
    device = M.default_mesh().devices[M.default_mesh().local_shards[0]]
    os.makedirs(args.out, exist_ok=True)
    run = _Run(device, kernels, metrics)
    results, meshes, cache = {}, [], {}
    for job in jobs:
        axes = job.get("axes", ["seq"] if job["kind"] == "attention"
                       else ["data", "model"])
        mesh = distributed.build_mesh(job["local"], job["shape"], axes)
        meshes.append(mesh)
        if job["kind"] == "fit":
            rec = _fit(job, mesh, device, run, cache)
        else:
            cache.clear()
            rec, outs = _attention(job, mesh, device, run)
            if me == 0:
                np.savez(os.path.join(args.out, f"{job['name']}.npz"),
                         **outs)
        rec.update({"positions": list(mesh.positions),
                    "local_shards": list(mesh.local_shards),
                    "local_models": list(mesh.local_models),
                    "groups": _groups(mesh)})
        results[job["name"]] = rec
    cache.clear()
    subgroups = len(M._SUBGROUPS)
    M.shutdown_distributed()
    import torch.distributed as dist

    with open(os.path.join(args.out, f"result-p{me}.json"), "w") as f:
        json.dump({"process": me, "device": str(device), "jobs": results,
                   "subgroups_built": subgroups,
                   "subgroups_left": len(M._SUBGROUPS),
                   "mesh_holds_group": any(
                       isinstance(v, dist.ProcessGroup)
                       for m in meshes for v in vars(m).values()),
                   "groups_after": [m.group is None for m in meshes]}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
