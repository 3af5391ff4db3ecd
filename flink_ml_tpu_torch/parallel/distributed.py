"""Multi-process training runtime: process-group meshes and the launcher.

The port of ``flink_ml_tpu/parallel/distributed.py:69-428``. One fit, many
processes: every process joins one ``torch.distributed`` process group, and
the fits' ``map_shards`` / ``MapReduceProgram`` programs run over a mesh
whose shards are split over the ranks. Three pieces:

- :func:`init_distributed`: the env-mappable, idempotent join. The same
  call works as code (explicit coordinator, process count and id), as
  environment (``FLINK_ML_TPU_COORDINATOR`` et al., what :func:`launch`
  sets) or as a no-op in a plain single-process run. It composes with
  ``mesh.init_distributed`` (the process-group layer), which it calls; one
  process (a world of one) stays without a group, so a one-rank run is the
  in-process fit.
- :func:`build_mesh`: the global mesh. Across processes a ``(dcn, data)``
  mesh with one row per process (``L`` virtual shards a rank on the rank's
  device, ``FLINK_ML_TPU_LOCAL_DEVICES``), so the fits shard and sum over
  both axes (``data_axes``) and the two-level reduce (``collective.py``)
  keeps the inner leg inside the process; or any shape whose positions
  are the ranks' ``L`` each (a ``(data, model)`` mesh whose model axis
  spans ranks or lies inside one, a ``seq`` mesh of several shards a
  rank); in one process the flat mesh.
- :func:`launch`: N child processes of one command, each a fresh
  interpreter (``subprocess``: never a fork of a process that has CUDA up),
  with the env mapping below, a rendezvous file in a fresh temporary
  directory (the children share the launcher's host; a TCP port picked
  ahead of the bind could be taken by another process meanwhile), one
  trace context for all, the per-child grace after the first failure, the
  poll-observed ``exitOrder``, and the whole group killed on timeout.
  ``python -m flink_ml_tpu_torch.parallel.distributed -n 2 -- prog.py``.

**Which backend.** A rank alone on its card takes NCCL. Ranks that share a
card (more processes than cards) take gloo, chosen explicitly by the
launcher through ``FLINK_ML_TPU_DIST_BACKEND``: NCCL refuses two ranks on one
device. gloo takes CUDA tensors for every collective the port calls
(``collective.GLOO_CUDA_OPS``); only ring attention's send/recv, which it
does not take, hops through pinned host buffers, counted (``sequence.py``).
CPU ranks take gloo.

Env mapping (set by the launcher, readable by any entry point):

======================================  =====================================
``FLINK_ML_TPU_COORDINATOR``            rendezvous ``host:port`` (TCP) or
                                        a ``file://`` URL
``FLINK_ML_TPU_NUM_PROCESSES``          total process count
``FLINK_ML_TPU_PROCESS_ID``             this process's index (0-based)
``FLINK_ML_TPU_LOCAL_DEVICES``          virtual shards a process holds
``FLINK_ML_TPU_DIST_DEVICE``            this process's device (``cuda:0``,
                                        ``cpu``)
``FLINK_ML_TPU_DIST_BACKEND``           ``nccl`` or ``gloo``
======================================  =====================================

The first four are the JAX package's names; a JAX-style launch env (where
``FLINK_ML_TPU_LOCAL_DEVICES`` simulates host devices) maps onto virtual
shards here.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence

#: env mapping (the JAX package's names, then the port's two)
COORDINATOR_ENV = "FLINK_ML_TPU_COORDINATOR"
NUM_PROCESSES_ENV = "FLINK_ML_TPU_NUM_PROCESSES"
PROCESS_ID_ENV = "FLINK_ML_TPU_PROCESS_ID"
LOCAL_DEVICES_ENV = "FLINK_ML_TPU_LOCAL_DEVICES"
DEVICE_ENV = "FLINK_ML_TPU_DIST_DEVICE"
BACKEND_ENV = "FLINK_ML_TPU_DIST_BACKEND"

__all__ = [
    "COORDINATOR_ENV", "NUM_PROCESSES_ENV", "PROCESS_ID_ENV",
    "LOCAL_DEVICES_ENV", "DEVICE_ENV", "BACKEND_ENV", "init_distributed",
    "init_from_env", "process_count", "process_index", "process_label",
    "build_mesh", "launch", "main",
]


def _env_int(name: str) -> Optional[int]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        import logging

        logging.getLogger(__name__).warning(
            "%s=%r is not an integer; ignoring it", name, raw)
        return None


def _local_devices() -> int:
    return max(_env_int(LOCAL_DEVICES_ENV) or 1, 1)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_devices: Optional[int] = None,
                     device=None, backend: Optional[str] = None,
                     timeout_s: Optional[float] = None) -> bool:
    """Join (or confirm) the multi-process runtime. Idempotent: an
    already-joined process, a single-process configuration and a repeat
    call are all no-ops. Returns True when the process is part of a live
    process group of more than one afterwards.

    Arguments default to the env mapping (what :func:`launch` sets), so
    entry points call ``init_distributed()`` unconditionally. ``device``
    defaults to ``FLINK_ML_TPU_DIST_DEVICE``, else the card; ``backend`` to
    ``FLINK_ML_TPU_DIST_BACKEND``, else NCCL for a CUDA device and gloo for
    the CPU (``mesh.init_distributed``, which this calls). The rendezvous is
    ``tcp://<coordinator>``, or the coordinator itself when it is a URL
    (``file://...``, what :func:`launch` sets). ``timeout_s``, the process group's collective
    timeout, defaults to the elastic collective deadline when one is armed
    (a gloo collective blocks its caller, so the deadline must bound it
    there), else 600 s."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator is None:
        coordinator = os.environ.get(COORDINATOR_ENV) or None
    if num_processes is None:
        num_processes = _env_int(NUM_PROCESSES_ENV)
    if process_id is None:
        process_id = _env_int(PROCESS_ID_ENV)
    if local_devices is None:
        local_devices = _local_devices()
    if device is None:
        device = os.environ.get(DEVICE_ENV) or None
    if backend is None:
        backend = os.environ.get(BACKEND_ENV) or None
    if coordinator is None or (num_processes or 1) <= 1:
        # nothing configured, or a world of one: no group, the in-process
        # mesh (a one-rank relaunch runs the in-process fit)
        return False
    if process_id is None:
        raise ValueError(f"{NUM_PROCESSES_ENV}={num_processes} needs "
                         f"{PROCESS_ID_ENV}")

    from flink_ml_tpu_torch.observability import profiling
    from flink_ml_tpu_torch.parallel import elastic
    from flink_ml_tpu_torch.parallel import mesh as _mesh

    if timeout_s is None:
        timeout_s = elastic.collective_timeout_s() or 600.0
    # the distributed-init rung of the boot ladder (ml.boot
    # phaseMs{phase="distributed-init"})
    with profiling.boot_phase("distributed-init"):
        return _mesh.init_distributed(
            init_method=(coordinator if "://" in coordinator
                         else f"tcp://{coordinator}"),
            world_size=int(num_processes), rank=int(process_id),
            device=device, timeout_s=timeout_s,
            local_shards=int(local_devices), backend=backend)


def init_from_env() -> bool:
    """:func:`init_distributed` with every argument from the env mapping:
    the one-liner for scripts started by :func:`launch`."""
    return init_distributed()


def _group_size():
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size(), dist.get_rank()
    except Exception:  # noqa: BLE001 — labeling helpers never raise
        pass
    return None


def process_count() -> int:
    """Total processes in the runtime: the env mapping when the launcher
    set it (authoritative before the group is joined, so a child labels its
    artifacts right from the first span), else the process group's size,
    else 1."""
    env = _env_int(NUM_PROCESSES_ENV)
    if env is not None:
        return env
    group = _group_size()
    return group[0] if group is not None else 1


def process_index() -> int:
    """This process's 0-based index (same sources as
    :func:`process_count`)."""
    env = _env_int(PROCESS_ID_ENV)
    if env is not None:
        return env
    group = _group_size()
    return group[1] if group is not None else 0


def process_label() -> Optional[int]:
    """The index to label artifacts with, or None in a single-process
    runtime (the seam behind ``spans-p<k>-*`` names and ``process=``
    records)."""
    if process_count() > 1:
        return process_index()
    return None


def build_mesh(local_axis: Optional[int] = None,
               shape: Optional[Sequence[int]] = None,
               axis_names: Optional[Sequence[str]] = None):
    """The global mesh for this runtime.

    Across processes: a ``(dcn, data)`` mesh, the process axis outermost
    with one row per process in rank order and the rank's ``L`` virtual
    shards on its device inside (``local_axis`` overrides ``L``, which
    defaults to ``FLINK_ML_TPU_LOCAL_DEVICES``, else 1). With ``shape``
    and ``axis_names``, a mesh of that shape instead (``(2, 2), ("data",
    "model")``, ``(4,), ("seq",)``): its ``prod(shape)`` positions must be
    the ranks' ``L`` each, split over the ranks row-major (``mesh.py``).

    In one process: the flat mesh (or ``shape`` over ``axis_names``), ``L``
    virtual shards on ``FLINK_ML_TPU_DIST_DEVICE`` when the launcher set
    them, else one shard per card (``create_mesh()``), so callers invoke
    this unconditionally."""
    import math

    import torch.distributed as dist

    from flink_ml_tpu_torch.observability import profiling
    from flink_ml_tpu_torch.parallel.mesh import (
        DATA_AXIS, DCN_AXIS, Mesh, create_mesh, default_mesh)

    per = int(local_axis) if local_axis is not None else _local_devices()
    if (shape is None) != (axis_names is None):
        raise ValueError("build_mesh takes shape and axis_names together")
    with profiling.boot_phase("mesh-build"):
        if not (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            device = os.environ.get(DEVICE_ENV)
            if shape is not None:
                return create_mesh(shape, axis_names, devices=[
                    device or "cuda"] * math.prod(shape))
            if device is None and local_axis is None \
                    and _env_int(LOCAL_DEVICES_ENV) is None:
                return create_mesh()
            return create_mesh((per,), devices=[device or "cuda"] * per)
        n = dist.get_world_size()
        if shape is None:
            shape, axis_names = (n, per), (DCN_AXIS, DATA_AXIS)
        elif math.prod(shape) != n * per:
            raise ValueError(f"a mesh of shape {tuple(shape)} over {n} "
                             f"ranks of {per} shards needs {n * per} "
                             f"positions")
        dev = default_mesh().devices[default_mesh().local_shards[0]]
        return Mesh([dev] * (n * per), axis_names, group=dist.group.WORLD,
                    rank=dist.get_rank(), shape=shape, processes=n)


# -- the launcher -------------------------------------------------------------

def _placement(device: str, num_processes: int):
    """Each rank's device and the group's backend: CPU ranks on gloo; CUDA
    ranks one to a card on NCCL while there are cards enough, else spread
    over the cards and on gloo (NCCL refuses ranks that share a card)."""
    if device == "cpu":
        return ["cpu"] * num_processes, "gloo"
    import torch

    cards = torch.cuda.device_count()
    if cards < 1:
        raise RuntimeError("launch(device='cuda') needs a CUDA card; pass "
                           "device='cpu' to launch CPU ranks")
    devices = [f"cuda:{r % cards}" for r in range(num_processes)]
    return devices, ("nccl" if num_processes <= cards else "gloo")


def launch(argv: Sequence[str], num_processes: int, local_devices: int = 1,
           env: Optional[dict] = None, timeout: float = 900.0,
           child_grace_s: float = 30.0, device: str = "cuda") -> List[dict]:
    """Run ``argv`` as ``num_processes`` coordinated processes.

    Each child gets the env mapping (the rendezvous: a file in a fresh
    temporary directory, removed when the group is done; its process id,
    ``local_devices`` virtual shards, its device and the group's backend,
    see the module docstring) and one trace context shared by all; the
    child calls :func:`init_from_env` before it builds its mesh. ``device`` is ``"cuda"`` (the default: the card, ranks spread
    over the cards) or ``"cpu"``. Children run concurrently (the
    rendezvous blocks until every process joins); the output of each is
    captured.

    Returns one record per process, in process order: ``{"process",
    "returncode", "exitOrder", "stdout", "stderr"}``; ``exitOrder`` is the
    poll-observed exit sequence (0 = first to exit, None when never seen
    to exit before draining), so an elastic driver names the first signal
    death (the victim) and not a grace-killed survivor. A child failure
    raises nothing (the caller owns the verdict); a timeout kills the whole
    group and raises ``TimeoutExpired``.

    ``child_grace_s``: once any child exits nonzero, its siblings get this
    many seconds before the group is killed and the records returned (a
    lost worker wedges its siblings in their next collective); the killed
    survivors report their signal's rc (e.g. ``-9``)."""
    import shutil
    import tempfile

    devices, backend = _placement(device, int(num_processes))
    base = dict(os.environ)
    base.update(env or {})
    rendezvous = tempfile.mkdtemp(prefix="flink-ml-tpu-rendezvous-")
    base[COORDINATOR_ENV] = f"file://{rendezvous}/store"
    base[NUM_PROCESSES_ENV] = str(int(num_processes))
    base[LOCAL_DEVICES_ENV] = str(int(local_devices))
    base[BACKEND_ENV] = backend
    # every child joins ONE trace: the launcher's current span when it has
    # one, else a fresh trace-only context (an explicit parent wins)
    from flink_ml_tpu_torch.observability import tracing

    if not base.get(tracing.TRACE_PARENT_ENV):
        ctx = (tracing.tracer.current_context()
               or tracing.fresh_context())
        base[tracing.TRACE_PARENT_ENV] = ctx.to_header()
    try:
        return _run_group(argv, base, devices, timeout, child_grace_s)
    finally:
        shutil.rmtree(rendezvous, ignore_errors=True)


def _run_group(argv, base: dict, devices, timeout: float,
               child_grace_s: float) -> List[dict]:
    """Start one child per device of ``devices`` with ``base`` and its
    process id, drain them all, and apply the grace and the timeout
    (see :func:`launch`)."""
    num_processes = len(devices)
    procs = []
    for pid in range(int(num_processes)):
        child_env = dict(base)
        child_env[PROCESS_ID_ENV] = str(pid)
        child_env[DEVICE_ENV] = devices[pid]
        procs.append(subprocess.Popen(
            list(argv), env=child_env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))

    # drain every child concurrently: a child blocked on a full pipe would
    # stall the lockstep group mid-collective
    collected = [None] * len(procs)

    def drain(i, proc):
        collected[i] = proc.communicate()

    threads = [threading.Thread(target=drain, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    grace_deadline = None  # armed by the first nonzero child exit
    exit_order = [None] * len(procs)
    exit_seq = 0

    def kill_all():
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        for t in threads:
            t.join(10.0)

    while True:
        alive = [t for t in threads if t.is_alive()]
        if not alive:
            break
        now = time.monotonic()
        for i, p in enumerate(procs):
            if exit_order[i] is None and p.poll() is not None:
                exit_order[i] = exit_seq
                exit_seq += 1
        if now >= deadline:
            kill_all()
            raise subprocess.TimeoutExpired(list(argv), timeout)
        if grace_deadline is None:
            if any(p.poll() is not None and p.returncode != 0
                   for p in procs):
                grace_deadline = now + max(float(child_grace_s), 0.0)
        elif now >= grace_deadline:
            kill_all()
            break
        alive[0].join(0.05)
    records = []
    for pid, (proc, got) in enumerate(zip(procs, collected)):
        out, err = got if got is not None else ("", "")
        records.append({"process": pid, "returncode": proc.returncode,
                        "exitOrder": exit_order[pid],
                        "stdout": out, "stderr": err})
    return records


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m flink_ml_tpu_torch.parallel.distributed -n 2 [-d L]
    [--device cpu] -- script.py args...``: exit 0 iff every process exited
    0; each child's output is replayed prefixed with its process index."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="flink_ml_tpu_torch.parallel.distributed",
        description="multi-process launcher of the PyTorch port")
    parser.add_argument("-n", "--processes", type=int, default=2)
    parser.add_argument("-d", "--local-devices", type=int, default=1,
                        help="virtual shards a process holds")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default) or 'cpu'")
    parser.add_argument("--timeout", type=float, default=900.0)
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="program to run (prefix with -- to separate)")
    args = parser.parse_args(argv)
    command = list(args.command)
    if command and command[0] == "--":
        # only the first "--" separates the launcher's arguments
        command = command[1:]
    if not command:
        parser.error("no command given")
    if command[0].endswith(".py"):
        command = [sys.executable] + command
    results = launch(command, args.processes, args.local_devices,
                     timeout=args.timeout, device=args.device)
    rc = 0
    for rec in results:
        for stream, text in (("out", rec["stdout"]),
                             ("err", rec["stderr"])):
            for line in (text or "").splitlines():
                print(f"[p{rec['process']}:{stream}] {line}",
                      file=sys.stderr if stream == "err" else sys.stdout)
        rc = rc or rec["returncode"]
    return rc


if __name__ == "__main__":
    sys.exit(main())
