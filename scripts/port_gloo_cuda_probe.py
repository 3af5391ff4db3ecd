#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors as they are: one rank of a probe
started by the port's launcher on ranks that share a card (gloo, chosen by
the launcher because NCCL refuses two ranks on one device):

    python -m flink_ml_tpu_torch.parallel.distributed -n 2 -- \\
        scripts/port_gloo_cuda_probe.py [--ops all_reduce,broadcast]

Each rank tries the named collectives (default: every collective the port's
parallel layer uses) on CUDA tensors of its device and checks the values;
rank 0 prints one JSON object, ``{"backend": ..., "device": ..., "ops":
{name: "ok" | "<error>"}}``. A collective gloo refuses with an exception
fails on every rank alike, so the group stays in step for the next one; one
that gloo takes for host memory aborts the process (``gloo::IoException``,
"Bad address"), so probe such ops one launch each. The port hands CUDA
tensors to gloo as they are for the collectives of
``collective.GLOO_CUDA_OPS``, and stages only ring attention's send/recv
through pinned host buffers; this probe is what that rests on
(``chip_smoke.py`` phase 19 runs it on the set and fails if an op of the
set is refused).
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


def main(argv=None) -> int:
    import argparse

    from flink_ml_tpu_torch.parallel import distributed, elastic

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ops", default="", help="comma-separated op names "
                    "(default: all)")
    wanted = [o for o in ap.parse_args(argv).ops.split(",") if o]

    os.environ.setdefault(elastic.COLLECTIVE_TIMEOUT_ENV, "60")
    if not distributed.init_from_env():
        print("the probe needs a launched group of more than one rank",
              file=sys.stderr)
        return 2
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device(os.environ.get(distributed.DEVICE_ENV, "cuda"))
    total = float(world * (world + 1) // 2)

    def mine(n=4):
        return torch.full((n,), float(rank + 1), device=dev)

    def all_reduce():
        x = mine()
        dist.all_reduce(x)  # torchlint: disable=raw-collective -- the probe calls each raw gloo op on CUDA tensors alone; through the seams it would test their staging, not the backend
        return bool((x == total).all())

    def broadcast():
        x = mine()
        dist.broadcast(x, 0)  # torchlint: disable=raw-collective -- the probe calls each raw gloo op on CUDA tensors alone; through the seams it would test their staging, not the backend
        return bool((x == 1.0).all())

    def all_gather():
        outs = [torch.empty(4, device=dev) for _ in range(world)]
        dist.all_gather(outs, mine())  # torchlint: disable=raw-collective -- the probe calls each raw gloo op on CUDA tensors alone; through the seams it would test their staging, not the backend
        return all(bool((o == r + 1.0).all()) for r, o in enumerate(outs))

    def all_gather_into_tensor():
        out = torch.empty(4 * world, device=dev)
        dist.all_gather_into_tensor(out, mine())  # torchlint: disable=raw-collective -- the probe calls each raw gloo op on CUDA tensors alone; through the seams it would test their staging, not the backend
        return bool((out.view(world, 4)[:, 0]
                     == torch.arange(1.0, world + 1, device=dev)).all())

    def reduce_scatter_tensor():
        out = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(out, mine(4 * world))  # torchlint: disable=raw-collective -- the probe calls each raw gloo op on CUDA tensors alone; through the seams it would test their staging, not the backend
        return bool((out == total).all())

    def all_to_all_single():
        out = torch.empty(4 * world, device=dev)
        dist.all_to_all_single(out, mine(4 * world))  # torchlint: disable=raw-collective -- the probe calls each raw gloo op on CUDA tensors alone; through the seams it would test their staging, not the backend
        return bool((out.view(world, 4)[:, 0]
                     == torch.arange(1.0, world + 1, device=dev)).all())

    def send_recv():
        recv = torch.empty(4, device=dev)
        ops = [dist.P2POp(dist.isend, mine(), (rank + 1) % world),
               dist.P2POp(dist.irecv, recv, (rank - 1) % world)]
        for req in dist.batch_isend_irecv(ops):  # torchlint: disable=raw-collective -- the probe calls each raw gloo op on CUDA tensors alone; through the seams it would test their staging, not the backend
            req.wait()
        return bool((recv == ((rank - 1) % world) + 1.0).all())

    ops = {}
    every = (all_reduce, broadcast, all_gather, all_gather_into_tensor,
             reduce_scatter_tensor, all_to_all_single, send_recv)
    unknown = set(wanted) - {fn.__name__ for fn in every}
    if unknown:
        print(f"unknown ops {sorted(unknown)}", file=sys.stderr)
        return 2
    for fn in every:
        if wanted and fn.__name__ not in wanted:
            continue
        try:  # a probe: the refusal is the answer
            ok = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ops[fn.__name__] = "ok" if ok else "wrong values"
        except Exception as e:  # noqa: BLE001
            ops[fn.__name__] = f"{type(e).__name__}: " + (
                str(e).strip().splitlines() or [""])[0][:160]
    if rank == 0:
        print(json.dumps({"backend": dist.get_backend(), "device": str(dev),
                          "torch": torch.__version__, "ops": ops}),
              flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
