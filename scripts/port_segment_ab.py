#!/usr/bin/env python3
"""The port's ``segment_reduce_sum`` at the FTRL sparse path's shapes and at
hashed domains, timed for one tree of the repository, so that two trees can
be held against each other on one card in one call.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/port_segment_ab.py --tree DIR [--out FILE]

Imports ``flink_ml_tpu_torch`` from DIR (the repository itself, or a
``git archive`` of another commit unpacked somewhere), builds its kernels,
holds ``segment_reduce_sum`` against its plain version at every shape
(within SUM_RTOL/SUM_ATOL, and bit-identical on a rerun), and prints one
JSON line: the tree, the card's name and power limit, and for each shape
the eager time (CUDA events around batches of back-to-back calls, host
enqueue included), the device time (calls captured in a CUDA graph and
replayed), the byte bound, and the eager and device times of one
``index_add_`` of the in-range rows into zeros (the library call for the
same sums). The shapes,
from one seed:

- ``dots padded``: FTRL's per-row dots as ``_pack_csr_shards`` lays them
  out for a batch of 100,000 rows of 10 stored values: row ids 0..99,999,
  ten each, then 48,576 padding slots with id 0 and value 0; n = 1,048,576,
  u = 131,072, c = 1;
- ``dots sorted``: the same n and u over 1,048,576 sorted ids drawn from
  [0, 100,000), no padding;
- ``per-coordinate``: n = 1,048,576, c = 2, ids drawn from [0, 100), u = 100
  (FTRL's gradient and weight sums);
- ``hashed c=1``: n = 2,000,000 ids drawn from [-5, 2^18 + 5), u = 2^18;
- ``hashed c=2``: n = 1,000,000 ids drawn from [0, 2^18), c = 2, u = 2^18.

Run it for parent, change, change, parent, each in a process of its own,
and compare within the call.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

SUM_RTOL, SUM_ATOL = 1e-4, 1e-3
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM device memory, at 700 W


def time_ms(fn, batches=7, per_batch=10, warmup=3):
    """Median per-call time over batches of back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return statistics.median(times)


def graph_ms(fn, reps=20):
    """Device time per call: ``reps`` calls captured in a CUDA graph and
    replayed, so that the host's enqueue time does not hide the card's."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, batches=5, per_batch=5, warmup=1) / reps


def shapes(g):
    """name -> (values, ids, u) on the card, from the generator g."""
    def ids_in(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, device="cuda",
                             dtype=torch.int32)

    def vals(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    nnz, rows, u_dots = 1 << 20, 100_000, 1 << 17
    padded = torch.zeros(nnz, dtype=torch.int32, device="cuda")
    padded[:10 * rows] = torch.arange(rows, dtype=torch.int32,
                                      device="cuda").repeat_interleave(10)
    dots_v = vals(nnz)
    dots_v[10 * rows:] = 0.0
    wide = 1 << 18
    return {
        "dots padded": (dots_v, padded, u_dots),
        "dots sorted": (vals(nnz), torch.sort(ids_in(0, rows, nnz)).values,
                        u_dots),
        "per-coordinate": (vals(nnz, 2), ids_in(0, 100, nnz), 100),
        "hashed c=1": (vals(2_000_000), ids_in(-5, wide + 5, 2_000_000), wide),
        "hashed c=2": (vals(1_000_000, 2), ids_in(0, wide, 1_000_000), wide),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", required=True,
                        help="root of the repository tree to import")
    parser.add_argument("--out", help="also append the JSON line to FILE")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("port_segment_ab: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from flink_ml_tpu_torch.ops import kernels as K
    assert Path(K.__file__).resolve().is_relative_to(tree), K.__file__

    for text in K.build_kernels().values():  # ptxas' report, to stderr
        for report in text.splitlines():
            if "registers" in report or "spill" in report:
                print("ptxas:", report.strip(), file=sys.stderr)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(19)
    results = {}
    for name, (v, ids, u) in shapes(g).items():
        got = K.segment_reduce_sum(v, ids, u)
        want = K.segment_reduce_sum_plain(v, ids, u)
        assert torch.equal(got, K.segment_reduce_sum(v, ids, u)), (
            f"{name}: rerun not bit-identical")
        excess = float(((got - want).abs() - SUM_RTOL * want.abs()
                        - SUM_ATOL).max())
        assert excess <= 0, f"{name}: off by {excess} over tolerance"
        c = 1 if v.ndim == 1 else v.shape[1]
        # index_add_ takes no id outside [0, u): the in-range rows, kept
        # before the timing
        keep = (ids >= 0) & (ids < u)
        lib_ids, lib_v = ids[keep].long(), v[keep]
        lib_out = torch.zeros((u,) if c == 1 else (u, c), device="cuda")

        def library():
            return lib_out.zero_().index_add_(0, lib_ids, lib_v)

        results[name] = {
            "n": v.shape[0], "u": u, "c": c,
            "max_abs_err": float((got - want).abs().max()),
            "ms": time_ms(lambda: K.segment_reduce_sum(v, ids, u)),
            "device_ms": graph_ms(lambda: K.segment_reduce_sum(v, ids, u)),
            "bound_ms": 4 * (v.numel() + ids.numel() + u * c)
                        / PEAK_BYTES_PER_S * 1e3,
            "library_ms": time_ms(library),
            "library_device_ms": graph_ms(library)}
        del got, want
    line = json.dumps({"tree": str(args.tree), "card": card,
                       "segment_reduce_sum": results})
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
