#!/usr/bin/env python3
"""Where a tile's time goes in the port's Lloyd stage 1
(``lloyd_partials_kernel`` of ``flink_ml_tpu_torch/csrc/kmeans_kernels.cu``),
on one CUDA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/port_lloyd_phases.py [--tree DIR] [--out FILE]

Builds the source of DIR (default: this repository) once more beside its
real library, with the source's own switch ``-DLLOYD_PHASE_CLOCKS``: block 0
reads ``clock64()`` between the phases of each tile (the barrier before the
copy, the copy, a barrier after it that only this build has, scoring, the
barrier after the labels, the ordering by label and the accumulation) and
keeps each thread's totals. Both run at the KMeans main shape, 1,000,000 x
100 float32, k = 10, unit weights, from one seed. Prints the card's name
and power limit, ptxas' registers and spills of the Lloyd kernel in both
builds, the real build's blocks per SM, the stage-1 times of both builds
(CUDA events around back-to-back launches, host enqueue included, and the
device time of launches captured in a CUDA graph and replayed), and the
mean cycles per tile of each phase over block 0's threads, with the most
any one thread took.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

PHASES = ("wait", "copy", "copy barrier", "scoring", "label barrier",
          "order", "accumulation")


def lloyd_ptxas(log):
    """ptxas' register and spill lines of lloyd_partials_kernel."""
    lines, current = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            current = line
        elif ("lloyd_partials_kernel" in current
              and ("registers" in line or "spill" in line)):
            lines.append(line.strip())
    return lines


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent),
                        help="root of the repository tree to import")
    parser.add_argument("--out", help="also write the result as JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("port_lloyd_phases: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from flink_ml_tpu_torch.ops import _build
    from flink_ml_tpu_torch.ops import kernels as K
    assert Path(K.__file__).resolve().is_relative_to(tree), K.__file__

    K.build_kernels()
    real = K._lib(K.KMEANS_SOURCE)
    real_ptxas = lloyd_ptxas(_build.BUILD_LOGS.get(K.KMEANS_SOURCE, ""))
    with tempfile.TemporaryDirectory() as tmp:
        lib_path = Path(tmp) / "libkmeans-clocks.so"
        built = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-DLLOYD_PHASE_CLOCKS", "-o",
             str(lib_path), str(_build.CSRC_DIR / f"{K.KMEANS_SOURCE}.cu")],
            capture_output=True, text=True)
        if built.returncode != 0:
            raise SystemExit(built.stderr)
        timed = ctypes.CDLL(str(lib_path))
    timed_ptxas = lloyd_ptxas(built.stdout + built.stderr)
    for fn, (argtypes, restype) in K._SIGNATURES[K.KMEANS_SOURCE].items():
        getattr(timed, fn).argtypes = argtypes
        getattr(timed, fn).restype = restype
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print("card:", card)

    n, d, k = 1_000_000, 100, 10
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.rand((n, d), generator=g, device="cuda")
    c = torch.rand((k, d), generator=g, device="cuda")
    v = torch.ones(n, device="cuda")
    rows, kchunk, smem = (getattr(K, "_fused_layout", None) or K._layout)(
        k, d, True)
    dev = torch.cuda.current_device()
    ntiles = -(-n // rows)
    tiles_per_block = -(-ntiles // min(ntiles, K._resident_blocks(
        dev, True, rows, smem)))

    def stage1(lib):
        """The wrapper's stage-1 launch, through ``lib``."""
        def run():
            saved = K._lib
            K._lib = lambda source: lib
            try:
                return K._launch_lloyd_partials(x, v, c)
            finally:
                K._lib = saved
        return run

    per_sm = ctypes.c_int(0)
    assert real.kmeans_blocks_per_sm(1, rows, smem, ctypes.byref(per_sm)) == 0
    want = stage1(real)()
    got = stage1(timed)()
    assert torch.equal(got, want), "the clocked build's partials differ"
    result = {"card": card, "tree": str(args.tree), "shape": [n, d, k],
              "rows": rows, "kchunk": kchunk, "smem_bytes": smem,
              "blocks": want.shape[0], "tiles_per_block": tiles_per_block,
              "blocks_per_sm": per_sm.value,
              "ptxas": {"real": real_ptxas, "timed": timed_ptxas},
              "ms": {}, "device_ms": {}}
    for name, lib in (("real", real), ("timed", timed)):
        result["ms"][name] = time_ms(stage1(lib))
        result["device_ms"][name] = graph_ms(stage1(lib))
    stage1(timed)()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (1024 * len(PHASES)))()
    timed.kmeans_lloyd_phase_cycles_read.argtypes = [ctypes.c_void_p]
    assert timed.kmeans_lloyd_phase_cycles_read(buf) == 0
    per_thread = [[buf[t * len(PHASES) + q] / tiles_per_block
                   for q in range(len(PHASES))] for t in range(rows)]
    mean = [statistics.mean(p[q] for p in per_thread)
            for q in range(len(PHASES))]
    result["cycles_per_tile"] = dict(zip(PHASES, mean))
    result["max_cycles_per_tile"] = dict(zip(PHASES, (
        max(p[q] for p in per_thread) for q in range(len(PHASES)))))
    result["cycles_per_tile_total"] = sum(mean)
    print(json.dumps(result, indent=1))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
