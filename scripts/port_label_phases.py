#!/usr/bin/env python3
"""Where a step's time goes in the tiled KMeans label body
(``nearest_tiles`` of ``flink_ml_tpu_torch/csrc/kmeans_kernels.cu``, the
body of ``assign_tile_kernel`` and ``lloyd_label_kernel``), on one CUDA
card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/port_label_phases.py [--tree DIR] [--out FILE]

Builds the source of DIR (default: this repository) once more beside its
real library, with the source's own switch ``-DLABEL_PHASE_CLOCKS``: block
0 reads ``clock64()`` between the phases of each step of its main loop (the
wait for the step's copies, the barrier or stage release, the issue of a
later step's copies, the FMAs, and on a centroid tile's last step the
epilogue of distances and keys) and keeps each thread's totals. Both run
``assign_nearest``'s tiled launch at three shapes, from one seed: 1,000,000
x 768 with k = 64, 200,000 x 1,536 with k = 1,024 and 1,000,000 x 100 with
k = 1,000. Prints the card's name and power limit, ptxas' registers and
spills of the label kernels in both builds, the real build's blocks per
SM, both builds' device times (calls captured in a CUDA graph and
replayed), ``addmm`` + ``argmin`` beside them, the operation bound, and the
mean cycles per step of each phase over block 0's threads.
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

PHASES = ("copy wait", "barrier", "copy issue", "FMAs", "epilogue")
SHAPES = ((1_000_000, 768, 64), (200_000, 1_536, 1_024),
          (1_000_000, 100, 1_000))
PEAK_FP32_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores, 700 W


def label_ptxas(log):
    """ptxas' register and spill lines of the label kernels, by kernel."""
    lines, current = {}, ""
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            current = line
        elif "registers" in line or "spill" in line:
            for name in ("assign_tile_kernel", "lloyd_label_kernel"):
                if name in current:
                    key = current.split("'")[1] if "'" in current else name
                    lines.setdefault(key, []).append(line.strip())
    return lines


def time_ms(fn, batches=5, per_batch=5, warmup=2):
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


def graph_ms(fn, reps=5):
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
    return time_ms(graph.replay, batches=5, per_batch=2, warmup=1) / reps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent),
                        help="root of the repository tree to import")
    parser.add_argument("--out", help="also write the result as JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("port_label_phases: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from flink_ml_tpu_torch.ops import _build
    from flink_ml_tpu_torch.ops import kernels as K
    assert Path(K.__file__).resolve().is_relative_to(tree), K.__file__

    K.build_kernels()
    real = K._lib(K.KMEANS_SOURCE)
    real_ptxas = label_ptxas(_build.BUILD_LOGS.get(K.KMEANS_SOURCE, ""))
    with tempfile.TemporaryDirectory() as tmp:
        lib_path = Path(tmp) / "libkmeans-label-clocks.so"
        built = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-DLABEL_PHASE_CLOCKS", "-o",
             str(lib_path), str(_build.CSRC_DIR / f"{K.KMEANS_SOURCE}.cu")],
            capture_output=True, text=True)
        if built.returncode != 0:
            raise SystemExit(built.stderr)
        timed = ctypes.CDLL(str(lib_path))
    for fn, (argtypes, restype) in K._SIGNATURES[K.KMEANS_SOURCE].items():
        getattr(timed, fn).argtypes = argtypes
        getattr(timed, fn).restype = restype
    timed.kmeans_label_phase_cycles_read.argtypes = [ctypes.c_void_p]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print("card:", card, flush=True)
    result = {"card": card, "tree": str(args.tree),
              "ptxas": {"real": real_ptxas,
                        "timed": label_ptxas(built.stdout + built.stderr)},
              "shapes": {}}
    g = torch.Generator(device="cuda").manual_seed(25)
    for n, d, k in SHAPES:
        x = torch.rand((n, d), generator=g, device="cuda")
        c = torch.rand((k, d), generator=g, device="cuda")
        plan = K.tiled_plan(n, k, d, False)

        def labels(lib):
            def run():
                saved = K._lib
                K._lib = lambda source: lib
                try:
                    return K._launch_assign_tiled(x, c, plan)
                finally:
                    K._lib = saved
            return run

        want = labels(real)()
        assert torch.equal(labels(timed)(), want), (
            "the clocked build's labels differ")
        per_sm = ctypes.c_int(0)
        query = getattr(real, "kmeans_label_blocks_per_sm")
        rc = (query(plan.dpad, plan.kp, ctypes.byref(per_sm))
              if "kmeans_label_blocks_per_sm" in K._SIGNATURES[K.KMEANS_SOURCE]
              else -1)
        csq = torch.sum(c * c, dim=1)
        row = {"plan": plan._asdict(), "blocks_per_sm": per_sm.value
               if rc == 0 else None,
               "device_ms": {name: graph_ms(labels(lib))
                             for name, lib in (("real", real),
                                               ("timed", timed))},
               "library_device_ms": graph_ms(
                   lambda: torch.addmm(csq, x, c.T, alpha=-2).argmin(1)),
               "bound_ms": 2 * n * k * d / PEAK_FP32_PER_S * 1e3}
        labels(timed)()
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (256 * len(PHASES)))()
        assert timed.kmeans_label_phase_cycles_read(buf) == 0
        tile_n = min(plan.kp, 128)
        steps = plan.kp // tile_n * plan.dpad // 32
        mean = [statistics.mean(buf[t * len(PHASES) + q] for t in range(256))
                / steps for q in range(len(PHASES))]
        row["steps"] = steps
        row["cycles_per_step"] = dict(zip(PHASES, mean))
        row["cycles_per_step_total"] = sum(mean)
        print(f"{n} x {d}, k={k}:", json.dumps(row), flush=True)
        result["shapes"][f"{n}x{d}k{k}"] = row
        del x, c, want
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
