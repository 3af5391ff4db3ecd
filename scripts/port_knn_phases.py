#!/usr/bin/env python3
"""Where a tile's time goes in the port's tiled and long-list KNN kernels
(``knn_tile_kernel`` and ``knn_long_kernel`` of
``flink_ml_tpu_torch/csrc/knn_kernels.cu``), and a row's in its radix
route (``knn_key_tile_kernel``, ``knn_select_kernel``), on one CUDA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/port_knn_phases.py [--k 10,50,256,300] [--radix-k 200]
        [--out FILE]

Builds the committed source twice more beside the real library, with the
source's own switches: ``-DKNN_PHASE_CLOCKS`` reads ``clock64()`` between
the phases of each step of the main loop (copy wait, barrier, copy issue,
FMAs, then for the tiled kernel the tile's epilogue of distances and
survivor masks and the insertion rounds, for the long-list kernel the
distances and filter and the buffer appends and merges), whose per-thread
totals the first block keeps; and ``-DKNN_NO_SELECTION`` folds each
finished tile into a sink (no selection), which times the distance tiles
alone. All three run on the 16,384 x 50,000 x 32 block of the card check
with one train split, at each k of ``--k`` (k <= 32 the tiled kernel, 32 <
k <= 256 the long-list one, past 256 the radix route; ``--radix-k`` takes
the radix route at lists of 256 or fewer too). Prints ptxas' registers and
spills of the two copies' instances, the blocks per SM of the real one,
the times (CUDA events) and the mean cycles per tile of each phase; for
the radix route, the keys alone (``-DKNN_NO_SELECTION`` skips the select
kernel) and the select block's cycles from its start to the end of each
phase (the sample's threshold, the candidates, the radix select, the
compaction, the sort, the output) for block 0 of the last chunk.
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

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from flink_ml_tpu_torch.ops import _build  # noqa: E402
from flink_ml_tpu_torch.ops import kernels as K  # noqa: E402

PHASES = ("copy wait", "barrier", "copy issue", "FMAs", "epilogue", "rounds")
LONG_PHASES = ("copy wait", "barrier", "copy issue", "FMAs",
               "distances and filter", "buffers and merges")


def tile_ptxas(log):
    """ptxas' stack, spill and register lines of each instance of
    knn_tile_kernel and knn_long_kernel, by instance."""
    lines, current = {}, ""
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            current = line
        elif "registers" in line or "spill" in line:
            for kind in ("tile", "long"):
                marker = f"knn_{kind}_kernelILi"
                if marker in current:
                    cap = current.split(marker)[1].split("E")[0]
                    lines.setdefault(f"{kind}<{cap}>", []).append(line.strip())
    return lines


def build(tmp, define):
    """The KNN source built with ``-D<define>``, and its ptxas lines."""
    lib_path = Path(tmp) / f"libknn-{define}.so"
    built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-D{define}",
                            "-o", str(lib_path),
                            str(_build.CSRC_DIR / f"{K.KNN_SOURCE}.cu")],
                           capture_output=True, text=True)
    if built.returncode != 0:
        raise SystemExit(built.stderr)
    ptxas = tile_ptxas(built.stderr)
    lib = ctypes.CDLL(str(lib_path))
    for fn, (argtypes, restype) in K._SIGNATURES[K.KNN_SOURCE].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib, ptxas


def time_ms(fn, batches=5, per_batch=5, warmup=2):
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


SELECT_PHASES = ("threshold", "candidates", "select", "compaction", "sort",
                 "output")


def radix_k(real, timed, sink, x, train, k):
    """The radix route's times at list length k with each library (the
    sink's is the distance keys alone), and block 0's select cycles."""
    n, d = x.shape
    nt = train.shape[0]
    plan = K.knn_radix_plan(n, nt, d, k)

    def launch(lib):
        saved = K._lib
        K._lib = lambda source: lib
        try:
            return K._launch_knn(x, train, k, cap=K.KNN_KEY_CAP_BYTES)
        finally:
            K._lib = saved

    assert torch.equal(launch(timed), launch(real)), "clocked lists differ"
    row = {"route": "radix", "plan": plan._asdict(),
           "select_smem": K.knn_select_smem_bytes(k, plan.cap_w,
                                                  plan.pairs_smem),
           "ms": {name: time_ms(lambda: launch(lib), batches=3, per_batch=2)
                  for name, lib in (("real", real), ("timed", timed),
                                    ("keys_only", sink))}}
    launch(timed)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * len(SELECT_PHASES))()
    timed.knn_select_cycles_read.argtypes = [ctypes.c_void_p]
    assert timed.knn_select_cycles_read(buf) == 0
    row["select_cycles"] = dict(zip(SELECT_PHASES, buf))
    print(f"radix k={k}:", json.dumps(row), flush=True)
    return row


def one_k(real, timed, sink, x, train, k):
    """The three libraries' times at list length k, and the timed copy's
    cycles per tile of each phase."""
    n, d = x.shape
    nt = train.shape[0]
    plan = K._knn_plan(n, nt, d, k, 1)
    if plan.route == "radix":
        return radix_k(real, timed, sink, x, train, k)
    assert plan.route in ("tiled", "long"), plan
    train_t = torch.zeros((plan.dpad, plan.ntp), device="cuda")
    train_t[:d, :nt] = train.T
    tsq = torch.full((plan.ntp,), float("inf"), device="cuda")
    tsq[:nt] = torch.sum(train * train, dim=1)
    out = torch.empty((n, k), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib):
        args = (x.data_ptr(), train_t.data_ptr(), tsq.data_ptr(),
                out.data_ptr(), 0, n, d, plan.dpad, plan.ntp)
        if plan.route == "long":
            rc = lib.knn_topk_long(*args, nt, k, plan.kcap, 1, stream)
        else:
            rc = lib.knn_topk_tiled(*args, k, plan.kcap, 1, stream)
        assert rc == 0, rc

    per_sm = ctypes.c_int(0)
    query = (real.knn_long_blocks_per_sm if plan.route == "long"
             else real.knn_tile_blocks_per_sm)
    assert query(plan.kcap, plan.dpad, ctypes.byref(per_sm)) == 0
    row = {"route": plan.route, "kcap": plan.kcap,
           "blocks_per_sm": per_sm.value,
           "ms": {name: time_ms(lambda: launch(lib))
                  for name, lib in (("real", real), ("timed", timed),
                                    ("no_selection", sink))}}
    launch(timed)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (256 * 6))()
    timed.knn_phase_cycles_read.argtypes = [ctypes.c_void_p]
    assert timed.knn_phase_cycles_read(buf) == 0
    cycles = [statistics.mean(buf[t * 6 + q] for t in range(256)) / plan.tiles
              for q in range(6)]
    names = LONG_PHASES if plan.route == "long" else PHASES
    row["cycles_per_tile"] = dict(zip(names, cycles))
    print(f"k={k}:", json.dumps(row), flush=True)
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--k", default="10",
                        help="comma-separated list lengths (default 10)")
    parser.add_argument("--radix-k", default="",
                        help="comma-separated list lengths to run through "
                             "the radix route whatever their length")
    parser.add_argument("--out", help="also write the result as JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("port_knn_phases: no CUDA device", file=sys.stderr)
        return 2
    K.build_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        timed, timed_ptxas = build(tmp, "KNN_PHASE_CLOCKS")
        sink, sink_ptxas = build(tmp, "KNN_NO_SELECTION")
    real = K._lib(K.KNN_SOURCE)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print("card:", card)

    n, nt, d = 16_384, 50_000, 32
    g = torch.Generator(device="cuda").manual_seed(13)
    x = torch.rand((n, d), generator=g, device="cuda")
    train = torch.rand((nt, d), generator=g, device="cuda")
    result = {"card": card, "shape": [n, nt, d], "splits": 1,
              "ptxas": {"timed": timed_ptxas, "no_selection": sink_ptxas},
              "by_k": {}}
    for k in (int(v) for v in args.k.split(",")):
        result["by_k"][k] = one_k(real, timed, sink, x, train, k)
    for k in (int(v) for v in args.radix_k.split(",") if v):
        result["by_k"][f"radix {k}"] = radix_k(real, timed, sink, x, train, k)
    print(json.dumps(result, indent=1))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
