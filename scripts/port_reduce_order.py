#!/usr/bin/env python3
"""Times the port's ``reduce_partials`` (a fixed two-level order: slices,
then a tree) against the exact block order and ``torch.sum`` on one CUDA
card, at the partials shapes of the main paths (Lloyd and SGD, each made
by its path's first stage) and at the two shapes the FTRL segment sums
gave it until they took their own second stage (gradient sums (1024, 100,
2) and per-row dots (25, 131072, 1), from a seeded tensor).

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/port_reduce_order.py [--out FILE]

The exact block order (s = 0, s += partials[b] for b = 0, 1, ..., one chain
of B dependent adds per column) is the order of the Pallas grid and of the
port's first ``reduce_partials``. The best design of it found for Hopper is
kept below: a one-warp block per 8-column tile stages its rows through a
shared-memory ring of 64-row chunks with ``cp.async``, seven chunks in
flight while the chain runs, four rows per shared-memory read; partials of
at most 32 rows take a thread per column. Each version is checked against
its own plain order with ``torch.equal``. Times are device times: 20
launches captured in a CUDA graph and replayed, so that the host's enqueue
time, which exceeds these kernels' run time, does not hide them; the eager
time per call (events around back-to-back calls) is printed beside it.
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

EXACT_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRedCols = 8;         // columns of a ring warp's tile
constexpr int kRedRows = 64;        // rows of one staged chunk
constexpr int kRedPitch = kRedRows + 4;  // floats per staged column
constexpr int kRedRing = 8;         // chunks of the ring
constexpr int kRedDirectRows = 32;  // rows of the direct kernel at most
constexpr int kRedDirectThreads = 256;

__host__ __device__ constexpr int reduce_ring_chunks(int blocks) {
  return (blocks + kRedRows - 1) / kRedRows < kRedRing
             ? (blocks + kRedRows - 1) / kRedRows
             : kRedRing;
}

__host__ __device__ constexpr int reduce_smem_bytes(int blocks) {
  return blocks <= kRedDirectRows
             ? 0
             : 4 * reduce_ring_chunks(blocks) * kRedCols * kRedPitch;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__global__ void __launch_bounds__(32)
    reduce_ring_kernel(const float* __restrict__ partials,
                       float* __restrict__ out, int blocks, int width) {
  extern __shared__ __align__(16) float ring[];
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kRedCols, cols = min(kRedCols, width - c0);
  const int nchunks = (blocks + kRedRows - 1) / kRedRows;
  // lane l copies column l % kRedCols of rows l / kRedCols + 4 j
  const int cc = lane % kRedCols, r0 = lane / kRedCols;

  auto issue = [&](int g) {
    if (g < nchunks && cc < cols) {
      const int b0 = g * kRedRows, rows = min(kRedRows, blocks - b0);
      float* dst = ring + ((g % kRedRing) * kRedCols + cc) * kRedPitch;
      const float* src = partials + (int64_t)b0 * width + c0 + cc;
#pragma unroll
      for (int r = r0; r < kRedRows; r += 32 / kRedCols)
        if (r < rows) cp_async4(dst + r, src + (int64_t)r * width);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");  // maybe empty
  };

#pragma unroll
  for (int g = 0; g < kRedRing - 1; ++g) issue(g);
  float s = 0.f;
  for (int g = 0; g < nchunks; ++g) {
    // chunk g is in: of the groups committed so far, only g + 1 ..
    // g + kRedRing - 2 may still be in flight
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRedRing - 2) : "memory");
    __syncwarp();  // every lane's copies of chunk g; chunk g - 1 is read
    issue(g + kRedRing - 1);  // into chunk g - 1's slot
    if (lane < cols) {
      const float* src = ring + ((g % kRedRing) * kRedCols + lane) * kRedPitch;
      const int rows = min(kRedRows, blocks - g * kRedRows);
      if (rows == kRedRows) {
        float4 v[kRedRows / 4];
#pragma unroll
        for (int q = 0; q < kRedRows / 4; ++q)
          v[q] = reinterpret_cast<const float4*>(src)[q];
#pragma unroll
        for (int q = 0; q < kRedRows / 4; ++q) {
          s += v[q].x;
          s += v[q].y;
          s += v[q].z;
          s += v[q].w;
        }
      } else {
        for (int r = 0; r < rows; ++r) s += src[r];
      }
    }
  }
  if (lane < cols) out[c0 + lane] = s;
}

__global__ void __launch_bounds__(kRedDirectThreads)
    reduce_direct_kernel(const float* __restrict__ partials,
                         float* __restrict__ out, int blocks, int width) {
  const int i = blockIdx.x * kRedDirectThreads + threadIdx.x;
  if (i >= width) return;
  float v[kRedDirectRows];
#pragma unroll
  for (int r = 0; r < kRedDirectRows; ++r)
    if (r < blocks) v[r] = partials[(int64_t)r * width + i];
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < kRedDirectRows; ++r)
    if (r < blocks) s += v[r];
  out[i] = s;
}

}  // namespace

extern "C" int exact_reduce(const float* partials, float* out, int blocks,
                            int width, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks <= kRedDirectRows) {
    reduce_direct_kernel<<<(width + kRedDirectThreads - 1) / kRedDirectThreads,
                           kRedDirectThreads, 0, s>>>(partials, out, blocks,
                                                      width);
    return (int)cudaGetLastError();
  }
  const int smem = reduce_smem_bytes(blocks);
  cudaError_t e = cudaFuncSetAttribute(
      reduce_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  reduce_ring_kernel<<<(width + kRedCols - 1) / kRedCols, 32, smem, s>>>(
      partials, out, blocks, width);
  return (int)cudaGetLastError();
}
"""


def time_ms(fn, batches=7, per_batch=10, warmup=3):
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
    """Device time per call: ``reps`` calls captured in a CUDA graph."""
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


def exact_plain(p):
    out = torch.zeros(p.shape[1:], device=p.device)
    for row in p:
        out += row
    return out


def main_path_partials(seed=3):
    """The partials of Lloyd's and SGD's first stages at the benchmark
    shapes (SGD's second stage is its own since it took one C entry, in
    the same order), and seeded tensors of the FTRL segment sums' former
    partials shapes."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    x, c = rand(1_000_000, 100), rand(10, 100)
    shapes = {"lloyd": K._launch_lloyd_partials(
        x, torch.ones(1_000_000, device="cuda"), c)}
    y, w = torch.floor(rand(1_000_000) * 2), rand(1_000_000)
    # stage 1 alone; its workspace's last row is the output, left unwritten
    shapes["sgd"] = K._launch_sgd_terms(x, y, w, rand(100) - 0.5, 0, 0,
                                        100_000, "logistic",
                                        combine=False)[:-1]
    shapes["ftrl_grad"] = torch.randn(1024, 100, 2, generator=g,
                                      device="cuda")
    shapes["ftrl_dots"] = torch.randn(25, 1 << 17, 1, generator=g,
                                      device="cuda")
    shapes["B=65535"] = torch.randn(65_535, 102, generator=g, device="cuda")
    return shapes


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the rows as JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("port_reduce_order: no CUDA device", file=sys.stderr)
        return 2
    K.build_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = Path(tmp) / "exact.cu", Path(tmp) / "libexact.so"
        src.write_text(EXACT_SOURCE)
        built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                str(lib_path), str(src)],
                               capture_output=True, text=True)
        if built.returncode != 0:
            print(built.stderr, file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(lib_path))
    lib.exact_reduce.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print("card:", card)
    rows = []
    for name, p in main_path_partials().items():
        blocks, width = p.shape[0], p[0].numel()
        out = torch.empty(p.shape[1:], device="cuda")

        def exact():
            rc = lib.exact_reduce(p.data_ptr(), out.data_ptr(), blocks, width,
                                  torch.cuda.current_stream().cuda_stream)
            assert rc == 0, rc

        exact()
        row = {
            "shape": name, "partials": list(p.shape),
            "exact_equal": torch.equal(out, exact_plain(p)),
            "port_equal": torch.equal(K.reduce_partials(p),
                                      K.reduce_partials_plain(p)),
            "exact_ms": graph_ms(exact),
            "port_ms": graph_ms(lambda: K._launch_reduce(p)),
            "sum_ms": graph_ms(lambda: torch.sum(p, 0)),
            "port_eager_ms": time_ms(lambda: K.reduce_partials(p)),
            "sum_eager_ms": time_ms(lambda: torch.sum(p, 0)),
            "card": card,
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0 if all(r["exact_equal"] and r["port_equal"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
