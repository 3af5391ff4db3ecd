"""KMeans kernels: wrappers, plain versions, launch counts and shape gates.

The port of the two kernels of ``flink_ml_tpu/ops/pallas_kernels.py`` that
KMeans runs, written by hand in CUDA C++ for Hopper
(``csrc/kmeans_kernels.cu``, built by ``_build.py`` at first use):

- :func:`assign_nearest` — nearest centroid per row, ``argmin_j(‖c_j‖² −
  2·x·c_j)``, first minimum; only the argmin is written.
- :func:`lloyd_partial_sums` — the same assignment, then the weighted
  ``[one_hotᵀ·x | Σ one_hot]`` of one Lloyd round, in two stages in a fixed
  order (per-block partials, then :func:`lloyd_reduce_partials`), with no
  atomics, so a call gives the same bits every time.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else. For a CUDA tensor it launches its kernel on the current
stream and adds one to its entry of :data:`launch_counts`, or raises: there
is no fallback. The ``*_plain`` versions compute the same functions in plain
PyTorch; a wrapper runs its plain version only for CPU tensors, and the
tests and ``chip_smoke.py`` hold the kernels against them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from flink_ml_tpu_torch.ops import _build

KERNEL_SOURCE = "kmeans_kernels"

#: what each kernel is and replaces, for reports (chip_smoke.py, PERF.md)
KERNELS = {
    "assign_nearest": {
        "route": "cuda", "source": "flink_ml_tpu_torch/csrc/kmeans_kernels.cu",
        "replaces": "flink_ml_tpu/ops/pallas_kernels.py:26"},
    "lloyd_partial_sums": {
        "route": "cuda", "source": "flink_ml_tpu_torch/csrc/kmeans_kernels.cu",
        "replaces": "flink_ml_tpu/ops/pallas_kernels.py:132"},
    "lloyd_reduce_partials": {
        "route": "cuda", "source": "flink_ml_tpu_torch/csrc/kmeans_kernels.cu",
        "replaces": "flink_ml_tpu/ops/pallas_kernels.py:141"},
}

#: kernel launches by wrapper since the last :func:`reset_launch_counts`
launch_counts = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# -- shape gates -------------------------------------------------------------

#: dynamic shared memory one block may use on Hopper (227 KB of the SM's 228)
SMEM_BLOCK_BYTES = 232448
#: shared memory for one staged chunk of centroids; more centroids than
#: fit are scored chunk by chunk
CENTROID_CHUNK_BYTES = 64 << 10
#: centroids the kernel scores together in registers; chunks are multiples
_KG = 16
#: row tiles (= threads per block) to try, largest first
_TILE_ROWS = (128, 64, 32)


def _layout(k: int, d: int, lloyd: bool) -> Optional[Tuple[int, int, int]]:
    """``(rows, kchunk, smem_bytes)`` of a launch, or None when no tile fits
    one block's shared memory. The sizes are the ones the layout comment
    in ``kmeans_kernels.cu`` lists: a transposed chunk of ``kchunk``
    centroids and their norms, a ``rows`` × ``(d | 1)`` x tile and, for
    Lloyd, the ``k`` × ``(d + 1)`` accumulator, row weights and labels."""
    cap = max(_KG, CENTROID_CHUNK_BYTES // (4 * (d + 1)) // _KG * _KG)
    want = min(-(-k // _KG) * _KG, cap)
    for rows in _TILE_ROWS:
        for kchunk in dict.fromkeys((want, _KG)):
            floats = kchunk * d + kchunk + rows * (d | 1)
            if lloyd:
                floats += k * (d + 1) + 2 * rows
            if 4 * floats <= SMEM_BLOCK_BYTES:
                return rows, kchunk, 4 * floats
    return None


def assign_kernel_fits(k: int, d: int) -> bool:
    """True when :func:`assign_nearest` has a tile for these shapes on
    Hopper: any k (centroids are chunked); d up to about 1,400."""
    return _layout(k, d, lloyd=False) is not None


def lloyd_kernel_fits(k: int, d: int) -> bool:
    """True when :func:`lloyd_partial_sums` has a tile for these shapes on
    Hopper: the block's (k, d+1) accumulator must fit in shared memory
    beside the x tile — the gate ``KMeans.fit`` applies."""
    return _layout(k, d, lloyd=True) is not None


# -- plain versions ------------------------------------------------------------

def assign_nearest_plain(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch :func:`assign_nearest`: (n,) int32."""
    csq = torch.sum(centroids * centroids, dim=1)
    d2 = csq[None, :] - 2.0 * (x @ centroids.T)
    return torch.argmin(d2, dim=1).to(torch.int32)


def lloyd_partial_sums_plain(x: torch.Tensor, v: torch.Tensor,
                             centroids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch :func:`lloyd_partial_sums`: (k, d+1) float32."""
    k, d = centroids.shape
    if x.shape[0] == 0:
        return torch.zeros((k, d + 1), dtype=torch.float32, device=x.device)
    a = assign_nearest_plain(x, centroids).long()
    one_hot = F.one_hot(a, k).to(x.dtype) * v[:, None]
    return torch.cat([one_hot.T @ x, one_hot.sum(0)[:, None]], dim=1)


def lloyd_reduce_partials_plain(partials: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch :func:`lloyd_reduce_partials`: the sum over the first
    axis, added in index order as the kernel adds it."""
    out = torch.zeros(partials.shape[1:], dtype=partials.dtype,
                      device=partials.device)
    for p in partials:
        out += p
    return out


# -- wrappers ------------------------------------------------------------------

def _is_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _check(name: str, **tensors: torch.Tensor) -> None:
    device = None
    for arg, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a torch.Tensor, "
                            f"got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: {arg} is on {t.device}; the kernels "
                             "run on CUDA and their plain versions on the CPU")
        if device is not None and t.device != device:
            raise ValueError(f"{name}: inputs are on {device} and {t.device}")
        device = t.device


def _check_points(name: str, x, centroids, v=None) -> None:
    tensors = {"x": x, "centroids": centroids}
    if v is not None:
        tensors["v"] = v
    _check(name, **tensors)
    if x.ndim != 2 or centroids.ndim != 2 or x.shape[1] != centroids.shape[1]:
        raise ValueError(f"{name}: x must be (n, d) and centroids (k, d), got "
                         f"{tuple(x.shape)} and {tuple(centroids.shape)}")
    if centroids.shape[0] < 1:
        raise ValueError(f"{name}: needs at least one centroid")
    if v is not None and tuple(v.shape) != (x.shape[0],):
        raise ValueError(f"{name}: v must be ({x.shape[0]},), got {tuple(v.shape)}")


def assign_nearest(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid index per row of x, fused distance + argmin.

    x: (n, d) float32; centroids: (k, d) float32, on one device → (n,) int32.
    Ties go to the lowest index. Replaces ``assign_nearest`` of
    ``flink_ml_tpu/ops/pallas_kernels.py``; no host padding is needed.
    """
    _check_points("assign_nearest", x, centroids)
    if not _is_cuda(x):
        return assign_nearest_plain(x, centroids)
    if x.shape[0] == 0:
        return torch.empty(0, dtype=torch.int32, device=x.device)
    out = _launch_assign(x, centroids)
    launch_counts["assign_nearest"] += 1
    return out


def lloyd_partial_sums(x: torch.Tensor, v: torch.Tensor,
                       centroids: torch.Tensor) -> torch.Tensor:
    """One Lloyd round's weighted partials, one pass over x.

    x: (n, d) float32; v: (n,) float32 row weights (0 adds nothing);
    centroids: (k, d) float32 → (k, d+1) float32 = [weighted sums | counts],
    assigned by the same rule as :func:`assign_nearest`. n == 0 gives zeros.
    Replaces ``lloyd_partial_sums`` of ``flink_ml_tpu/ops/pallas_kernels.py``.
    """
    _check_points("lloyd_partial_sums", x, centroids, v)
    if not _is_cuda(x):
        return lloyd_partial_sums_plain(x, v, centroids)
    k, d = centroids.shape
    if x.shape[0] == 0:
        return torch.zeros((k, d + 1), dtype=torch.float32, device=x.device)
    partials = _launch_lloyd_partials(x, v, centroids)
    launch_counts["lloyd_partial_sums"] += 1
    return lloyd_reduce_partials(partials)


def lloyd_reduce_partials(partials: torch.Tensor) -> torch.Tensor:
    """(B, k, d+1) per-block partials → (k, d+1), summed in block order:
    the second stage of :func:`lloyd_partial_sums`."""
    _check("lloyd_reduce_partials", partials=partials)
    if partials.ndim != 3 or partials.shape[0] < 1:
        raise ValueError("lloyd_reduce_partials: partials must be (B, k, d+1) "
                         f"with B >= 1, got {tuple(partials.shape)}")
    if not _is_cuda(partials):
        return lloyd_reduce_partials_plain(partials)
    out = _launch_reduce(partials)
    launch_counts["lloyd_reduce_partials"] += 1
    return out


# -- launches (CUDA only) --------------------------------------------------------

def build_kernels() -> dict:
    """Builds and loads the kernels' library now instead of at first use;
    returns ptxas' report by source (empty for a library built earlier)."""
    _lib()
    return dict(_build.BUILD_LOGS)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL_SOURCE)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.kmeans_error_string.argtypes = [I]
    lib.kmeans_error_string.restype = ctypes.c_char_p
    lib.kmeans_blocks_per_sm.argtypes = [I, I, I, ctypes.POINTER(I)]
    lib.kmeans_assign_nearest.argtypes = [P, P, P, P, L, I, I, I, I, I, I, I, P]
    lib.kmeans_lloyd_partials.argtypes = [P, P, P, P, P, L, I, I, I, I, I, I,
                                          I, L, P]
    lib.kmeans_reduce_partials.argtypes = [P, P, I, I, P]
    for fn in (lib.kmeans_blocks_per_sm, lib.kmeans_assign_nearest,
               lib.kmeans_lloyd_partials, lib.kmeans_reduce_partials):
        fn.restype = I
    return lib


def _raise_on_error(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().kmeans_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


@functools.lru_cache(maxsize=None)
def _resident_blocks(device_index: int, lloyd: bool, rows: int, smem: int) -> int:
    """Blocks of this configuration the whole card holds at once."""
    per_sm = ctypes.c_int(0)
    _raise_on_error(_lib().kmeans_blocks_per_sm(int(lloyd), rows, smem,
                                                ctypes.byref(per_sm)),
                    "occupancy query")
    if per_sm.value < 1:
        raise RuntimeError(f"no block of {rows} threads and {smem} bytes of "
                           "shared memory fits an SM of this card")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return per_sm.value * sms


def _launch_setup(x: torch.Tensor, k: int, d: int, lloyd: bool):
    what = "lloyd_partial_sums" if lloyd else "assign_nearest"
    layout = _layout(k, d, lloyd)
    if layout is None:
        raise ValueError(f"{what}: no tile for k={k}, d={d} fits a block's "
                         "shared memory; check the shape gate first")
    device_index = (x.device.index if x.device.index is not None
                    else torch.cuda.current_device())
    vec4 = int(d % 4 == 0 and x.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return layout, device_index, vec4, stream


def _launch_assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    n, d = x.shape
    k = centroids.shape[0]
    with torch.cuda.device(x.device):
        (rows, kchunk, smem), dev, vec4, stream = _launch_setup(x, k, d, False)
        csq = torch.sum(centroids * centroids, dim=1)
        out = torch.empty(n, dtype=torch.int32, device=x.device)
        grid = min(-(-n // rows), _resident_blocks(dev, False, rows, smem))
        _raise_on_error(_lib().kmeans_assign_nearest(
            x.data_ptr(), centroids.data_ptr(), csq.data_ptr(), out.data_ptr(),
            n, k, d, rows, kchunk, smem, vec4, grid, stream), "assign_nearest")
    return out


def _launch_lloyd_partials(x: torch.Tensor, v: torch.Tensor,
                           centroids: torch.Tensor) -> torch.Tensor:
    n, d = x.shape
    k = centroids.shape[0]
    with torch.cuda.device(x.device):
        (rows, kchunk, smem), dev, vec4, stream = _launch_setup(x, k, d, True)
        csq = torch.sum(centroids * centroids, dim=1)
        ntiles = -(-n // rows)
        blocks = min(ntiles, _resident_blocks(dev, True, rows, smem))
        tiles_per_block = -(-ntiles // blocks)
        blocks = -(-ntiles // tiles_per_block)  # no block without rows
        partials = torch.empty((blocks, k, d + 1), dtype=torch.float32,
                               device=x.device)
        _raise_on_error(_lib().kmeans_lloyd_partials(
            x.data_ptr(), v.data_ptr(), centroids.data_ptr(), csq.data_ptr(),
            partials.data_ptr(), n, k, d, rows, kchunk, smem, vec4, blocks,
            tiles_per_block, stream), "lloyd_partial_sums")
    return partials


def _launch_reduce(partials: torch.Tensor) -> torch.Tensor:
    blocks = partials.shape[0]
    with torch.cuda.device(partials.device):
        out = torch.empty(partials.shape[1:], dtype=torch.float32,
                          device=partials.device)
        stream = torch.cuda.current_stream(partials.device).cuda_stream
        _raise_on_error(_lib().kmeans_reduce_partials(
            partials.data_ptr(), out.data_ptr(), blocks, out.numel(), stream),
            "lloyd_reduce_partials")
    return out
