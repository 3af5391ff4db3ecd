"""Mid-iteration checkpoint/resume.

The port of ``flink_ml_tpu/iteration/checkpoint.py`` (ref: the aligned
checkpoint barriers of flink-ml-iteration, HeadOperatorCheckpointAligner.java
:42, checkpoint/Checkpoints.java:43). There are no in-flight records between
rounds, so a checkpoint is an atomic snapshot of (carry, epoch).

Format, the same bytes as the JAX package's: one directory per checkpoint,
``leaves.npz`` (``leaf_<i>`` in the carry's leaf order) and a version-2
``manifest.json`` with each leaf's sha256, dtype and shape. Files are
fsynced before the atomic rename publishes the directory, so a torn write
cannot pass for a valid checkpoint. A carry written by either package
restores in the other.

The carry is a pytree walked by :func:`tree_flatten` in the order
``jax.tree_util`` gives: tuples (named ones too) and lists in order, dict
keys sorted (an ``OrderedDict`` in insertion order), ``None`` as no leaf,
everything else (tensors, numpy arrays, numpy and Python scalars) a leaf.
``torch.utils._pytree`` keeps dicts in insertion order, which would change
the leaf order, so the port walks its own.

Placement: a save copies each tensor leaf to the host once (``.cpu()``),
and writes a dim-0-sharded leaf (``parallel.update_sharding.Sharded``) as
its global (padded) view, as the JAX package's ``np.asarray`` of a sharded
leaf does; :meth:`CheckpointManager._place` puts a restored leaf onto its
template leaf's device and dtype, and a sharded one back onto its mesh's
layout; a numpy or Python template leaf gets the host array as it is.

Failure behavior: ``restore()`` validates the newest checkpoint against its
manifest and, on any corruption (missing or unreadable manifest or leaves,
digest mismatch, dtype/shape drift, leaf-count mismatch), quarantines the
directory as ``ckpt-*.corrupt`` and falls back to the next-older one, never
raising mid-recovery. No surviving checkpoint means a fresh start (None).

Instrumentation, the JAX package's: a ``checkpoint.save`` span (``epoch``,
``bytes``, ``leaves``), a ``checkpoint.restore`` span (``epoch``,
``checkpoint``, ``bytes``, or ``result="fresh-start"``), a
``checkpoint.quarantine`` event, and the ``ml.checkpoint`` group's
``opMs{op=}`` / ``opBytes{op=}`` histograms and ``ops{op=}`` /
``quarantined`` counters, recorded while the tracer is armed. None of it
touches the bytes written.
"""

from __future__ import annotations

import collections
import hashlib
import json
import logging
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.common.metrics import ML_GROUP, metrics
from flink_ml_tpu_torch.observability import tracing
from flink_ml_tpu_torch.resilience import faults

logger = logging.getLogger(__name__)

#: bucket bounds for checkpoint payload-size histograms (bytes)
_BYTE_BUCKETS = tuple(4.0 ** i for i in range(4, 19))  # 256 B .. 64 GB


def _ckpt_group():
    return metrics.group(ML_GROUP, "checkpoint")


def _observe(op: str, ms: float, nbytes: int) -> None:
    """Record one save/restore into the ml.checkpoint histograms, labeled
    by operation so both directions share one metric name (while the
    tracer is armed)."""
    if not tracing.tracer.active:
        return
    labels: Dict[str, str] = {"op": op}
    group = _ckpt_group()
    group.histogram("opMs", labels=labels).observe(ms)
    group.histogram("opBytes", buckets=_BYTE_BUCKETS,
                    labels=labels).observe(nbytes)
    group.counter("ops", labels=labels)

#: manifest schema: 1 = epoch + num_leaves only (legacy, still restorable);
#: 2 = adds per-leaf {sha256, dtype, shape} integrity records
MANIFEST_VERSION = 2


# -- the carry's pytree ------------------------------------------------------

class TreeDef:
    """The structure of a flattened carry: ``node`` is ``None`` (no leaf),
    ``"leaf"``, or ``(kind, type, keys, children)``."""

    def __init__(self, node):
        self.node = node

    def unflatten(self, leaves) -> Any:
        it = iter(leaves)
        out = _build(self.node, it)
        if next(it, _END) is not _END:
            raise ValueError("more leaves than the tree has")
        return out


_END = object()


def _walk(tree, leaves: list):
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return ("seq", type(tree), None,
                [_walk(child, leaves) for child in tree])
    if isinstance(tree, dict):
        keys = (list(tree) if isinstance(tree, collections.OrderedDict)
                else sorted(tree))
        return ("map", type(tree), keys,
                [_walk(tree[k], leaves) for k in keys])
    leaves.append(tree)
    return "leaf"


def _build(node, it):
    if node is None:
        return None
    if node == "leaf":
        leaf = next(it, _END)
        if leaf is _END:
            raise ValueError("fewer leaves than the tree has")
        return leaf
    kind, typ, keys, children = node
    built = [_build(child, it) for child in children]
    if kind == "map":
        return typ(zip(keys, built))
    if typ is tuple or typ is list:
        return typ(built)
    return typ(*built)  # a namedtuple


def tree_flatten(tree) -> Tuple[list, TreeDef]:
    """(leaves, treedef) of a carry, in ``jax.tree_util``'s leaf order."""
    leaves: list = []
    node = _walk(tree, leaves)
    return leaves, TreeDef(node)


# -- validation ----------------------------------------------------------------

class CorruptCheckpoint(Exception):
    """A checkpoint directory failed integrity validation. Never escapes
    ``restore()``: it routes to quarantine and fallback."""


def _leaf_digest(arr: np.ndarray) -> Optional[str]:
    if arr.dtype == object:  # pointer bytes are not content: no digest
        return None
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _host_leaf(leaf) -> np.ndarray:
    """A carry leaf as the host array a checkpoint holds: a tensor comes to
    the host once, through ``.cpu()``; a sharded leaf as its global view."""
    if hasattr(leaf, "global_view"):
        leaf = leaf.global_view()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _fsync_path(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # e.g. a filesystem that won't open directories
    try:
        os.fsync(fd)
    except OSError:
        pass  # fsync unsupported here: durability is best-effort, the
        # digests still catch a torn write on restore
    finally:
        os.close(fd)


def load_validated(ckpt_dir: str, expected_leaves: Optional[int] = None
                   ) -> Tuple[List[np.ndarray], int]:
    """(host leaves, epoch) of one checkpoint directory, validated against
    its v2 manifest (per-leaf sha256/dtype/shape); raises
    :class:`CorruptCheckpoint` describing what failed. Any unexpected
    exception during validation (a manifest mangled into the wrong JSON
    shape raises KeyError/AttributeError) is itself corruption evidence and
    is re-raised as CorruptCheckpoint."""
    try:
        return _validate_checkpoint(ckpt_dir, expected_leaves)
    except CorruptCheckpoint:
        raise
    except Exception as e:  # noqa: BLE001 — see docstring
        raise CorruptCheckpoint(
            f"validation failed: {type(e).__name__}: {e}") from e


def _validate_checkpoint(ckpt_dir: str, expected_leaves: Optional[int]
                         ) -> Tuple[List[np.ndarray], int]:
    try:
        with open(os.path.join(ckpt_dir, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CorruptCheckpoint(f"manifest unreadable: {e}") from e
    num = manifest.get("num_leaves")
    if not isinstance(num, int):
        raise CorruptCheckpoint("manifest lacks num_leaves")
    if expected_leaves is not None and num != expected_leaves:
        # an incompatible snapshot takes the same fallback path as a failed
        # digest; quarantine renames, never deletes
        raise CorruptCheckpoint(
            f"checkpoint has {num} leaves, template has "
            f"{expected_leaves} (a mismatch on every checkpoint "
            "means the template/config changed, not the data)")
    records = manifest.get("leaves")
    try:
        with np.load(os.path.join(ckpt_dir, "leaves.npz")) as z:
            host_leaves = [z[f"leaf_{i}"] for i in range(num)]
    except Exception as e:  # noqa: BLE001 — BadZipFile, KeyError,
        # OSError, truncated-stream ValueError: all mean "unreadable"
        raise CorruptCheckpoint(f"leaves unreadable: {e}") from e
    if records is not None:  # version >= 2: verify integrity records
        if len(records) != num:
            raise CorruptCheckpoint("manifest leaf records truncated")
        for i, (arr, rec) in enumerate(zip(host_leaves, records)):
            if (rec.get("dtype") is not None
                    and str(arr.dtype) != rec["dtype"]):
                raise CorruptCheckpoint(
                    f"leaf_{i} dtype {arr.dtype} != manifest "
                    f"{rec['dtype']}")
            if (rec.get("shape") is not None
                    and list(arr.shape) != list(rec["shape"])):
                raise CorruptCheckpoint(
                    f"leaf_{i} shape {list(arr.shape)} != manifest "
                    f"{rec['shape']}")
            want = rec.get("sha256")
            if want is not None and _leaf_digest(arr) != want:
                raise CorruptCheckpoint(f"leaf_{i} sha256 mismatch")
    return host_leaves, manifest["epoch"]


def list_checkpoint_names(base_dir: str) -> List[str]:
    """Sorted ``ckpt-<number>`` directory names under ``base_dir`` (empty
    when the directory is missing or unreadable)."""
    try:
        names = os.listdir(base_dir)
    except OSError:
        return []
    return sorted(d for d in names
                  if d.startswith("ckpt-") and d[len("ckpt-"):].isdigit())


def quarantine_checkpoint(ckpt_dir: str, reason: str) -> str:
    """Rename a corrupt checkpoint directory to ``*.corrupt`` (never delete:
    forensic evidence), count it (``ml.checkpoint quarantined``) and emit
    the ``checkpoint.quarantine`` trace event; returns the quarantine path
    (or ``"<removed>"`` when the rename itself failed)."""
    target = ckpt_dir + ".corrupt"
    n = 0
    while os.path.exists(target):
        n += 1
        target = f"{ckpt_dir}.corrupt{n}"
    try:
        os.rename(ckpt_dir, target)
    except OSError:  # already gone / unrenameable: drop it instead
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        target = "<removed>"
    logger.warning("corrupt checkpoint %s quarantined as %s (%s)",
                   ckpt_dir, target, reason)
    if tracing.tracer.active:
        _ckpt_group().counter("quarantined")
    tracing.tracer.event("checkpoint.quarantine",
                         checkpoint=os.path.basename(ckpt_dir),
                         reason=reason)
    return target


def repad_leading(host: np.ndarray, target_shape) -> np.ndarray:
    """Re-place one dim-0 zero-padded leaf onto a different padded length
    (the cross-parallelism re-placement seam): trims or re-extends trailing
    zero padding. A nonzero trimmed tail is genuine incompatibility and
    raises :class:`CorruptCheckpoint`, routing the restore to quarantine and
    fallback."""
    target_shape = tuple(int(s) for s in target_shape)
    if tuple(host.shape) == target_shape:
        return host
    if (host.ndim != len(target_shape) or host.ndim == 0
            or tuple(host.shape[1:]) != target_shape[1:]):
        raise CorruptCheckpoint(
            f"leaf shape {tuple(host.shape)} cannot re-place onto "
            f"{target_shape}: only the leading (padded) dim may differ")
    n = target_shape[0]
    if host.shape[0] > n:
        tail = host[n:]
        if np.any(tail != np.zeros((), dtype=host.dtype)):
            raise CorruptCheckpoint(
                f"leaf shape {tuple(host.shape)} trim to {target_shape} "
                "would drop nonzero state (not dim-0 padding)")
        return np.ascontiguousarray(host[:n])
    pad = [(0, n - host.shape[0])] + [(0, 0)] * (host.ndim - 1)
    return np.pad(host, pad)


class CheckpointManager:
    """Saves/restores (carry, epoch) snapshots under a base directory.

    ``repad_dim0=True`` opts restore into cross-parallelism re-placement:
    leaves whose shapes differ from the template only in dim 0 are trimmed
    or zero-extended through :func:`repad_leading`. Off by default: a shape
    drift is corruption unless a caller declares its dim 0 to be padding."""

    def __init__(self, base_dir: str, keep: int = 2,
                 repad_dim0: bool = False):
        self.base_dir = base_dir
        self.keep = keep
        self.repad_dim0 = repad_dim0
        os.makedirs(base_dir, exist_ok=True)
        # a crash between makedirs and the atomic rename strands a
        # ckpt-*.tmp dir; left alone they accumulate forever
        self.sweep_orphans()

    # -- write ---------------------------------------------------------------
    def save(self, carry: Any, epoch: int,
             extras: Optional[Dict[str, dict]] = None) -> str:
        """Save one checkpoint. ``extras`` maps artifact names to JSON
        documents written as ``<name>.json`` beside the manifest inside the
        atomic rename (ignored by integrity validation)."""
        start = time.perf_counter()
        with tracing.tracer.span("checkpoint.save", epoch=epoch) as sp:
            ckpt_dir, nbytes = self._save(carry, epoch, sp, extras)
        _observe("save", (time.perf_counter() - start) * 1000.0, nbytes)
        return ckpt_dir

    def _save(self, carry: Any, epoch: int, sp,
              extras: Optional[Dict[str, dict]]) -> Tuple[str, int]:
        faults.inject("checkpoint-save", epoch=epoch)
        leaves, _ = tree_flatten(carry)
        ckpt_dir = os.path.join(self.base_dir, f"ckpt-{epoch:08d}")
        tmp_dir = ckpt_dir + ".tmp"
        os.makedirs(tmp_dir, exist_ok=True)
        host_leaves = [_host_leaf(x) for x in leaves]
        nbytes = int(sum(x.nbytes for x in host_leaves))
        sp.set_attribute("bytes", nbytes)
        sp.set_attribute("leaves", len(host_leaves))
        leaves_path = os.path.join(tmp_dir, "leaves.npz")
        np.savez(leaves_path,
                 **{f"leaf_{i}": x for i, x in enumerate(host_leaves)})
        manifest = {
            "version": MANIFEST_VERSION,
            "epoch": epoch,
            "num_leaves": len(leaves),
            "leaves": [{"sha256": _leaf_digest(x),
                        "dtype": str(x.dtype),
                        "shape": list(x.shape)} for x in host_leaves],
        }
        manifest_path = os.path.join(tmp_dir, "manifest.json")
        with open(manifest_path, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        for name, doc in (extras or {}).items():
            extra_path = os.path.join(tmp_dir, f"{name}.json")
            with open(extra_path, "w") as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
        # fsync data before the rename: the atomic publish must never expose
        # a directory whose contents still live in the page cache only
        _fsync_path(leaves_path)
        faults.inject("checkpoint-publish", epoch=epoch)
        # atomic publish: rename makes partially-written checkpoints invisible
        if os.path.exists(ckpt_dir):
            shutil.rmtree(ckpt_dir)
        os.rename(tmp_dir, ckpt_dir)
        _fsync_path(self.base_dir)  # persist the directory entry itself
        self._gc()
        return ckpt_dir, nbytes

    def clear(self) -> None:
        """Discard all checkpoints (called when an iteration completes)."""
        for name in self.list_checkpoints():
            shutil.rmtree(os.path.join(self.base_dir, name),
                          ignore_errors=True)

    def sweep_orphans(self) -> int:
        """Remove stranded ``ckpt-*.tmp`` dirs (a crash mid-save); returns
        how many were swept. Quarantined ``*.corrupt`` dirs are kept."""
        swept = 0
        for name in os.listdir(self.base_dir):
            if name.startswith("ckpt-") and name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.base_dir, name),
                              ignore_errors=True)
                swept += 1
        return swept

    def _gc(self) -> None:
        ckpts = self.list_checkpoints()
        for stale in ckpts[:-self.keep]:
            shutil.rmtree(os.path.join(self.base_dir, stale),
                          ignore_errors=True)

    # -- read ----------------------------------------------------------------
    def list_checkpoints(self):
        return list_checkpoint_names(self.base_dir)

    def _place(self, host: np.ndarray, tmpl):
        """One restored host leaf onto the template leaf's device and dtype
        (a sharded template leaf: onto its mesh's layout); a numpy or Python
        template leaf gets the host array as it is."""
        if hasattr(tmpl, "like_global"):
            return tmpl.like_global(host)
        if isinstance(tmpl, torch.Tensor):
            return torch.as_tensor(host, dtype=tmpl.dtype, device=tmpl.device)
        return host

    def _repad(self, host: np.ndarray, target_shape) -> np.ndarray:
        """One restored leaf onto the template's shape under ``repad_dim0``
        (:func:`repad_leading`; the elastic manager also rescales per-shard
        progress, ``parallel/elastic.py``)."""
        return repad_leading(host, target_shape)

    def restore(self, template_carry: Any) -> Optional[Tuple[Any, int]]:
        """Newest checkpoint that passes integrity validation, restored onto
        the template's structure, devices and dtypes; corrupt checkpoints are
        quarantined (``ckpt-*.corrupt``) and skipped in favor of the
        next-older one. None if no valid checkpoint exists."""
        start = time.perf_counter()
        t_leaves, treedef = tree_flatten(template_carry)
        with tracing.tracer.span("checkpoint.restore") as sp:
            for name in reversed(self.list_checkpoints()):
                ckpt_dir = os.path.join(self.base_dir, name)
                try:
                    host_leaves, epoch = load_validated(ckpt_dir,
                                                        len(t_leaves))
                    if self.repad_dim0:
                        host_leaves = [
                            self._repad(h, t.shape if hasattr(t, "shape")
                                        else np.shape(t))
                            for h, t in zip(host_leaves, t_leaves)]
                except CorruptCheckpoint as e:
                    quarantine_checkpoint(ckpt_dir, str(e))
                    continue
                restored = [self._place(host, tmpl)
                            for host, tmpl in zip(host_leaves, t_leaves)]
                nbytes = int(sum(x.nbytes for x in host_leaves))
                sp.set_attribute("epoch", epoch)
                sp.set_attribute("checkpoint", name)
                sp.set_attribute("bytes", nbytes)
                _observe("restore", (time.perf_counter() - start) * 1000.0,
                         nbytes)
                return treedef.unflatten(restored), epoch
            sp.set_attribute("result", "fresh-start")
        return None
