"""Fleet telemetry plane: live cross-process aggregation + membership.

The port of ``flink_ml_tpu/observability/fleet.py``: the same beacon
files, schema and folds, so either package's :class:`FleetView` reads the
other's beacons to the same report. The port has no elastic runtime yet,
so a beacon's elastic load fields are those of a process that ran no
elastic fit, and the member index comes from ``FLINK_ML_TPU_PROCESS_ID``
or the ``torch.distributed`` rank (:func:`_process_index`).

Every process in a runtime (training worker, serving replica,
controller) periodically writes an atomic **beacon** —
``fleet-p<k>-<pid>.json`` — into a shared fleet directory: a liveness
stamp, its role, windowed histogram/counter snapshot slices in the
mergeable bucket format that :func:`check_histogram_snapshot` /
``MetricsRegistry.merge`` already validate, key load gauges
(queueDepth, inFlight, model version / canary, participation) and the
most recent ``elastic.*`` / ``ml.controller`` trace events.  Because
the carried slices are plain cumulative-bucket snapshots, fleet-level
aggregation is bin-exact by construction: summing member counts arrays
gives the same histogram a single process would have recorded — the
same fold-exactly discipline the DrJAX-style reducers apply on device
(arXiv:2403.07128), host-side, with JiT-aggregation-style staleness
bookkeeping for members that stop reporting (arXiv:2208.09740).

:class:`FleetView` (in a coordinating process or the CLI) merges live
beacons into fleet-level windowed quantiles ("fleet p99 over the last 60 s"), a
membership table with staleness classification (alive / stale / dead
by beacon age vs the announced interval) and per-replica load rows.
``observability/slo.py`` evaluates ``scope: fleet`` objectives through
it, and :func:`stale_member_indices` is the elastic watchdog's view
over the same beacon stamps (the JAX package's ``parallel/elastic.py``
``stale_processes()``) — ONE liveness mechanism, so a watchdog and the
fleet CLI can never disagree about who is dead.

CLI: ``python -m flink_ml_tpu_torch.observability.fleet <dir>
[--json|--check|--watch]`` (the port's trace CLI is each module's
:func:`main` until its dispatcher is ported; exit 4 on a dead member or a
violated fleet-scope SLO under ``--check``, 2 without fleet telemetry).
Live route: ``/fleet`` on the telemetry endpoint
(observability/server.py).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from flink_ml_tpu_torch.common import locks
from flink_ml_tpu_torch.common.metrics import (
    WindowedHistogram,
    check_histogram_snapshot,
    histogram_quantile,
    metrics,
)

#: the elastic heartbeat dir's env var (``parallel/elastic.py``): the
#: elastic watchdog and the fleet view read the same beacons
HEARTBEAT_DIR_ENV = "FLINK_ML_TPU_HEARTBEAT_DIR"
#: this process's 0-based index in a multi-process runtime, under the JAX
#: package's name (flink_ml_tpu/parallel/distributed.py)
PROCESS_ID_ENV = "FLINK_ML_TPU_PROCESS_ID"

#: shared fleet directory (writer side); falls back to the elastic
#: heartbeat dir, then to ``<trace_dir>/fleet`` when tracing is armed
FLEET_DIR_ENV = "FLINK_ML_TPU_FLEET_DIR"
#: seconds between beacon writes (default 2.0)
BEACON_S_ENV = "FLINK_ML_TPU_FLEET_BEACON_S"
#: beacon age beyond which a member is *stale*; *dead* past twice this
#: (default: 2x the beacon interval)
STALE_S_ENV = "FLINK_ML_TPU_FLEET_STALE_S"

BEACON_GLOB = "fleet-*.json"
BEACON_SCHEMA = 1
DEFAULT_BEACON_S = 2.0
#: window slices every beacon carries, seconds (smallest >= the asked
#: window is picked at read time)
FLEET_WINDOWS = (60.0, 300.0)

EXIT_OK = 0
EXIT_INVALID = 2
EXIT_VIOLATION = 4

#: trace-event names a beacon carries (membership/ops context)
_EVENT_NAMES = ("elastic.", "ml.controller")
_EVENT_LIMIT = 20

__all__ = [
    "FLEET_DIR_ENV", "BEACON_S_ENV", "STALE_S_ENV", "BEACON_GLOB",
    "BEACON_SCHEMA", "FLEET_WINDOWS", "EXIT_OK", "EXIT_INVALID",
    "EXIT_VIOLATION", "beacon_interval_s", "stale_after_s", "fleet_dir",
    "find_fleet_dir", "write_beacon", "start_beacon", "stop_beacon",
    "read_beacons", "member_key", "FleetView", "fold_snapshots",
    "stale_member_indices", "provenance", "main",
]


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        val = float(raw)
    except ValueError:
        return default
    return val if val > 0.0 else default


def beacon_interval_s() -> float:
    """Seconds between beacon writes (``FLINK_ML_TPU_FLEET_BEACON_S``,
    default 2.0; non-positive or junk values fall back)."""
    return _env_float(BEACON_S_ENV, DEFAULT_BEACON_S)


def stale_after_s() -> float:
    """Beacon age past which a member classifies *stale*
    (``FLINK_ML_TPU_FLEET_STALE_S``, default 2x the beacon interval).
    *Dead* starts at twice this again — a member gets one full missed
    interval of grace before 'stale' and a second before 'dead'."""
    return _env_float(STALE_S_ENV, 2.0 * beacon_interval_s())


def fleet_dir() -> Optional[str]:
    """The directory this process's beacons go to, or None (disarmed):
    ``FLINK_ML_TPU_FLEET_DIR``, else the elastic heartbeat dir (one
    liveness plane — parallel/elastic.py), else ``<trace_dir>/fleet``
    when tracing is armed."""
    explicit = os.environ.get(FLEET_DIR_ENV)
    if explicit:
        return explicit
    hb = os.environ.get(HEARTBEAT_DIR_ENV)
    if hb:
        return hb
    try:
        from flink_ml_tpu_torch.observability.tracing import tracer

        trace_dir = tracer.trace_dir
    except Exception:
        trace_dir = None
    if trace_dir:
        return os.path.join(trace_dir, "fleet")
    return None


def find_fleet_dir(path: str) -> Optional[str]:
    """Reader-side resolution: ``path`` itself if it holds beacons,
    else its ``fleet/`` subdir (how a trace dir nests them), else
    None."""
    for cand in (path, os.path.join(path, "fleet")):
        if glob.glob(os.path.join(cand, BEACON_GLOB)):
            return cand
    return None


# -- beacon writing ----------------------------------------------------------

_seq_lock = locks.make_lock("observability.fleet")
_seq = 0
# singleton periodic writer: token -> role, in registration order
_beacon_tokens: Dict[int, str] = {}
_beacon_thread: Optional[threading.Thread] = None
_beacon_stop: Optional[threading.Event] = None
_beacon_dir: Optional[str] = None
_next_token = 1


def _next_seq() -> int:
    global _seq
    with _seq_lock:
        _seq += 1
        return _seq


def _windows_payload(registry) -> dict:
    """Per-group windowed slices: for every :class:`WindowedHistogram`
    a cumulative-bucket snapshot per fleet window, for every windowed
    counter its per-window delta.  Keys are stringified whole seconds
    ("60", "300") so JSON round-trips exactly."""
    out: dict = {}
    for gname, group in registry.group_items():
        hists: dict = {}
        for key, hist in group.histogram_items():
            if not isinstance(hist, WindowedHistogram):
                continue
            per_window = {}
            for window_s in FLEET_WINDOWS:
                snap = hist.window_snapshot(window_s)
                per_window[str(int(window_s))] = snap
            hists[key] = per_window
        counters: dict = {}
        for key, wc in group.windowed_counter_items():
            counters[key] = {str(int(w)): int(wc.window_delta(w))
                             for w in FLEET_WINDOWS}
        if hists or counters:
            entry: dict = {}
            if hists:
                entry["histograms"] = hists
            if counters:
                entry["counters"] = counters
            out[gname] = entry
    return out


def _gauges_payload(registry) -> dict:
    out: dict = {}
    for gname, group in registry.group_items():
        if not gname.startswith("ml."):
            continue
        snap = group.snapshot()
        if snap.get("gauges"):
            out[gname] = dict(snap["gauges"])
    return out


def _load_payload() -> dict:
    """Point-in-time load row: serving status (when a batcher runs
    here) + elastic participation.  Every probe is best-effort — a
    beacon must never sink the workload it describes."""
    load: dict = {}
    try:
        from flink_ml_tpu_torch.observability.server import get_serving_status

        provider = get_serving_status()
        if provider is not None:
            st = provider() or {}
            queue = st.get("queue") or {}
            load["servable"] = st.get("servable")
            load["queueDepth"] = queue.get("rows")
            load["inFlight"] = st.get("pipeline_depth")
            load["modelVersion"] = st.get("model_version")
            load["canary"] = st.get("canary")
    except Exception:
        pass
    try:
        from flink_ml_tpu_torch.parallel import elastic

        prov = elastic.provenance()
        load["participation"] = prov.get("participationMin")
        load["elasticEvents"] = prov.get("elasticEvents")
    except Exception:
        pass
    try:
        from flink_ml_tpu_torch.observability import profiling

        ready_ms = profiling.boot_to_ready_ms()
        if ready_ms is not None:
            load["bootToReadyMs"] = round(ready_ms, 3)
    except Exception:
        pass
    try:
        # continuous-evaluation quality (observability/evaluation.py):
        # the worst fresh live AUC + feedback coverage, so a half-fleet
        # quality collapse is visible from one `mltrace fleet` call
        from flink_ml_tpu_torch.observability import evaluation

        prov = evaluation.provenance()
        if prov.get("aucLive") is not None:
            load["aucLive"] = prov["aucLive"]
        if prov.get("feedbackCoverage") is not None:
            load["feedbackCoverage"] = prov["feedbackCoverage"]
        if prov.get("labelLagP99Ms") is not None:
            load["labelLagP99Ms"] = prov["labelLagP99Ms"]
    except Exception:
        pass
    return load


def _events_payload() -> list:
    """The last ``elastic.*`` / ``ml.controller`` events from the
    tracer's recent-span ring, oldest first."""
    try:
        from flink_ml_tpu_torch.observability.tracing import tracer

        records = list(tracer.recent)
    except Exception:
        return []
    picked = []
    for record in records:
        for ev in record.get("events", ()):
            name = ev.get("name", "")
            if name.startswith(_EVENT_NAMES[0]) or name == _EVENT_NAMES[1]:
                picked.append({"name": name, "ts_us": ev.get("ts_us"),
                               "attrs": ev.get("attrs", {})})
    return picked[-_EVENT_LIMIT:]


def _process_index() -> int:
    """This process's 0-based index: ``FLINK_ML_TPU_PROCESS_ID``, else
    the ``torch.distributed`` rank while a process group is up, else 0 —
    the JAX package's ``process_index`` sources with the jax runtime's
    index replaced by the process group's rank."""
    raw = os.environ.get(PROCESS_ID_ENV, "").strip()
    if raw:
        try:
            return int(raw)
        except ValueError:
            pass
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def beacon_payload(role: str = "process", registry=None,
                   epoch: Optional[int] = None,
                   now: Optional[float] = None) -> dict:
    """The beacon dict :func:`write_beacon` persists — exposed so tests
    and the live ``/fleet`` route can inspect it without disk."""
    if registry is None:
        registry = metrics
    if now is None:
        now = time.time()
    try:
        from flink_ml_tpu_torch.observability.exporters import safe_process_label

        proc = safe_process_label()
    except Exception:
        proc = None
    try:
        index = int(_process_index())
    except Exception:
        index = 0
    payload = {
        "schema": BEACON_SCHEMA,
        "time": float(now),
        "seq": _next_seq(),
        "pid": os.getpid(),
        "process": proc,
        "processIndex": index,
        "role": role,
        "interval_s": beacon_interval_s(),
    }
    if epoch is not None:
        payload["epoch"] = int(epoch)
    try:
        payload["windows"] = _windows_payload(registry)
    except Exception:
        payload["windows"] = {}
    try:
        payload["gauges"] = _gauges_payload(registry)
    except Exception:
        payload["gauges"] = {}
    payload["load"] = _load_payload()
    payload["events"] = _events_payload()
    return payload


def write_beacon(base_dir: Optional[str] = None, role: str = "process",
                 registry=None, epoch: Optional[int] = None,
                 now: Optional[float] = None) -> Optional[str]:
    """Atomically write this process's beacon into ``base_dir`` (or the
    :func:`fleet_dir` resolution when None).  Returns the path, or None
    when disarmed or on any write failure — liveness reporting must
    never raise into the workload (the elastic ``beat()`` contract)."""
    resolved = base_dir if base_dir is not None else fleet_dir()
    if not resolved:
        return None
    try:
        from flink_ml_tpu_torch.observability.exporters import artifact_suffix

        suffix = artifact_suffix()
    except Exception:
        suffix = str(os.getpid())
    path = os.path.join(resolved, f"fleet-{suffix}.json")
    try:
        payload = beacon_payload(role=role, registry=registry,
                                 epoch=epoch, now=now)
        os.makedirs(resolved, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(payload, fh)
        os.replace(tmp, path)
        return path
    except (OSError, ValueError, TypeError):
        return None


def _beacon_loop(stop: threading.Event) -> None:
    # wait-first: start_beacon already wrote the initial beacon, and an
    # eager write here would race a second start_beacon's joined-role
    # write landing between thread start and the first tick
    while not stop.wait(beacon_interval_s()):
        with _seq_lock:
            base, roles = _beacon_dir, list(_beacon_tokens.values())
        if roles:
            role = "+".join(dict.fromkeys(roles))
            write_beacon(base, role=role)


def start_beacon(role: str = "process",
                 base_dir: Optional[str] = None) -> Optional[int]:
    """Start (or join) the singleton periodic beacon writer under
    ``role``; returns a token for :func:`stop_beacon`, or None when no
    fleet dir resolves (disarmed runtime — nothing to write into).
    Multiple components sharing a process (batcher + controller)
    stack roles: the beacon reports them joined with '+'."""
    global _beacon_thread, _beacon_stop, _beacon_dir, _next_token
    resolved = base_dir if base_dir is not None else fleet_dir()
    if not resolved:
        return None
    with _seq_lock:
        token = _next_token
        _next_token += 1
        _beacon_tokens[token] = role
        _beacon_dir = resolved
        roles = list(_beacon_tokens.values())
        started = _beacon_thread is not None and _beacon_thread.is_alive()
        if not started:
            _beacon_stop = threading.Event()
            _beacon_thread = threading.Thread(
                target=_beacon_loop, args=(_beacon_stop,),
                name="fleet-beacon", daemon=True)
    # first write + thread start outside the lock: never IO under it
    write_beacon(resolved, role="+".join(dict.fromkeys(roles)))
    if not started:
        _beacon_thread.start()
    return token


def stop_beacon(token: Optional[int]) -> None:
    """Release a :func:`start_beacon` registration; the last release
    stops the writer thread after one final beacon (so the stamp a
    clean shutdown leaves behind is as fresh as possible)."""
    if token is None:
        return
    global _beacon_thread, _beacon_stop, _beacon_dir
    with _seq_lock:
        _beacon_tokens.pop(token, None)
        if _beacon_tokens:
            return
        stop, thread = _beacon_stop, _beacon_thread
        base = _beacon_dir
        _beacon_stop = _beacon_thread = None
        _beacon_dir = None
    if stop is not None:
        stop.set()
    if thread is not None and thread.is_alive():
        thread.join(timeout=2.0 * beacon_interval_s())
    write_beacon(base, role="stopped")


# -- beacon reading ----------------------------------------------------------

def _validate_beacon(raw: dict) -> None:
    """All-or-nothing admission: a beacon either parses whole — schema,
    stamp, and every carried window snapshot bucket-valid — or it is
    rejected entirely.  A torn write must never fold partially into a
    fleet aggregate (the ``MetricsRegistry.merge`` discipline)."""
    if not isinstance(raw, dict):
        raise ValueError("beacon is not an object")
    if raw.get("schema") != BEACON_SCHEMA:
        raise ValueError(f"unknown beacon schema {raw.get('schema')!r}")
    float(raw["time"])
    int(raw["pid"])
    int(raw.get("processIndex", 0))
    windows = raw.get("windows", {})
    if not isinstance(windows, dict):
        raise ValueError("beacon windows is not an object")
    for gname, entry in windows.items():
        if not isinstance(entry, dict):
            raise ValueError(f"beacon group {gname!r} is not an object")
        for key, per_window in entry.get("histograms", {}).items():
            if not isinstance(per_window, dict):
                raise ValueError(
                    f"beacon histogram {key!r} windows not an object")
            for snap in per_window.values():
                check_histogram_snapshot(key, snap)
        for key, per_window in entry.get("counters", {}).items():
            if not isinstance(per_window, dict):
                raise ValueError(
                    f"beacon counter {key!r} windows not an object")
            for val in per_window.values():
                int(val)


def member_key(raw: dict) -> str:
    """Stable member identity across relaunches: ``p<index>`` when the
    runtime hands out process labels (a relaunched replica with a new
    pid supersedes its predecessor), else ``pid-<pid>``."""
    proc = raw.get("process")
    if proc is not None:
        return f"p{proc}"
    return f"pid-{raw.get('pid')}"


def read_beacons(base_dir: str) -> Tuple[List[dict], int]:
    """``(beacons, invalid_count)`` from ``base_dir`` — one entry per
    member (newest stamp wins when a relaunch left an older file
    behind), torn/partial/malformed beacons counted but never folded."""
    members: Dict[str, dict] = {}
    invalid = 0
    for path in sorted(glob.glob(os.path.join(base_dir, BEACON_GLOB))):
        try:
            with open(path, encoding="utf-8") as fh:
                raw = json.load(fh)
            _validate_beacon(raw)
        except (OSError, ValueError, TypeError, KeyError):
            invalid += 1
            continue
        key = member_key(raw)
        prev = members.get(key)
        if prev is None or float(raw["time"]) >= float(prev["time"]):
            members[key] = raw
    return list(members.values()), invalid


def fold_snapshots(snaps: List[dict]) -> Optional[dict]:
    """Sum cumulative-bucket snapshots bin-exactly.  Bucket layouts
    must match across members (they do by construction — every process
    runs the same code registering the same buckets); a mismatch raises
    rather than aggregating apples with oranges."""
    folded: Optional[dict] = None
    for snap in snaps:
        if folded is None:
            folded = {"buckets": [float(b) for b in snap["buckets"]],
                      "counts": [int(c) for c in snap["counts"]],
                      "sum": float(snap.get("sum", 0.0)),
                      "count": int(snap.get("count", 0))}
            continue
        check_histogram_snapshot(None, snap, folded["buckets"])
        folded["counts"] = [a + int(b) for a, b
                            in zip(folded["counts"], snap["counts"])]
        folded["sum"] += float(snap.get("sum", 0.0))
        folded["count"] += int(snap.get("count", 0))
    return folded


def _key_matches(key: str, name: str,
                 labels: Optional[Dict[str, str]]) -> bool:
    """Base-name + label-subset match (the slo.py rule: extra labels on
    the series — ``servable=``, ``process=`` — never block a match).
    Lazy imports keep the exporters/health edges one-directional at
    module load."""
    base, _, rest = key.partition("{")
    if base != name:
        return False
    if not labels:
        return True
    from flink_ml_tpu_torch.observability.health import _parse_labels

    got = _parse_labels(rest[:-1] if rest else "")
    return all(got.get(k) == str(v) for k, v in labels.items())


def _pick_window(per_window: Dict[str, object], window_s: float):
    """The carried slice answering a ``window_s`` ask: smallest carried
    window >= the ask (never undercounts), else the largest carried."""
    parsed = sorted((float(w), snap) for w, snap in per_window.items())
    if not parsed:
        return None
    for w, snap in parsed:
        if w >= window_s:
            return snap
    return parsed[-1][1]


class FleetView:
    """Aggregated live view over a fleet directory's beacons:
    membership with staleness classification, bin-exact fleet-level
    windowed quantiles, per-replica load rows.  ``clock`` is injectable
    for tests; classification clamps negative ages to zero so a
    clock-skewed (future-stamped) beacon reads as fresh, never as
    negative-age weirdness."""

    def __init__(self, base_dir: str, stale_s: Optional[float] = None,
                 clock=time.time):
        self.base_dir = base_dir
        self.stale_s = float(stale_s) if stale_s is not None \
            else stale_after_s()
        self.clock = clock
        self.members: List[dict] = []
        self.invalid = 0
        self.refresh()

    def refresh(self) -> None:
        self.members, self.invalid = read_beacons(self.base_dir)

    def _age(self, raw: dict, now: float) -> float:
        return max(0.0, now - float(raw["time"]))

    def classify(self, age_s: float) -> str:
        if age_s <= self.stale_s:
            return "alive"
        if age_s <= 2.0 * self.stale_s:
            return "stale"
        return "dead"

    def membership(self) -> List[dict]:
        """One row per member: identity, role, state, beacon age."""
        now = self.clock()
        rows = []
        for raw in sorted(self.members, key=member_key):
            age = self._age(raw, now)
            rows.append({
                "member": member_key(raw),
                "process": raw.get("process"),
                "processIndex": raw.get("processIndex"),
                "pid": raw.get("pid"),
                "role": raw.get("role"),
                "state": self.classify(age),
                "age_s": round(age, 3),
                "seq": raw.get("seq"),
                "epoch": raw.get("epoch"),
                "interval_s": raw.get("interval_s"),
            })
        return rows

    def alive_members(self) -> List[dict]:
        now = self.clock()
        return [raw for raw in self.members
                if self.classify(self._age(raw, now)) == "alive"]

    def members_missing(self) -> List[str]:
        """Member ids currently stale or dead — the 'half-dead fleet'
        bookkeeping fleet-scope SLO verdicts must surface."""
        now = self.clock()
        return sorted(member_key(raw) for raw in self.members
                      if self.classify(self._age(raw, now)) != "alive")

    # -- SLO source protocol (alive members only) ------------------------
    def hist_window(self, group: str, name: str,
                    labels: Optional[Dict[str, str]],
                    window_s: float) -> Tuple[Optional[dict], str]:
        snaps = []
        contributing = 0
        for raw in self.alive_members():
            entry = raw.get("windows", {}).get(group, {})
            member_snaps = [
                _pick_window(per_window, window_s)
                for key, per_window in entry.get("histograms", {}).items()
                if _key_matches(key, name, labels)]
            member_snaps = [s for s in member_snaps if s is not None]
            if member_snaps:
                contributing += 1
                snaps.extend(member_snaps)
        folded = fold_snapshots(snaps)
        return folded, f"fleet[{contributing}]:{int(window_s)}s"

    def counter_window(self, group: str, name: str,
                       labels: Optional[Dict[str, str]],
                       window_s: float) -> Tuple[float, str]:
        total = 0
        contributing = 0
        for raw in self.alive_members():
            entry = raw.get("windows", {}).get(group, {})
            hit = False
            for key, per_window in entry.get("counters", {}).items():
                if not _key_matches(key, name, labels):
                    continue
                delta = _pick_window(per_window, window_s)
                if delta is not None:
                    total += int(delta)
                    hit = True
            if hit:
                contributing += 1
        return float(total), f"fleet[{contributing}]:{int(window_s)}s"

    def gauge_values(self, group: str, name: str,
                     labels: Optional[Dict[str, str]] = None) -> List[tuple]:
        out = []
        for raw in self.alive_members():
            for key, val in raw.get("gauges", {}).get(group, {}).items():
                if not _key_matches(key, name, labels):
                    continue
                try:
                    out.append((f"{key}@{member_key(raw)}", float(val)))
                except (TypeError, ValueError):
                    continue  # non-numeric gauge: not comparable
        return out

    # -- per-member detail -----------------------------------------------
    def per_member_quantile(self, group: str, name: str,
                            labels: Optional[Dict[str, str]],
                            window_s: float, q: float) -> Dict[str, float]:
        """Member id -> quantile over its OWN carried window — the
        per-replica load signal beside the fleet aggregate."""
        out: Dict[str, float] = {}
        for raw in self.alive_members():
            entry = raw.get("windows", {}).get(group, {})
            snaps = [
                _pick_window(per_window, window_s)
                for key, per_window in entry.get("histograms", {}).items()
                if _key_matches(key, name, labels)]
            folded = fold_snapshots([s for s in snaps if s is not None])
            if folded is not None and folded.get("count", 0) > 0:
                out[member_key(raw)] = histogram_quantile(folded, q)
        return out

    def aggregates(self, window_s: float) -> Dict[str, dict]:
        """Fleet-level p50/p99/count for every windowed histogram any
        alive member carries, keyed ``<group>/<series>`` — the signal
        table load-aware routing will read."""
        by_key: Dict[str, List[dict]] = {}
        for raw in self.alive_members():
            for gname, entry in raw.get("windows", {}).items():
                for key, per_window in entry.get("histograms", {}).items():
                    snap = _pick_window(per_window, window_s)
                    if snap is not None:
                        by_key.setdefault(f"{gname}/{key}", []).append(snap)
        out: Dict[str, dict] = {}
        for full_key, snaps in sorted(by_key.items()):
            try:
                folded = fold_snapshots(snaps)
            except ValueError:
                continue  # drifted layout across members: skip the series
            if folded is None or folded.get("count", 0) <= 0:
                continue
            out[full_key] = {
                "p50": histogram_quantile(folded, 0.50),
                "p99": histogram_quantile(folded, 0.99),
                "count": folded["count"],
                "sum": folded["sum"],
                "members": len(snaps),
            }
        return out

    def load_rows(self) -> List[dict]:
        rows = []
        for raw in sorted(self.members, key=member_key):
            load = raw.get("load", {}) or {}
            rows.append({"member": member_key(raw),
                         "role": raw.get("role"), **load})
        return rows

    def report(self, window_s: float = 60.0) -> dict:
        """The full fleet report the CLI and ``/fleet`` route render."""
        membership = self.membership()
        states = [row["state"] for row in membership]
        return {
            "fleetDir": self.base_dir,
            "time": self.clock(),
            "windowS": window_s,
            "staleS": self.stale_s,
            "members": membership,
            "counts": {"alive": states.count("alive"),
                       "stale": states.count("stale"),
                       "dead": states.count("dead"),
                       "invalid": self.invalid},
            "membersMissing": self.members_missing(),
            "aggregates": self.aggregates(window_s),
            "load": self.load_rows(),
        }


# -- elastic liveness view ---------------------------------------------------

def stale_member_indices(base_dir: str, timeout_s: float,
                         num_processes: Optional[int] = None,
                         now: Optional[float] = None) -> List[int]:
    """Process indices whose beacon stamp is older than ``timeout_s``
    (or missing entirely) — the elastic watchdog's
    ``stale_processes()`` view over the fleet plane.  A member that
    never wrote a beacon is stale by definition: silence IS the
    signal."""
    beacons, _ = read_beacons(base_dir)
    if now is None:
        now = time.time()
    fresh = set()
    seen = set()
    for raw in beacons:
        idx = int(raw.get("processIndex", 0))
        seen.add(idx)
        if max(0.0, now - float(raw["time"])) <= timeout_s:
            fresh.add(idx)
    n = num_processes if num_processes is not None else \
        (max(seen) + 1 if seen else 0)
    return [i for i in range(n) if i not in fresh]


# -- provenance --------------------------------------------------------------

def provenance() -> dict:
    """The fleet fields benchmark rows carry: ``fleetMembers`` (beacon
    count in the resolved fleet dir) and ``fleetP99Ms`` (fleet queueMs
    p99 over 60 s, falling back to transformMs then batchMs).  Both
    None on single-process / disarmed benches — never raises (the
    benchmark provenance contract)."""
    out = {"fleetMembers": None, "fleetP99Ms": None}
    try:
        base = fleet_dir()
        if not base:
            return out
        view = FleetView(base)
        if not view.members:
            return out
        out["fleetMembers"] = len(view.members)
        for series in ("queueMs", "transformMs", "batchMs"):
            snap, _src = view.hist_window("ml.serving", series, None, 60.0)
            if snap is not None and snap.get("count", 0) > 0:
                out["fleetP99Ms"] = histogram_quantile(snap, 0.99)
                break
    except Exception:
        pass
    return out


# -- CLI ---------------------------------------------------------------------

def _fmt_ms(val) -> str:
    if val is None or val != val:  # NaN
        return "-"
    return f"{val:.2f}ms"


def render_report(report: dict) -> str:
    counts = report["counts"]
    lines = [f"fleet {report['fleetDir']} — "
             f"{len(report['members'])} member(s): "
             f"{counts['alive']} alive, {counts['stale']} stale, "
             f"{counts['dead']} dead"
             + (f", {counts['invalid']} invalid beacon(s)"
                if counts["invalid"] else "")]
    if report["members"]:
        lines.append(f"  {'member':<8} {'role':<18} {'state':<6} "
                     f"{'age':>7} {'pid':>7} {'seq':>5}  epoch")
        for row in report["members"]:
            epoch = row.get("epoch")
            lines.append(
                f"  {row['member']:<8} {str(row.get('role')):<18} "
                f"{row['state']:<6} {row['age_s']:>6.1f}s "
                f"{str(row.get('pid')):>7} {str(row.get('seq')):>5}  "
                f"{epoch if epoch is not None else '-'}")
    if report["membersMissing"]:
        lines.append("  missing: " + ", ".join(report["membersMissing"]))
    if report["aggregates"]:
        lines.append(f"windows ({int(report['windowS'])}s, "
                     "alive members, bin-exact fold):")
        for key, agg in report["aggregates"].items():
            lines.append(
                f"  {key:<40} p50={_fmt_ms(agg['p50'])} "
                f"p99={_fmt_ms(agg['p99'])} n={agg['count']} "
                f"members={agg['members']}")
    loaded = [row for row in report["load"]
              if any(row.get(k) is not None for k in
                     ("queueDepth", "inFlight", "servable",
                      "bootToReadyMs", "aucLive"))]
    if loaded:
        lines.append("load:")
        for row in loaded:
            boot = row.get("bootToReadyMs")
            auc = row.get("aucLive")
            cov = row.get("feedbackCoverage")
            lines.append(
                f"  {row['member']:<8} queueDepth="
                f"{row.get('queueDepth')} inFlight={row.get('inFlight')} "
                f"servable={row.get('servable')} "
                f"version={row.get('modelVersion')} "
                f"canary={row.get('canary')}"
                + (f" bootToReadyMs={boot:.0f}" if boot is not None
                   else "")
                + (f" aucLive={auc:.4f}" if auc is not None else "")
                + (f" coverage={cov:.2f}" if cov is not None else ""))
        # the half-fleet collapse view: one line naming the member
        # whose live AUC is worst across the fleet
        quality = [(row["member"], row["aucLive"]) for row in loaded
                   if row.get("aucLive") is not None]
        if quality:
            worst_member, worst_auc = min(quality, key=lambda mv: mv[1])
            lines.append(f"quality: worst live AUC {worst_auc:.4f} "
                         f"({worst_member}, {len(quality)} member(s) "
                         f"reporting)")
    return "\n".join(lines)


def _eval_fleet_slos(view: "FleetView", spec_path: Optional[str]):
    """Fleet-scope SLO verdicts over this view (lazy import — slo.py
    imports fleet for its own fleet-source, this is the reverse edge
    kept function-local)."""
    from flink_ml_tpu_torch.observability import slo as slo_mod

    if spec_path:
        slos = slo_mod.load_specs(spec_path)
    else:
        slos = slo_mod.default_slos()
    # quality rides too: its gauges travel in every beacon's ml.quality
    # group, so a fleet-scope AUC floor evaluates from beacons alone
    slos = [s for s in slos
            if s.kind in ("latency", "error-rate", "quality")]
    for s in slos:
        s.scope = "fleet"
    return slo_mod.evaluate_slos(slos, fleet_view=view)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="flink-ml-tpu-trace fleet",
        description="Live fleet membership + bin-exact windowed "
                    "aggregates from beacon files.")
    parser.add_argument("dir", help="fleet dir (or a trace dir/root "
                                    "holding a fleet/ subdir)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit the report as JSON")
    parser.add_argument("--check", action="store_true",
                        help="exit 4 on a dead member or a violated "
                             "fleet-scope SLO")
    parser.add_argument("--watch", action="store_true",
                        help="re-render every beacon interval until ^C")
    parser.add_argument("--window", type=float, default=60.0,
                        help="aggregation window seconds (default 60)")
    parser.add_argument("--stale-s", type=float, default=None,
                        help="override the staleness threshold")
    parser.add_argument("--spec", default=None,
                        help="JSON SLO spec file evaluated at fleet "
                             "scope under --check")
    parser.add_argument("--latest", action="store_true",
                        help="treat DIR as a root; use its newest "
                             "trace dir")
    args = parser.parse_args(argv)

    try:
        from flink_ml_tpu_torch.observability.exporters import resolve_trace_dir

        root = resolve_trace_dir(args.dir, args.latest)
    except OSError as exc:
        print(f"fleet: {exc}", file=sys.stderr)
        return EXIT_INVALID

    while True:
        base = find_fleet_dir(root)
        if base is None:
            print(f"fleet: no fleet telemetry under {root} "
                  f"(no {BEACON_GLOB} beacons)", file=sys.stderr)
            return EXIT_INVALID
        view = FleetView(base, stale_s=args.stale_s)
        report = view.report(window_s=args.window)
        rc = EXIT_OK
        verdicts = []
        if args.check:
            if report["counts"]["dead"]:
                rc = EXIT_VIOLATION
            try:
                verdicts = _eval_fleet_slos(view, args.spec)
            except (OSError, ValueError) as exc:
                print(f"fleet: bad SLO spec: {exc}", file=sys.stderr)
                return EXIT_INVALID
            if any(not v["ok"] for v in verdicts):
                rc = EXIT_VIOLATION
        if args.as_json:
            if verdicts:
                report = dict(report, slo=verdicts)
            print(json.dumps(report, indent=2, sort_keys=True))
        else:
            print(render_report(report))
            if verdicts:
                from flink_ml_tpu_torch.observability.slo import render_verdicts

                print(render_verdicts(verdicts))
        if not args.watch:
            return rc
        try:
            time.sleep(beacon_interval_s())
        except KeyboardInterrupt:
            return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
