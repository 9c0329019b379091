# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Live-metrics plane: the process-local rolling-rollup registry.

Spans, StreamEvents and FaultEvents drain per query into the ledger and
are read back after a run ends. This module is the in-flight half:
counters, gauges and bounded fixed-bucket rolling-window histograms with
deterministic, mergeable p50/p95/p99, cheap enough to feed from the
drivers' loops and exported mid-run to a status file.

Contract:

* **fed only at existing drain points** — the Power Run's per-query
  drain, the bench parent's result loop, the pipeline cache decision and
  the heartbeat. It never reads the device, so it adds no host sync.
* **one shared bucket layout** — every histogram uses the module-level
  geometric edge table (:data:`EDGES`, 8 buckets a decade over
  1e-1..~7.5e7, about 33 % resolution), so snapshots from different
  processes or streams merge by summing bucket counts; a quantile is the
  upper edge of the smallest bucket whose cumulative count reaches the
  rank, which does not depend on merge order
  (:func:`quantile_from_buckets`, :func:`merge_hist_snapshots`).
* **bounded rolling window** — each histogram keeps ``slots``
  epoch-tagged sub-windows of ``window_s / slots`` seconds; recording
  into a slot whose epoch is stale resets it, so memory is fixed and no
  timer thread exists. The injectable ``clock`` makes rotation tests
  deterministic.
* **one lock per registry** — all counter, gauge and histogram state
  belongs to a :class:`Registry` under its single ``_lock``.
* **schema-versioned exports** — snapshots carry ``metricsV``
  (:data:`METRICS_VERSION`); the ledger stamps the same version on
  ``metrics`` records and its loader refuses an unknown one.
* **atomic live file** — :func:`export_live` writes the snapshot to
  ``NDS_TPU_METRICS_FILE`` by write-temp-then-rename: a reader sees a
  complete old file or a complete new one. A literal ``{pid}`` in the
  path expands to the writing process id.

Standard library only: the bench parent, which never imports torch,
imports it as ``nds_tpu_torch.obs.metrics``.
"""

from __future__ import annotations

import json
import math
import os
import sys
import threading
import time

METRICS_VERSION = 1

# canonical metric names the drivers feed (shared vocabulary so the
# rollup helpers, the readers and the docs agree)
QUERY_WALL = "query.wall_ms"
QUEUE_WAIT = "admission.queue_wait_ms"
STALL = "prefetch.stall_ms"
SYNC_WAIT = "query.sync_wait_ms"
# pipeline-cache efficacy (engine/stream.py feeds these at the cache
# decision and at every eviction)
PIPE_HIT = "pipeline.cache.hit"
PIPE_MISS = "pipeline.cache.miss"
PIPE_EVICT = "pipeline.cache.evict"

# the ONE bucket edge table every histogram shares: geometric,
# 8 buckets/decade (~33% resolution), 1e-1 .. 10^7.875 (~21 h in ms).
# Values at or below the first edge land in bucket 0; values past the
# last edge clamp into the final bucket (quantiles saturate at its
# edge instead of inventing precision).
_BUCKETS_PER_DECADE = 8
EDGES = tuple(10.0 ** (i / _BUCKETS_PER_DECADE - 1) for i in range(72))


def bucket_index(value: float) -> int:
    """Index of the smallest edge >= value (clamped into the table)."""
    if not (value > EDGES[0]):          # also catches NaN -> bucket 0
        return 0
    if value >= EDGES[-1]:
        return len(EDGES) - 1
    # geometric edges: the index is a log, not a scan
    i = int(math.ceil((math.log10(value) + 1.0) * _BUCKETS_PER_DECADE))
    # float rounding at an exact edge can land one off either way
    while EDGES[i] < value:
        i += 1
    while i > 0 and EDGES[i - 1] >= value:
        i -= 1
    return i


def bucket_value(index: int) -> float:
    """The quantile value a bucket reports: its upper edge."""
    return EDGES[min(max(index, 0), len(EDGES) - 1)]


def quantile_from_buckets(buckets, q: float):
    """Deterministic quantile over ``{index: count}`` (or ``[[i, n],
    ...]``) bucket counts: the upper edge of the smallest bucket whose
    cumulative count reaches ``ceil(q * total)``. Merge-order
    independent by construction — the answer depends only on the
    summed counts. Returns None on an empty distribution."""
    if not isinstance(buckets, dict):
        buckets = dict(buckets)
    total = sum(buckets.values())
    if total <= 0:
        return None
    rank = max(1, math.ceil(q * total))
    cum = 0
    for i in sorted(buckets):
        cum += buckets[i]
        if cum >= rank:
            return round(bucket_value(i), 6)
    return round(bucket_value(sorted(buckets)[-1]), 6)


def merge_hist_snapshots(snaps):
    """Merge histogram snapshot dicts (the :meth:`Registry.snapshot`
    per-histogram shape) by summing bucket counts and recomputing the
    quantiles — associative and commutative, so cross-stream /
    cross-arm rollups do not depend on merge order. The EWMA is a
    feed-order construct and does not merge; it is omitted."""
    merged = {"count": 0, "sum": 0.0, "min": None, "max": None}
    buckets: dict = {}
    roll_buckets: dict = {}
    roll_count = 0
    roll_sum = 0.0
    window_s = None
    for s in snaps:
        merged["count"] += s.get("count", 0)
        merged["sum"] += s.get("sum", 0.0)
        for bound, key in ((min, "min"), (max, "max")):
            v = s.get(key)
            if v is not None:
                merged[key] = v if merged[key] is None else \
                    bound(merged[key], v)
        for i, n in s.get("buckets", ()):
            buckets[i] = buckets.get(i, 0) + n
        roll = s.get("rolling") or {}
        roll_count += roll.get("count", 0)
        roll_sum += roll.get("sum", 0.0)
        if window_s is None:
            window_s = roll.get("windowS")
        for i, n in roll.get("buckets", ()):
            roll_buckets[i] = roll_buckets.get(i, 0) + n
    merged["sum"] = round(merged["sum"], 6)
    merged["buckets"] = sorted(buckets.items())
    for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
        merged[key] = quantile_from_buckets(buckets, q)
    merged["rolling"] = {
        "windowS": window_s, "count": roll_count,
        "sum": round(roll_sum, 6),
        "buckets": sorted(roll_buckets.items()),
    }
    for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
        merged["rolling"][key] = quantile_from_buckets(roll_buckets, q)
    return merged


class _Hist:
    """One histogram: cumulative bucket counts plus ``n_slots``
    epoch-tagged rolling sub-windows. NOT self-locking — every access
    goes through the owning registry's one dedicated lock."""

    __slots__ = ("count", "sum", "min", "max", "ewma", "buckets",
                 "slots")

    def __init__(self, n_slots: int):
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self.ewma = None
        self.buckets: dict = {}
        # slot = [epoch, count, sum, {bucket: n}]
        self.slots = [[-1, 0, 0.0, {}] for _ in range(n_slots)]

    def record(self, value: float, now: float, slot_s: float,
               alpha: float) -> None:
        i = bucket_index(value)
        self.count += 1
        self.sum += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        self.ewma = value if self.ewma is None else (
            alpha * value + (1.0 - alpha) * self.ewma)
        self.buckets[i] = self.buckets.get(i, 0) + 1
        epoch = int(now // slot_s)
        slot = self.slots[epoch % len(self.slots)]
        if slot[0] != epoch:             # stale sub-window: recycle it
            slot[0] = epoch
            slot[1] = 0
            slot[2] = 0.0
            slot[3] = {}
        slot[1] += 1
        slot[2] += value
        slot[3][i] = slot[3].get(i, 0) + 1

    def rolling(self, now: float, slot_s: float):
        """(count, sum, merged buckets) over the live window."""
        floor = int(now // slot_s) - len(self.slots) + 1
        count = 0
        total = 0.0
        buckets: dict = {}
        for epoch, n, s, b in self.slots:
            if epoch < floor:
                continue
            count += n
            total += s
            for i, bn in b.items():
                buckets[i] = buckets.get(i, 0) + bn
        return count, total, buckets


class Registry:
    """Process-local, thread-safe live-metrics registry. All state is
    instance-scoped under the ONE dedicated ``_lock``; feed methods do
    dict arithmetic only (no IO, no device, no other lock), so holding
    the lock never blocks on anything slower than the GIL."""

    def __init__(self, window_s: float = 60.0, slots: int = 12,
                 clock=time.monotonic, ewma_alpha: float = 0.25):
        self.window_s = max(float(window_s), 1e-3)
        self.n_slots = max(int(slots), 1)
        self.slot_s = self.window_s / self.n_slots
        self.ewma_alpha = ewma_alpha
        self._clock = clock
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._hists: dict = {}

    # -- feeds (called at existing drain/evidence points only) ----------

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        now = self._clock()
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Hist(self.n_slots)
            h.record(float(value), now, self.slot_s, self.ewma_alpha)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    # -- reads ----------------------------------------------------------

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def hist_count(self, name: str) -> int:
        with self._lock:
            h = self._hists.get(name)
            return 0 if h is None else h.count

    def _hist_snapshot(self, h: _Hist, now: float) -> dict:
        count, total, buckets = h.rolling(now, self.slot_s)
        snap = {
            "count": h.count, "sum": round(h.sum, 6),
            "min": h.min, "max": h.max,
            "ewma": None if h.ewma is None else round(h.ewma, 6),
            "buckets": sorted(h.buckets.items()),
            "rolling": {
                "windowS": self.window_s, "count": count,
                "sum": round(total, 6),
                "perMin": round(count * 60.0 / self.window_s, 4),
                "buckets": sorted(buckets.items()),
            },
        }
        for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            snap[key] = quantile_from_buckets(h.buckets, q)
            snap["rolling"][key] = quantile_from_buckets(buckets, q)
        return snap

    def snapshot(self) -> dict:
        """The full schema-versioned state: counters, gauges, and every
        histogram with cumulative + rolling bucket counts and
        deterministic quantiles. Safe to json.dump as-is."""
        now = self._clock()
        with self._lock:
            return {
                "metricsV": METRICS_VERSION,
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "hists": {name: self._hist_snapshot(h, now)
                          for name, h in sorted(self._hists.items())},
            }

    # -- driver rollups (compact, ledger-record sized) ------------------

    def _rolling_stats(self, name: str, now: float):
        h = self._hists.get(name)
        if h is None:
            return None
        count, total, buckets = h.rolling(now, self.slot_s)
        if count == 0:
            return None
        return count, total, buckets, h.ewma

    def query_rollup(self) -> dict:
        """Rolling-window rollup for per-query ``metrics`` ledger
        records and heartbeat notes: queries/min, rolling wall
        quantiles, EWMA wall, queue-wait quantiles, stall share."""
        now = self._clock()
        with self._lock:
            out = {"queries": self._counters.get("queries.total", 0)}
            for key in ("ok", "error", "timeout"):
                n = self._counters.get(f"queries.{key}", 0)
                if n:
                    out[f"{key}Count"] = n
            faults = self._counters.get("faults.total", 0)
            if faults:
                out["faults"] = faults
            # pipeline-cache efficacy (appear only once streaming ran:
            # a dim-only run keeps the record clean)
            for field, name in (("pipeHit", PIPE_HIT),
                                ("pipeMiss", PIPE_MISS),
                                ("pipeEvict", PIPE_EVICT)):
                n = self._counters.get(name, 0)
                if n:
                    out[field] = n
            wall = self._rolling_stats(QUERY_WALL, now)
            if wall is not None:
                count, total, buckets, ewma = wall
                out["qpm"] = round(count * 60.0 / self.window_s, 4)
                out["wallP50Ms"] = quantile_from_buckets(buckets, 0.5)
                out["wallP95Ms"] = quantile_from_buckets(buckets, 0.95)
                out["wallP99Ms"] = quantile_from_buckets(buckets, 0.99)
                if ewma is not None:
                    out["ewmaWallMs"] = round(ewma, 3)
                stall = self._rolling_stats(STALL, now)
                if stall is not None and total > 0:
                    out["stallPct"] = round(100.0 * stall[1] / total, 2)
            queue = self._rolling_stats(QUEUE_WAIT, now)
            if queue is not None:
                out["queueWaitP50Ms"] = quantile_from_buckets(queue[2],
                                                              0.5)
                out["queueWaitP99Ms"] = quantile_from_buckets(queue[2],
                                                              0.99)
            return out

    def heartbeat_rollup(self) -> dict:
        """The two rolling-throughput fields the bench heartbeat rides
        in its progress record and stderr liveness line; {} before the
        first completed query (liveness lines stay clean at startup)."""
        now = self._clock()
        with self._lock:
            wall = self._rolling_stats(QUERY_WALL, now)
            if wall is None:
                return {}
            count, _total, _buckets, ewma = wall
            out = {"qpm": round(count * 60.0 / self.window_s, 2)}
            if ewma is not None:
                out["ewmaWallMs"] = round(ewma, 1)
            return out

    def stream_rollup(self, wall_s: float) -> dict:
        """End-of-stream CUMULATIVE rollup for the per-stream
        ``metrics`` ledger record: QPS, wall quantiles over every
        query, queue-wait quantiles, timeout-shed and fault counts."""
        with self._lock:
            out = {
                "queries": self._counters.get("queries.total", 0),
                "okCount": self._counters.get("queries.ok", 0),
                "errorCount": self._counters.get("queries.error", 0),
                "timeoutShed": self._counters.get("queries.timeout", 0),
                "faults": self._counters.get("faults.total", 0),
                "wallS": round(max(wall_s, 0.0), 3),
            }
            if wall_s > 0:
                out["qps"] = round(out["queries"] / wall_s, 4)
                out["qpm"] = round(out["qps"] * 60.0, 2)
            for field, name in (("pipeHit", PIPE_HIT),
                                ("pipeMiss", PIPE_MISS),
                                ("pipeEvict", PIPE_EVICT)):
                n = self._counters.get(name, 0)
                if n:
                    out[field] = n
            h = self._hists.get(QUERY_WALL)
            if h is not None and h.count:
                out["wallP50Ms"] = quantile_from_buckets(h.buckets, 0.5)
                out["wallP95Ms"] = quantile_from_buckets(h.buckets, 0.95)
                out["wallP99Ms"] = quantile_from_buckets(h.buckets, 0.99)
                out["wallMeanMs"] = round(h.sum / h.count, 3)
            queue = self._hists.get(QUEUE_WAIT)
            if queue is not None and queue.count:
                out["queueWaitP50Ms"] = quantile_from_buckets(
                    queue.buckets, 0.5)
                out["queueWaitP99Ms"] = quantile_from_buckets(
                    queue.buckets, 0.99)
                out["queueWaitMaxMs"] = round(queue.max, 3)
            stall = self._hists.get(STALL)
            if stall is not None and stall.count:
                out["stallMs"] = round(stall.sum, 3)
            return out


# the process-default registry every feed point shares. A plain
# import-time binding (no env read, no lazy singleton lock): the
# object itself is the synchronization point, and tests swap state via
# default().reset(), never by rebinding.
_DEFAULT = Registry()


def default() -> Registry:
    """The process-local default registry (one per driver process; a
    Throughput stream is a process, so per-stream == per-registry)."""
    return _DEFAULT


def export_live(path: str | None = None, registry: Registry | None = None,
                extra: dict | None = None) -> str | None:
    """Atomically replace the live status file with the current
    snapshot. ``path`` defaults to ``NDS_TPU_METRICS_FILE`` (read at
    call time — the env-freeze rule); unset means metrics export is
    off and the call is a cheap no-op. ``{pid}`` in the path expands
    to this process id so concurrent streams sharing one env write
    distinct files. Returns the path written, or None."""
    path = path or os.environ.get("NDS_TPU_METRICS_FILE")
    if not path:
        return None
    path = path.replace("{pid}", str(os.getpid()))
    reg = registry if registry is not None else default()
    doc = reg.snapshot()
    doc["t"] = time.time()
    if extra:
        doc.update(extra)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(doc, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError as exc:
        # a full disk or a yanked mount must never kill the driver the
        # live file merely watches; the stale file stays readable
        print(f"# live metrics export failed ({exc}); continuing",
              file=sys.stderr)
        return None
    return path
