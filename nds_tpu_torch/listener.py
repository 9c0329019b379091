# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Runtime failure listener: the in-process stand-in for the reference's
Scala SparkListener + Py4J bridge (ref: nds/jvm_listener/src/main/scala/com/
nvidia/spark/rapids/listener/TaskFailureListener.scala:27-36 and
nds/python_listener/PythonListener.py:21-61).

The reference registers an in-JVM listener that captures every non-Success
task end reason and fans it out to Python callbacks. Here the execution
engine is in-process, so the bridge collapses to a process-local registry:
failures reported to :class:`Manager` reach every registered listener,
which feed the ``CompletedWithTaskFailures`` status taxonomy in
:mod:`nds_tpu_torch.report`.
"""

from __future__ import annotations

import threading
import traceback
from collections import deque
from dataclasses import dataclass, field


@dataclass
class TaskFailure:
    """One failed/retried unit of work inside an otherwise-running query."""

    where: str        # e.g. "partition 3/8 of hash_join probe"
    reason: str       # exception text / device error
    fatal: bool = False


class FailureListener:
    """Accumulates task-failure reasons for one query run
    (ref: nds/python_listener/PythonListener.py:30-49)."""

    def __init__(self):
        self.failures: list[TaskFailure] = []
        self._lock = threading.Lock()

    def notify(self, where: str, reason: str, fatal: bool = False) -> None:
        with self._lock:
            self.failures.append(TaskFailure(where, reason, fatal))

    def register(self) -> "FailureListener":
        Manager.register(self)
        return self

    def unregister(self) -> None:
        Manager.unregister(self)


class Manager:
    """Fan-out registry (ref: nds/jvm_listener/.../Manager.scala:24-63).

    Listeners are scoped to the thread that registered them: concurrent
    in-process query streams (Throughput Run) each see only their own task
    failures. Failures raised from a thread with no scoped listener (e.g. a
    shared device-runtime callback thread) are recorded in
    ``Manager.unattributed`` for diagnostics but are NOT fanned out — one
    stream's device error must never mark every concurrent stream
    ``CompletedWithTaskFailures``.
    """

    _listeners: list[FailureListener] = []       # (owner_thread_id, listener) pairs
    _owners: list[int] = []
    _lock = threading.Lock()
    # bounded ring (newest kept): a failure storm on an unattributed
    # thread must evict O(1) per record, not O(n) list.pop(0)
    _UNATTRIBUTED_MAX = 1000
    unattributed: deque = deque(maxlen=_UNATTRIBUTED_MAX)

    @classmethod
    def register(cls, listener: FailureListener) -> None:
        with cls._lock:
            if listener not in cls._listeners:
                cls._listeners.append(listener)
                cls._owners.append(threading.get_ident())

    @classmethod
    def unregister(cls, listener: FailureListener) -> None:
        with cls._lock:
            if listener in cls._listeners:
                i = cls._listeners.index(listener)
                cls._listeners.pop(i)
                cls._owners.pop(i)

    @classmethod
    def notify_all(cls, where: str, reason: str, fatal: bool = False) -> None:
        me = threading.get_ident()
        with cls._lock:
            targets = [l for l, o in zip(cls._listeners, cls._owners)
                       if o == me]
            if not targets:
                cls.unattributed.append(TaskFailure(where, reason, fatal))
                return
        for l in targets:
            l.notify(where, reason, fatal)


@dataclass
class StreamEvent:
    """Accounting record for one streamed scan execution: which path served
    it (the chunk pipeline or the eager chunk loop), how many chunks flowed,
    and how many host syncs it charged. Drained per query by the Power Run
    into the per-query summaries (``streamedScans``)."""

    where: str                 # e.g. "store_sales"
    chunks: int
    syncs: int                 # host syncs charged while the scan executed
    path: str                  # "compiled" | "eager"
    reason: str = ""           # why the pipeline was not taken
    rows: int = -1             # survivor rows the pipeline kept (-1 =
    #                            unknown: the eager loop)
    partitions: int = 1        # grace-style partition count (1 = none)
    part_rows: tuple = ()      # per-partition survivor counts
    bytes_h2d: int = -1        # host->device bytes the scan uploaded
    scan_launches: int = 0     # K4 chunk_scan launches of the drive
    probe_launches: int = 0    # K5 join_probe launches of the drive
    kernel_fused_stages: int = 0  # lowered conjuncts (+ the hash stage)
    #                            per K4 launch; 0 = no fused scan pass
    prefetch_stall_ms: float = -1.0  # driver ms BLOCKED on the prefetch
    #                            ring (ring off: the inline slice + encode
    #                            + upload time); -1 = unknown
    graph: str = ""            # how the compiled program ran: "captured",
    #                            "replayed", "uncaptured" (cpu), "eager
    #                            drive", "refused: <reason>"; "" = eager
    shards: int = 1            # shard count of the scan's mesh (1 = none)
    shard_rows: tuple = ()     # per-shard survivor counts
    collectives: int = -1      # all-to-all/psum/all-gather calls of the
    #                            sharded drive (-1 = unsharded or eager)
    bytes_ici: int = -1        # bytes one shard sent through them


_stream_tls = threading.local()


def record_stream_event(where: str, chunks: int, syncs: int, path: str,
                        reason: str = "", rows: int = -1,
                        partitions: int = 1, part_rows=(),
                        bytes_h2d: int = -1, scan_launches: int = 0,
                        probe_launches: int = 0,
                        kernel_fused_stages: int = 0,
                        prefetch_stall_ms: float = -1.0,
                        graph: str = "", shards: int = 1, shard_rows=(),
                        collectives: int = -1,
                        bytes_ici: int = -1) -> None:
    """Engine-side hook (engine/stream.py, sql/planner.py): record how a
    streamed scan executed. Thread-scoped like the sync counters."""
    lst = getattr(_stream_tls, "events", None)
    if lst is None:
        lst = _stream_tls.events = deque(maxlen=1000)
    lst.append(StreamEvent(where, chunks, syncs, path, reason, rows,
                           partitions, tuple(part_rows), bytes_h2d,
                           scan_launches, probe_launches,
                           kernel_fused_stages, prefetch_stall_ms, graph,
                           shards, tuple(shard_rows), collectives,
                           bytes_ici))


def drain_stream_events() -> list:
    """Return and clear the calling thread's streamed-scan events
    (oldest first; the ring keeps the newest 1000)."""
    lst = getattr(_stream_tls, "events", None)
    if not lst:
        return []
    out = list(lst)
    lst.clear()
    return out


def stream_event_json(e: StreamEvent) -> dict:
    """The JSON shape of a StreamEvent in the Power Run's summaries
    (``streamedScans``)."""
    return {
        "table": e.where, "chunks": e.chunks, "syncs": e.syncs,
        "path": e.path, "partitions": e.partitions,
        "scanLaunches": e.scan_launches, "probeLaunches": e.probe_launches,
        **({"rows": e.rows} if e.rows >= 0 else {}),
        **({"partRows": list(e.part_rows)} if e.partitions > 1 else {}),
        **({"shards": e.shards, "shardRows": list(e.shard_rows),
            "collectives": e.collectives, "bytesIci": e.bytes_ici}
           if e.shards > 1 else {}),
        **({"bytesH2d": e.bytes_h2d} if e.bytes_h2d >= 0 else {}),
        **({"kernelStages": e.kernel_fused_stages}
           if e.kernel_fused_stages else {}),
        **({"prefetchStallMs": round(e.prefetch_stall_ms, 3)}
           if e.prefetch_stall_ms >= 0 else {}),
        **({"reason": e.reason} if e.reason else {}),
        **({"graph": e.graph} if e.graph else {}),
    }


def stream_evidence(events) -> dict:
    """Aggregate drained :class:`StreamEvent` objects into the compact
    per-query evidence dict the ledger records: total syncs and chunks,
    upload bytes, partition counts, the pipeline/eager split and the
    fallback reasons — ``ledger.evidence_from_scans`` over the JSON
    shape, for a driver that holds the live events."""
    from nds_tpu_torch.obs.ledger import evidence_from_scans
    return evidence_from_scans([stream_event_json(e) for e in events])


def report_task_failure(where: str, exc: BaseException | str,
                        fatal: bool = False) -> None:
    """Engine-side hook: call on any retried task, capacity retry or
    device error. ``exc`` may be a caught exception or a plain reason
    string (for retries that raised nothing)."""
    if isinstance(exc, BaseException):
        reason = "".join(
            traceback.format_exception_only(type(exc), exc)).strip()
    else:
        reason = str(exc)
    Manager.notify_all(where, reason, fatal)
