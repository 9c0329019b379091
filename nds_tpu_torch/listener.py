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
