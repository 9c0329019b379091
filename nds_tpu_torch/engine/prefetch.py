# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Bounded prefetch ring: the asynchronous ingest half of the streamed path.

A single WORKER thread pulls upcoming chunks from the source iterator
(``ChunkedTable.host_chunks`` — the arrow slice and narrow encode into
pinned host buffers — or the eager loop's ``device_chunks``), applies the
caller's ``prepare`` step (the upload) and hands the ready payloads through
a bounded queue:

* the queue depth (the ``prefetch_depth`` setting, read when the ring is
  built, default 2) is the BACKPRESSURE bound: the worker blocks once
  ``depth`` prepared chunks are waiting, so the ring's extra live set is
  ``depth x chunk bytes`` — the term the accumulator sizing prices;
* delivery is ORDERED (one worker, one FIFO queue);
* ``close()`` signals the worker, drains the queue so a blocked ``put``
  wakes, and joins the thread — the drive loops call it from ``finally``;
* a worker exception rides the queue and re-raises on the driver at the
  next fetch.

CUDA uploads (:func:`upload_async`): the worker copies from pinned buffers
with ``non_blocking=True`` on a side stream and records an event; the
payload is an :class:`Upload`. When the driver fetches it, its current
stream waits on that event (no host wait) and every uploaded tensor gets
``record_stream`` on the driver's stream, so the caching allocator does not
hand the memory out again before the driver's work on it is done.

``depth <= 0`` disables the ring: :func:`chunk_ring` returns an inline pump
that runs ``prepare`` on the driver thread at each fetch — the same chunks,
bit for bit.

Contract for ``prepare`` and the source iterator: NO host reads and NO
spans (the worker has its own thread-local counters; a sync there would
vanish from the driver's accounting).

The driver's blocked time on the ring accumulates in ``stall_ns`` — the
``prefetchStallMs`` of each streamed scan. With the ring off it holds the
inline slice + encode + upload time instead.

Faults: each prepare step runs behind the ``prefetch`` seam
(engine/faults.py) with its bounded retry, on the worker or inline. A
retry that recovers on the worker records its event through the ring,
which re-records it on the driver thread at the next fetch, so it lands
in the statement's own ``faultEvents``.
"""

from __future__ import annotations

import queue
import threading
import time

import torch

from nds_tpu_torch.engine import faults as _F

_ITEM = "item"
_DONE = "done"
_ERR = "err"

# how long a blocked worker put waits between shutdown checks
_PUT_POLL_S = 0.05


def prefetch_depth() -> int:
    """The calling statement's ``prefetch_depth`` setting (chunks the
    worker may run ahead of the driver; ``<= 0``: inline)."""
    from nds_tpu_torch.engine.settings import setting
    return int(setting("prefetch_depth"))


class Upload:
    """A payload whose device tensors were copied on a side stream:
    ``value`` is what the consumer gets, ``tensors`` the device tensors
    the copies wrote, ``event`` the event recorded after them (a list of
    events, one a device, for a payload joined from several devices'
    uploads)."""

    __slots__ = ("value", "tensors", "event")

    def __init__(self, value, tensors, event):
        self.value, self.tensors, self.event = value, tensors, event

    @staticmethod
    def joined(parts, value):
        """One payload ``value`` from several uploads (one a device);
        ``value`` itself when none of ``parts`` is an Upload (the CPU)."""
        ups = [u for u in parts if isinstance(u, Upload)]
        if not ups:
            return value
        return Upload(value, [t for u in ups for t in u.tensors],
                      [e for u in ups for e in _events(u.event)])

    def consume(self):
        """Order the caller's current stream (on each upload's device)
        after the upload (a device wait, not a host one) and return
        ``value``."""
        for ev in _events(self.event):
            torch.cuda.current_stream(ev.device).wait_event(ev)
        for t in self.tensors:
            t.record_stream(torch.cuda.current_stream(t.device))
        return self.value


def _events(event) -> list:
    return list(event) if isinstance(event, (list, tuple)) else [event]


def value_of(payload):
    """The value of an Upload, or the payload itself."""
    return payload.value if isinstance(payload, Upload) else payload


def upload_async(device, side_stream, copy):
    """Run ``copy()`` (which uploads from pinned host buffers with
    ``non_blocking=True`` and returns ``(value, device tensors)``) on
    ``side_stream`` and wrap the result as an :class:`Upload`. On the CPU
    it just returns ``copy()``'s value."""
    if torch.device(device).type != "cuda":
        return copy()[0]
    with torch.cuda.stream(side_stream):
        value, tensors = copy()
        event = torch.cuda.Event()
        event.record(side_stream)
    return Upload(value, tensors, event)


def _deliver(payload):
    return payload.consume() if isinstance(payload, Upload) else payload


def _prepare_guarded(prepare, item):
    """One prepare attempt behind the ``prefetch`` fault seam (a
    ``device-put`` injection fires inside ``prepare`` itself)."""
    _F.fault_point("prefetch")
    return item if prepare is None else prepare(item)


class _InlineRing:
    """Depth-0 pump: same interface, no thread — ``prepare`` runs on the
    driver at each fetch. ``stall_ns`` then measures the inline host fetch
    (slice + encode + upload)."""

    def __init__(self, it, prepare=None):
        self._it = iter(it)
        self._prepare = prepare
        self.stall_ns = 0

    def next_chunk(self):
        t0 = time.perf_counter_ns()
        try:
            item = next(self._it, None)
            if item is None:
                return None
            return _deliver(_F.with_retry(
                "prefetch", lambda: _prepare_guarded(self._prepare, item)))
        finally:
            self.stall_ns += time.perf_counter_ns() - t0

    def stall_ms(self) -> float:
        return self.stall_ns / 1e6

    def close(self) -> None:
        self._it = iter(())


class ChunkRing:
    """Bounded, ordered, single-worker prefetch ring over one chunk
    iterator. See the module docstring for the contract."""

    def __init__(self, it, prepare=None, depth=2, name="nds-prefetch"):
        self._q: queue.Queue = queue.Queue(maxsize=max(int(depth), 1))
        self._stop = threading.Event()
        self._exhausted = False
        self.stall_ns = 0
        # recovery events of the worker, re-recorded on the driver
        self._faults: list = []
        self._faults_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._work, args=(iter(it), prepare), daemon=True,
            name=name)
        self._thread.start()

    def _put(self, payload) -> bool:
        """Backpressure-bounded put that stays responsive to shutdown:
        False when the ring closed while waiting."""
        while not self._stop.is_set():
            try:
                self._q.put(payload, timeout=_PUT_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _sink(self, seam, action, attempt=0, detail=""):
        """The worker's FaultEvent sink: fault events are thread-scoped,
        so the worker parks them here for the driver."""
        with self._faults_lock:
            self._faults.append((seam, action, attempt, detail))

    def _drain_worker_faults(self) -> None:
        """Re-record the worker's recovery events on the driver thread."""
        with self._faults_lock:
            got, self._faults[:] = list(self._faults), []
        for (seam, action, attempt, detail) in got:
            _F.record_fault_event(seam, action, attempt=attempt,
                                  detail=detail)

    def _work(self, it, prepare) -> None:
        try:
            for item in it:
                if self._stop.is_set():
                    return
                # exhausted or non-transient errors ride the queue and
                # re-raise at the driver's next fetch
                payload = _F.with_retry(
                    "prefetch", lambda i=item: _prepare_guarded(prepare, i),
                    record=self._sink)
                if not self._put((_ITEM, payload)):
                    return
            self._put((_DONE, None))
        except BaseException as exc:  # propagate to the driver, always
            self._put((_ERR, exc))

    def next_chunk(self):
        """Next prepared payload, or None at end of stream. Re-raises a
        worker exception. The blocked wait accumulates in ``stall_ns``."""
        if self._exhausted:
            return None
        t0 = time.perf_counter_ns()
        kind, value = self._q.get()
        self.stall_ns += time.perf_counter_ns() - t0
        self._drain_worker_faults()
        if kind is _ITEM:
            return _deliver(value)
        self._exhausted = True
        if kind is _ERR:
            self.close()
            raise value
        return None

    def stall_ms(self) -> float:
        return self.stall_ns / 1e6

    def close(self) -> None:
        """Clean shutdown (idempotent): signal the worker, drain the queue
        so a blocked put wakes, join the thread, and re-record any
        recovery event still parked (a fault on the last chunk)."""
        self._stop.set()
        self._exhausted = True
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=60.0)
        self._drain_worker_faults()


def chunk_ring(it, prepare=None, depth=None, name="nds-prefetch"):
    """The ring the drive loops use: a :class:`ChunkRing` when the depth
    (default: the ``prefetch_depth`` setting) is positive, the inline pump
    otherwise."""
    d = prefetch_depth() if depth is None else int(depth)
    if d <= 0:
        return _InlineRing(it, prepare)
    return ChunkRing(it, prepare, depth=d, name=name)
