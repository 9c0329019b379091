# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Zero-sync span tracing: the engine-side half of the obs layer.

A span is a host-clock interval (``time.perf_counter_ns`` at enter/exit)
with the thread's sync accounting deltas attached: host syncs charged,
nanoseconds blocked on device->host reads, and kernel-build (nvcc)
nanoseconds — all read from the counters :mod:`nds_tpu_torch.engine.ops`
already maintains, so opening a span never touches the device. Sync-site
events (:class:`SyncSite`) are emitted by ``ops.host_read`` itself when a
fetch actually charged syncs, carrying the first-class call-site tag that
``tools/sync_profile.py`` used to recover by monkeypatching.

Scoping mirrors :class:`nds_tpu_torch.listener.Manager`: records land in the
ring of the thread that produced them (concurrent Throughput streams each
drain only their own), and a span finished on a thread that never
attached a ring (e.g. a shared device-runtime callback thread) lands in
the module-level :data:`unattributed` diagnostics deque instead of
leaking or cross-charging a stream.
"""

from __future__ import annotations

import threading
import time
from collections import deque

# ring capacity per thread: diagnostics, never unbounded; drivers drain
# per query
_RING_MAX = 8192

_tls = threading.local()

# spans/sync events from threads with no attached ring (mirrors
# Manager.unattributed: never fanned into another stream's drain)
unattributed: deque = deque(maxlen=1000)

_E = None


def _ops():
    """Late-bound engine.ops (ops imports this module at its top, so the
    reverse import must happen after both modules exist)."""
    global _E
    if _E is None:
        from nds_tpu_torch.engine import ops
        _E = ops
    return _E


def attach() -> None:
    """Give the calling thread its own span ring (idempotent). Called by
    ``Session.sql`` so every query-executing thread is scoped; a record
    finished on a never-attached thread goes to :data:`unattributed`."""
    if getattr(_tls, "ring", None) is None:
        _tls.ring = deque(maxlen=_RING_MAX)


def drain_spans() -> list:
    """Return and clear the calling thread's trace records (spans and
    sync-site events, completion order). Attaches the thread."""
    attach()
    out = list(_tls.ring)
    _tls.ring.clear()
    return out


def _emit(rec) -> None:
    ring = getattr(_tls, "ring", None)
    if ring is None:
        unattributed.append(rec)
    else:
        ring.append(rec)


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def attributed() -> tuple:
    """(syncs, wait_ns) already attributed to sync-site events on this
    thread — ``ops.host_read`` subtracts these so a fetch that re-enters
    ``host_read`` (nested reads) charges each site exactly once."""
    return (getattr(_tls, "attr_syncs", 0), getattr(_tls, "attr_wait", 0))


class SyncSite:
    """One host_read fetch that charged host syncs: the first-class form
    of tools/sync_profile.py's call-site attribution."""

    __slots__ = ("tag", "site", "syncs", "wait_ns", "ts_ns", "depth")

    def __init__(self, tag, site, syncs, wait_ns, ts_ns, depth):
        self.tag = tag            # host_read tag ("sync", "counts3", ...)
        self.site = site          # "file.py:lineno:function" above ops.py
        self.syncs = syncs
        self.wait_ns = wait_ns
        self.ts_ns = ts_ns
        self.depth = depth

    def __repr__(self):
        return (f"SyncSite({self.tag!r}, {self.site!r}, "
                f"syncs={self.syncs})")


def note_sync(tag: str, syncs: int, wait_ns: int, site: str) -> None:
    """Record one sync-charging host read (called from ``ops.host_read``
    only when ``syncs`` not already attributed by a nested read)."""
    _tls.attr_syncs = getattr(_tls, "attr_syncs", 0) + syncs
    _tls.attr_wait = getattr(_tls, "attr_wait", 0) + wait_ns
    _emit(SyncSite(tag, site, syncs, wait_ns, time.perf_counter_ns(),
                   len(_stack())))


class SpanRecord:
    """One finished span. ``syncs``/``sync_wait_ns``/``compile_ns`` are
    deltas of the thread's existing ops counters over the span (children
    included — it is a tree, readers subtract for self-time)."""

    __slots__ = ("name", "attrs", "ts_ns", "dur_ns", "syncs",
                 "sync_wait_ns", "compile_ns", "depth", "dropped",
                 "_s0", "_w0", "_c0")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.ts_ns = 0
        self.dur_ns = 0
        self.syncs = 0
        self.sync_wait_ns = 0
        self.compile_ns = 0
        self.depth = 0
        self.dropped = False

    def set(self, **kw) -> None:
        """Attach counters/labels mid-span (chunks=…, cache="hit", …)."""
        self.attrs.update(kw)

    def drop(self) -> None:
        """Discard this span: it still unwinds normally at ``__exit__``
        but is never emitted. For spans whose subject turns out not to
        exist — e.g. the drive loop's ``stream.prefetch`` stall span
        when the ring reports end-of-stream: there was no chunk, so
        there must be no span record for one."""
        self.dropped = True

    def __enter__(self) -> "SpanRecord":
        E = _ops()
        st = _stack()
        self.depth = len(st)
        st.append(self)
        self._s0 = E.sync_count()
        self._w0 = E.sync_wait_ns()
        self._c0 = E.compile_ns()
        self.ts_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.dur_ns = time.perf_counter_ns() - self.ts_ns
        E = _ops()
        self.syncs = E.sync_count() - self._s0
        self.sync_wait_ns = E.sync_wait_ns() - self._w0
        self.compile_ns = E.compile_ns() - self._c0
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:                  # defensive: mis-nested exits
            st.remove(self)
        if not self.dropped:
            _emit(self)
        return False

    def __repr__(self):
        return (f"SpanRecord({self.name!r}, {self.dur_ns / 1e6:.3f}ms, "
                f"syncs={self.syncs}, attrs={self.attrs})")


class _NullSpan:
    """Shared no-op span, for a site that opens a span only sometimes
    (the planner's nested plans)."""

    __slots__ = ()

    def set(self, **kw) -> None:
        pass

    def drop(self) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


def span(name: str, **attrs):
    """Open a nestable span on the calling thread. Usage::

        with obs.span("stream.drive", chunk=i) as sp:
            ...
            sp.set(rows=n)

    Zero host syncs by construction: enter/exit read the host clock and
    the thread's existing sync/wait/compile counters, nothing else. Under
    a replay (the streamed pipeline's per-chunk program, a replayed
    statement) it is a no-op: the replay's phases are the pipeline's own
    ``stream.*`` spans and the whole-statement ``replay.record``,
    ``replay.compile`` and ``replay.drive`` spans, which engine/replay.py
    and the session open outside the replayed region."""
    if _ops().replay_mode() == "replay":
        return NULL_SPAN
    return SpanRecord(name, attrs)


def annotate(**attrs) -> None:
    """Set attributes on the innermost OPEN span of the calling thread
    (no-op when none is open, and under a replay) — lets a callee deep in
    the engine label the span its caller opened (the streaming executor
    stamping its path and chunk counts on the planner's ``stream``
    span)."""
    if _ops().replay_mode() == "replay":
        return
    st = getattr(_tls, "stack", None)
    if st:
        st[-1].attrs.update(attrs)


