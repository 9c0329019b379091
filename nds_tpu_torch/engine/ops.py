# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Structural relational operators over DeviceTable, on torch tensors.

All grouping and joining is sort-based on device: stable sorts, run
boundaries and segment reductions (collision-free), with searchsorted
probes for the join build/probe phases. The grouped aggregations run on the
hand-written kernels of :mod:`nds_tpu_torch.engine.kernels`.

Shape discipline: every materialization pads its row count up to a
power-of-two bucket (:func:`bucket_len`), with valid rows in a prefix
(``DeviceTable.nrows`` logical rows out of ``plen`` physical). Data past the
logical count is garbage that every operator ignores: joins hash pad rows to
unmatchable sentinels, grouping gives them a discardable trailing group, and
sorts order them last.

Host reads: every device->host read (``.item()``, ``.cpu()``,
``.tolist()``) goes through :func:`host_read`, and the ones that block are
counted per thread (:func:`sync_count`, :func:`sync_wait_ns`).

Hashes are 64-bit and unsigned in meaning but computed in int64: torch has
no logical right shift on int64 and no unsigned sort or searchsorted on the
CPU, so a logical shift masks the arithmetic one and unsigned order is
signed order after flipping bit 63.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

import numpy as np
import torch

from nds_tpu_torch.engine import faults as _faults
from nds_tpu_torch.engine import prim
from nds_tpu_torch.engine import settings as _settings
from nds_tpu_torch.engine.column import Column, encs_equal, is_dec
from nds_tpu_torch.engine.table import DeviceTable
from nds_tpu_torch.obs import trace as _trace

I64 = torch.int64
F64 = torch.float64

# ---------------------------------------------------------------------------
# bucketed shapes
# ---------------------------------------------------------------------------


# the bucket floor and rule (engine/settings.py, which the host-only
# static models share)
_MIN_BUCKET = _settings.MIN_BUCKET
bucket_len = _settings.bucket_len


# ---------------------------------------------------------------------------
# the execution device and host-sync accounting (thread-local: concurrent
# streams each count their own syncs)
# ---------------------------------------------------------------------------

_sync_tls = threading.local()


def device() -> torch.device:
    """The calling thread's execution device (set by the Session around
    every statement; ``cpu`` when none is set)."""
    return getattr(_sync_tls, "device", None) or torch.device("cpu")


class _OnDevice:
    def __init__(self, dev, conf=None, pool=None, graph=True):
        self.dev = torch.device(dev)
        self.conf = conf
        self.pool, self.graph = pool, graph

    def __enter__(self):
        t = _sync_tls
        self._prev = (getattr(t, "device", None), _settings.statement_conf(),
                      getattr(t, "graph_pool", None),
                      getattr(t, "stream_graph", True))
        t.device = self.dev
        if self.conf is not None:
            _settings.use_conf(self.conf)
        t.graph_pool, t.stream_graph = self.pool, self.graph
        return self.dev

    def __exit__(self, *exc):
        t = _sync_tls
        t.device, conf, t.graph_pool, t.stream_graph = self._prev
        _settings.use_conf(conf)


@contextlib.contextmanager
def device_scope(dev):
    """Context: new tensors of the enclosed operators go to ``dev`` (one
    shard's device), and on cuda ``dev`` is the current device, so the
    hand-written kernels (launched through ctypes, with no device guard
    of their own) run on the card their tensors and stream belong to;
    everything else of the calling statement stays."""
    t = _sync_tls
    prev = getattr(t, "device", None)
    t.device = torch.device(dev)
    guard = torch.cuda.device(t.device) if t.device.type == "cuda" \
        else contextlib.nullcontext()
    try:
        with guard:
            yield t.device
    finally:
        t.device = prev


def on_device(dev, conf=None, pool=None, graph=True):
    """Context: run the enclosed operators on ``dev``, with the session's
    ``conf`` answering :func:`setting` (the caller's conf stays when
    ``conf`` is None). ``pool`` (a callable returning a CUDA graph pool
    handle) is where captured graphs allocate; ``graph`` False runs a
    streamed statement's per-chunk program from Python on every chunk
    instead of replaying its captured graph (engine/stream.py)."""
    return _OnDevice(dev, conf, pool, graph)


def graph_pool():
    """The calling statement's CUDA graph pool handle (the session's),
    or None when no session gave one."""
    pool = getattr(_sync_tls, "graph_pool", None)
    return pool() if pool is not None else None


def stream_graph() -> bool:
    """Whether the calling statement replays its streamed per-chunk
    programs as captured graphs (see :func:`on_device`)."""
    return getattr(_sync_tls, "stream_graph", True)


# the streamed path's settings live in the torch-free engine/settings.py
# (read by the host-only static models too); ``setting`` answers the
# calling statement's value
setting = _settings.setting
STREAM_DEFAULTS = _settings.STREAM_DEFAULTS
SETTING_ENV = _settings.SETTING_ENV


def add_syncs(n: int = 1) -> None:
    """Charge ``n`` host syncs to the calling thread's stream."""
    _sync_tls.count = getattr(_sync_tls, "count", 0) + n


def sync_count() -> int:
    """Host syncs counted on the calling thread so far."""
    return getattr(_sync_tls, "count", 0)


def add_sync_wait(ns: int) -> None:
    """Charge nanoseconds spent BLOCKED on a device->host read."""
    _sync_tls.wait_ns = getattr(_sync_tls, "wait_ns", 0) + ns


def sync_wait_ns() -> int:
    return getattr(_sync_tls, "wait_ns", 0)


def add_fetch_bytes(n: int) -> None:
    """Record device->host result bytes (collect()/to_arrow transfers)."""
    _sync_tls.fetch_bytes = getattr(_sync_tls, "fetch_bytes", 0) + n


def fetch_bytes() -> int:
    return getattr(_sync_tls, "fetch_bytes", 0)


def add_compile_ns(ns: int) -> None:
    """Charge kernel-build (nvcc) and graph-capture nanoseconds to the
    calling thread."""
    _sync_tls.compile_ns = getattr(_sync_tls, "compile_ns", 0) + ns


def compile_ns() -> int:
    """Nanoseconds of kernel building and graph capture on the calling
    thread."""
    return getattr(_sync_tls, "compile_ns", 0)


def _sync_site() -> str:
    """First non-ops engine frame above the fetch — the call-site tag
    every sync-charging host read carries into the trace layer."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if "nds_tpu_torch" in fn and not fn.endswith("ops.py"):
            return (f"{os.path.basename(fn)}:{f.f_lineno}:"
                    f"{f.f_code.co_name}")
        f = f.f_back
    return "?"


# --------------------------------------------------------------------------
# record / replay: every host read the engine performs routes through
# host_read(), so a statement fragment can be RECORDED once (an eager run
# that logs its host decisions) and then REPLAYED with the log answering
# every host read, touching no device value on the host. The streamed
# chunk pipeline (engine/stream.py) records its per-chunk join graph on the
# first chunk and replays it on every chunk.
# --------------------------------------------------------------------------


class ReplayMismatch(RuntimeError):
    """The replay consumed host reads in a different order than the
    recording — the fragment is not replay-safe; callers fall back eager."""


# --------------------------------------------------------------------------
# stream-bounds mode: the streamed executor replays ONE per-chunk program
# for every chunk of a ChunkedTable, so the program must be CHUNK-INVARIANT
# — no host decision may depend on a chunk's data. Inside a stream-bounds
# region:
#   * host scalar syncs raise StreamSyncError (the executor falls back to
#     the eager chunk loop — correctness never depends on streamability);
#   * joins size their pair buckets from STATIC bounds instead of a
#     data-dependent sizing sync, registering a device-side overflow
#     predicate via stream_overflow() that the executor checks once at the
#     pipeline's single materializing sync (overflow => rerun eager);
#   * lazy compaction never takes the adaptive resolve.
# Host reads against NON-streamed inputs (dimension key maps/ranges) stay
# legal: they are chunk-invariant and ride the replay log.
# --------------------------------------------------------------------------


class StreamSyncError(RuntimeError):
    """A chunk-data-dependent host sync was reached inside a stream-bounds
    region; the statement's join graph is not streamable through the
    chunk pipeline."""


def stream_bounds_on() -> bool:
    return getattr(_sync_tls, "stream_bounds", False)


class _StreamBoundsSession:
    def __enter__(self):
        self._prev = (stream_bounds_on(),
                      getattr(_sync_tls, "stream_flags", None))
        _sync_tls.stream_bounds = True
        self.flags: list = []
        _sync_tls.stream_flags = self.flags
        return self

    def __exit__(self, *exc):
        _sync_tls.stream_bounds, _sync_tls.stream_flags = self._prev
        _sync_tls.eval_table = None     # noted inside; held no longer


def stream_bounds():
    """Context: execute with chunk-invariant (bound-derived) shape
    decisions; ``.flags`` collects the device-side overflow predicates the
    region registered."""
    return _StreamBoundsSession()


# whole-column host reads whose results the replay log serves like a
# dimension read (replay._LIFTABLE). Over rows that derive from the
# streamed chunk, a replay would hand every chunk the first chunk's
# values: inside a stream-bounds region they are legal only while an
# expression evaluates over a table the per-chunk program holds
# chunk-invariant.
_CHUNK_HAZARD_READS = frozenset(("date_part", "month_arith", "cast_str",
                                 "concat"))


class _ChunkInvariant:
    def __init__(self, tables):
        self.tables = list(tables)

    def __enter__(self):
        self._prev = getattr(_sync_tls, "invariant_tables", ())
        _sync_tls.invariant_tables = self.tables
        return self

    def __exit__(self, *exc):
        _sync_tls.invariant_tables = self._prev


def chunk_invariant(tables):
    """Context: ``tables`` (the per-chunk program's non-streamed parts)
    hold no chunk data; an expression evaluated over any other table
    inside a stream-bounds region is chunk-derived."""
    return _ChunkInvariant(tables)


def note_eval_table(table) -> None:
    """The table an expression is being evaluated over (the planner
    notes it inside stream-bounds regions)."""
    _sync_tls.eval_table = table


def _refuse_chunk_read(tag: str) -> None:
    """Raise :class:`StreamSyncError` for a hazard read of chunk-derived
    rows while a per-chunk program records (a replay serves only what a
    record allowed)."""
    if tag not in _CHUNK_HAZARD_READS or not stream_bounds_on() \
            or replay_mode() == "replay":
        return
    t = getattr(_sync_tls, "eval_table", None)
    if not any(t is x for x in getattr(_sync_tls, "invariant_tables", ())):
        raise StreamSyncError(
            f"{tag}: a whole-column host read of chunk-derived rows inside "
            "a stream-bounds region (its logged value would serve every "
            "chunk)")


def stream_overflow(pred) -> None:
    """Register a device bool scalar that is True when a bound-sized
    bucket overflowed (rows silently dropped). The streaming executor ORs
    every flag into its accumulated overflow bit; outside a stream-bounds
    region this is a no-op."""
    flags = getattr(_sync_tls, "stream_flags", None)
    if flags is not None:
        flags.append(pred)


class _OuterMatchCollector:
    """Collects the per-dispatch matched-build-row masks an outer-build
    join registers: the streamed pipeline ORs them into a device-resident
    unmatched-key accumulator so the outer-extras rows can be emitted
    once, at materialize time."""

    def __enter__(self):
        self._prev = getattr(_sync_tls, "stream_outer", None)
        self.masks: list = []
        _sync_tls.stream_outer = self.masks
        return self

    def __exit__(self, *exc):
        _sync_tls.stream_outer = self._prev


def outer_match_collector():
    return _OuterMatchCollector()


def stream_outer_matched(mask) -> None:
    """Register the device bool vector of build-side rows the current
    outer-build join dispatch matched. No-op outside a collector region."""
    lst = getattr(_sync_tls, "stream_outer", None)
    if lst is not None:
        lst.append(mask)


class _SuspendStreamRecord:
    """Escape hatch for CHUNK-INVARIANT inner plans reached from inside a
    streamed pipeline's record phase (subquery residuals): restores plain
    eager execution — replay log detached, stream-bounds off (the inner
    plan runs ONCE, not per chunk, and may sync), and a FRESH pending
    count/check list so the inner's batched resolutions never drain counts
    the outer record phase still owes its log."""

    def __enter__(self):
        t = _sync_tls
        self._saved = (
            replay_mode(), getattr(t, "replay_log", None),
            getattr(t, "replay_cursor", 0),
            getattr(t, "replay_operands", None),
            stream_bounds_on(), getattr(t, "stream_flags", None),
            getattr(t, "stream_outer", None),
            getattr(t, "pending", None), getattr(t, "checks", None))
        t.replay_mode = "off"
        t.replay_log = None
        t.replay_cursor = 0
        t.replay_operands = None
        t.stream_bounds = False
        t.stream_flags = None
        t.stream_outer = None
        t.pending = []
        t.checks = []
        return self

    def __exit__(self, *exc):
        t = _sync_tls
        (t.replay_mode, t.replay_log, t.replay_cursor, t.replay_operands,
         t.stream_bounds, t.stream_flags, t.stream_outer,
         t.pending, t.checks) = self._saved


def suspend_stream_record():
    return _SuspendStreamRecord()


def guarded_scalar_read(tag: str, dev_scalar) -> int:
    """A CHUNK-DERIVED host scalar inside the streamed pipeline: outside a
    stream-bounds region an ordinary counted host read. Inside one, the
    value read on the FIRST chunk is recorded and replayed for every later
    chunk — with a device-side staleness guard registered on the overflow
    channel, so a chunk whose live value differs flips the pipeline's
    overflow flag and the statement re-runs eagerly, bit for bit."""

    def fetch():
        add_syncs()
        t0 = time.perf_counter_ns()
        out = int(dev_scalar.item()) if torch.is_tensor(dev_scalar) \
            else int(dev_scalar)
        add_sync_wait(time.perf_counter_ns() - t0)
        return out

    if not stream_bounds_on():
        return host_read(tag, fetch)
    # replay serves the recorded value without touching fetch; record
    # fetches (one counted sync, first chunk only) and logs it
    val = host_read(tag, fetch)
    stream_overflow(dev_scalar != val)
    return val


def replay_mode() -> str:
    return getattr(_sync_tls, "replay_mode", "off")


class _ReplaySession:
    def __init__(self, mode: str, log, operands=None):
        self.mode, self.log = mode, log
        self.operands = operands

    def __enter__(self):
        self._prev = (replay_mode(), getattr(_sync_tls, "replay_log", None),
                      getattr(_sync_tls, "replay_cursor", 0),
                      getattr(_sync_tls, "replay_operands", None))
        # snapshot ENTRIES (not an index): resolve_counts clears the list
        # mid-replay, so positions shift — restoration is by identity
        self._pend_snapshot = list(_pending_counts())
        _sync_tls.replay_mode = self.mode
        _sync_tls.replay_log = self.log
        _sync_tls.replay_cursor = 0
        _sync_tls.replay_operands = self.operands
        return self.log

    def __exit__(self, *exc):
        if self.mode == "replay":
            # counts created while replaying belong to the replayed
            # program (on the card, to a captured graph whose tensors hold
            # their values only after a replay): none may reach a later
            # statement's batched resolve. Keep only the entries that
            # existed when the replay began; drop deferred checks against
            # the others unless they already hold their (logged) value.
            snap = self._pend_snapshot
            lst = _pending_counts()
            lst[:] = [c for c in lst if any(c is s for s in snap)]
            checks = getattr(_sync_tls, "checks", None)
            if checks:
                _sync_tls.checks = [
                    (c, f) for c, f in checks
                    if any(c is s for s in snap) or c._host is not None]
        (_sync_tls.replay_mode, _sync_tls.replay_log,
         _sync_tls.replay_cursor, _sync_tls.replay_operands) = self._prev


def recording(log=None):
    """Context: run eagerly while logging every host read."""
    return _ReplaySession("record", [] if log is None else log)


def replaying(log, operands=None):
    """Context: serve every host read from ``log`` (no device value is
    read on the host); ``operands`` resolves any lifted :class:`ArgRef`
    entries to the device tensors uploaded once for the log."""
    return _ReplaySession("replay", log, operands)


class ArgRef:
    """Placeholder in a replay log for an array lifted into a device
    OPERAND (uploaded once when the pipeline is built, instead of once per
    replay; see replay.py)."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


def _resolve_refs(val):
    ops = getattr(_sync_tls, "replay_operands", None)
    if isinstance(val, ArgRef):
        return ops[val.index]
    if isinstance(val, tuple) and any(isinstance(x, ArgRef) for x in val):
        return tuple(ops[x.index] if isinstance(x, ArgRef) else x
                     for x in val)
    return val


def host_read(tag: str, fetch):
    """The single host-read choke point. Off: fetch. Record: fetch and
    log. Replay: pop the recorded value — no device contact.

    A fetch that charged host syncs emits a sync-site event naming its
    engine call site. Attribution is re-entrancy-exact: a fetch that
    re-enters host_read charges each site only its OWN syncs."""
    mode = replay_mode()
    if mode == "replay":
        log = _sync_tls.replay_log
        i = _sync_tls.replay_cursor
        if i >= len(log) or log[i][0] != tag:
            got = log[i][0] if i < len(log) else "<end>"
            raise ReplayMismatch(f"expected {got!r}, hit {tag!r} at {i}")
        _sync_tls.replay_cursor = i + 1
        return _resolve_refs(log[i][1])
    s0, w0 = sync_count(), sync_wait_ns()
    a_s0, a_w0 = _trace.attributed()
    val = fetch()
    a_s1, a_w1 = _trace.attributed()
    own = (sync_count() - s0) - (a_s1 - a_s0)
    if own > 0:
        own_wait = max((sync_wait_ns() - w0) - (a_w1 - a_w0), 0)
        _trace.note_sync(tag, own, own_wait, _sync_site())
    if mode == "record":
        _sync_tls.replay_log.append((tag, val))
    return val


def _guarded_blocking_fetch(tag: str, fetch):
    """The ``sync`` fault seam around one blocking device->host fetch: a
    bounded retry of the idempotent read (a retried read still counts as
    one sync, its wait covering every attempt), and the statement
    watchdog (``NDS_TPU_STATEMENT_DEADLINE_S``), under which a hung fetch
    raises :class:`faults.StatementTimeout`. Unarmed, the fetch runs
    inline on this thread. Armed, it runs on a helper thread, whose
    current CUDA stream is not this thread's: the fetch then runs on the
    stream that was current here, so it reads after the kernels that
    wrote its values."""
    if _faults.statement_deadline_s() is not None \
            and torch.cuda.is_initialized():
        stream = torch.cuda.current_stream()
        unbound = fetch

        def fetch():
            with torch.cuda.stream(stream):
                return unbound()

    def guarded():
        _faults.fault_point("sync", tag)
        return fetch()

    return _faults.with_retry(
        "sync", lambda: _faults.bounded_call("sync", guarded))


def timed_read(tag: str, fetch):
    """host_read() with the fetch charged to the thread's sync/wait
    accounting — for blocking device->host reads that are not simple
    scalar syncs (chunk spans, whole-column string/date fetches). The
    fetch runs behind the ``sync`` fault seam."""
    _refuse_chunk_read(tag)

    def timed():
        add_syncs()
        t0 = time.perf_counter_ns()
        out = _guarded_blocking_fetch(tag, fetch)
        add_sync_wait(time.perf_counter_ns() - t0)
        return out

    return host_read(tag, timed)


def host_sync(value) -> int:
    """Read a device scalar on host, counting the sync."""
    if stream_bounds_on():
        raise StreamSyncError(
            "host scalar sync inside a stream-bounds region")

    def fetch():
        add_syncs()
        t0 = time.perf_counter_ns()
        out = _guarded_blocking_fetch("sync", lambda: int(value.item())) \
            if torch.is_tensor(value) else int(value)
        add_sync_wait(time.perf_counter_ns() - t0)
        return out

    return host_read("sync", fetch)


def upload(x, device, dtype=None) -> torch.Tensor:
    """A host array or list as a tensor on ``device``. On cuda the copy
    goes from page-locked memory without a host wait (a pageable copy
    waits for the device); the caching host allocator holds the pinned
    block until the copy is done. A tensor already there passes through.
    Inside a :func:`staged_uploads` region the copy is served by the
    stage (see there)."""
    dev = torch.device(device)
    if torch.is_tensor(x) and x.device.type == dev.type:
        return x if dtype is None else x.to(dtype)
    t = torch.as_tensor(x, dtype=dtype)
    if dev.type != "cuda":
        return t
    stage = getattr(_sync_tls, "upload_stage", None)
    if stage is not None:
        return stage.take(t, dev)
    return t.pin_memory().to(dev, non_blocking=True)


class CaptureError(RuntimeError):
    """A statement could not be captured as one CUDA graph (a host-to-
    device copy or a synchronizing call inside the capture region)."""


class UploadStage:
    """The host arrays one captured statement uploads, each uploaded ONCE
    before the capture. A replayed statement uploads what its text and
    its recorded log determine (IN-lists, dictionary lookup tables), so
    the warm-up replay fills the stage (``fill``: every upload copies and
    is kept, by content) and the capture is served from it (``serve``: the
    next kept tensor of equal dtype, shape and bytes; none raises
    :class:`CaptureError`). Both run with the module caches bypassed
    (:func:`staging`), so they take the same path and make the same
    uploads in the same order. No copy is then captured: a captured copy
    from pinned memory would read its host buffer again on every replay,
    after the host allocator may have handed it out again. The kept
    tensors live as long as the stage, which the compiled statement
    holds."""

    def __init__(self):
        self.kept: dict = {}
        self.serving = False
        self._cursor: dict = {}

    def take(self, t: torch.Tensor, dev) -> torch.Tensor:
        key = (str(t.dtype), tuple(t.shape), t.numpy().tobytes())
        got = self.kept.setdefault(key, [])
        if not self.serving:
            out = t.pin_memory().to(dev, non_blocking=True)
            got.append(out)
            return out
        i = self._cursor.get(key, 0)
        if i >= len(got):
            raise CaptureError(
                f"host-to-device copy of a {t.dtype} {tuple(t.shape)} "
                "array inside the capture that the warm-up replay did not "
                "make")
        self._cursor[key] = i + 1
        return got[i]


# one capture stream per device, shared by every CUDA graph of the process
_CAPTURE_STREAMS: dict = {}


def capture_stream(dev) -> torch.cuda.Stream:
    """The side stream every CUDA graph of the process captures on. The
    caching allocator hands a freed block out again only on the stream
    that allocated it, so graphs that share a memory pool share its
    blocks only when they capture on one stream."""
    dev = torch.device(dev)
    st = _CAPTURE_STREAMS.get(dev)
    if st is None:
        st = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    return st


class _StagedUploads:
    def __init__(self, stage: UploadStage, serve: bool):
        self.stage, self.serve = stage, serve

    def __enter__(self):
        self._prev = getattr(_sync_tls, "upload_stage", None)
        self.stage.serving = self.serve
        self.stage._cursor = {}
        _sync_tls.upload_stage = self.stage
        return self.stage

    def __exit__(self, *exc):
        _sync_tls.upload_stage = self._prev


def staged_uploads(stage: UploadStage, serve: bool = False):
    """Context: route this thread's cuda uploads through ``stage`` —
    filling it (warm-up) or, with ``serve``, serving from it while a CUDA
    graph captures."""
    return _StagedUploads(stage, serve)


def staging() -> bool:
    """True while this thread prepares (the warm-up replay) or captures a
    statement's CUDA graph. Module-level caches are then bypassed: they
    neither answer nor fill. A tensor allocated during the capture comes
    from the graph's private pool and holds its value only after a
    replay, so it must never be kept; and a cache answer in the warm-up
    that the capture would not get (or the other way round) would make
    the two take different paths."""
    return getattr(_sync_tls, "upload_stage", None) is not None


def to_host(t: torch.Tensor) -> np.ndarray:
    """Uncounted host copy of a tensor that the caller's counted read
    (``timed_read``/``host_read``) already wraps."""
    return t.cpu().numpy()


class DeviceCount:
    """A logical row count that stays on device (no-shrink capacity
    propagation with batched sync points).

    ``dev`` is a 0-d device tensor; ``bound`` the static upper bound used
    for every physical-shape choice. Only a consumer that truly needs the
    host integer resolves, and resolution drains EVERY pending count of the
    calling thread in one transfer.
    """

    __slots__ = ("dev", "bound", "_host")

    def __init__(self, dev, bound: int):
        self.dev = dev
        self.bound = int(bound)
        self._host: int | None = None
        _pending_counts().append(self)

    def to_int(self) -> int:
        if self._host is None and stream_bounds_on():
            # a chunk-data-dependent count must never reach the host
            # inside the per-chunk program (engine/stream.py)
            raise StreamSyncError(
                "DeviceCount resolution inside a stream-bounds region")
        if self._host is None:
            resolve_counts()
        if self._host is None:
            # not in the calling thread's pending list: fetch directly
            def fetch():
                add_syncs()
                t0 = time.perf_counter_ns()
                out = int(self.dev.item())
                add_sync_wait(time.perf_counter_ns() - t0)
                return out

            self._host = host_read("count1", fetch)
            _run_deferred_checks()
        return self._host

    def __repr__(self):
        state = self._host if self._host is not None else "?"
        return f"DeviceCount({state}/{self.bound})"

    # implicit coercions raise so every host consumer is an EXPLICIT,
    # counted choice between count_int (syncs, batched) and count_bound
    def _no_host(self, *_a, **_k):
        raise TypeError(
            "DeviceCount is not a host value; use ops.count_int (syncs, "
            "batched) or ops.count_bound (free upper bound)")

    __bool__ = __index__ = __int__ = __eq__ = __lt__ = __le__ = __gt__ = \
        __ge__ = __add__ = __radd__ = __mul__ = __rmul__ = _no_host
    __hash__ = None


def _pending_counts() -> list:
    lst = getattr(_sync_tls, "pending", None)
    if lst is None:
        lst = _sync_tls.pending = []
    return lst


def resolve_counts() -> None:
    """Fetch every pending device count of this thread in ONE transfer
    (counted as one host sync — the batching is the point)."""
    lst = _pending_counts()
    pend = [c for c in lst if c._host is None]
    if not pend:
        lst.clear()
        _run_deferred_checks()
        return
    if stream_bounds_on():
        # the pending counts belong to the per-chunk program: their
        # values differ chunk to chunk, so no log entry may stand for them
        raise StreamSyncError("count resolution inside a stream-bounds "
                              "region")

    def fetch():
        t0 = time.perf_counter_ns()
        devs = [c.dev if torch.is_tensor(c.dev)
                else torch.tensor(int(c.dev), dtype=I64) for c in pend]
        dev0 = devs[0].device
        vals = torch.stack([d.to(dev0, I64).reshape(()) for d in devs])
        # a failed transfer leaves the pending list untouched, so the
        # seam's retry drains it
        out = [int(v) for v in _guarded_blocking_fetch(
            "counts", lambda: vals.cpu().tolist())]
        add_sync_wait(time.perf_counter_ns() - t0)
        add_syncs()
        return out

    vals = host_read(f"counts{len(pend)}", fetch)
    for c, v in zip(pend, vals):
        c._host = v
    lst.clear()
    _run_deferred_checks()


def defer_check(count: DeviceCount, fn) -> None:
    """Register a validation against a count's eventual host value; it
    runs at whichever batched resolution produces the value."""
    lst = getattr(_sync_tls, "checks", None)
    if lst is None:
        lst = _sync_tls.checks = []
    lst.append((count, fn))


def _run_deferred_checks() -> None:
    lst = getattr(_sync_tls, "checks", None)
    if not lst:
        return
    ready = [(c, f) for c, f in lst if c._host is not None]
    _sync_tls.checks = [(c, f) for c, f in lst if c._host is None]
    first_err = None
    for c, f in ready:          # every ready check runs even if one raises
        try:
            f(c._host)
        except Exception as e:
            first_err = first_err or e
    if first_err is not None:
        raise first_err


def flush_deferred_checks() -> None:
    """Statement-end barrier: resolve any counts that deferred checks are
    waiting on so SQL runtime errors surface inside their statement."""
    if getattr(_sync_tls, "checks", None):
        resolve_counts()


def discard_deferred_checks() -> None:
    """Drop pending deferred checks (the statement aborted)."""
    _sync_tls.checks = []


def count_int(n) -> int:
    """Host integer of a count (resolves a DeviceCount, batched)."""
    return n.to_int() if isinstance(n, DeviceCount) else int(n)


def count_bound(n) -> int:
    """Static upper bound of a count — free of any sync."""
    if isinstance(n, DeviceCount):
        return n.bound if n._host is None else n._host
    return int(n)


def count_arr(n):
    """Tensor-use form: the device scalar (or the plain int)."""
    return n.dev if isinstance(n, DeviceCount) else n


def live_mask(plen: int, nrows, dev=None) -> torch.Tensor:
    """Bool mask of the logical (non-pad) prefix of a physical array.
    ``nrows`` may be a host int or a :class:`DeviceCount` (no sync)."""
    if dev is None:
        dev = nrows.dev.device if isinstance(nrows, DeviceCount) \
            and torch.is_tensor(nrows.dev) else device()
    return torch.arange(plen, device=dev) < count_arr(nrows)


def compact_indices(mask: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of the first ``n`` True rows of ``mask``, padded to
    ``bucket_len(n)`` with an out-of-range fill (gathers clip, scatters
    drop)."""
    cap = bucket_len(n)
    plen = int(mask.shape[0])
    return prim.nonzero_sized(mask, cap, max(plen, 1))


# bucket ceiling below which a lazily-compacted table keeps its un-shrunk
# bucket
LAZY_SHRINK_ROWS = 1 << 20


def compact_table(table: DeviceTable, mask: torch.Tensor,
                  shrink: bool = False) -> DeviceTable:
    """Keep rows where ``mask`` is true, as a prefix-padded table.

    Default (``shrink=False``): NO host sync — live rows gather to the
    prefix of a bucket sized from the producer's bound and the logical
    count rides along as a :class:`DeviceCount`. ``shrink=True`` syncs once
    and re-buckets to the tight capacity."""
    m = mask & live_mask(table.plen, table.nrows, mask.device)
    if shrink:
        n = host_sync(m.sum())
        return take_padded(table, compact_indices(m, n), n)
    cap = min(bucket_len(count_bound(table.nrows)), bucket_len(table.plen))
    idx = prim.nonzero_sized(m, cap, max(table.plen, 1))
    n = DeviceCount(m.sum(), min(count_bound(table.nrows), cap))
    out = take_padded(table, idx, n)
    if cap > LAZY_SHRINK_ROWS and not stream_bounds_on():
        # past this bucket size the downstream sorts a fat bucket drags
        # through cost more than one (batched) round trip: resolve now
        return resolve_table(out)
    return out


def resolve_table(table: DeviceTable, shrink: bool = True) -> DeviceTable:
    """Resolve a table's lazy count to a host int (batched) and, by
    default, slice the physical bucket down to the tight capacity."""
    n = table.nrows
    if not isinstance(n, DeviceCount):
        return table
    ni = n.to_int()
    cap = bucket_len(ni)
    if not shrink or cap >= table.plen:
        return DeviceTable(table.columns, ni, plen=table.plen)
    from nds_tpu_torch.engine.column import slice_col_prefix
    cols = {nm: slice_col_prefix(c, cap) for nm, c in table.columns.items()}
    return DeviceTable(cols, ni, plen=cap)


def gather_table_rows(table: DeviceTable, idx: torch.Tensor,
                      nrows) -> DeviceTable:
    """Whole-table row gather (clip mode); logical length ``nrows``."""
    from dataclasses import replace as _replace
    out = {}
    for n, c in table.columns.items():
        out[n] = _replace(
            c, data=prim.take_clip(c.data, idx),
            valid=None if c.valid is None else prim.take_clip(c.valid, idx))
    return DeviceTable(out, nrows, plen=int(idx.shape[0]))


def take_padded(table: DeviceTable, idx: torch.Tensor, nrows) -> DeviceTable:
    """Gather rows by (possibly out-of-range padded) ``idx``; logical length
    ``nrows``. The physical length follows ``idx``."""
    cap = int(idx.shape[0])
    if table.plen == 0:
        cols = {n: _null_column_like(c, cap)
                for n, c in table.columns.items()}
        return DeviceTable(cols, 0, plen=cap)
    if not table.columns:
        return DeviceTable({}, nrows, plen=cap)
    return gather_table_rows(table, idx, nrows)


# ---------------------------------------------------------------------------
# sort-key preparation
# ---------------------------------------------------------------------------

# ONE lock for every _identity_cache-managed dict; compute() stays off-lock
_IDENTITY_LOCK = threading.Lock()


def _identity_cache(cache: dict, max_size: int, key_arrays: tuple, compute,
                    static_key=(), reads_host: bool = False):
    """Bounded FIFO cache keyed by the identity of host arrays or tensors
    (plus an optional hashable ``static_key``). The entry holds references
    to the keyed objects so a recycled id() can never alias a freed one.

    A cache whose ``compute`` reads the host (``reads_host``) is BYPASSED
    under record/replay: record and replay must consume the same host-read
    sequence, and a record-time hit from an earlier statement would skip a
    read that a replay on fresh intermediate tensors performs. Every cache
    is bypassed while a CUDA graph is prepared or captured
    (:func:`staging`)."""
    if (reads_host and replay_mode() != "off") or staging():
        return compute()
    key = (static_key,) + tuple(id(a) for a in key_arrays)
    hit = cache.get(key)
    if hit is not None and all(h is a for h, a in zip(hit[0], key_arrays)):
        return hit[1]
    value = compute()
    with _IDENTITY_LOCK:
        hit = cache.get(key)
        if hit is not None and all(h is a
                                   for h, a in zip(hit[0], key_arrays)):
            return hit[1]
        if len(cache) >= max_size:
            cache.pop(next(iter(cache)))
        cache[key] = (key_arrays, value)
    return value


_rank_cache: dict = {}
_dev_cache: dict = {}


def host_table(arr: np.ndarray, dev) -> torch.Tensor:
    """Device copy of a cached HOST lookup table (dictionary ranks, merged
    maps), itself cached per (array identity, device)."""
    return _identity_cache(_dev_cache, 2048, (arr,),
                           lambda: upload(arr, dev),
                           static_key=str(dev))


def _dict_ranks(dict_values) -> tuple:
    """(code -> lexicographic rank, rank -> code) maps for one string
    dictionary, cached per dictionary as HOST arrays."""
    def compute():
        order = np.argsort(dict_values.astype(str), kind="stable")
        ranks = np.empty(len(order), dtype=np.int64)
        ranks[order] = np.arange(len(order))
        return ranks, order.astype(np.int64)
    return _identity_cache(_rank_cache, 512, (dict_values,), compute)


def ordered_codes(col: Column) -> torch.Tensor:
    """For a string column, map dictionary codes to lexicographic ranks so
    integer comparisons order like string comparisons."""
    ranks = host_table(_dict_ranks(col.dict_values)[0], col.data.device)
    return prim.take(ranks, col.data)


def plain_col(col: Column) -> Column:
    """Decoded (logical-representation) view of a possibly-encoded column."""
    return col.plain() if col.enc is not None else col


def plain_data(col: Column) -> torch.Tensor:
    """Decoded data of a possibly-encoded column."""
    return col.plain().data if col.enc is not None else col.data


def sortable_view(col: Column) -> torch.Tensor:
    """Numeric view of a column that sorts in SQL ascending order."""
    if col.kind == "str":
        return ordered_codes(col)
    if col.kind == "bool":
        return col.data.to(torch.int32)
    return col.data


def _lexsort_impl(views, valids, descending, nulls_last, pad_key, n_valid):
    """Multi-key stable sort by iterative order-preserving re-coding: each
    key folds into one combined int64 code via :func:`_dense_codes` (codes
    ascend with the value, so ``dense(combined)*fold + code`` keeps
    lexicographic order), and one stable single-key argsort finishes."""
    n = views[0].shape[0]
    dev = views[0].device
    fold = 2 * n + 4
    combined = None
    if pad_key:
        combined = (torch.arange(n, device=dev) >= n_valid).to(I64)
    for v, valid, desc, nl in zip(views, valids, descending, nulls_last):
        if desc:
            v = -v.to(I64) if v.dtype != F64 else -v
        if v.dtype == F64:
            # NaNs compare EQUAL (one code, greatest) so later keys can
            # still break their ties
            nan = torch.isnan(v)
            c = _dense_codes(torch.where(nan, torch.full(
                (), float("inf"), dtype=F64, device=dev), v))
            code = 2 * c + nan.to(I64) + 1                # 1..2n
        else:
            code = _dense_codes(v) + 1                    # 1..n
        if valid is not None:
            code = torch.where(valid, code, torch.full(
                (), 2 * n + 3 if nl else 0, dtype=I64, device=dev))
        combined = code if combined is None else \
            _dense_codes(combined) * fold + code
    if combined is None:
        return torch.arange(n, device=dev)
    return prim.argsort_stable(combined)


def lexsort_indices(cols, descending=None, nulls_last=None,
                    n_valid=None) -> torch.Tensor:
    """Stable multi-key sort. ``cols`` primary-first; per-key descending and
    nulls-last flags (SQL default: asc, nulls first). With ``n_valid``,
    rows past the logical count sort after every live row."""
    n = len(cols[0])
    if descending is None:
        descending = [False] * len(cols)
    if nulls_last is None:
        nulls_last = [False] * len(cols)
    pad_key = n_valid is not None and (
        isinstance(n_valid, DeviceCount) or n_valid < n)
    views = tuple(sortable_view(c) for c in cols)
    valids = tuple(c.valid for c in cols)
    return _lexsort_impl(views, valids, tuple(descending), tuple(nulls_last),
                         pad_key, 0 if n_valid is None else count_arr(n_valid))


# ---------------------------------------------------------------------------
# grouping
# ---------------------------------------------------------------------------


def _dense_codes(v: torch.Tensor) -> torch.Tensor:
    """Dense group codes of a single 1-D key (exact, via one stable sort).
    Codes are < len(v); no host sync."""
    n = v.shape[0]
    order = prim.argsort_stable(v)
    sv = v[order]
    boundary = torch.cat([torch.ones(1, dtype=torch.bool, device=v.device),
                          sv[1:] != sv[:-1]])
    code_sorted = torch.cumsum(boundary.to(I64), 0) - 1
    out = torch.zeros(n, dtype=I64, device=v.device)
    out[order] = code_sorted
    return out


_PAD_GROUP_KEY = prim.I64_MAX // 2


def _group_rep_impl(gids, n_valid, cap):
    """First-occurrence row index of each live group, bucket-padded to
    ``cap``; the pad group scatters out of range and is dropped."""
    plen = gids.shape[0]
    dev = gids.device
    live = torch.arange(plen, device=dev) < n_valid
    scatter_ids = torch.where(live, gids, torch.full((), cap, dtype=I64,
                                                     device=dev))
    return prim.scatter_amin(torch.full((cap,), plen, dtype=I64, device=dev),
                             scatter_ids, torch.arange(plen, dtype=I64,
                                                       device=dev))


def _group_ids_impl(views, valids, n_valid):
    """Iterative dense re-coding (see :func:`group_ids`): per-row dense
    group ids with pads in one trailing group, plus the live group count
    as a device scalar."""
    plen = views[0].shape[0]
    dev = views[0].device
    live = torch.arange(plen, device=dev) < n_valid
    fold = 2 * plen + 2
    combined = None
    for v, valid in zip(views, valids):
        if valid is not None:
            # zero data under nulls: all-null rows must compare equal
            v = torch.where(valid, v, torch.zeros((), dtype=v.dtype,
                                                  device=dev))
        codes = _dense_codes(v)
        if valid is not None:
            codes = 2 * codes + (~valid).to(I64)
        if combined is None:
            combined = codes
        else:
            combined = _dense_codes(combined) * fold + codes
    combined = torch.where(live, combined, torch.full(
        (), _PAD_GROUP_KEY, dtype=I64, device=dev))
    gids = _dense_codes(combined)
    ngroups = torch.where(live, gids, torch.full((), -1, dtype=I64,
                                                 device=dev)).max() + 1
    return gids, ngroups


# row count from which multi-key groupings try the packed single-sort plan
GROUP_PACK_MIN = 1 << 20


def _int_key_ranges(views, n_valid):
    """(min, max) of every integer key view over live rows."""
    plen = views[0].shape[0]
    dev = views[0].device
    live = torch.arange(plen, device=dev) < n_valid
    big = torch.full((), prim.I64_MAX, dtype=I64, device=dev)
    small = torch.full((), prim.I64_MIN, dtype=I64, device=dev)
    mins = torch.stack([torch.where(live, v.to(I64), big).min()
                        for v in views])
    maxs = torch.stack([torch.where(live, v.to(I64), small).max()
                        for v in views])
    return mins, maxs


def _group_ids_packed(views, valids, offsets, widths, n_valid):
    """Single-sort grouping: every key's offset code (null flag folded)
    packs into one int64, so ONE :func:`_dense_codes` sort replaces the
    K+1 sorts of the iterative fold."""
    plen = views[0].shape[0]
    dev = views[0].device
    combined = torch.zeros(plen, dtype=I64, device=dev)
    for v, valid, off, width in zip(views, valids, offsets, widths):
        code = v.to(I64) - off
        if valid is not None:
            code = 2 * torch.where(valid, code, torch.zeros(
                (), dtype=I64, device=dev)) + (~valid).to(I64)
        combined = (combined << width) | code
    live = torch.arange(plen, device=dev) < n_valid
    combined = torch.where(live, combined, torch.full(
        (), _PAD_GROUP_KEY, dtype=I64, device=dev))
    gids = _dense_codes(combined)
    ngroups = torch.where(live, gids, torch.full((), -1, dtype=I64,
                                                 device=dev)).max() + 1
    return gids, ngroups


def _packed_group_plan(key_cols, views, n_valid):
    """(offsets, widths) when the combined key fits 62 bits, else None.
    String/bool key spans are host-known; integer keys cost ONE range
    sync."""
    int_idx = [i for i, c in enumerate(key_cols)
               if c.kind not in ("str", "bool")]
    spans = [None] * len(key_cols)
    for i, c in enumerate(key_cols):
        if c.kind == "str":
            spans[i] = (0, max(len(c.dict_values) - 1, 0))
        elif c.kind == "bool":
            spans[i] = (0, 1)
    if int_idx:
        def fetch():
            mins, maxs = _int_key_ranges(
                tuple(views[i] for i in int_idx), n_valid)
            return to_host(mins), to_host(maxs)

        mins, maxs = timed_read("group_ranges", fetch)
        for k, i in enumerate(int_idx):
            if mins[k] > maxs[k]:              # no live rows
                spans[i] = (0, 0)
            else:
                spans[i] = (int(mins[k]), int(maxs[k]))
    offsets, widths, total = [], [], 0
    for (lo, hi), c in zip(spans, key_cols):
        span = hi - lo
        if c.valid is not None:
            span = 2 * span + 1                # null flag folded in
        width = max(int(span).bit_length(), 1)
        offsets.append(lo)
        widths.append(width)
        total += width
    if total > 62:
        return None
    return tuple(offsets), tuple(widths)


def group_ids(key_cols, n_valid=None):
    """Grouping by iterative dense re-coding.

    Returns ``(gids, ngroups, rep_indices, cap)``: per-row dense group id
    (pad rows land in one trailing, discardable group), the live group
    count, the (bucket-padded, ``cap``-long) row index of each group's first
    occurrence, and the bucket capacity every grouped output is allocated
    with. SQL GROUP BY treats nulls as equal; each column's code folds its
    null flag in (``2*value_code + is_null``)."""
    plen = len(key_cols[0])
    dev = key_cols[0].data.device
    if n_valid is None:
        n_valid = plen
    if plen == 0:
        cap = bucket_len(0)
        return (torch.zeros(0, dtype=I64, device=dev), 0,
                torch.full((cap,), 1, dtype=I64, device=dev), cap)
    views = tuple(sortable_view(c) for c in key_cols)
    valids = tuple(c.valid for c in key_cols)
    nv = count_arr(n_valid)
    plan = None
    if len(key_cols) > 1 and plen >= GROUP_PACK_MIN:
        plan = _packed_group_plan(key_cols, views, nv)
    if plan is not None:
        gids, ng_dev = _group_ids_packed(views, valids, plan[0], plan[1], nv)
    else:
        gids, ng_dev = _group_ids_impl(views, valids, nv)
    # the one host sync — routed through the pending batch
    ngroups = DeviceCount(ng_dev, count_bound(n_valid)).to_int()
    cap = bucket_len(ngroups)
    rep = _group_rep_impl(gids, nv, cap)
    return gids, ngroups, rep, cap


# ---------------------------------------------------------------------------
# aggregation: the grouped sum, count, min and max run on the hand-written
# kernels (engine/kernels.py); a row takes part when its (validity-masked)
# group id lies in [0, ngroups)
# ---------------------------------------------------------------------------


def _masked_gids(gids, valid):
    if valid is None:
        return gids
    return torch.where(valid, gids, torch.full((), -1, dtype=gids.dtype,
                                               device=gids.device))


def agg_count(col: Column | None, gids, ngroups) -> Column:
    """count(*) when col is None else count(col) (non-null). Pad rows need
    no masking here: grouping routes them to a trailing group that lands
    past the logical group count or is dropped by the kernel."""
    from nds_tpu_torch.engine.kernels import segment_sum_f64
    valid = None if col is None else col.valid
    _, counts = segment_sum_f64(None, _masked_gids(gids, valid), ngroups)
    return Column("i64", counts)


def agg_sum(col: Column, gids, ngroups) -> Column:
    col = plain_col(col)           # sums need logical values
    g = _masked_gids(gids, col.valid)
    if col.kind == "f64":
        from nds_tpu_torch.engine.kernels import segment_sum_f64
        sums, counts = segment_sum_f64(col.data, g, ngroups)
        return Column("f64", sums, counts > 0)
    # exact two's-complement int64 sum for decimals and integers
    from nds_tpu_torch.engine.kernels import segment_sum_i64
    sums, counts = segment_sum_i64(col.data.to(I64), g, ngroups)
    kind = f"dec(38,{col.scale})" if is_dec(col.kind) else "i64"
    return Column(kind, sums, counts > 0)


def _agg_min_impl(view, valid, gids, ngroups, is_max):
    """Exact-kind MIN/MAX (integers, decimals, dates, string ranks)."""
    dev = view.device
    v = (torch.ones(view.shape[0], dtype=torch.bool, device=dev)
         if valid is None else valid)
    sentinel = prim.I64_MIN if is_max else prim.I64_MAX
    data = torch.where(v, view.to(I64), torch.full((), sentinel, dtype=I64,
                                                   device=dev))
    seg = prim.segment_max if is_max else prim.segment_min
    out = seg(data, gids, ngroups)
    cnt = prim.segment_sum(v.to(I64), gids, ngroups)
    return out, cnt > 0


def agg_min(col: Column, gids, ngroups, is_max=False) -> Column:
    if col.kind == "f64":
        from nds_tpu_torch.engine.kernels import (segment_minmax_f64,
                                                  segment_sum_f64)
        g = _masked_gids(gids, col.valid)
        mins, maxs = segment_minmax_f64(col.data, g, ngroups)
        _, cnt = segment_sum_f64(None, g, ngroups)
        out = maxs if is_max else mins
        return Column("f64", torch.where(cnt > 0, out, torch.zeros(
            (), dtype=F64, device=out.device)), cnt > 0)
    out, out_valid = _agg_min_impl(sortable_view(col), col.valid, gids,
                                   ngroups, bool(is_max))
    if col.kind == "str":
        # min/max of strings: map the winning rank back to a dictionary code
        rank_to_code = host_table(_dict_ranks(col.dict_values)[1],
                                  out.device)
        codes = prim.take(rank_to_code,
                          out.clamp(0, rank_to_code.shape[0] - 1))
        return Column("str", codes.to(torch.int32), out_valid,
                      col.dict_values)
    # order-preserving encodings: min/max of codes IS the code of the
    # min/max value, so the result stays encoded (decode at materialize)
    return Column(col.kind, out.to(col.data.dtype), out_valid, enc=col.enc)


def agg_avg(col: Column, gids, ngroups) -> Column:
    col = plain_col(col)
    g = _masked_gids(gids, col.valid)
    if col.kind == "f64":
        from nds_tpu_torch.engine.kernels import segment_sum_f64
        sums, counts = segment_sum_f64(col.data, g, ngroups)
    else:
        # exact int64 sum first, then one f64 divide
        from nds_tpu_torch.engine.kernels import segment_sum_i64
        isums, counts = segment_sum_i64(col.data.to(I64), g, ngroups)
        sums = isums.to(F64)
        if is_dec(col.kind):
            sums = prim.true_div(sums, 10.0 ** col.scale)
    out = torch.where(counts > 0, sums / counts.clamp(min=1).to(F64),
                      torch.zeros((), dtype=F64, device=sums.device))
    return Column("f64", out, counts > 0)


def _agg_stddev_impl(data, valid, gids, ngroups):
    dev = data.device
    v = (torch.ones(data.shape[0], dtype=torch.bool, device=dev)
         if valid is None else valid)
    d = torch.where(v, data, torch.zeros((), dtype=F64, device=dev))
    s1 = prim.segment_sum(d, gids, ngroups)
    s2 = prim.segment_sum(d * d, gids, ngroups)
    c = prim.segment_sum(v.to(F64), gids, ngroups)
    mean = s1 / c.clamp(min=1.0)
    var = (s2 - c * mean * mean) / (c - 1.0).clamp(min=1.0)
    return torch.sqrt(var.clamp(min=0.0)), c > 1


def agg_stddev_samp(col: Column, gids, ngroups) -> Column:
    col = plain_col(col)
    data = col.data.to(F64)
    if is_dec(col.kind):
        data = prim.true_div(data, 10.0 ** col.scale)
    out, enough = _agg_stddev_impl(data, col.valid, gids, ngroups)
    return Column("f64", out, enough)


# ---------------------------------------------------------------------------
# filter / compact
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------


def _u64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


_HASH_C1 = _u64(0x9E3779B97F4A7C15)
_HASH_C2 = _u64(0xBF58476D1CE4E5B9)
_HASH_C3 = _u64(0x94D049BB133111EB)
_HASH_SEED = _u64(0x243F6A8885A308D3)
_NULL_MARK = _u64(0xA5A5A5A5A5A5A5A5)


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    x = (x ^ _srl(x, 30)) * _HASH_C2
    x = (x ^ _srl(x, 27)) * _HASH_C3
    return x ^ _srl(x, 31)


def unsigned_order(h: torch.Tensor) -> torch.Tensor:
    """Signed view of uint64 bits that sorts in unsigned order."""
    return h ^ prim.I64_MIN


def _key_hash_impl(views, valids, side_salt: int, null_safe: bool, n_valid,
                   excluded=None):
    """64-bit composite hash of prepared key views (uint64 bits in int64).

    Default SQL join semantics: rows with any null key get a per-row unique
    value that cannot match the other side. With ``null_safe`` the null
    flag is folded into the hash instead so null keys compare equal. Pad
    rows past ``n_valid``, and rows flagged in ``excluded``, always get the
    unmatchable per-row value."""
    n = views[0].shape[0]
    dev = views[0].device
    h = torch.full((n,), _HASH_SEED, dtype=I64, device=dev)
    any_null = torch.zeros(n, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=I64, device=dev)
    for v, valid in zip(views, valids):
        if v.dtype == F64:
            # equality-preserving int words: the integer part plus a 52-bit
            # fraction word (the hash is only a candidate prefilter)
            vf = torch.nan_to_num(v)
            ip = vf.clamp(-9.0e18, 9.0e18).to(I64)
            frac = ((vf - torch.floor(vf)) * float(2 ** 52)).to(I64)
            words = (ip, frac)
        else:
            words = (v.to(I64),)
        if valid is not None:
            words = tuple(torch.where(valid, w, zero) for w in words)
            marker = torch.where(valid, zero, torch.full(
                (), _NULL_MARK, dtype=I64, device=dev))
            any_null = any_null | ~valid
        else:
            marker = torch.zeros(n, dtype=I64, device=dev)
        h = _mix64(h ^ marker)
        for w in words:
            h = _mix64(h ^ (w * _HASH_C1))
    unmatchable = torch.zeros(n, dtype=torch.bool, device=dev) \
        if null_safe else any_null
    unmatchable = unmatchable | (torch.arange(n, device=dev) >= n_valid)
    if excluded is not None:
        unmatchable = unmatchable | excluded
    row_ids = torch.arange(n, dtype=I64, device=dev)
    # bit layout: bits 0-1 side tag, bit 2 = REAL marker, row id from bit 3
    sentinel = (1 if side_salt else 2) + (row_ids << 3)
    return torch.where(unmatchable, sentinel, h | 4)


def _hash_views(left_keys, right_keys):
    """Per-pair hashable views of the join keys. String pairs map through
    one merged dictionary ordering first (codes of two dictionaries are not
    comparable)."""
    lviews, rviews = [], []
    for lk, rk in zip(left_keys, right_keys):
        if lk.kind == "str" and rk.kind == "str":
            lv, rv = ordered_codes_merged(lk, rk)
        else:
            lv, rv = plain_data(lk), plain_data(rk)
        lviews.append(lv)
        rviews.append(rv)
    return tuple(lviews), tuple(rviews)


def _verify_pairs(l_idx, r_idx, left_keys, right_keys,
                  null_safe: bool = False) -> torch.Tensor:
    """Exact key equality for candidate pairs (hash-collision safety).
    With ``null_safe``, null == null."""
    ok = torch.ones(l_idx.shape[0], dtype=torch.bool, device=l_idx.device)
    for lk, rk in zip(left_keys, right_keys):
        if lk.kind == "str" and rk.kind == "str":
            lmap, rmap = ordered_codes_merged(lk, rk)
            lv = prim.take(lmap, l_idx)
            rv = prim.take(rmap, r_idx)
        else:
            lv = prim.take(plain_data(lk), l_idx)
            rv = prim.take(plain_data(rk), r_idx)
        eq = lv == rv
        lvalid = None if lk.valid is None else prim.take(lk.valid, l_idx)
        rvalid = None if rk.valid is None else prim.take(rk.valid, r_idx)
        if null_safe:
            lnull = torch.zeros_like(eq) if lvalid is None else ~lvalid
            rnull = torch.zeros_like(eq) if rvalid is None else ~rvalid
            eq = torch.where(lnull | rnull, lnull & rnull, eq)
        else:
            if lvalid is not None:
                eq = eq & lvalid
            if rvalid is not None:
                eq = eq & rvalid
        ok = ok & eq
    return ok


_merged_cache: dict = {}


def ordered_codes_merged(a: Column, b: Column):
    """Map two string columns' codes into one shared value ordering, cached
    per dictionary pair (host arrays — see :func:`_dict_ranks`)."""
    def compute():
        union, inverse = np.unique(
            np.concatenate([a.dict_values.astype(str),
                            b.dict_values.astype(str)]),
            return_inverse=True)
        a_map = inverse[: len(a.dict_values)].astype(np.int64)
        b_map = inverse[len(a.dict_values):].astype(np.int64)
        return a_map, b_map
    a_map, b_map = _identity_cache(
        _merged_cache, 256, (a.dict_values, b.dict_values), compute)
    return prim.take(host_table(a_map, a.data.device), a.data), \
        prim.take(host_table(b_map, b.data.device), b.data)


def _probe_candidates(left_keys, right_keys, null_safe=False,
                      n_left=None, n_right=None, l_excl=None, r_excl=None):
    """Hash-probe phase shared by the monolithic and chunked joins: returns
    ``(counts, lo, order, total)`` — per-left-row candidate counts, start
    offsets into the hash-sorted right side, the right-side sort order, and
    the total candidate-pair count (host sync)."""
    plen_l = len(left_keys[0])
    plen_r = len(right_keys[0])
    n_left = plen_l if n_left is None else n_left
    n_right = plen_r if n_right is None else n_right
    lviews, rviews = _hash_views(left_keys, right_keys)
    lvalids = tuple(c.valid for c in left_keys)
    rvalids = tuple(c.valid for c in right_keys)
    rh = unsigned_order(_key_hash_impl(rviews, rvalids, 1, null_safe,
                                       count_arr(n_right), r_excl))
    order = prim.argsort_stable(rh)
    rh_sorted = rh[order]
    if stream_bounds_on():
        # chunk-invariant program: no data-dependent sizing sync. The
        # caller sizes its pair bucket from static bounds and registers a
        # device-side overflow flag (checked at the pipeline's single
        # materializing sync). An integer probe side takes the
        # bound-bucket probe kernel (K5: the probe-side hash of
        # _key_hash_impl and both searchsorted sides in one pass);
        # float keys and null-safe probes keep the hash + searchsorted
        # below. Candidate counts are identical either way.
        if not null_safe and not any(v.dtype.is_floating_point
                                     for v in lviews):
            from nds_tpu_torch.engine.kernels import join_probe
            counts, lo = join_probe(lviews, lvalids, count_arr(n_left),
                                    l_excl, rh_sorted)
            return counts, lo, order, None
        lh = unsigned_order(_key_hash_impl(lviews, lvalids, 0, null_safe,
                                           count_arr(n_left), l_excl))
        lo = prim.searchsorted(rh_sorted, lh)
        hi = prim.searchsorted(rh_sorted, lh, right=True)
        return hi - lo, lo, order, None
    lh = unsigned_order(_key_hash_impl(lviews, lvalids, 0, null_safe,
                                       count_arr(n_left), l_excl))
    lo = prim.searchsorted(rh_sorted, lh)
    hi = prim.searchsorted(rh_sorted, lh, right=True)
    counts = hi - lo
    total = host_sync(counts.sum())                    # host sync 1
    return counts, lo, order, total


def _pair_indices(counts, lo, order, cand, plen_r, row_mask=None):
    """Candidate pair indices (left row, right row), padded to ``cand``;
    ``row_mask`` restricts the probe rows."""
    plen_l = counts.shape[0]
    dev = counts.device
    row = torch.arange(plen_l, device=dev)
    if row_mask is not None:
        counts = torch.where(row_mask, counts, torch.zeros(
            (), dtype=counts.dtype, device=dev))
    l_idx = prim.repeat_total(row, counts, cand)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(cand, device=dev) - prim.repeat_total(starts, counts,
                                                             cand)
    r_pos = prim.repeat_total(lo, counts, cand) + pos
    r_idx = prim.take_clip(order, r_pos.clamp(0, max(plen_r - 1, 0)))
    return l_idx, r_idx


def join_indices(left_keys, right_keys, how: str = "inner",
                 null_safe: bool = False, n_left=None, n_right=None,
                 l_excl=None, r_excl=None, probe=None):
    """Equi-join. Returns ``(l_idx, r_idx, n_pairs, l_extra, n_lx, r_extra,
    n_rx)``: bucket-padded matched pair indices with their logical count,
    plus (for outer joins) the bucket-padded unmatched row indices of each
    side. Pad slots hold out-of-range indices (gathers clip, scatters drop).
    ``l_excl``/``r_excl`` are deferred filter masks (True = row filtered
    out). ``probe`` passes a precomputed :func:`_probe_candidates` result.
    """
    plen_l = len(left_keys[0])
    plen_r = len(right_keys[0])
    dev = left_keys[0].data.device
    n_left = plen_l if n_left is None else n_left
    n_right = plen_r if n_right is None else n_right
    counts, lo, order, total = probe if probe is not None else \
        _probe_candidates(left_keys, right_keys, null_safe,
                          n_left, n_right, l_excl, r_excl)
    if total is None or total > 0:
        if total is None:
            # stream-bounds join: the candidate total stays on device, so
            # the pair bucket is sized from STATIC bounds (probe-side
            # bucket x a power-of-two fanout allowance). A chunk whose
            # true candidate count exceeds it would silently drop pairs,
            # so the excess registers as a device-side overflow flag the
            # streaming executor checks at its single materializing sync.
            total_dev = counts.sum()
            cand = min(bucket_len(count_bound(n_left)) * stream_fanout(),
                       bucket_len(PAIR_BUDGET))
            stream_overflow(total_dev > cand)
            pair_live = torch.arange(cand, device=dev) < total_dev
            n_pairs_bound = cand
        else:
            cand = bucket_len(total)
            pair_live = live_mask(cand, total, dev)
            n_pairs_bound = total
        l_idx, r_idx = _pair_indices(counts, lo, order, cand, plen_r)
        ok = _verify_pairs(l_idx, r_idx, left_keys, right_keys, null_safe)
        ok = ok & pair_live
        # NO pair-count sync: verified pairs compact to the prefix of the
        # candidate bucket and the exact count rides as a DeviceCount
        n_pairs = DeviceCount(ok.sum(), n_pairs_bound)
        keep = prim.nonzero_sized(ok, cand, cand)
        l_idx = prim.take_fill(l_idx, keep, plen_l)
        r_idx = prim.take_fill(r_idx, keep, plen_r)
    else:
        n_pairs = 0
        cap0 = bucket_len(0)
        l_idx = torch.full((cap0,), plen_l, dtype=I64, device=dev)
        r_idx = torch.full((cap0,), plen_r, dtype=I64, device=dev)

    l_extra = r_extra = None
    n_lx = n_rx = 0
    miss = miss_r = None
    if how in ("left", "full"):
        matched = prim.scatter_set(
            torch.zeros(plen_l, dtype=torch.bool, device=dev), l_idx, True)
        miss = ~matched & live_mask(plen_l, n_left, dev)
        if l_excl is not None:
            miss = miss & ~l_excl
        n_lx = DeviceCount(miss.sum(), count_bound(n_left))
    if how in ("right", "full"):
        matched_r = prim.scatter_set(
            torch.zeros(plen_r, dtype=torch.bool, device=dev), r_idx, True)
        miss_r = ~matched_r & live_mask(plen_r, n_right, dev)
        if r_excl is not None:
            miss_r = miss_r & ~r_excl
        n_rx = DeviceCount(miss_r.sum(), count_bound(n_right))
    # one batched transfer resolves every count this join created
    if miss is not None:
        n_lx = n_lx.to_int()
        l_extra = compact_indices(miss, n_lx)
    if miss_r is not None:
        n_rx = n_rx.to_int()
        r_extra = compact_indices(miss_r, n_rx)
    return l_idx, r_idx, n_pairs, l_extra, n_lx, r_extra, n_rx


_PK_SENTINEL = prim.I64_MAX


def _semi_sorted_impl(lv, lvalid, rv, rvalid, n_left, n_right):
    """Sort-based existence probe on directly comparable key views: dead
    right rows take the sentinel, live rows sort live-first, so one
    leftmost searchsorted + equality + liveness check answers "does any
    LIVE right row hold this value" — exact and sync-free."""
    plen_r = rv.shape[0]
    dev = rv.device
    ok_r = torch.arange(plen_r, device=dev) < n_right
    if rvalid is not None:
        ok_r = ok_r & rvalid
    dk = torch.where(ok_r, rv.to(I64), torch.full((), _PK_SENTINEL,
                                                  dtype=I64, device=dev))
    order = prim.lexsort2(~ok_r, dk)
    dks = dk[order]
    lvv = lv.to(I64)
    lo = prim.searchsorted(dks, lvv).clamp(0, max(plen_r - 1, 0))
    hit = (prim.take(dks, lo) == lvv) & prim.take(ok_r[order], lo)
    ok_l = torch.arange(lv.shape[0], device=dev) < n_left
    if lvalid is not None:
        ok_l = ok_l & lvalid
    return hit & ok_l


def semi_join_mask(left_keys, right_keys, negate: bool = False,
                   null_safe: bool = False, n_left=None,
                   n_right=None) -> torch.Tensor:
    """Boolean per-left-row mask: has (semi) / lacks (anti) a match on the
    right. Used for IN / EXISTS / NOT EXISTS and (null-safe) set ops.
    Pad rows always come back False."""
    plen_l = len(left_keys[0])
    dev = left_keys[0].data.device
    n_left = plen_l if n_left is None else n_left
    lk, rk = left_keys[0], right_keys[0]
    if len(left_keys) == 1 and not null_safe and \
            lk.kind != "f64" and rk.kind != "f64" and \
            (lk.kind == rk.kind or
             {lk.kind, rk.kind} <= {"i64", "date"}):
        # single integer-comparable key: the sort probe answers existence
        # directly — no candidate-pair sync
        if lk.kind == "str" and rk.kind == "str":
            lview, rview = ordered_codes_merged(lk, rk)
        elif lk.kind != "str" and rk.kind != "str":
            lview, rview = plain_data(lk), plain_data(rk)
        else:
            lview = rview = None
        if lview is not None:
            plen_r = len(rk)
            n_r = plen_r if n_right is None else n_right
            matched = _semi_sorted_impl(lview, lk.valid, rview, rk.valid,
                                        count_arr(n_left), count_arr(n_r))
            out = ~matched if negate else matched
            return out & live_mask(plen_l, n_left, dev)
    l_idx, _, _, _, _, _, _ = join_indices(
        left_keys, right_keys, "inner", null_safe, n_left, n_right)
    matched = prim.scatter_set(
        torch.zeros(plen_l, dtype=torch.bool, device=dev), l_idx, True)
    out = ~matched if negate else matched
    return out & live_mask(plen_l, n_left, dev)


def _live_dim(plen_d, n_dim, dvalid, d_excl, dev):
    ok_d = torch.arange(plen_d, device=dev) < n_dim
    if dvalid is not None:
        ok_d = ok_d & dvalid
    if d_excl is not None:
        ok_d = ok_d & ~d_excl
    return ok_d


def _pk_gather_impl(fkey, fvalid, dkey, dvalid, n_fact, n_dim,
                    f_excl, d_excl):
    """Exact merge-probe of fact keys against a UNIQUE dimension key.

    Dead dimension rows (pads, filtered, null keys) take an unmatchable
    sentinel before the sort, so one searchsorted + equality check finds
    the unique match. Returns ``(r_idx, matched)`` at fact length."""
    plen_d = dkey.shape[0]
    dev = dkey.device
    ok_d = _live_dim(plen_d, n_dim, dvalid, d_excl, dev)
    dk = torch.where(ok_d, dkey.to(I64), torch.full((), _PK_SENTINEL,
                                                    dtype=I64, device=dev))
    # live-first tie-break: leftmost searchsorted lands on the live row
    order = prim.lexsort2(~ok_d, dk)
    dks = dk[order]
    fk = fkey.to(I64)
    lo = prim.searchsorted(dks, fk).clamp(0, plen_d - 1)
    hit = prim.take(dks, lo) == fk
    plen_f = fkey.shape[0]
    ok_f = _live_dim(plen_f, n_fact, fvalid, f_excl, dev)
    matched = hit & ok_f & prim.take(ok_d[order], lo)
    return prim.take(order, lo), matched


_dense_dim_cache: dict = {}


def _dense_dim_info(dim_key: Column, n_dim: int):
    """(base, device position map) when the dimension key is a dense-ish
    unique integer range (every TPC-DS surrogate key is), else None.
    Cached per key-tensor identity: one gather replaces the per-join sort
    probe."""
    if dim_key.kind == "str" or dim_key.enc is not None or n_dim == 0 \
            or n_dim > (1 << 24):
        return None

    def compute():
        def fetch():
            live = to_host(dim_key.data[:n_dim]).astype(np.int64)
            if dim_key.valid is not None and \
                    not bool(np.all(to_host(dim_key.valid[:n_dim]))):
                return None                   # null PKs: sort path handles
            mn = int(live.min())
            span = int(live.max()) - mn + 1
            # sparse keys blow the map; 4x slack covers SCD-style gaps
            if span > max(4 * n_dim, 1 << 16) or span > (1 << 26):
                return None
            pos = np.full(span, n_dim, dtype=np.int64)  # n_dim = miss mark
            pos[live - mn] = np.arange(n_dim)
            return mn, pos

        got = timed_read("dense_dim", fetch)
        if got is None:
            return None
        mn, pos = got
        return mn, upload(pos, dim_key.data.device)

    return _identity_cache(_dense_dim_cache, 64, (dim_key.data,), compute,
                           static_key=n_dim, reads_host=True)


def _pk_gather_dense_impl(fkey, fvalid, dkey, dvalid, pos_map, base,
                          n_fact, n_dim, f_excl, d_excl):
    """Dense-range merge probe: position-map gather instead of sort +
    searchsorted. Same contract as :func:`_pk_gather_impl`."""
    plen_d = dkey.shape[0]
    plen_f = fkey.shape[0]
    dev = dkey.device
    ok_d = _live_dim(plen_d, n_dim, dvalid, d_excl, dev)
    fk = fkey.to(I64)
    off = fk - base
    span = pos_map.shape[0]
    inb = (off >= 0) & (off < span)
    r_idx = prim.take(pos_map, off.clamp(0, span - 1))
    r_ok = inb & (r_idx < n_dim)
    r_idx = r_idx.clamp(0, plen_d - 1)
    hit = r_ok & (prim.take(dkey.to(I64), r_idx) == fk)
    hit = hit & prim.take(ok_d, r_idx)
    ok_f = _live_dim(plen_f, n_fact, fvalid, f_excl, dev)
    return r_idx, hit & ok_f


def pk_gather_join(fact_key: Column, dim_key: Column, n_fact, n_dim,
                   f_excl=None, d_excl=None):
    """Planner-facing wrapper of :func:`_pk_gather_impl`: prepares
    comparable integer views (merged dictionary ranks for string pairs),
    and takes the dense-range position-map probe when the dimension key
    is a dense unique integer range."""
    if isinstance(n_dim, DeviceCount):
        n_dim = n_dim.to_int()
    if fact_key.kind == "str" and dim_key.kind == "str":
        fview, dview = ordered_codes_merged(fact_key, dim_key)
    else:
        fview, dview = plain_data(fact_key), plain_data(dim_key)
        dense = _dense_dim_info(dim_key, n_dim)
        if dense is not None:
            base, pos_map = dense
            return _pk_gather_dense_impl(
                fview, fact_key.valid, dview, dim_key.valid, pos_map,
                int(base), count_arr(n_fact), n_dim, f_excl, d_excl)
    return _pk_gather_impl(fview, fact_key.valid, dview, dim_key.valid,
                           count_arr(n_fact), n_dim, f_excl, d_excl)


_dim_span_cache: dict = {}


def _pack_keys_impl(views, valids, offsets, widths, spans):
    """Pack offset key codes into one int64, with a combined validity
    (per-key nulls AND in-range)."""
    plen = views[0].shape[0]
    dev = views[0].device
    packed = torch.zeros(plen, dtype=I64, device=dev)
    ok = torch.ones(plen, dtype=torch.bool, device=dev)
    for v, valid, off, width, span in zip(views, valids, offsets, widths,
                                          spans):
        k = v.to(I64) - off
        ok = ok & (k >= 0) & (k <= span)
        if valid is not None:
            ok = ok & valid
        packed = (packed << width) | k.clamp(0, span)
    return packed, ok


def pk_gather_join_multi(fact_keys, dim_keys, n_fact, n_dim,
                         f_excl=None, d_excl=None):
    """Composite-key merge probe against a UNIQUE key set: pack every key
    into one int64 (widths from the dim side's value spans — one range
    sync, identity-cached per key set) and run the single-key exact probe.
    Returns ``(r_idx, matched)`` or None when the keys cannot pack."""
    if len(fact_keys) == 1:
        return pk_gather_join(fact_keys[0], dim_keys[0], n_fact, n_dim,
                              f_excl, d_excl)
    kinds = {c.kind for c in list(fact_keys) + list(dim_keys)}
    if any(k in ("str", "f64") or k.startswith("dec") for k in kinds):
        return None
    if isinstance(n_dim, DeviceCount):
        n_dim = n_dim.to_int()
    fact_keys = [plain_col(c) for c in fact_keys]
    dim_keys = [plain_col(c) for c in dim_keys]

    def compute():
        def fetch():
            mins, maxs = _int_key_ranges(
                tuple(c.data for c in dim_keys), n_dim)
            return to_host(mins), to_host(maxs)

        mins, maxs = timed_read("dim_ranges", fetch)
        offsets, widths, spans, total = [], [], [], 0
        for lo, hi in zip(mins, maxs):
            span = max(int(hi) - int(lo), 0)
            width = max(int(span).bit_length(), 1)
            offsets.append(int(lo))
            widths.append(width)
            spans.append(span)
            total += width
        if total > 62:
            return None
        return tuple(offsets), tuple(widths), tuple(spans)

    plan = _identity_cache(_dim_span_cache, 128,
                           tuple(c.data for c in dim_keys), compute,
                           static_key=n_dim, reads_host=True)
    if plan is None:
        return None
    offsets, widths, spans = plan
    fpacked, fok = _pack_keys_impl(
        tuple(c.data for c in fact_keys),
        tuple(c.valid for c in fact_keys), offsets, widths, spans)
    dpacked, dok = _pack_keys_impl(
        tuple(c.data for c in dim_keys),
        tuple(c.valid for c in dim_keys), offsets, widths, spans)
    return _pk_gather_impl(fpacked, fok, dpacked, dok, count_arr(n_fact),
                           n_dim, f_excl, d_excl)


def _null_column_like(col: Column, n: int) -> Column:
    dev = col.data.device
    data = torch.zeros((n,) + tuple(col.data.shape[1:]),
                       dtype=col.data.dtype, device=dev)
    return Column(col.kind, data, torch.zeros(n, dtype=torch.bool,
                                              device=dev),
                  col.dict_values, enc=col.enc)


# candidate-pair budget of one materialized join chunk: beyond it the inner
# join splits the probe side into capacity-bounded spans
PAIR_BUDGET = 1 << 22


def _pow2_ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length() if n > 2 else 2


def stream_fanout() -> int:
    """Stream-bounds pair-bucket fanout: inside the streamed chunk
    pipeline a hash join cannot sync for its candidate total, so the
    bucket is the probe side's bound times this power-of-two allowance;
    overflow falls back to the eager loop. The ``stream_fanout`` setting,
    rounded up to a power of two."""
    return _pow2_ceil(int(setting("stream_fanout")))


def _chunk_spans(counts_np, budget):
    """Greedy contiguous spans of probe rows whose candidate-pair sums stay
    within ``budget`` (a single row exceeding it gets its own span)."""
    n = len(counts_np)
    cum = np.cumsum(counts_np, dtype=np.int64)
    spans, s = [], 0
    while s < n:
        base = cum[s - 1] if s else 0
        e = int(np.searchsorted(cum, base + budget, side="right"))
        if e <= s:
            e = s + 1                    # oversized single row: own span
        spans.append((s, e))
        s = e
    return spans


def _chunked_inner_join(left, right, left_keys, right_keys, probe,
                        residual_fn) -> DeviceTable:
    """Inner join materialized span-by-span so peak memory is bounded by
    ``PAIR_BUDGET`` pairs, with residual predicates applied per span."""
    counts, lo, order, total = probe
    plen_r = len(right_keys[0])
    dev = counts.device

    def fetch():
        counts_np = to_host(counts)
        return (_chunk_spans(counts_np, PAIR_BUDGET),
                np.concatenate([[0], np.cumsum(counts_np)]))

    spans, cum = timed_read("chunk_spans", fetch)
    parts, schema_chunk = [], None
    row = torch.arange(counts.shape[0], device=dev)
    for (s, e) in spans:
        span_total = int(cum[e] - cum[s])
        if span_total == 0:
            continue
        cand = bucket_len(span_total)
        l_idx, r_idx = _pair_indices(counts, lo, order, cand, plen_r,
                                     (row >= s) & (row < e))
        ok = _verify_pairs(l_idx, r_idx, left_keys, right_keys)
        ok = ok & live_mask(cand, span_total, dev)
        raw = DeviceTable(
            {**gather_table_rows(left, l_idx, cand).columns,
             **gather_table_rows(right, r_idx, cand).columns}, cand)
        schema_chunk = raw
        if residual_fn is not None:
            ok = ok & residual_fn(raw)
        n_live = host_sync(ok.sum())                   # host sync per span
        if n_live == 0:
            continue
        keep = compact_indices(ok, n_live)
        parts.append(take_padded(raw, keep, n_live))
    if not parts:
        empty = torch.zeros(bucket_len(0), dtype=I64, device=dev)
        return take_padded(schema_chunk, empty + schema_chunk.plen, 0)
    return concat_tables(parts) if len(parts) > 1 else parts[0]


def _exchange_inner_join(left, right, left_on, right_on, mesh,
                         residual_fn) -> DeviceTable:
    """Repartition join of two row-sharded sides (both past the broadcast
    threshold; the planner's repartition arm). Each shard hashes its
    keys with the join's own hash, the (hash, row id) pairs of both sides
    move through the all-to-all exchange on the shards as they stand
    (``exchange_join_pairs``) and each shard probes its co-partitioned
    key range. The matched pairs are verified against the key columns
    (gathered whole), put in the unmeshed join's order (left row, then
    right row) and counted a shard a side with one host sync; then each
    side's rows come to the first shard's device by the cheaper of two
    moves (``sharded.rows_at``): with fewer pairs than the side has rows,
    each shard hands over just its matched rows, else the whole side
    gathers. The residual predicate applies there. Row ids index each
    side's physical rows in shard order (``sharded.shard_offsets``)."""
    from nds_tpu_torch.engine import sharded as SH
    from nds_tpu_torch.parallel.exchange import (Sharded,
                                                 exchange_join_pairs,
                                                 gather_rows)
    SH.COUNTS["exchange_joins"] += 1
    S = mesh.size
    l_offs, r_offs = SH.shard_offsets(left), SH.shard_offsets(right)
    lh, rh, lrow, rrow = [], [], [], []
    for i, dev in enumerate(mesh.devices):
        g = mesh.first + i
        lp, rp = left.parts[i], right.parts[i]
        with device_scope(dev):
            lk = [lp[c] for c in left_on]
            rk = [rp[c] for c in right_on]
            lviews, rviews = _hash_views(lk, rk)
            lh.append(_key_hash_impl(lviews, tuple(c.valid for c in lk), 0,
                                     False, count_arr(lp.nrows)))
            rh.append(_key_hash_impl(rviews, tuple(c.valid for c in rk), 1,
                                     False, count_arr(rp.nrows)))
            lrow.append(l_offs[g] + torch.arange(lp.plen, dtype=I64,
                                                 device=dev))
            rrow.append(r_offs[g] + torch.arange(rp.plen, dtype=I64,
                                                 device=dev))
    l_idx, r_idx, live = exchange_join_pairs(
        Sharded(lh, mesh), Sharded(lrow, mesh), Sharded(rh, mesh),
        Sharded(rrow, mesh), mesh)
    if mesh.world > 1:
        # every process goes on with every pair
        l_idx, r_idx, live = (gather_rows([x], mesh)
                              for x in (l_idx, r_idx, live))
    lk = SH.physical(left.select(list(left_on)))
    rk = SH.physical(right.select(list(right_on)))
    with device_scope(mesh.devices[0]) as dev:
        ok = live & _verify_pairs(l_idx, r_idx, [lk[c] for c in left_on],
                                  [rk[c] for c in right_on])
        del lk, rk

        def per_shard(idx, offs):
            # the pairs whose row lies on each global shard: the pairs at
            # or past each shard's first row, differenced (reductions
            # against scalars, no host contact)
            past = torch.stack([(ok & (idx >= b)).sum() for b in offs[:S]]
                               + [torch.zeros((), dtype=I64, device=dev)])
            return past[:S] - past[1:]

        counts = torch.cat([per_shard(l_idx, l_offs),
                            per_shard(r_idx, r_offs)])
        counts = timed_read("exch_pairs",                # host sync
                            lambda: [int(x) for x in counts.tolist()])
        n_pairs = sum(counts[:S])
        order = prim.lexsort2(torch.where(ok, r_idx, r_offs[-1]),
                              torch.where(ok, l_idx, l_offs[-1]))[:n_pairs]
        cap = bucket_len(n_pairs)
        matched = DeviceTable(
            {**SH.rows_at(left, prim.take_clip(l_idx, order), l_offs,
                          counts[:S], cap, ascending=True).columns,
             **SH.rows_at(right, prim.take_clip(r_idx, order), r_offs,
                          counts[S:], cap).columns}, n_pairs)
        if residual_fn is not None:
            mask = residual_fn(matched) & live_mask(matched.plen, n_pairs)
            matched = compact_table(matched, mask)
    return matched


def join_tables(left: DeviceTable, right: DeviceTable, left_on, right_on,
                how: str = "inner", l_excl=None, r_excl=None,
                residual_fn=None) -> DeviceTable:
    """Materialized equi-join of two tables; column name collisions must be
    resolved by the caller. ``residual_fn`` (inner joins) maps a
    materialized pair table to a keep mask.

    A row-sharded left side of an inner join (engine/sharded.py) joins
    shard by shard against a replicated or whole right side, and through
    the repartition join against a row-sharded one; any other join reads
    its sides whole."""
    from nds_tpu_torch.engine import sharded as SH
    if how == "inner" and l_excl is None and SH.is_row(left):
        if not SH.is_row(right):
            return SH.probe_join(left, right, left_on, right_on, r_excl,
                                 residual_fn)
        if r_excl is None and right.mesh is left.mesh:
            # both sides row-sharded => repartition join over the exchange
            # (tables under the broadcast threshold are replicated at
            # registration, so fact x dim joins never take this path)
            return _exchange_inner_join(left, right, left_on, right_on,
                                        left.mesh, residual_fn)
    left_keys = [left[c] for c in left_on]
    right_keys = [right[c] for c in right_on]
    probe = None
    if how == "inner":
        probe = _probe_candidates(left_keys, right_keys,
                                  n_left=left.nrows, n_right=right.nrows,
                                  l_excl=l_excl, r_excl=r_excl)
        # probe[3] is None under stream-bounds: the span-by-span join
        # syncs per span, so the streamed path always takes the
        # bound-bucket monolithic arm below
        if probe[3] is not None and probe[3] > PAIR_BUDGET:
            return _chunked_inner_join(left, right, left_keys, right_keys,
                                       probe, residual_fn)
    l_idx, r_idx, n_pairs, l_extra, n_lx, r_extra, n_rx = join_indices(
        left_keys, right_keys, how,
        n_left=left.nrows, n_right=right.nrows,
        l_excl=l_excl, r_excl=r_excl, probe=probe)
    matched = DeviceTable(
        {**gather_table_rows(left, l_idx, n_pairs).columns,
         **gather_table_rows(right, r_idx, n_pairs).columns}, n_pairs)
    if residual_fn is not None and how == "inner":
        mask = residual_fn(matched) & live_mask(matched.plen, n_pairs,
                                                l_idx.device)
        matched = compact_table(matched, mask)
    parts = [matched]
    if l_extra is not None and n_lx:
        cols = dict(gather_table_rows(left, l_extra, n_lx).columns)
        cols.update({n: _null_column_like(c, int(l_extra.shape[0]))
                     for n, c in right.columns.items()})
        parts.append(DeviceTable(cols, n_lx))
    if r_extra is not None and n_rx:
        cols = {n: _null_column_like(c, int(r_extra.shape[0]))
                for n, c in left.columns.items()}
        cols.update(gather_table_rows(right, r_extra, n_rx).columns)
        parts.append(DeviceTable(cols, n_rx))
    return concat_tables(parts) if len(parts) > 1 else matched


# ---------------------------------------------------------------------------
# concatenation (UNION ALL) with dictionary merging
# ---------------------------------------------------------------------------


_union_cache: dict = {}


def _align_str_dicts(cols):
    """(per-part code tensors, shared dictionary) for string columns whose
    dictionaries may differ: remap every part's codes into one merged
    value table (identity fast path when all parts share one dictionary).
    The merged dictionary is cached per input-dictionary identity tuple so
    repeated executions hand out the SAME host object."""
    dicts = [c.dict_values for c in cols]
    if all(d is dicts[0] for d in dicts):
        return [c.data for c in cols], dicts[0]

    def compute():
        union, inverse = np.unique(
            np.concatenate([d.astype(str) for d in dicts]),
            return_inverse=True)
        maps, off = [], 0
        for d in dicts:
            maps.append(inverse[off:off + len(d)].astype(np.int32))
            off += len(d)
        return maps, union.astype(object)

    maps, union = _identity_cache(_union_cache, 256, tuple(dicts), compute)
    return [prim.take(host_table(m, c.data.device), c.data)
            for m, c in zip(maps, cols)], union


def _align_encodings(cols):
    """Decode parts whose encodings differ; identical encodings
    concatenate narrow and stay encoded."""
    enc0 = cols[0].enc
    if all(encs_equal(c.enc, enc0) for c in cols) and \
            len({c.data.dtype for c in cols}) == 1:
        return cols, enc0
    return [plain_col(c) for c in cols], None


def concat_columns(cols) -> Column:
    kind = cols[0].kind
    if kind == "str":
        datas, dict_values = _align_str_dicts(cols)
        data = torch.cat(datas)
        valid = _concat_valids(cols)
        return Column("str", data.to(torch.int32), valid, dict_values)
    cols, enc = _align_encodings(cols)
    data = torch.cat([c.data for c in cols])
    return Column(kind, data, _concat_valids(cols), enc=enc)


def _concat_valids(cols):
    if all(c.valid is None for c in cols):
        return None
    return torch.cat([c.valid_mask() for c in cols])


def concat_tables(tables) -> DeviceTable:
    """UNION ALL. Physical concatenation interleaves each part's pad rows, so
    the result is re-compacted back to prefix-padded form; the logical counts
    are resolved on host (all parts in one batched transfer)."""
    names = tables[0].column_names
    total = sum(count_int(t.nrows) for t in tables)
    if not names:
        return DeviceTable({}, total, plen=max(bucket_len(total), total))
    out = {}
    for n in names:
        cols = [t[n] for t in tables]
        kind = cols[0].kind
        enc = None
        if kind == "str":
            datas, dict_values = _align_str_dicts(cols)
        else:
            cols, enc = _align_encodings(cols)
            datas, dict_values = [c.data for c in cols], None
        d = torch.cat(datas)
        if kind == "str":
            d = d.to(torch.int32)
        v = None if all(c.valid is None for c in cols) else \
            torch.cat([c.valid_mask() for c in cols])
        out[n] = Column(kind, d, v, dict_values, enc)
    dev = out[names[0]].data.device
    live = torch.cat([torch.arange(t.plen, device=dev) < count_int(t.nrows)
                      for t in tables])
    raw = DeviceTable(out, total)
    # fast path only when the summed physical length is itself a bucket
    if total == int(live.shape[0]) and total == bucket_len(total):
        return raw                                    # no pads anywhere
    idx = compact_indices(live, total)
    return take_padded(raw, idx, total)


# ---------------------------------------------------------------------------
# sort / limit
# ---------------------------------------------------------------------------


def limit_table(table: DeviceTable, n: int) -> DeviceTable:
    """First ``n`` logical rows (callers sort first; pads always trail).
    LIMIT is output-shaping: a lazy count legitimately resolves here."""
    new_n = min(n, count_int(table.nrows))
    cap = bucket_len(new_n)
    if cap >= table.plen:
        return DeviceTable(dict(table.columns), new_n)
    dev = next(iter(table.columns.values())).data.device \
        if table.columns else device()
    return gather_table_rows(table, torch.arange(cap, device=dev), new_n)
