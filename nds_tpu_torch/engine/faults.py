# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Fault registry and recovery policies: every failure seam named,
bounded and recoverable.

* **Registry** — :data:`SEAMS` names every failure seam with its
  classification (``transient`` / ``degradable`` / ``fatal``) and its
  recovery policy. A seam that is not registered cannot be injected.
* **Deterministic injection** — ``NDS_TPU_FAULT=seam:kind:nth`` (read at
  use, never at import) makes the ``nth`` occurrence of
  :func:`fault_point` at ``seam`` raise :class:`FaultInjected`
  (``kind=error``), or sleep ``NDS_TPU_FAULT_HANG_S`` seconds first
  (``kind=hang``: the hung fetch the watchdog must beat). One injection
  fires per process per spec; occurrences are counted under a lock, so
  threads agree on ``nth``.
* **Recovery policies** — ``transient`` seams recover through
  :func:`with_retry` (bounded attempts, deterministic backoff);
  ``degradable`` seams take the degradation ladder (compiled -> eager),
  recorded as evidence; ``fatal`` seams raise a classified
  :class:`FaultError` promptly.
* **FaultEvent evidence** — every recovery records a :class:`FaultEvent`
  into a thread-scoped bounded ring, drained per query by the drivers
  into ``faultEvents`` beside ``streamedScans`` and into the ledger.
* **Statement watchdog** — ``NDS_TPU_STATEMENT_DEADLINE_S`` arms a
  per-statement deadline: :func:`bounded_call` runs a blocking fetch on
  a daemon helper thread and raises :class:`StatementTimeout` (status
  ``timeout`` in the drivers) when the statement's remaining budget runs
  out. Unset (the default) the call runs inline: no thread, no cost.
  The helper thread has none of the caller's thread-local state; a
  caller whose fetch depends on some (a CUDA stream) passes it in
  (``engine/ops.py`` does).

Standard library only: the bench parent imports it without torch.
Shared state: the occurrence counters are one dict under one lock
(``_FAULT_LOCK``); the event ring and the statement clock are
thread-local.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass

TRANSIENT = "transient"
DEGRADABLE = "degradable"
FATAL = "fatal"


@dataclass(frozen=True)
class Seam:
    """One registered failure seam: where it lives, how it is classified,
    and its recovery policy. ``retries`` is the
    bounded attempt allowance of a transient seam's :func:`with_retry`
    (total attempts = retries + 1); ``retry_on`` names the exception
    types the retry treats as transient — anything else propagates
    unchanged, so a genuine engine bug is never masked by a retry loop."""

    name: str
    where: str
    classify: str
    recovery: str
    retries: int = 0
    retry_on: tuple = ()


# THE registry: every fault_point() call names one of these. Order is
# documentation order (DESIGN.md's seam table mirrors it; tests assert
# the mirror).
SEAMS = {s.name: s for s in (
    Seam("prefetch", "engine/prefetch.py worker (slice+encode+upload)",
         TRANSIENT,
         "bounded retry of the prepare step on the worker; exhausted or "
         "non-transient errors re-raise at the driver's next fetch "
         "exactly like the inline path",
         retries=2, retry_on=("FaultInjected", "OSError")),
    Seam("device-put", "engine/stream.py StreamPipeline._prepare_first / "
         "_preparer (host->device upload)",
         TRANSIENT,
         "covered by the prefetch seam's bounded retry (prepare wraps "
         "the upload); inline/depth-0 paths retry on the driver",
         retries=2, retry_on=("FaultInjected", "OSError")),
    Seam("pipeline-compile", "engine/stream.py _build_pipeline "
         "(record of the per-chunk program)",
         DEGRADABLE,
         "degrade compiled->eager: the statement reruns through the "
         "eager chunk loop, bit for bit, recorded as a fault event"),
    Seam("exchange", "engine/stream.py StreamPipeline._drive_static / "
         "_drive_eager (the sharded pipeline's per-chunk exchange)",
         DEGRADABLE,
         "degrade sharded->single-device eager rerun, bit-for-bit"),
    Seam("chunk-store-read", "io/chunk_store.py load_plan, recovered in "
         "engine/table.py ChunkedTable._wire_plan",
         TRANSIENT,
         "corrupt entry (checksum/torn write): delete + re-encode from "
         "the source arrow once; version drift stays a loud fatal "
         "refusal (operator action)",
         retries=1, retry_on=("FaultInjected",)),
    Seam("chunk-store-write", "io/chunk_store.py save_plan, degraded in "
         "engine/table.py ChunkedTable._wire_plan",
         DEGRADABLE,
         "best-effort persist: a failed/contended/killed write degrades "
         "to the in-memory wire plan; a killed writer leaves old-valid "
         "or none (lock-file steal by pid liveness)"),
    Seam("sync", "engine/ops.py timed_read/host_sync/resolve_counts "
         "(blocking device->host fetch)",
         TRANSIENT,
         "bounded retry of the idempotent fetch; under "
         "NDS_TPU_STATEMENT_DEADLINE_S a hung fetch raises "
         "StatementTimeout (status 'timeout') instead of hanging",
         retries=1, retry_on=("FaultInjected", "OSError")),
    Seam("ledger-write", "obs/ledger.py Ledger.write (flush+fsync)",
         TRANSIENT,
         "one bounded retry, then degrade: the write is skipped with a "
         "stderr note and a write_failures count — evidence loss is "
         "recorded, the campaign continues",
         retries=1, retry_on=("FaultInjected", "OSError")),
    Seam("bench-child", "bench.py ChildServer.start (persistent serving "
         "child) and the campaign's arm spawn",
         TRANSIENT,
         "restart with deterministic-jittered backoff; 2 consecutive "
         "setup failures trip the circuit breaker into a labeled "
         "partial artifact (fail fast, never a burned round)"),
    Seam("peer", "parallel/multihost.py maybe_initialize (the "
         "federation's coordinator/peer attach)",
         FATAL,
         "classified FaultError raised promptly (no silent retry loop: "
         "a half-formed federation must never run a collective); under "
         "a deadline a stuck attach raises StatementTimeout"),
)}


class FaultError(RuntimeError):
    """Base classified error of the fault layer: carries the seam name so
    drivers and tests can attribute it without string
    matching. Every path out of a failed recovery raises one of these
    (or re-raises the original, non-transient exception unchanged)."""

    def __init__(self, seam: str, message: str):
        super().__init__(message)
        self.seam = seam


class FaultInjected(FaultError):
    """The deterministic injected fault (``NDS_TPU_FAULT``). Recovery
    paths treat it exactly like the real fault it simulates."""


class StatementTimeout(FaultError):
    """The statement's ``NDS_TPU_STATEMENT_DEADLINE_S`` budget ran out
    inside a blocking wait: the watchdog's classified error. Drivers map
    it to status ``timeout``; the helper thread stays blocked (daemon)
    but the process — and the campaign — moves on."""


@dataclass
class FaultEvent:
    """One recovery (or classified failure) at a registered seam — the
    evidence record the drivers drain per query next to StreamEvents.
    ``action``: ``recovered`` (transient retry succeeded) | ``degrade``
    (ladder step taken) | ``timeout`` (watchdog fired) | ``fatal``
    (classified error raised) | ``note`` (diagnostic, e.g. heartbeat
    survival)."""

    seam: str
    action: str
    attempt: int = 0
    detail: str = ""


def fault_event_json(e: FaultEvent) -> dict:
    """The ONE JSON shape of a FaultEvent in driver summaries
    (``faultEvents`` next to ``streamedScans``) and the campaign
    ledger."""
    out = {"seam": e.seam, "action": e.action}
    if e.attempt:
        out["attempt"] = e.attempt
    if e.detail:
        out["detail"] = str(e.detail)[:200]
    return out


_fault_tls = threading.local()


def record_fault_event(seam: str, action: str, attempt: int = 0,
                       detail: str = "") -> None:
    """Record one recovery event, thread-scoped like the sync counters
    and StreamEvents (concurrent streams account their own
    recoveries). Suppressed under ``NDS_TPU_FAULT_DRIFT``
    (:func:`_drift`)."""
    if _drift():
        return
    lst = getattr(_fault_tls, "events", None)
    if lst is None:
        # deque(maxlen): diagnostics ring, never unbounded, O(1) evict
        lst = _fault_tls.events = deque(maxlen=1000)
    lst.append(FaultEvent(seam, action, attempt, detail))


def _drift() -> bool:
    """``NDS_TPU_FAULT_DRIFT``: recovery suppressed, for the fault
    harness's self-test alone (``tools/fault_diff.py --inject-drift``):
    :func:`with_retry` stops retrying and no event is recorded, so every
    recovery check of the harness must fail. Never set outside it."""
    return bool(os.environ.get("NDS_TPU_FAULT_DRIFT"))


def drain_fault_events() -> list:
    """Return and clear the calling thread's fault events (oldest first;
    the ring keeps the newest 1000) — the per-query drain the drivers
    run, mirroring ``listener.drain_stream_events``."""
    lst = getattr(_fault_tls, "events", None)
    if not lst:
        return []
    out = list(lst)
    lst.clear()
    return out


# ---------------------------------------------------------------------------
# deterministic injection
# ---------------------------------------------------------------------------

# process-global occurrence counters: seam -> times fault_point() was
# reached while an injection spec targeted it. ONE dict, ONE dedicated
# lock, reset by tests between injections.
_FAULT_COUNTS: dict = {}
_FAULT_LOCK = threading.Lock()


def fault_spec():
    """Parse ``NDS_TPU_FAULT=seam:kind:nth`` (read at USE time). Returns
    ``(seam, kind, nth)`` or None. Unknown seams raise: a typo'd
    injection silently never firing would make a fault test pass
    vacuously."""
    env = os.environ.get("NDS_TPU_FAULT", "").strip()
    if not env:
        return None
    parts = env.split(":")
    seam = parts[0]
    kind = parts[1] if len(parts) > 1 and parts[1] else "error"
    try:
        nth = int(parts[2]) if len(parts) > 2 else 1
    except ValueError:
        nth = 1
    if seam not in SEAMS:
        raise ValueError(f"NDS_TPU_FAULT names unregistered seam "
                         f"{seam!r} (known: {sorted(SEAMS)})")
    if kind not in ("error", "hang"):
        raise ValueError(f"NDS_TPU_FAULT kind {kind!r} not in "
                         "('error', 'hang')")
    return seam, kind, max(nth, 1)


def hang_seconds() -> float:
    """``NDS_TPU_FAULT_HANG_S`` (default 30): how long a ``hang``-kind
    injection blocks before raising — long enough that an un-watchdogged
    statement visibly hangs, bounded so nothing wedges forever."""
    try:
        return float(os.environ.get("NDS_TPU_FAULT_HANG_S", "30"))
    except ValueError:
        return 30.0


def reset_fault_counts() -> None:
    """Zero the occurrence counters, so ``nth`` counts from a known
    state."""
    with _FAULT_LOCK:
        _FAULT_COUNTS.clear()


def fired_count(seam: str) -> int:
    """How many fault_point() occurrences the seam has seen since the
    last reset while targeted: the check that an injection fired."""
    with _FAULT_LOCK:
        return _FAULT_COUNTS.get(seam, 0)


def fault_point(seam: str, detail: str = "") -> None:
    """The injection seam: a no-op unless ``NDS_TPU_FAULT`` targets
    ``seam``, in which case the ``nth`` occurrence raises
    :class:`FaultInjected` (``kind=hang`` sleeps ``NDS_TPU_FAULT_HANG_S``
    first — the hung-sync simulation). Exactly one injection fires per
    spec per process; occurrences are counted under the lock so
    concurrent threads agree on ``nth``. Callers place this at the TOP
    of the seam's real work, so the simulated fault interrupts exactly
    where a real one would."""
    spec = fault_spec()
    if spec is None or spec[0] != seam:
        return
    _seam, kind, nth = spec
    with _FAULT_LOCK:
        n = _FAULT_COUNTS[seam] = _FAULT_COUNTS.get(seam, 0) + 1
    if n != nth:
        return
    if kind == "hang":
        time.sleep(hang_seconds())
    raise FaultInjected(seam, f"injected fault at seam {seam!r}"
                        + (f" ({detail})" if detail else ""))


# ---------------------------------------------------------------------------
# recovery: bounded deterministic retry
# ---------------------------------------------------------------------------

# deterministic backoff schedule base (seconds): attempt k sleeps
# base * 2^k — no randomness, so a test's wall bound holds
_BACKOFF_BASE_S = 0.02


def _is_transient(exc: BaseException, seam: Seam) -> bool:
    names = {t.__name__ for t in type(exc).__mro__}
    return bool(names & set(seam.retry_on))


def with_retry(seam_name: str, fn, record=record_fault_event):
    """Run ``fn`` under the seam's bounded-retry policy: an exception in
    the seam's ``retry_on`` set retries up to ``retries`` times with
    deterministic backoff; success after k>0 failures records ONE
    ``recovered`` FaultEvent (via ``record`` — ring workers pass a
    sink that re-records on the driver thread); exhaustion re-raises
    the last transient error unchanged (already classified when it is a
    FaultError). Non-transient exceptions propagate untouched on the
    FIRST attempt — a retry loop must never mask an engine bug."""
    seam = SEAMS[seam_name]
    attempts = 1 + (0 if _drift() else max(seam.retries, 0))
    last = None
    for k in range(attempts):
        try:
            out = fn()
        except BaseException as exc:
            if not _is_transient(exc, seam) or k + 1 >= attempts:
                raise
            last = exc
            time.sleep(_BACKOFF_BASE_S * (1 << k))
            continue
        if k > 0:
            ev_seam = last.seam if isinstance(last, FaultError) \
                else seam_name
            record(ev_seam, "recovered", attempt=k,
                   detail=f"{type(last).__name__}: {last}")
        return out
    raise AssertionError("unreachable")  # pragma: no cover


# ---------------------------------------------------------------------------
# statement watchdog
# ---------------------------------------------------------------------------


def statement_deadline_s() -> float | None:
    """``NDS_TPU_STATEMENT_DEADLINE_S`` (read at use; unset/<=0 = off):
    the per-statement wall budget the watchdog enforces at every
    bounded wait."""
    env = os.environ.get("NDS_TPU_STATEMENT_DEADLINE_S", "").strip()
    if not env:
        return None
    try:
        v = float(env)
    except ValueError:
        return None
    return v if v > 0 else None


_stmt_tls = threading.local()


class statement_scope:
    """Thread-scoped statement clock (entered by ``Session.sql``): the
    watchdog charges every bounded wait against ONE per-statement
    budget, so N slow fetches cannot each consume a fresh deadline.
    Re-entrant statements (a view definition executing a query) keep the
    OUTER clock — the statement the user is waiting on."""

    def __enter__(self):
        self._outer = getattr(_stmt_tls, "start", None)
        if self._outer is None:
            _stmt_tls.start = time.monotonic()
        return self

    def __exit__(self, *exc):
        if self._outer is None:
            _stmt_tls.start = None
        return False


def _remaining_s() -> float | None:
    """Remaining statement budget, or None when the watchdog is off.
    Outside any statement scope the full deadline applies per wait."""
    deadline = statement_deadline_s()
    if deadline is None:
        return None
    start = getattr(_stmt_tls, "start", None)
    if start is None:
        return deadline
    return deadline - (time.monotonic() - start)


def bounded_call(seam_name: str, fn):
    """Run a blocking wait under the statement watchdog. Watchdog off
    (the default): call inline — zero threads, zero overhead,
    bit-for-bit today's path. Armed: the call runs on a daemon helper
    thread and the driver waits at most the statement's REMAINING
    budget; expiry records a ``timeout`` FaultEvent and raises
    :class:`StatementTimeout` (the helper stays blocked — an
    interruptible hang does not exist in-process; the classified error
    is the contract). A helper-thread exception re-raises on the
    driver unchanged."""
    remaining = _remaining_s()
    if remaining is None:
        return fn()
    if remaining <= 0:
        record_fault_event(seam_name, "timeout",
                           detail="statement budget exhausted")
        raise StatementTimeout(
            seam_name, f"statement deadline "
            f"({statement_deadline_s()}s) already exhausted before the "
            f"{seam_name!r} wait")
    box: list = []
    done = threading.Event()

    def runner():
        try:
            box.append(("ok", fn()))
        except BaseException as exc:  # propagate to the driver, always
            box.append(("err", exc))
        finally:
            done.set()

    t = threading.Thread(target=runner, daemon=True,
                         name=f"nds-watchdog-{seam_name}")
    t.start()
    if not done.wait(timeout=remaining):
        record_fault_event(seam_name, "timeout",
                           detail=f"blocked > {remaining:.1f}s remaining")
        raise StatementTimeout(
            seam_name, f"{seam_name!r} wait exceeded the statement "
            f"deadline (NDS_TPU_STATEMENT_DEADLINE_S="
            f"{statement_deadline_s()}); statement marked timeout")
    kind, val = box[0]
    if kind == "err":
        raise val
    return val
