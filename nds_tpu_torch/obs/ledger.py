# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Campaign evidence ledger: the durable, validated artifact of a run.

One append-only JSONL record that the Power Run (``--ledger``) and the
bench entry (``NDS_BENCH_RESULTS_JSONL``) write and every post-hoc tool
(``nds_tpu_torch.tools.bench_compare``) reads:

* **schema-versioned**: every record carries ``"v": LEDGER_VERSION``;
  a loader meeting a version it does not understand refuses loudly
  instead of silently misreading fields;
* **flushed per record**: each ``write()`` flushes and fsyncs, so a
  SIGKILL loses at most the in-flight statement — and the loader
  tolerates a torn final line (reported, never fatal). Non-JSON lines
  elsewhere are skipped like legacy chatter (a resumed-after-kill file
  legitimately carries an old torn line mid-file); a VERSIONED record
  that fails validation is rejected wherever it sits;
* **self-describing**: a ``meta`` record opens the campaign (driver,
  platform, scale), a terminal ``end`` record closes it
  (``completed`` / ``aborted``, queries done, wall seconds), so a
  ledger with no ``end`` record IS the signature of a kill;
* **evidence-bearing**: each ``query`` record carries the wall time,
  phase rollup, sync counts and the streamed-scan aggregate
  (:func:`evidence_from_scans`: chunks, syncs, upload bytes,
  partitions, the compiled/eager split and fallback reasons).

Record kinds and their required fields (beyond ``v``/``kind``/``t``):

======== ==================================================
meta     driver; optional platform, scale, anything else
query    name, status ("ok" | "error" | "timeout")
progress (heartbeat) — optional query/done/total/elapsedS
metrics  scope ("query" | "stream"), metricsV — live-metrics
         rollup (:mod:`nds_tpu_torch.obs.metrics`)
end      status ("completed" | "aborted")
======== ==================================================

Legacy bench resume lines (bare ``{"name":…, "ms":…}`` query results and
``{"platform":…}`` meta lines) are normalized by the loader.

Standard library only, like the fault registry and the metrics
registry it uses: the bench parent imports all three without torch.
"""

from __future__ import annotations

import io
import json
import os
import sys
import threading
import time

from nds_tpu_torch.engine import faults as _F
from nds_tpu_torch.obs import metrics as _metrics

LEDGER_VERSION = 1
# the live-metrics rollup schema carried by `metrics` records — its own
# gate, separate from the envelope version: rollup shapes (bucket
# layout, quantile keys) can evolve without re-versioning every record.
# Must match metrics.METRICS_VERSION (pinned by test).
METRICS_VERSION = 1


# record kinds -> required fields (beyond v/kind/t)
_REQUIRED = {
    "meta": ("driver",),
    "query": ("name", "status"),
    "progress": (),
    "metrics": ("scope",),
    "end": ("status",),
}

_QUERY_STATUSES = ("ok", "error", "timeout")
_END_STATUSES = ("completed", "aborted")


class LedgerError(ValueError):
    """A ledger file that cannot be trusted: unknown schema version,
    invalid record shape, or mid-file corruption. Deliberately loud —
    resuming a campaign from a misread ledger would silently re-pay or
    drop measured queries."""


def _validate(rec: dict, lineno: int) -> dict:
    if not isinstance(rec, dict):
        raise LedgerError(f"ledger line {lineno}: record is not an object")
    v = rec.get("v")
    if v != LEDGER_VERSION:
        raise LedgerError(
            f"ledger line {lineno}: schema version {v!r} is not the "
            f"supported version {LEDGER_VERSION} — refusing to guess at "
            "an unknown record shape (upgrade the reader, or re-record)")
    kind = rec.get("kind")
    if kind not in _REQUIRED:
        raise LedgerError(f"ledger line {lineno}: unknown record kind "
                          f"{kind!r} (known: {sorted(_REQUIRED)})")
    missing = [k for k in _REQUIRED[kind] if k not in rec]
    if missing:
        raise LedgerError(f"ledger line {lineno}: {kind} record missing "
                          f"required field(s) {missing}")
    if kind == "query" and rec["status"] not in _QUERY_STATUSES:
        raise LedgerError(f"ledger line {lineno}: query status "
                          f"{rec['status']!r} not in {_QUERY_STATUSES}")
    if kind == "end" and rec["status"] not in _END_STATUSES:
        raise LedgerError(f"ledger line {lineno}: end status "
                          f"{rec['status']!r} not in {_END_STATUSES}")
    if kind == "metrics" and rec.get("metricsV") != METRICS_VERSION:
        # same refusal discipline as the envelope version: silently
        # misreading an evolved rollup shape would corrupt a comparison
        raise LedgerError(
            f"ledger line {lineno}: metrics record version "
            f"{rec.get('metricsV')!r} is not the supported version "
            f"{METRICS_VERSION} — refusing to guess at an unknown "
            "rollup shape (upgrade the reader, or re-record)")
    return rec


def _normalize_legacy(msg: dict) -> dict | None:
    """Map a pre-ledger bench resume line onto a v1 record, or None
    for unrecognized chatter (old files tolerated stray lines).
    Records claiming to be ledger-shaped ('v'/'kind' present) never
    reach here — iter_ledger validates (and raises on) those."""
    if "v" in msg or "kind" in msg:
        return None
    if "name" in msg and "ms" in msg:
        return {"v": LEDGER_VERSION, "kind": "query", "t": 0.0,
                "status": "ok", **msg}
    if "name" in msg and "error" in msg:
        return {"v": LEDGER_VERSION, "kind": "query", "t": 0.0,
                "status": "error", **msg}
    if "platform" in msg and len(msg) == 1:
        return {"v": LEDGER_VERSION, "kind": "meta", "t": 0.0,
                "driver": "bench", "platform": msg["platform"]}
    return None


def iter_ledger(path: str):
    """Yield validated records from a ledger file, oldest first.

    Tolerances, exactly two: a torn FINAL line (the in-flight statement
    of a kill — yielded as a ``progress`` record with ``torn: True`` so
    :func:`load_ledger` can report it) and legacy pre-ledger resume
    lines (normalized). A versioned record that fails validation —
    unknown version, unknown kind, missing fields — raises
    :class:`LedgerError` wherever it sits: a poisoned record is
    corruption, not weather."""
    with open(path) as f:
        lines = f.read().split("\n")
    # trailing newline yields one empty tail element; drop empties at the
    # end but keep interior blanks visible to the numbering
    while lines and lines[-1] == "":
        lines.pop()
    last = len(lines)
    for lineno, ln in enumerate(lines, 1):
        ln = ln.strip()
        if not ln:
            continue
        try:
            msg = json.loads(ln)
        except ValueError:
            if lineno == last:
                # torn final write from a kill: the ledger contract says
                # this costs at most the in-flight statement
                yield lineno, {"v": LEDGER_VERSION, "kind": "progress",
                               "t": 0.0, "torn": True}
                return
            # mid-file garbage: legacy resume files carried stray
            # non-JSON chatter; tolerate (skip) rather than poison
            continue
        if isinstance(msg, dict) and msg.get("v") == LEDGER_VERSION \
                and msg.get("kind") in _REQUIRED:
            yield lineno, _validate(msg, lineno)
            continue
        if isinstance(msg, dict) and ("v" in msg or "kind" in msg):
            # claims to be a ledger record but is not a valid one
            # (unknown version, unknown kind, or missing 'v'): raise —
            # silently dropping it would re-pay or undercount a query
            _validate(msg, lineno)
            continue
        legacy = _normalize_legacy(msg) if isinstance(msg, dict) else None
        if legacy is not None:
            yield lineno, legacy


class LedgerData:
    """One loaded campaign: meta, per-query records, heartbeat count,
    the terminal record (None = the campaign was killed mid-flight),
    and whether the final line was torn."""

    def __init__(self):
        self.meta: dict = {}
        self.queries: dict = {}          # name -> best record (ok wins)
        self.attempts: list = []         # every query record, file order
        self.progress = 0
        self.metrics: list = []          # live-metrics rollups, file order
        self.end: dict | None = None
        self.torn = False

    @property
    def platform(self) -> str | None:
        return self.meta.get("platform")

    def times(self) -> dict:
        """name -> wall ms over queries that COMPLETED (status ok)."""
        return {n: r["ms"] for n, r in self.queries.items()
                if r["status"] == "ok" and "ms" in r}

    def complete(self) -> bool:
        """Did the campaign close itself (terminal record present)?"""
        return self.end is not None


def load_ledger(path: str) -> LedgerData:
    """Load and validate a whole ledger file. Raises :class:`LedgerError`
    on unknown versions or malformed records; a torn final line is
    absorbed (``data.torn``) so a killed campaign still resumes."""
    data = LedgerData()
    for _lineno, rec in iter_ledger(path):
        kind = rec["kind"]
        if kind == "meta":
            # later meta refines earlier (platform discovered mid-run)
            data.meta.update(rec)
        elif kind == "query":
            # activity AFTER a terminal record means a RESUMED run is in
            # flight: the old end record no longer closes this file, and
            # only a fresh one can ("no end record = kill signature"
            # must hold for the resumed segment too)
            data.end = None
            prev = data.queries.get(rec["name"])
            data.attempts.append(rec)
            # an ok record always wins over a timeout/error retry; among
            # equals the LATEST wins (a retried success replaces)
            if prev is None or rec["status"] == "ok" \
                    or prev["status"] != "ok":
                data.queries[rec["name"]] = rec
        elif kind == "progress":
            if rec.get("torn"):
                data.torn = True
            else:
                data.progress += 1
                data.end = None          # heartbeat after end: resumed run
        elif kind == "metrics":
            # rollup activity is activity: like a heartbeat, a metrics
            # record after an end record means a resumed run is in flight
            data.end = None
            data.metrics.append(rec)
        elif kind == "end":
            data.end = rec
    return data


def evidence_from_scans(scans) -> dict:
    """Aggregate a ``streamedScans`` JSON list (the
    :func:`nds_tpu_torch.listener.stream_event_json` shape) into the compact
    per-query evidence dict the ledger carries and
    ``nds_tpu_torch.tools.bench_compare`` diffs: total syncs/chunks, upload and
    wire bytes, partition/shard/collective counts, path split and
    fallback reasons — the runtime numbers the exec/mem audits bound."""
    ev = {"scans": len(scans), "chunks": 0, "syncs": 0, "bytesH2d": 0,
          "bytesIci": 0, "collectives": 0, "partitions": 1, "shards": 1,
          "compiled": 0, "eager": 0}
    reasons = []
    for s in scans:
        ev["chunks"] += s.get("chunks", 0)
        ev["syncs"] += s.get("syncs", 0)
        ev["bytesH2d"] += max(s.get("bytesH2d", 0), 0)
        ev["bytesIci"] += max(s.get("bytesIci", 0), 0)
        ev["collectives"] += max(s.get("collectives", 0), 0)
        # driver ms blocked on the prefetch ring (measured, non-
        # deterministic — informational only, never a gated key)
        ev["prefetchStallMs"] = round(
            ev.get("prefetchStallMs", 0.0)
            + max(s.get("prefetchStallMs", 0.0), 0.0), 3)
        ev["partitions"] = max(ev["partitions"], s.get("partitions", 1))
        ev["shards"] = max(ev["shards"], s.get("shards", 1))
        if s.get("path") == "compiled":
            ev["compiled"] += 1
        else:
            ev["eager"] += 1
            if s.get("reason"):
                reasons.append(s["reason"])
    if reasons:
        ev["fallbackReasons"] = reasons
    return ev


class Ledger:
    """Append-only writer. Every record is validated before it is
    written and durably flushed (flush + fsync) so a kill can lose at
    most the statement in flight. Thread-safe: the heartbeat thread
    interleaves ``progress`` records with the main thread's ``query``
    records."""

    def __init__(self, path: str, stamp: dict | None = None, **meta):
        self.path = path
        # provenance stamp merged into EVERY record (campaign arm name,
        # env-knob fingerprint): cross-arm merges key on what the record
        # SAYS it measured, not on which file it sat in. Set before the
        # meta write below so the stamp rides that record too.
        self._stamp = dict(stamp or {})
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        preexisting = os.path.exists(path) and os.path.getsize(path) > 0
        self._f = open(path, "a")
        if preexisting:
            # seal a torn tail: a SIGKILL mid-write leaves the last line
            # unterminated, and appending straight onto it would MERGE
            # our first record into invalid JSON (losing both). A lone
            # newline turns the torn fragment into a mid-file skip the
            # loader already tolerates, and our records start clean.
            with open(path, "rb") as rf:
                rf.seek(-1, os.SEEK_END)
                sealed = rf.read(1) == b"\n"
            if not sealed:
                self._f.write("\n")
                self._f.flush()
        # REENTRANT: the bench's SIGTERM handler calls close() from the
        # main thread, which may be interrupted INSIDE write() holding
        # this lock (fsync is slow) — a plain Lock would deadlock the
        # handler and the process would hang until the -k SIGKILL,
        # exactly the killed-campaign scenario the ledger exists to
        # survive
        self._lock = threading.RLock()
        self._closed = False
        # ledger-write seam evidence: writes that degraded (skipped
        # after the bounded retry) — the campaign continues, the loss
        # is counted, finalize() can surface it
        self.write_failures = 0
        if meta and not preexisting:
            self.write("meta", **meta)

    def write(self, kind: str, **fields) -> dict:
        """One validated, durably-flushed record. The physical write is
        the ``ledger-write`` transient seam (engine/faults.py registry):
        a failed flush/fsync (full disk, injected fault) takes ONE
        bounded retry, then DEGRADES — the record is dropped with a
        stderr note and a ``write_failures`` count, because losing one
        evidence record must never kill the campaign writing it. The
        loader's torn-line tolerance absorbs any partial line a failed
        attempt left."""
        rec = {"v": LEDGER_VERSION, "kind": kind, "t": round(time.time(), 3)}
        rec.update(self._stamp)
        rec.update(fields)
        _validate(rec, 0)
        line = json.dumps(rec, sort_keys=True)

        def emit():
            _F.fault_point("ledger-write", detail=kind)
            with self._lock:
                if self._closed:
                    return
                self._f.write(line + "\n")
                self._f.flush()
                try:
                    os.fsync(self._f.fileno())
                except (OSError, io.UnsupportedOperation):
                    pass                 # pipes/pytest capture: flush is all

        try:
            _F.with_retry("ledger-write", emit)
        except (OSError, _F.FaultError) as exc:
            _F.record_fault_event("ledger-write", "degrade",
                                 detail=str(exc)[:200])
            self.write_failures += 1
            print(f"# ledger write failed ({exc}); record dropped, "
                  "campaign continues", file=sys.stderr)
        return rec

    def meta(self, **fields) -> dict:
        return self.write("meta", driver=fields.pop("driver", "bench"),
                          **fields)

    def query(self, name: str, status: str = "ok", **fields) -> dict:
        """One validated per-query record. Derives the ``evidence``
        aggregate from ``streamedScans`` when the caller did not."""
        if "streamedScans" in fields and "evidence" not in fields:
            fields["evidence"] = evidence_from_scans(fields["streamedScans"])
        return self.write("query", name=name, status=status, **fields)

    def progress(self, **fields) -> dict:
        return self.write("progress", **fields)

    def metrics(self, scope: str, **fields) -> dict:
        """One schema-versioned live-metrics rollup record (the
        :mod:`nds_tpu_torch.obs.metrics` snapshot vocabulary): ``scope
        "query"`` rides the drivers' rolling rollup per completed
        query, ``scope "stream"`` the end-of-stream QPS / quantile /
        queue-wait / timeout-shed aggregate."""
        return self.write("metrics", scope=scope,
                          metricsV=METRICS_VERSION, **fields)

    def close(self, status: str | None = None, **fields) -> None:
        """Write the terminal record (idempotent) and close the file.
        ``status=None`` closes without a terminal record (the caller
        already wrote one, or wants the kill signature preserved)."""
        with self._lock:
            closed = self._closed
        if status is not None and not closed:
            self.write("end", status=status, **fields)
        with self._lock:
            self._closed = True
            try:
                self._f.close()
            except OSError:
                pass


class Heartbeat:
    """Liveness thread for a long campaign: every ``interval_s`` it
    writes one ``progress`` record to the ledger and one ``#`` line to
    stderr, so a hung child is visible within seconds — not at the
    rc=124 autopsy. Sync-free by construction: the beat reads the host
    clock and whatever the ``status`` callable returns (which must
    itself touch no device — the drivers pass dict snapshots of counters
    they already maintain); the traced-vs-untraced parity test runs an
    arm under a live heartbeat to pin this."""

    _STDERR = object()       # default sentinel: out=None silences

    def __init__(self, interval_s: float, ledger: "Ledger | None" = None,
                 status=None, out=_STDERR):
        self.interval_s = max(float(interval_s), 0.05)
        self.ledger = ledger
        self.status = status
        self.out = sys.stderr if out is Heartbeat._STDERR else out
        self.beats = 0
        self._survived = 0       # beat() exceptions the loop outlived
        self._stop = threading.Event()
        self._thread = None
        self._t0 = None

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.beat()
            except Exception as exc:
                # the liveness thread must outlive its own bugs: a beat
                # that raised records a progress NOTE (best effort) and
                # the loop continues — a silently dead heartbeat would
                # un-detect the very hangs it exists to surface
                self._survived += 1
                try:
                    if self.ledger is not None:
                        self.ledger.progress(
                            note="heartbeat-exception",
                            error=f"{type(exc).__name__}: {exc}"[:200])
                except Exception:
                    pass
                if self.out is not None:
                    try:
                        print(f"# heartbeat survived {type(exc).__name__}:"
                              f" {exc}", file=self.out, flush=True)
                    except Exception:
                        pass

    def beat(self) -> dict:
        """One heartbeat (also callable directly, e.g. from tests)."""
        self.beats += 1
        elapsed = time.perf_counter() - self._t0 if self._t0 else 0.0
        fields = {"elapsedS": round(elapsed, 1), "beat": self.beats}
        try:
            extra = self.status() if self.status is not None else None
        except Exception:                 # liveness must outlive status bugs
            extra = None
        if isinstance(extra, dict):
            fields.update(extra)
        if self.ledger is not None:
            try:
                self.ledger.progress(**fields)
            except (OSError, ValueError):
                pass                      # a full disk must not kill the run
        if self.out is not None:
            desc = " ".join(f"{k}={v}" for k, v in fields.items()
                            if k not in ("beat",))
            print(f"# heartbeat {self.beats}: {desc}", file=self.out,
                  flush=True)
        try:
            # live-metrics snapshot on the heartbeat cadence: a cheap
            # no-op unless NDS_TPU_METRICS_FILE is set (atomic
            # write-temp-then-rename; registry reads only — sync-free
            # like the rest of the beat)
            _metrics.export_live(extra=fields)
        except Exception:
            pass          # liveness must outlive exporter bugs too
        return fields

    def start(self) -> "Heartbeat":
        self._t0 = time.perf_counter()
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="nds-ledger-heartbeat")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 1.0)
            self._thread = None

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
