# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Fault-injection differential: the runtime half of the port's fault
contract (the port of the reference's ``tools/fault_diff.py``).

The registry (``nds_tpu_torch/engine/faults.py``) models the engine's
failure seams and their recovery policies. This harness sweeps the
deterministic injection matrix (``NDS_TPU_FAULT=seam:kind:nth``) over
the streamed A/B statements on the toy star tables
(``tools.perf_audit_diff.star_tables``: the reference's
``_chunked_star_session`` tables, store_sales streamed in 2,048-row
chunks at 2 partitions) and fails unless every injection ends in one of
the two permitted outcomes:

* **recovered, bit for bit**: the injected run's rows equal the
  fault-free baseline exactly (a retry or a step down the degradation
  ladder may change the path, never the rows), the injection fired
  (``faults.fired_count``), and the drained FaultEvents match it (one
  event at the injected seam);
* **classified error, within the deadline**: a :class:`faults.FaultError`
  (``StatementTimeout`` from the statement watchdog, the fatal ``peer``
  refusal) raised within the entry's wall bound; never a hang, wrong
  rows or an unclassified exception.

``NDS_TPU_FAULT`` is not part of the streamed pipeline cache's key, so
every arm starts from an empty cache (:func:`_fresh`): a cached pipeline
would skip the compile seam and the injection would never fire. The
exchange entry runs its two shards on the one device inside
``parallel.exchange.sharing_devices()``. An entry that cannot run here
is printed by name as skipped, never passed over in silence.

``bench-child`` is injected in ``tests/test_torch_bench.py`` (it needs
the bench entry's supervisor): :data:`COVERED_ELSEWHERE` names it, and
``tests/test_torch_fault_diff.py`` holds the matrix plus that test to
the registry.

``--inject-drift`` sets ``NDS_TPU_FAULT_DRIFT`` (``with_retry`` stops
retrying, no FaultEvent is recorded) and reruns a recovering subset:
every entry must then fail, which proves the harness can see a dropped
recovery path.

Run: ``python -m nds_tpu_torch.tools.fault_diff [--device cpu]
[--inject-drift]``. The device defaults to cuda and the harness refuses
to run without a GPU unless given ``--device cpu``. On cuda the streamed
statements launch K4 (``chunk_scan``) and the exchange entry's join K5
(``join_probe``); the closing line counts both.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from nds_tpu_torch.tools.perf_audit_diff import _env

# the cheap filter and projection statement: one streamed scan, every
# seam on its path (prefetch ring, upload, compile, sync)
TEMPLATE = 1
# the partitioned fan-out statement the sharded exchange entry drives
TEMPLATE_SHARDED = 7
PARTITIONS = 2
SHARDS = 2
# the watchdog entry: a hang of HANG_S under a DEADLINE_S statement
# deadline, the timeout due before HANG_BOUND_S; the hang is short (the
# reference hangs 20 s, bound 15) but still well past the deadline
HANG_S = 6
DEADLINE_S = 2
HANG_BOUND_S = 5

_DEVICE = "cuda"


def _fresh(conf=None):
    """A fresh star session over an empty pipeline cache (the injected
    build must run)."""
    from nds_tpu_torch.engine import stream as S
    from nds_tpu_torch.tools.perf_audit_diff import star_session, star_tables
    for key in list(S._PIPELINE_CACHE):
        S._evict(key)
    return star_session(star_tables(42), _DEVICE,
                        {"stream_partitions": PARTITIONS, **(conf or {})})


def _clean_faults():
    from nds_tpu_torch.engine import faults as F
    F.reset_fault_counts()
    F.drain_fault_events()


class Failure(Exception):
    pass


def _run_template(session, idx):
    from nds_tpu_torch.tools.perf_audit_diff import AB_QUERIES
    return session.sql(AB_QUERIES[idx]).collect()


def _injected(spec, idx=TEMPLATE, session=None, **env):
    """(rows, wall seconds) of one statement on a fresh session under
    ``NDS_TPU_FAULT=spec``."""
    s = session if session is not None else _fresh()
    _clean_faults()
    with _env(NDS_TPU_FAULT=spec, **env):
        t0 = time.monotonic()
        rows = _run_template(s, idx)
        return rows, time.monotonic() - t0


def _expect_recovered(name, seam, baseline, rows, wall_s, wall_bound_s,
                      n_events=1):
    from nds_tpu_torch.engine import faults as F
    if wall_s > wall_bound_s:
        raise Failure(f"{name}: wall {wall_s:.1f}s exceeded the "
                      f"{wall_bound_s:.0f}s bound (hang mode survived?)")
    if rows != baseline or not rows:
        raise Failure(f"{name}: recovered rows diverged from the "
                      "fault-free baseline (silent wrong rows)")
    if F.fired_count(seam) < 1:
        raise Failure(f"{name}: the injection never fired: the check "
                      "was vacuous")
    events = F.drain_fault_events()
    at_seam = [e for e in events if e.seam == seam]
    if len(at_seam) != n_events:
        raise Failure(
            f"{name}: FaultEvent count at seam {seam!r} is "
            f"{len(at_seam)}, injections were {n_events} "
            f"(all events: {[(e.seam, e.action) for e in events]}): "
            "the recovery path stopped recording (swallowed fault)")


# ---------------------------------------------------------------------------
# matrix entries
# ---------------------------------------------------------------------------


def entry_prefetch(baseline):
    """A transient fault in the prefetch worker (slice, encode, upload):
    the ring's bounded retry recovers in place and the event reaches the
    driver thread."""
    rows, wall = _injected("prefetch:error:1")
    _expect_recovered("prefetch", "prefetch", baseline, rows, wall, 60)


def entry_device_put(baseline):
    """A transient upload fault (in whichever preparation reaches
    occurrence 1: the inline first chunk or the ring worker): bounded
    retry."""
    rows, wall = _injected("device-put:error:1")
    _expect_recovered("device-put", "device-put", baseline, rows, wall, 60)


def entry_pipeline_compile(baseline):
    """A degradable build fault: the compiled path steps down to the
    eager chunk loop, one degrade FaultEvent, rows bit for bit; the next
    execution builds the pipeline afresh (compiled again)."""
    from nds_tpu_torch.listener import drain_stream_events
    s = _fresh()
    drain_stream_events()
    rows, wall = _injected("pipeline-compile:error:1", session=s)
    _expect_recovered("pipeline-compile", "pipeline-compile", baseline,
                      rows, wall, 60)
    drain_stream_events()
    again = _run_template(s, TEMPLATE)
    paths = [e.path for e in drain_stream_events()]
    if again != baseline or paths != ["compiled"]:
        raise Failure(f"pipeline-compile: the execution after the "
                      f"degraded one ran {paths}, rows equal "
                      f"{again == baseline}: no fresh build")


def entry_sync_retry(baseline):
    """A transient fault in a blocking fetch: the idempotent read
    retries (charging the same syncs)."""
    rows, wall = _injected("sync:error:1")
    _expect_recovered("sync-retry", "sync", baseline, rows, wall, 60)


def entry_sync_hang_watchdog(_baseline):
    """The watchdog: a hung blocking fetch (hang kind, ``HANG_S``) under a
    ``DEADLINE_S`` statement deadline raises the classified
    StatementTimeout well before the hang would have ended."""
    from nds_tpu_torch.engine import faults as F
    s = _fresh()
    _clean_faults()
    with _env(NDS_TPU_FAULT="sync:hang:1", NDS_TPU_FAULT_HANG_S=HANG_S,
              NDS_TPU_STATEMENT_DEADLINE_S=DEADLINE_S):
        t0 = time.monotonic()
        try:
            _run_template(s, TEMPLATE)
        # the harness expects this classified error: the engine recorded
        # its event, which the check below reads
        # nds-lint: ignore[swallowed-fault]
        except F.StatementTimeout:
            wall = time.monotonic() - t0
        except Exception as exc:
            raise Failure(f"sync-hang: unclassified {type(exc).__name__} "
                          f"escaped instead of StatementTimeout: {exc}")
        else:
            raise Failure("sync-hang: the hung statement completed: the "
                          "injection never engaged the watchdog")
    if wall >= HANG_BOUND_S:
        raise Failure(f"sync-hang: StatementTimeout took {wall:.1f}s: the "
                      "watchdog did not beat the hang")
    events = [e for e in F.drain_fault_events() if e.seam == "sync"]
    if not any(e.action == "timeout" for e in events):
        raise Failure("sync-hang: no timeout FaultEvent recorded")


def entry_chunk_store_read(baseline):
    """A transient store-read fault on a warm store: the entry is dropped
    and encoded again from the source, rows bit for bit."""
    with tempfile.TemporaryDirectory() as d:
        with _env(NDS_TPU_CHUNK_STORE=d):
            warm = _run_template(_fresh(), TEMPLATE)   # persist entries
            if warm != baseline:
                raise Failure("chunk-store-read: the store path diverged "
                              "before any injection")
            rows, wall = _injected("chunk-store-read:error:1")
            _expect_recovered("chunk-store-read", "chunk-store-read",
                              baseline, rows, wall, 60)


def entry_chunk_store_write(baseline):
    """A degradable store-write fault on a cold store: the best-effort
    save degrades to the in-memory wire plan, the statement unharmed."""
    with tempfile.TemporaryDirectory() as d:
        with _env(NDS_TPU_CHUNK_STORE=d):
            rows, wall = _injected("chunk-store-write:error:1")
            _expect_recovered("chunk-store-write", "chunk-store-write",
                              baseline, rows, wall, 60)


def entry_exchange():
    """A degradable fault in the sharded pipeline's exchange, its two
    shards on the one device (``sharing_devices``): sharded compiled
    steps down to the unsharded eager loop, bit for bit against the
    fault-free sharded run."""
    from nds_tpu_torch.parallel.exchange import sharing_devices
    conf = {"stream_shards": SHARDS}
    with sharing_devices():
        base = _run_template(_fresh(conf=conf), TEMPLATE_SHARDED)
        rows, wall = _injected("exchange:error:1", TEMPLATE_SHARDED,
                               session=_fresh(conf=conf))
    _expect_recovered("exchange", "exchange", base, rows, wall, 120)


def entry_peer():
    """A fatal federation-peer fault: ``maybe_initialize`` raises the
    classified error at once (no retry loop, no hang) and records the
    fatal FaultEvent. Skipped (by name) when this process already
    joined a federation."""
    from nds_tpu_torch.engine import faults as F
    from nds_tpu_torch.parallel import multihost
    if multihost._initialized:
        return "skipped: federation already initialized in-process"
    _clean_faults()
    with _env(NDS_TPU_MULTIHOST="1", NDS_TPU_FAULT="peer:error:1"):
        t0 = time.monotonic()
        try:
            multihost.maybe_initialize(_DEVICE)
        # the harness expects this classified error: the engine recorded
        # its event, which the check below reads
        # nds-lint: ignore[swallowed-fault]
        except F.FaultInjected:
            wall = time.monotonic() - t0
        except Exception as exc:
            raise Failure(f"peer: unclassified {type(exc).__name__} "
                          f"escaped: {exc}")
        else:
            raise Failure("peer: the injected attach fault was absorbed: "
                          "a half-formed federation could run collectives")
    if wall > 10:
        raise Failure(f"peer: the classified error took {wall:.1f}s")
    events = [e for e in F.drain_fault_events() if e.seam == "peer"]
    if [e.action for e in events] != ["fatal"]:
        raise Failure(f"peer: expected one fatal FaultEvent, got "
                      f"{[(e.seam, e.action) for e in events]}")
    return None


def entry_ledger_write():
    """A transient ledger-write fault: one bounded retry lands the record
    durably; the campaign never notices."""
    from nds_tpu_torch.engine import faults as F
    from nds_tpu_torch.obs import ledger as L
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "campaign.jsonl")
        led = L.Ledger(path, driver="bench")
        _clean_faults()
        with _env(NDS_TPU_FAULT="ledger-write:error:1"):
            led.query("query1", status="ok", ms=1.0)
        if led.write_failures:
            raise Failure("ledger-write: one injected fault must retry "
                          "clean, not degrade")
        led.close("completed")
        data = L.load_ledger(path)
        if "query1" not in data.queries or data.end is None:
            raise Failure("ledger-write: the retried record or the "
                          "terminal one is missing")
        events = [e for e in F.drain_fault_events()
                  if e.seam == "ledger-write"]
        if [e.action for e in events] != ["recovered"]:
            raise Failure(f"ledger-write: expected one recovered "
                          f"FaultEvent, got "
                          f"{[(e.seam, e.action) for e in events]}")
    return None


# seams whose injection runs in another test (held as a union with the
# matrix by tests/test_torch_fault_diff.py)
COVERED_ELSEWHERE = {
    "bench-child": "tests/test_torch_bench.py::"
                   "test_bench_child_fault_takes_the_restart_path",
}

STATEMENT_ENTRIES = (
    ("prefetch", entry_prefetch),
    ("device-put", entry_device_put),
    ("pipeline-compile", entry_pipeline_compile),
    ("sync-retry", entry_sync_retry),
    ("sync-hang-watchdog", entry_sync_hang_watchdog),
    ("chunk-store-read", entry_chunk_store_read),
    ("chunk-store-write", entry_chunk_store_write),
)
OTHER_ENTRIES = (
    ("exchange", entry_exchange),
    ("peer", entry_peer),
    ("ledger-write", entry_ledger_write),
)
DRIFT_ENTRIES = (("prefetch", entry_prefetch),
                 ("sync-retry", entry_sync_retry))


def run_diff(inject_drift=False, verbose=True, device="cuda", only=None,
             outcomes=None):
    """Run the matrix on ``device``; returns the failures (empty: pass).
    ``inject_drift`` reruns a recovering subset with recovery suppressed:
    every entry must then fail. ``only`` names the entries to run (default
    all); ``outcomes``, when given, is filled with each entry's
    ``recovered``, ``classified``, ``skipped: ...`` or ``failed``."""
    global _DEVICE
    _DEVICE = device
    failures = []
    outcomes = {} if outcomes is None else outcomes

    def log(msg):
        if verbose:
            print(f"# fault_diff: {msg}", file=sys.stderr)

    def attempt(name, call, prefix=""):
        if only is not None and name not in only:
            return
        log(name)
        try:
            note = call()
            outcomes[name] = note or (
                "classified" if name in ("sync-hang-watchdog", "peer")
                else "recovered")
            if note:
                log(f"{name}: {note}")
        except Failure as exc:
            outcomes[name] = "failed"
            failures.append(f"{prefix}{exc}")
        except Exception as exc:
            outcomes[name] = "failed"
            failures.append(f"{prefix}{name}: unclassified "
                            f"{type(exc).__name__}: {exc}")
        finally:
            _clean_faults()

    if inject_drift:
        with _env(NDS_TPU_FAULT_DRIFT="1"):
            baseline = _run_template(_fresh(), TEMPLATE)
            for name, fn in DRIFT_ENTRIES:
                attempt(name, lambda fn=fn: fn(baseline), "drift:")
        return failures
    baseline = _run_template(_fresh(), TEMPLATE)
    if not baseline:
        return ["baseline template returned no rows"]
    for name, fn in STATEMENT_ENTRIES:
        attempt(name, lambda fn=fn: fn(baseline))
    for name, fn in OTHER_ENTRIES:
        attempt(name, fn)
    # the state the matrix leaves behind must be clean: one last
    # fault-free run, bit for bit against the opening baseline
    if _run_template(_fresh(), TEMPLATE) != baseline:
        failures.append("post-matrix fault-free rerun diverged: an "
                        "injection poisoned engine state")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="fault-injection differential harness")
    ap.add_argument("--inject-drift", action="store_true",
                    help="suppress the recovery machinery "
                    "(NDS_TPU_FAULT_DRIFT) and require the harness to "
                    "FAIL: the self-test of the gate")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from nds_tpu_torch import resolve_device
    from nds_tpu_torch.engine import kernels as K
    resolve_device(args.device)
    K.reset_launches()
    outcomes = {}
    failures = run_diff(inject_drift=args.inject_drift, device=args.device,
                        outcomes=outcomes)
    print(json.dumps({"outcomes": outcomes, "launches": {
        k: K.LAUNCHES.get(k, 0) for k in ("chunk_scan", "join_probe")}}))
    if args.inject_drift:
        if failures:
            print(f"# drift detected as designed ({len(failures)} "
                  "failures): the gate can fail", file=sys.stderr)
            return 0
        print("# DRIFT NOT DETECTED: recovery suppression passed the "
              "matrix: the gate is vacuous", file=sys.stderr)
        return 1
    for f in failures:
        print(f"FAULT-DIFF FAILURE: {f}", file=sys.stderr)
    print(f"# fault_diff: {'FAILED' if failures else 'ok'}",
          file=sys.stderr)
    return 2 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
