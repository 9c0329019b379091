# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Trace exporters: Chrome ``trace_event`` files and per-query rollups.

One file per query, loadable in ``chrome://tracing`` / Perfetto: spans
become ``"ph": "X"`` complete events (microsecond ts/dur from the span's
host clock), sync-site events become thin ``"X"`` slices whose width is
the time the host spent BLOCKED on that read — the stall is visible at a
glance. The whole document stays plain JSON, so ``tools/trace_report.py``
aggregates the same files the browser loads.
"""

from __future__ import annotations

import json
from collections import Counter

from nds_tpu_torch.obs.trace import SpanRecord, SyncSite


def to_chrome(records, query: str = "", pid: int = 0,
              tid: int = 0, roll: dict | None = None) -> dict:
    """Chrome trace_event document (object form) for one drained record
    list. Extra top-level keys are legal in the format; ``nds`` carries
    the query name and the rollup so readers need not re-aggregate.
    Callers that already computed :func:`rollup` (the drivers stamp it
    into the query summary too) pass it as ``roll`` to skip the rewalk."""
    events = []
    for r in records:
        if isinstance(r, SpanRecord):
            args = {"syncs": r.syncs,
                    "syncWaitMs": round(r.sync_wait_ns / 1e6, 3),
                    "compileMs": round(r.compile_ns / 1e6, 3)}
            args.update(r.attrs)
            events.append({
                "name": r.name, "cat": "query", "ph": "X",
                "ts": r.ts_ns / 1e3, "dur": r.dur_ns / 1e3,
                "pid": pid, "tid": tid, "args": args})
        elif isinstance(r, SyncSite):
            events.append({
                "name": f"sync:{r.tag}", "cat": "sync", "ph": "X",
                "ts": r.ts_ns / 1e3 - r.wait_ns / 1e3,
                "dur": max(r.wait_ns / 1e3, 1.0),
                "pid": pid, "tid": tid,
                "args": {"site": r.site, "syncs": r.syncs}})
    return {"traceEvents": events,
            "displayTimeUnit": "ms",
            "nds": {"query": query,
                    "rollup": rollup(records) if roll is None else roll}}


def write_chrome_trace(path: str, records, query: str = "",
                       roll: dict | None = None) -> None:
    with open(path, "w") as f:
        # compact: the consumers (chrome://tracing, Perfetto,
        # tools/trace_report.py) are all programmatic, and a ~2500-chunk
        # streamed scan emits thousands of events per file
        json.dump(to_chrome(records, query=query, roll=roll), f,
                  separators=(",", ":"))


def rollup(records, top_sites: int = 5) -> dict:
    """Per-query aggregate the drivers merge into their JSON summaries:
    per-phase totals (ms/count/syncs, by span name), the top sync-charging
    host-read sites, and any eager-fallback streamed scans with their
    reason — the phase-attribution slice of the full trace."""
    phases: dict = {}
    sites: Counter = Counter()
    site_tag: dict = {}
    fallbacks = []
    for r in records:
        if isinstance(r, SpanRecord):
            p = phases.setdefault(r.name, {"ms": 0.0, "count": 0,
                                           "syncs": 0})
            p["ms"] = round(p["ms"] + r.dur_ns / 1e6, 3)
            p["count"] += 1
            p["syncs"] += r.syncs
            if r.name == "stream" and r.attrs.get("path") == "eager":
                fallbacks.append({
                    "table": r.attrs.get("table", "?"),
                    "reason": r.attrs.get("reason", ""),
                    "ms": round(r.dur_ns / 1e6, 3), "syncs": r.syncs})
        elif isinstance(r, SyncSite):
            sites[r.site] += r.syncs
            site_tag.setdefault(r.site, r.tag)
    out = {"phases": phases,
           "syncSites": [{"site": s, "tag": site_tag[s], "syncs": n}
                         for s, n in sites.most_common(top_sites)]}
    if fallbacks:
        out["fallbacks"] = fallbacks
    return out
