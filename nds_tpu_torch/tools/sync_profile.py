# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Per-statement host-sync site profiler (the port of the reference's
``tools/sync_profile.py``).

Live mode runs statements of the bench stream and prints each one's
histogram of sync sites. It reads the port's first-class attribution:
every fetch through ``ops.host_read`` that charged syncs emits one
:class:`nds_tpu_torch.obs.trace.SyncSite` naming its engine call site,
and a fetch that re-enters ``host_read`` charges each site only its own
syncs, so every sync is counted once (the reason the reference left its
old monkeypatch). A sync-heavy eager loop can emit one site a read, so
the profiler deepens the trace ring (``NDS_TPU_TRACE_RING``) and says so
when a ring still filled up.

Post-hoc mode reads a port ledger (``nds_tpu_torch.obs.ledger``: a bench
entry's ``NDS_BENCH_RESULTS_JSONL`` or a Power Run's ``--ledger``) and
prints each recorded statement's top sites from its
``tracePhases.syncSites`` rollup, without running anything and without
importing torch::

    python -m nds_tpu_torch.tools.sync_profile LEDGER.jsonl [query9 ...]
    python -m nds_tpu_torch.tools.sync_profile [--device cpu] query9 query83

``NDS_BENCH_SCALE`` (default 0.01) picks the bench entry's data
(``nds_tpu_torch.bench.ensure_data``) and stream in live mode, which
defaults to cuda and refuses to run without a GPU unless given ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

DEEP_RING = "1048576"


def site_histogram(records) -> "collections.Counter":
    """(tag, site) -> syncs over one drained trace-record list."""
    from nds_tpu_torch.obs.trace import SyncSite
    sites = collections.Counter()
    for r in records:
        if isinstance(r, SyncSite):
            sites[(r.tag, r.site)] += r.syncs
    return sites


def ledger_histograms(path, wanted=()):
    """Per-statement sync-site histograms from a completed round's ledger
    (the recorded ``tracePhases.syncSites`` rollup: the top sites a
    statement; the whole histogram needs a live run). Returns print
    lines."""
    from nds_tpu_torch.obs.ledger import load_ledger   # torch-free
    data = load_ledger(path)
    lines = []
    for name in sorted(data.queries):
        if wanted and name not in wanted:
            continue
        rec = data.queries[name]
        roll = rec.get("tracePhases") or rec.get("trace") or {}
        sites = roll.get("syncSites") or []
        used = rec.get("hostSyncs", sum(s.get("syncs", 0) for s in sites))
        lines.append(f"\n== {name}: {used} syncs "
                     f"(top {len(sites)} sites as recorded) ==")
        for s in sorted(sites, key=lambda s: -s.get("syncs", 0)):
            lines.append(f"  {s.get('syncs', 0):3d}  "
                         f"{s.get('tag', '?'):12s} {s.get('site', '?')}")
    if not lines:
        lines.append(f"# no completed query records in ledger {path}")
    return lines


def profile(session, queries, names=None):
    """Run each of ``names`` (default all) of ``queries`` ({name: sql}) on
    ``session``; returns ``[(name, syncs, Counter of (tag, site) ->
    syncs, ring full)]``."""
    from nds_tpu_torch.engine import ops as E
    from nds_tpu_torch.obs import trace as obs_trace
    out = []
    for name in (names or queries):
        obs_trace.drain_spans()          # table-setup leftovers
        s0 = E.sync_count()
        session.sql(queries[name]).collect()
        used = E.sync_count() - s0
        records = obs_trace.drain_spans()
        full = len(records) >= obs_trace._ring_max()
        out.append((name, used, site_histogram(records), full))
    return out


def live_lines(profiles) -> list:
    """The print lines of :func:`profile`'s result."""
    lines = []
    for name, used, sites, full in profiles:
        if full:
            lines.append(f"  !! trace ring full: oldest sync sites evicted "
                         f"for {name}: the histogram is a floor; raise "
                         "NDS_TPU_TRACE_RING")
        lines.append(f"\n== {name}: {used} syncs ==")
        for (tag, where), n in sites.most_common():
            lines.append(f"  {n:3d}  {tag:12s} {where}")
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and os.path.isfile(argv[0]):
        # post-hoc: a ledger file instead of statement names
        for ln in ledger_histograms(argv[0], set(argv[1:])):
            print(ln)
        return 0
    ap = argparse.ArgumentParser(
        description="per-statement host-sync site histograms")
    ap.add_argument("queries", nargs="*", help="statements (default: all)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    # before the first statement attaches its thread's ring
    os.environ.setdefault("NDS_TPU_TRACE_RING", DEEP_RING)

    from nds_tpu_torch import bench as B
    from nds_tpu_torch import resolve_device
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.schema import get_schemas

    device = resolve_device(args.device)
    cfg = B.Config(scale=os.environ.get("NDS_BENCH_SCALE", "0.01"))
    data_dir = B.ensure_data(cfg)
    queries = dict(B.bench_queries(cfg))
    sess = Session(device=device)
    for table, fields in get_schemas(use_decimal=True).items():
        path = os.path.join(data_dir, table)
        if os.path.exists(path):
            sess.read_columnar_view(table, path, "parquet",
                                    {f.name: str(f.type) for f in fields})
    for ln in live_lines(profile(sess, queries, args.queries or None)):
        print(ln)
    return 0


if __name__ == "__main__":
    sys.exit(main())
