# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Mid-run monitor over the live-metrics snapshot files (the port of the
reference's ``tools/obs_live.py``).

The port's drivers export an atomically replaced JSON snapshot of their
rolling-rollup registry (``NDS_TPU_METRICS_FILE``; see
``nds_tpu_torch/obs/metrics.py``) on the heartbeat cadence. This tool
renders one such file, or a campaign directory of per-arm files, as a
table you can read while the run executes: queries a minute over the
rolling window, rolling p99 wall, prefetch-stall share, fault counts,
the streamed pipeline cache's hits, misses and evictions, and per-arm
done/total progress. Every snapshot shares one fixed bucket layout, so a
view of several also prints a merged TOTAL row (bucket counts summed,
quantiles recomputed: independent of order).

It imports no torch, as the reference's imports no jax: the metrics
module has only the standard library.

Usage::

  python -m nds_tpu_torch.tools.obs_live RUN_DIR/metrics.json
  python -m nds_tpu_torch.tools.obs_live CAMPAIGN_DIR     # */metrics.json
  python -m nds_tpu_torch.tools.obs_live CAMPAIGN_DIR --watch 5
"""

import argparse
import glob
import json
import os
import sys
import time

from nds_tpu_torch.obs.metrics import merge_hist_snapshots

QUERY_WALL = "query.wall_ms"
STALL = "prefetch.stall_ms"


def load_snapshot(path):
    """One snapshot dict, or None (missing / torn-at-creation file —
    export_live's rename makes torn content impossible after the first
    write, but the very first read can race file creation)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def find_snapshots(source):
    """[(label, path)] for a file, or a directory in campaign layout
    (``<arm>/metrics.json``) falling back to ``metrics*.json`` directly
    inside it (the throughput {pid} fan-out pattern)."""
    if os.path.isfile(source):
        return [(os.path.basename(os.path.dirname(os.path.abspath(
            source))) or source, source)]
    arms = sorted(glob.glob(os.path.join(source, "*", "metrics.json")))
    if arms:
        return [(os.path.basename(os.path.dirname(p)), p) for p in arms]
    flat = sorted(glob.glob(os.path.join(source, "metrics*.json")))
    return [(os.path.basename(p), p) for p in flat]


def _hist(doc, name):
    return (doc.get("hists") or {}).get(name)


def _row_stats(doc, now):
    """The renderable numbers for one snapshot document."""
    counters = doc.get("counters") or {}
    wall = _hist(doc, QUERY_WALL) or {}
    roll = wall.get("rolling") or {}
    stall = _hist(doc, STALL) or {}
    sroll = stall.get("rolling") or {}
    rsum = roll.get("sum") or 0.0
    stats = {
        "queries": counters.get("queries.total", 0),
        "ok": counters.get("queries.ok", 0),
        "errors": (counters.get("queries.error", 0)
                   + counters.get("queries.timeout", 0)),
        "faults": counters.get("faults.total", 0),
        # streamed pipeline-cache effectiveness: hits = compiles avoided
        # (parameterized plans re-serving one compile), evictions =
        # capacity/staleness churn worth noticing mid-run
        "pipeHit": counters.get("pipeline.cache.hit", 0),
        "pipeMiss": counters.get("pipeline.cache.miss", 0),
        "pipeEvict": counters.get("pipeline.cache.evict", 0),
        "qpm": roll.get("perMin"),
        "rollP99": roll.get("p99"),
        "ewma": wall.get("ewma"),
        "stallPct": (round(100.0 * (sroll.get("sum") or 0.0) / rsum, 1)
                     if rsum > 0 else None),
        "age": None if doc.get("t") is None else max(now - doc["t"], 0.0),
        "done": doc.get("done"),
        "total": doc.get("total"),
        "query": doc.get("query"),
        "phase": doc.get("phase"),
    }
    return stats


def _fmt(v, nd=1, suffix=""):
    if v is None:
        return "-"
    return f"{v:.{nd}f}{suffix}"


def render(snapshots, now=None):
    """Printable lines for [(label, doc)] snapshot pairs."""
    now = time.time() if now is None else now
    if not snapshots:
        return ["# no metrics snapshots found (is NDS_TPU_METRICS_FILE "
                "set on the run?)"]
    hdr = (f"{'source':<18} {'prog':>9} {'q/min':>7} {'p99ms':>9} "
           f"{'ewma':>8} {'stall%':>6} {'flt':>4} {'err':>4} "
           f"{'pipe h/m':>9} {'age_s':>6}  last")
    lines = ["# live metrics (rolling window rollups; age = snapshot "
             "staleness)", hdr]
    wall_snaps = []
    for label, doc in snapshots:
        s = _row_stats(doc, now)
        if s["done"] is not None and s["total"] is not None:
            prog = f"{s['done']}/{s['total']}"
        else:
            prog = str(s["queries"])
        last = s["query"] or ""
        if s["phase"]:
            last = f"{last} [{s['phase']}]" if last else f"[{s['phase']}]"
        if s["pipeHit"] or s["pipeMiss"]:
            pipe = f"{s['pipeHit']}/{s['pipeMiss']}"
            if s["pipeEvict"]:
                pipe += f"-{s['pipeEvict']}"
        else:
            pipe = "-"
        lines.append(
            f"{label[:18]:<18} {prog:>9} {_fmt(s['qpm']):>7} "
            f"{_fmt(s['rollP99']):>9} {_fmt(s['ewma']):>8} "
            f"{_fmt(s['stallPct']):>6} {s['faults']:>4} {s['errors']:>4} "
            f"{pipe:>9} {_fmt(s['age']):>6}  {last}")
        wall = _hist(doc, QUERY_WALL)
        if wall is not None:
            wall_snaps.append(wall)
    if len(wall_snaps) > 1:
        merged = merge_hist_snapshots(wall_snaps)
        roll = merged["rolling"]
        lines.append(
            f"{'TOTAL':<18} {'':>9} {'':>7} {_fmt(roll['p99']):>9} "
            f"{'':>8} {'':>6} {'':>4} {'':>4} {'':>9} {'':>6}  "
            f"merged {merged['count']} walls, cum p50/p99 "
            f"{_fmt(merged['p50'])}/{_fmt(merged['p99'])} ms")
    return lines


def report(source):
    pairs = [(label, doc) for label, path in find_snapshots(source)
             for doc in [load_snapshot(path)] if doc is not None]
    return render(pairs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render live-metrics snapshot files "
        "(NDS_TPU_METRICS_FILE) as a mid-run progress/rollup table")
    ap.add_argument("source", help="a metrics.json file, a campaign "
                    "directory of <arm>/metrics.json, or a directory "
                    "of metrics*.json stream snapshots")
    ap.add_argument("--watch", type=float, default=0.0, metavar="SEC",
                    help="re-render every SEC seconds until interrupted")
    args = ap.parse_args(argv)
    while True:
        for ln in report(args.source):
            print(ln)
        if args.watch <= 0:
            return 0
        sys.stdout.flush()
        try:
            time.sleep(args.watch)
        except KeyboardInterrupt:
            return 0
        print()


if __name__ == "__main__":
    sys.exit(main())
