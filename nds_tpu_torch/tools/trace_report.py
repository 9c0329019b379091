# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Aggregate a --trace-dir of per-query Chrome traces (or an evidence
ledger) into the phase table of the port.

    python -m nds_tpu_torch.tools.trace_report TRACE_DIR_OR_LEDGER [--top N]

Reads every ``*.trace.json`` that ``python -m nds_tpu_torch.power
--trace-dir`` or the bench entry's ``NDS_BENCH_TRACE_DIR`` wrote, or a
ledger (``power --ledger``, ``NDS_BENCH_RESULTS_JSONL``), and prints:

1. the per-query phase breakdown: self-time per phase (a span's time
   less its children's) in pipeline order (:data:`PHASES`), host syncs,
   and for streamed scans the transfer accounting: logical and uploaded
   (host-to-device) bytes, the upload GB/s over the scans' wall against
   the host link's rate (the uploads cross PCIe, not the card's memory:
   ``h2d GB/s | %PCIe roof``), the prefetch stall (ms the chunk loop
   waited on the ring), and for a sharded scan its collective bytes.
   Shards that share one card move those bytes through its memory, so
   they are priced against the HBM rate (``collective MB | collective
   GB/s | %HBM roof``); only shards on distinct cards get the
   interconnect columns (``nvlink MB | nvlink GB/s | %NVLink roof``);
2. the top sync-charging host-read sites;
3. the eager-fallback cost by reason;
4. the ``static-roofline %`` and ``unexplained ms`` columns, which need
   the static cost model (``perf_audit``, not yet in the port) and read
   "—" until it lands;
5. the ranked next bottleneck: host-sync blocking, eager fallbacks,
   capture and compile time, and the host-link, memory and interconnect
   headroom, each in attributable ms. A share is never clamped: a byte
   count that is wrong shows as a share above 100%.

The rates are the card's datasheet figures, NVIDIA H100 80GB HBM3 (SXM5):
PCIe Gen5 x16 at 64 GB/s in each direction (128 GB/s both ways), 3.35
TB/s of HBM and NVLink 4 at 450 GB/s in each direction;
``NDS_TPU_ROOFLINE_H2D_GBS``, ``NDS_TPU_ROOFLINE_HBM_GBS`` and
``NDS_TPU_ROOFLINE_ICI_GBS`` override them (the last two are the
reference's names: tools/trace_report.py).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from collections import Counter, defaultdict

# the card's host link, memory and interconnect rates in GB/s (datasheet
# figures of the H100 SXM5: PCIe Gen5 x16 64 GB/s a direction, HBM3 3.35
# TB/s, NVLink 4 450 GB/s a direction)
H100_PCIE_GBS = 64.0
H100_HBM_GBS = 3350.0
H100_NVLINK_GBS = 450.0
ROOFLINE_H2D_GBS = float(os.environ.get("NDS_TPU_ROOFLINE_H2D_GBS",
                                        H100_PCIE_GBS))
ROOFLINE_HBM_GBS = float(os.environ.get("NDS_TPU_ROOFLINE_HBM_GBS",
                                        H100_HBM_GBS))
ROOFLINE_ICI_GBS = float(os.environ.get("NDS_TPU_ROOFLINE_ICI_GBS",
                                        H100_NVLINK_GBS))

# why the static columns are empty
NO_STATIC = ("static-roofline % and unexplained ms: — (they need the "
             "static cost model, perf_audit, which the port does not have "
             "yet: ROADMAP Queue 1, the lint and the auditors)")

# phase columns in pipeline order; every other span (the query and
# stream umbrellas, uncovered wall) folds into "other". The port's own
# phases beside the reference's: stream.encode (the wire plan: codec
# planning and encoding, or the chunk store's load), stream.upload (the
# first chunk's upload) and stream.capture (the per-chunk program's CUDA
# graph capture)
PHASES = ("plan", "replay.record", "replay.compile", "replay.drive",
          "stream.encode", "stream.upload", "stream.record",
          "stream.compile", "stream.capture", "stream.kernel",
          "stream.partition", "stream.exchange", "stream.prefetch",
          "stream.drive", "stream.eager", "stream.overflow-rerun",
          "stream.materialize", "materialize")


def self_times(events):
    """Per-event self duration: each X event's ``dur`` minus the dur of
    its directly nested children (ts/dur containment on one thread)."""
    spans = [dict(e) for e in events if e.get("ph") == "X"]
    spans.sort(key=lambda e: (e["ts"], -e["dur"]))
    stack = []
    for e in spans:
        e["self"] = e["dur"]
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
            stack.pop()
        e["top"] = not stack          # not contained in any other span
        if stack:
            stack[-1]["self"] -= e["dur"]
        stack.append(e)
    return spans


def load_trace(path):
    with open(path) as f:
        doc = json.load(f)
    query = (doc.get("nds") or {}).get("query") or \
        os.path.basename(path).split(".trace.json")[0]
    return query, doc.get("traceEvents") or []


def _new_agg():
    return {
        "per_query": {},
        "sites": Counter(),
        "site_tag": {},
        "fallbacks": defaultdict(lambda: {"queries": 0, "ms": 0.0,
                                          "syncs": 0, "rerun_ms": 0.0,
                                          "chunks": 0}),
        # the compiled path's unit costs in this run: the basis of the
        # fallbacks' projected savings
        "drive_ms": 0.0, "drive_n": 0, "mat_ms": 0.0, "mat_n": 0,
        # per template: streamed scans and the K4/K5 launches they made
        "kernels": defaultdict(lambda: {"scans": 0, "launches": 0}),
    }


def _new_row(total_ms=0.0, sync_ms=0.0):
    return {"total_ms": total_ms, "syncs": 0, "phases": defaultdict(float),
            "h2d": 0, "logical": 0, "stream_ms": 0.0, "ici": 0,
            "cards": 1, "sync_ms": sync_ms, "pf_stall": 0.0}


def collect_from_traces(trace_dir):
    """Aggregate a --trace-dir of Chrome traces; None when empty."""
    files = sorted(glob.glob(os.path.join(trace_dir, "*.trace.json")))
    if not files:
        return None
    agg = _new_agg()
    fallbacks = agg["fallbacks"]
    for path in files:
        query, events = load_trace(path)

        def is_sync(e):
            return e.get("cat") == "sync" or e["name"].startswith("sync:")

        row = _new_row()
        for e in events:
            if e.get("ph") == "X" and is_sync(e):
                args = e.get("args") or {}
                site = args.get("site", "?")
                agg["sites"][site] += args.get("syncs", 0)
                row["syncs"] += args.get("syncs", 0)
                row["sync_ms"] += e.get("dur", 0.0) / 1e3
                agg["site_tag"].setdefault(site,
                                           e["name"].split("sync:")[-1])
        # sync slices stay out of the span tree: their blocked time
        # belongs to the phase span that paid it
        spans = self_times([e for e in events if not is_sync(e)])
        for e in spans:
            name = e["name"]
            args = e.get("args") or {}
            row["phases"][name if name in PHASES else "other"] += \
                e["self"] / 1e3
            if name == "stream":
                row["pf_stall"] += max(args.get("prefetchStallMs", 0)
                                       or 0, 0)
                k = agg["kernels"][query]
                k["scans"] += 1
                k["launches"] += max(args.get("scanLaunches", 0) or 0, 0) \
                    + max(args.get("probeLaunches", 0) or 0, 0)
                row["h2d"] += args.get("bytesH2d", 0) or 0
                row["logical"] += args.get("bytesLogical",
                                           args.get("bytesH2d", 0)) or 0
                row["stream_ms"] += e["dur"] / 1e3
                row["ici"] += max(args.get("bytesIci", 0) or 0, 0)
                row["cards"] = max(row["cards"],
                                   args.get("shardCards", 1) or 1)
            if name == "stream.drive":
                agg["drive_ms"] += e["self"] / 1e3
                agg["drive_n"] += 1
            if name == "stream.materialize":
                agg["mat_ms"] += e["self"] / 1e3
                agg["mat_n"] += 1
            if name == "stream" and args.get("path") == "eager":
                fb = fallbacks[args.get("reason", "?")]
                fb["queries"] += 1
                fb["ms"] += e["dur"] / 1e3
                fb["syncs"] += args.get("syncs", 0)
                fb["chunks"] += args.get("chunks", 0)
            if name == "stream.overflow-rerun":
                fb = fallbacks[args.get("reason", "bound-bucket overflow")]
                fb["rerun_ms"] += e["dur"] / 1e3
        # the wall from the top-level spans only, so nested phases never
        # count twice
        row["total_ms"] = sum(e["dur"] for e in spans if e["top"]) / 1e3
        agg["per_query"][query] = row
    return agg


def collect_from_ledger(path):
    """The same aggregate from an evidence ledger: each query record's
    ``tracePhases`` rollup (inclusive ms, counts, syncs, sync sites,
    fallbacks) and its streamed-scan evidence. Phase times are inclusive
    span totals, uploaded bytes stand in for the logical volume, and a
    ledger names no cards, so its collective bytes price against the
    card's memory."""
    from nds_tpu_torch.obs import ledger as L
    data = L.load_ledger(path)
    if not data.queries:
        return None
    agg = _new_agg()
    for name, rec in sorted(data.queries.items()):
        if rec["status"] != "ok":
            continue
        roll = rec.get("tracePhases") or rec.get("trace") or {}
        phases = roll.get("phases") or {}
        row = _new_row(rec.get("ms", 0.0), rec.get("syncWaitMs", 0.0))
        # rollup times are inclusive: the umbrellas ('query', 'stream')
        # stay out of the columns, and 'plan' loses its known children
        incl = {n: p.get("ms", 0.0) for n, p in phases.items()}
        plan_children = incl.get("stream", 0.0) + sum(
            incl.get(n, 0.0) for n in ("replay.record", "replay.compile",
                                       "replay.drive"))
        for pname, p in phases.items():
            ms = p.get("ms", 0.0)
            if pname == "stream":
                row["stream_ms"] += ms
            if pname in ("query", "stream"):
                continue
            if pname == "plan":
                ms = max(ms - plan_children, 0.0)
            row["phases"][pname if pname in PHASES else "other"] += ms
            if pname == "stream.drive":
                agg["drive_ms"] += ms
                agg["drive_n"] += p.get("count", 0)
            if pname == "stream.materialize":
                agg["mat_ms"] += ms
                agg["mat_n"] += p.get("count", 0)
        row["compile_ms"] = rec.get("compileMs",
                                    rec.get("compileS", 0.0) * 1e3)
        ev = rec.get("evidence")
        if ev is None and "streamedScans" in rec:
            ev = L.evidence_from_scans(rec["streamedScans"])
        ev = ev or {}
        row["h2d"] = max(ev.get("bytesH2d", 0), 0)
        row["logical"] = row["h2d"]
        row["ici"] = max(ev.get("bytesIci", 0), 0)
        row["pf_stall"] = max(ev.get("prefetchStallMs", 0.0), 0.0)
        row["syncs"] = rec.get("hostSyncs",
                               sum(p.get("syncs", 0)
                                   for p in phases.values()))
        for site in roll.get("syncSites") or []:
            agg["sites"][site.get("site", "?")] += site.get("syncs", 0)
            agg["site_tag"].setdefault(site.get("site", "?"),
                                       site.get("tag", "?"))
        for fb_rec in roll.get("fallbacks") or []:
            fb = agg["fallbacks"][fb_rec.get("reason", "?")]
            fb["queries"] += 1
            fb["ms"] += fb_rec.get("ms", 0.0)
            fb["syncs"] += fb_rec.get("syncs", 0)
        agg["per_query"][name] = row
    return agg if agg["per_query"] else None


def collective_ms(row) -> float:
    """A sharded scan's collective wall: the exchange pass plus the
    cross-shard reduce inside materialize."""
    return (row["phases"].get("stream.exchange", 0.0)
            + row["phases"].get("stream.materialize", 0.0))


def _split_ici(rows):
    """(bytes, collective ms) of the rows whose shards share one card
    and of those whose shards span several."""
    out = {"shared": [0, 0.0], "nvlink": [0, 0.0]}
    for r in rows:
        if r["ici"]:
            side = out["nvlink" if r["cards"] > 1 else "shared"]
            side[0] += r["ici"]
            side[1] += collective_ms(r)
    return out


def bottlenecks(agg):
    """The run's levers ranked by attributable ms: host-sync blocking,
    eager fallbacks, capture and compile, the host-link headroom of the
    streamed scans' uploads, the memory headroom of shared-card
    collectives, and the interconnect headroom of collectives across
    cards."""
    rows = list(agg["per_query"].values())
    out = []
    sync_ms = sum(r["sync_ms"] for r in rows)
    if sync_ms > 0:
        out.append((sync_ms, "host-sync blocking", "reduce round trips"))
    fb_ms = sum(fb["ms"] for fb in agg["fallbacks"].values())
    if fb_ms > 0:
        out.append((fb_ms, "eager fallbacks",
                    "widen streamability (fallback ranking below)"))
    compile_ms = sum(max(r["phases"].get("stream.compile", 0.0)
                         + r["phases"].get("stream.capture", 0.0)
                         + r["phases"].get("replay.compile", 0.0),
                         r.get("compile_ms", 0.0)) for r in rows)
    if compile_ms > 0:
        out.append((compile_ms, "capture and compile",
                    "keep captured graphs across executions"))
    stream_ms = sum(r["stream_ms"] for r in rows)
    h2d = sum(r["h2d"] for r in rows)
    if stream_ms > 0 and h2d > 0:
        # the streamed scans' uploads cross the host link
        gbs = h2d / (stream_ms / 1e3) / 1e9
        frac = gbs / ROOFLINE_H2D_GBS
        out.append((stream_ms * (1.0 - frac),
                    f"host-link headroom (uploads at {gbs:.1f} GB/s = "
                    f"{frac * 100:.1f}% of {ROOFLINE_H2D_GBS:.0f} PCIe)",
                    "upload fewer bytes or overlap the uploads"))
    for side, roof, what in (("shared", ROOFLINE_HBM_GBS,
                              "shared-card collective HBM headroom"),
                             ("nvlink", ROOFLINE_ICI_GBS,
                              "NVLink roofline headroom")):
        nbytes, ms = _split_ici(rows)[side]
        if nbytes > 0 and ms > 0:
            gbs = nbytes / (ms / 1e3) / 1e9
            frac = gbs / roof
            out.append((ms * (1.0 - frac),
                        f"{what} (collectives at {gbs:.1f} GB/s = "
                        f"{frac * 100:.1f}% of {roof:.0f})",
                        "batch and widen the exchanges"))
    return sorted(out, key=lambda t: t[0], reverse=True)


def render(agg, source, top=10):
    """The printable report of one collected aggregate."""
    per_query = agg["per_query"]
    rows = per_query.values()
    used = [p for p in PHASES if any(r["phases"].get(p) for r in rows)]
    if any(r["phases"].get("other") for r in rows):
        used.append("other")
    any_bytes = any(r["logical"] for r in rows)
    shared = any(r["ici"] and r["cards"] <= 1 for r in rows)
    nvlink = any(r["ici"] and r["cards"] > 1 for r in rows)
    any_stall = any(r.get("pf_stall", 0.0) > 0.0 for r in rows)
    heads = ""
    if any_bytes:
        heads += " logical MB | h2d MB | h2d GB/s | %PCIe roof |"
    if shared:
        heads += " collective MB | collective GB/s | %HBM roof |"
    if nvlink:
        heads += " nvlink MB | nvlink GB/s | %NVLink roof |"
    if any_stall:
        heads += " pf-stall ms |"
    heads += " static-roofline % | unexplained ms |"
    n_cols = (len(used) + 5 + 4 * any_bytes + 3 * shared + 3 * nvlink
              + any_stall)
    lines = [f"# trace report: {len(per_query)} queries from {source}",
             "",
             "| query | total ms | " + " | ".join(used) + " | host syncs |"
             + heads,
             "|---" * n_cols + "|"]
    for q in sorted(per_query):
        r = per_query[q]
        cells = " | ".join(f"{r['phases'].get(p, 0.0):.1f}" for p in used)
        tail = ""
        if any_bytes:
            # bytes uploaded a second of streamed scan wall, against the
            # host link
            gbs = (r["h2d"] / (r["stream_ms"] / 1e3) / 1e9) \
                if r["stream_ms"] else 0.0
            tail += (f" {r['logical'] / 1e6:.1f} | {r['h2d'] / 1e6:.1f} | "
                     f"{gbs:.2f} | {gbs / ROOFLINE_H2D_GBS * 100:.1f} |")
        for on, distinct, roof in ((shared, False, ROOFLINE_HBM_GBS),
                                   (nvlink, True, ROOFLINE_ICI_GBS)):
            if not on:
                continue
            if r["ici"] and (r["cards"] > 1) == distinct:
                ms = collective_ms(r)
                gbs = (r["ici"] / (ms / 1e3) / 1e9) if ms else 0.0
                tail += (f" {r['ici'] / 1e6:.1f} | {gbs:.2f} | "
                         f"{gbs / roof * 100:.1f} |")
            else:
                tail += " - | - | - |"
        if any_stall:
            tail += f" {r.get('pf_stall', 0.0):.1f} |"
        tail += " — | — |"
        lines.append(f"| {q} | {r['total_ms']:.1f} | {cells} | "
                     f"{r['syncs']} |" + tail)
    lines.append(f"# {NO_STATIC}")
    comp = sum(r["phases"].get("stream.compile", 0.0)
               + r["phases"].get("stream.capture", 0.0) for r in rows)
    drive = sum(r["phases"].get("stream.drive", 0.0) for r in rows)
    if comp or drive:
        ratio = f"{comp / drive:.2f}" if drive else "inf"
        lines.append(f"# streamed pipeline capture/drive ratio: {ratio} "
                     f"({comp:.1f} ms capture / {drive:.1f} ms drive)")
    kern = agg.get("kernels") or {}
    if kern:
        engaged = sum(1 for k in kern.values() if k["launches"] > 0)
        lines.append(f"# kernel coverage: {engaged}/{len(kern)} streamed "
                     "templates launched K4 or K5")
    lines.append("")
    sites = agg["sites"]
    lines.append(f"# top host-sync sites (of {sum(sites.values())} "
                 "attributed syncs)")
    for site, n in sites.most_common(top):
        lines.append(f"  {n:4d}  {agg['site_tag'].get(site, '?'):<12} "
                     f"{site}")
    lines.append("")
    fallbacks = agg["fallbacks"]
    if fallbacks:
        lines.append("# eager-fallback cost by reason (projected = measured "
                     "eager ms minus a compiled-path estimate from this "
                     "run's per-chunk drive cost)")
        per_drive = agg["drive_ms"] / agg["drive_n"] \
            if agg["drive_n"] else None
        per_mat = agg["mat_ms"] / agg["mat_n"] if agg["mat_n"] else 0.0
        for reason, fb in sorted(fallbacks.items(),
                                 key=lambda kv: kv[1]["ms"], reverse=True):
            extra = ""
            if fb["rerun_ms"]:
                wasted = max(fb["ms"] - fb["rerun_ms"], 0.0)
                extra = (f"  (overflow rerun: {fb['rerun_ms']:.1f} ms "
                         f"eager + {wasted:.1f} ms wasted pipeline)")
            if per_drive is not None and fb["chunks"]:
                est = fb["chunks"] * per_drive + fb["queries"] * per_mat
                proj = f"{max(fb['ms'] - est, 0.0):9.1f} ms saved"
            else:
                proj = f"{'n/a':>12} saved"
            lines.append(f"  {fb['ms']:9.1f} ms  {proj}  "
                         f"{fb['syncs']:4d} syncs  "
                         f"{fb['queries']:3d} scans  {reason}{extra}")
    else:
        lines.append("# no eager-fallback streamed scans in this run")
    ranked = bottlenecks(agg)
    lines.append("")
    if ranked:
        lines.append("# next bottleneck (ranked by attributable ms)")
        for ms, what, action in ranked:
            lines.append(f"  {ms:9.1f} ms  {what} -> {action}")
    else:
        lines.append("# next bottleneck: no attributable costs in this run")
    return lines


def metrics_report_lines(path):
    """A ledger's live-metrics records (``obs/metrics.py`` rollups) as
    an appended section; [] when it carries none."""
    from nds_tpu_torch.obs import ledger as L
    recs = L.load_ledger(path).metrics
    if not recs:
        return []

    def fmt(rec, keys):
        return " ".join(f"{label}={rec[key]}" for key, label in keys
                        if rec.get(key) is not None)

    lines = ["", "# live metrics records (obs/metrics.py rollups carried "
             "in the ledger)"]
    for rec in (r for r in recs if r.get("scope") == "stream"):
        lines.append("  stream  " + fmt(rec, (
            ("app", "app"), ("phase", "phase"), ("queries", "queries"),
            ("okCount", "ok"), ("errorCount", "err"),
            ("timeoutShed", "timeoutShed"), ("faults", "faults"),
            ("qps", "qps"), ("wallP50Ms", "wallP50Ms"),
            ("wallP99Ms", "wallP99Ms"), ("wallMeanMs", "wallMeanMs"),
            ("queueWaitP50Ms", "queueWaitP50Ms"),
            ("queueWaitP99Ms", "queueWaitP99Ms"),
            ("stallMs", "stallMs"))))
    queries = [r for r in recs if r.get("scope") == "query"]
    if queries:
        lines.append(f"  query rollups: {len(queries)} records; last "
                     + fmt(queries[-1], (
                         ("query", "query"), ("queries", "queries"),
                         ("qpm", "qpm"), ("wallP50Ms", "wallP50Ms"),
                         ("wallP99Ms", "wallP99Ms"),
                         ("ewmaWallMs", "ewmaWallMs"),
                         ("stallPct", "stallPct"),
                         ("queueWaitP99Ms", "queueWaitP99Ms"))))
    return lines


def report(source, top=10):
    """The printable lines of a --trace-dir (directory) or a ledger
    (file)."""
    if os.path.isdir(source):
        agg = collect_from_traces(source)
        if agg is None:
            return [f"# no *.trace.json files under {source}"]
        return render(agg, source, top=top)
    if not os.path.exists(source):
        return [f"# {source}: no such trace dir or ledger file"]
    agg = collect_from_ledger(source)
    if agg is None:
        return [f"# no completed query records in ledger {source}"]
    return render(agg, source, top=top) + metrics_report_lines(source)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nds_tpu_torch.tools.trace_report",
        description="aggregate a --trace-dir (or an evidence ledger file) "
        "into the per-phase breakdown, roofline columns, top sync sites, "
        "fallback costs and the ranked next bottleneck")
    ap.add_argument("trace_dir", help="directory of *.trace.json files "
                    "(power --trace-dir, NDS_BENCH_TRACE_DIR), or an "
                    "evidence ledger file")
    ap.add_argument("--top", type=int, default=10,
                    help="sync sites to list (default 10)")
    args = ap.parse_args(argv)
    for ln in report(args.trace_dir, top=args.top):
        print(ln)
    return 0


if __name__ == "__main__":
    sys.exit(main())
