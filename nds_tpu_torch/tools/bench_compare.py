# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Cross-round comparison of evidence ledgers: diff two rounds, gate on
regressions, and render the per-statement table from a ledger.

* **diff** (two rounds): per-statement wall ratios, the geomean ratio,
  and the evidence deltas (host syncs, streamed-scan syncs, upload
  bytes, eager fallbacks), so a regression names its mechanism;
* **--gate**: exit nonzero when the geomean regresses past
  ``--threshold`` (1.10), any statement past ``--per-query-threshold``
  (1.50), or deterministic evidence regresses at all (a sync count up, a
  pipeline statement newly eager), or round B is incomplete unless
  ``--allow-missing``. The two thresholds are policy, not measurements;
* **--inject-drift**: self-test — regress round B synthetically before
  gating and require the gate to fail (exit 0 iff it did);
* **--emit-perf PATH**: the per-statement table of one ledger, through
  the bench's own renderer;
* **--record-ab PATH**: run the 14 streamed A/B statements
  (``tools/perf_audit_diff.AB_QUERIES``) on the chunked toy session,
  partitions forced to 2, plus ab0, ab2 and ab7 at 2 shards sharing the
  device, and ledger each statement's warm sight (the session's row
  counts, chunk rows and settings ride the meta record);
* **--audit-perf PATH**: hold such a ledger's uploaded and collective
  bytes against the static cost model (``analysis/perf_audit.py``) built
  from the ledger's own meta: equal where the model is exact, inside its
  band otherwise. With ``--inject-drift`` every prediction is zeroed and
  the check must fail (exit 0 iff it did).

With more than two rounds it prints the cross-arm table instead (every
round against the first, labeled by the arm name its ledger records).

A round is a ledger (``python -m nds_tpu_torch.bench`` with
``NDS_BENCH_RESULTS_JSONL``, or ``python -m nds_tpu_torch.power
--ledger``), or a JSON document with a ``"times"`` map (the bench's
baseline file).

Usage:
    python -m nds_tpu_torch.tools.bench_compare A.jsonl B.jsonl [--gate]
    python -m nds_tpu_torch.tools.bench_compare A.jsonl A.jsonl --gate \\
        --inject-drift
    python -m nds_tpu_torch.tools.bench_compare B.jsonl --emit-perf T.md
    python -m nds_tpu_torch.tools.bench_compare base.jsonl a1.jsonl a2.jsonl
    python -m nds_tpu_torch.tools.bench_compare --record-ab ab.jsonl \
        [--device cpu]
    python -m nds_tpu_torch.tools.bench_compare --audit-perf ab.jsonl \
        [--inject-drift]
"""

import argparse
import json
import math
import os
import sys

from nds_tpu_torch.obs import ledger as L


def _geomean(vals):
    return math.exp(sum(math.log(max(v, 1e-3)) for v in vals) / len(vals))


# evidence keys diffed per query,
# in report column order. 'syncs' is SCAN-level (streamed-scan charged
# syncs); 'hostSyncs' is the STATEMENT-level counter — kept as separate
# keys so the gate never compares one against the other (a query that
# stops streaming must not read as a sync regression).
EVIDENCE_KEYS = ("syncs", "hostSyncs", "bytesH2d", "bytesIci",
                 "collectives", "eager")


def load_round(path):
    """Normalize one round artifact into
    ``{times, perf, evidence, meta, end, torn, path}``.

    ``evidence[q]`` is the per-query aggregate (ledger ``evidence``
    field, derived from ``streamedScans`` when a record predates the
    field), plus the statement-level ``hostSyncs`` counter under its
    own key (never conflated with the scan-level ``syncs``)."""
    times, perf, evidence, meta, end, torn = {}, {}, {}, {}, None, False
    failed = {}
    metrics = []
    if path.endswith(".json"):
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict) or "times" not in doc:
            raise L.LedgerError(
                f"{path}: JSON round must carry a 'times' map "
                "(BASELINE_TIMES.json shape)")
        times = dict(doc["times"])
        meta = {k: v for k, v in doc.items() if k != "times"}
    else:
        data = L.load_ledger(path)
        torn = data.torn
        meta = data.meta
        end = data.end
        # live-metrics rollup records (obs/metrics.py) when the
        # round carried them; [] on legacy ledgers — every consumer of
        # this key must degrade to "no live metrics" silently
        metrics = data.metrics
        for name, rec in data.queries.items():
            if rec["status"] != "ok" or "ms" not in rec:
                continue
            times[name] = rec["ms"]
            perf[name] = rec
            ev = rec.get("evidence")
            if ev is None and "streamedScans" in rec:
                ev = L.evidence_from_scans(rec["streamedScans"])
            ev = dict(ev or {})
            if "hostSyncs" in rec:
                ev["hostSyncs"] = rec["hostSyncs"]
            evidence[name] = ev
        # failed = attempted under its OWN budget and did not complete.
        # Walk the full attempt history, not just the best record: a
        # round-budget retry of a genuinely hung query must not shadow
        # its budget-limited timeout (a round-budget kill alone means
        # the ROUND ran out — that is coverage loss, not a regression)
        for rec in data.attempts:
            name = rec["name"]
            if name in times:
                continue                       # an ok record wins
            if rec["status"] != "ok" and \
                    rec.get("limiter") != "round-budget":
                failed[name] = rec["status"]
    return {"path": path, "times": times, "perf": perf,
            "evidence": evidence, "meta": meta, "end": end, "torn": torn,
            "failed": failed, "metrics": metrics}


def compare(a, b):
    """Per-query and aggregate deltas between two loaded rounds."""
    common = sorted(set(a["times"]) & set(b["times"]))
    rows = []
    for q in common:
        ta, tb = a["times"][q], b["times"][q]
        row = {"query": q, "a_ms": ta, "b_ms": tb,
               "ratio": tb / max(ta, 1e-9)}
        ea, eb = a["evidence"].get(q), b["evidence"].get(q)
        if ea is not None and eb is not None:
            row["evidence"] = {k: (ea.get(k, 0), eb.get(k, 0))
                               for k in EVIDENCE_KEYS
                               if ea.get(k, 0) or eb.get(k, 0)}
        rows.append(row)
    out = {"common": common, "rows": rows,
           "only_a": sorted(set(a["times"]) - set(b["times"])),
           "only_b": sorted(set(b["times"]) - set(a["times"])),
           # ok in A, error/timeout in B: the worst regression there is —
           # these must never vanish into the 'only in A' footnote
           "now_failing": {q: b.get("failed", {})[q]
                           for q in sorted(set(a["times"])
                                           & set(b.get("failed", {})))}}
    if common:
        ga = _geomean([a["times"][q] for q in common])
        gb = _geomean([b["times"][q] for q in common])
        out.update(geomean_a=ga, geomean_b=gb,
                   geomean_ratio=gb / max(ga, 1e-9))
    return out


def format_compare(cmp, a, b, top=15):
    lines = [f"# bench_compare: {os.path.basename(a['path'])} (A) vs "
             f"{os.path.basename(b['path'])} (B)"]
    for label, r in (("A", a), ("B", b)):
        endrec = r["end"]
        state = (f"{endrec['status']} ({endrec.get('reason', 'clean')})"
                 if endrec else
                 ("json-times" if r["path"].endswith(".json")
                  else "NO terminal record (killed campaign)"))
        torn = " torn-tail" if r["torn"] else ""
        lines.append(f"#   {label}: {len(r['times'])} queries, "
                     f"platform {r['meta'].get('platform', '?')}, "
                     f"end: {state}{torn}")
    if not cmp["common"]:
        lines.append("# no common queries — nothing comparable")
        return lines
    lines.append(f"# geomean: A {cmp['geomean_a']:.1f} ms -> "
                 f"B {cmp['geomean_b']:.1f} ms "
                 f"(ratio {cmp['geomean_ratio']:.4f} over "
                 f"{len(cmp['common'])} common; <1 = B faster)")
    if cmp["only_a"] or cmp["only_b"]:
        lines.append(f"# only in A: {len(cmp['only_a'])}; "
                     f"only in B: {len(cmp['only_b'])}")
    for q, status in cmp.get("now_failing", {}).items():
        lines.append(f"# NOW FAILING: {q} was ok in A, {status} in B")
    ranked = sorted(cmp["rows"], key=lambda r: r["ratio"], reverse=True)
    lines.append("")
    lines.append("| query | A ms | B ms | ratio | evidence delta |")
    lines.append("|---|---|---|---|---|")
    for r in ranked[:top]:
        ev = r.get("evidence") or {}
        delta = ", ".join(f"{k} {va}->{vb}" for k, (va, vb) in ev.items()
                          if va != vb) or "-"
        lines.append(f"| {r['query']} | {r['a_ms']:.0f} | {r['b_ms']:.0f} "
                     f"| {r['ratio']:.2f} | {delta} |")
    if len(ranked) > top:
        lines.append(f"# ... {len(ranked) - top} more queries "
                     "(sorted by ratio, worst first)")
    return lines


def metrics_note(r, label):
    """One-line live-metrics summary per round when the ledger carried
    ``metrics`` records (obs/metrics.py rollups); [] on legacy
    ledgers, so pre-metrics comparisons print byte-identically."""
    streams = [m for m in r.get("metrics") or ()
               if m.get("scope") == "stream"]
    if not streams:
        return []
    s = streams[-1]
    parts = [f"queries={s.get('queries')}"]
    for key in ("qps", "wallP50Ms", "wallP99Ms", "queueWaitP99Ms",
                "timeoutShed", "faults"):
        if s.get(key) is not None:
            parts.append(f"{key}={s[key]}")
    return [f"# live metrics {label} ({round_label(r)}): "
            + " ".join(parts)]


def round_label(r, fallback=None):
    """How a round is named in cross-arm output: the arm name RECORDED
    in its ledger (the bench's campaign stamp) when present — provenance
    the artifact carries, not the path it happens to sit at — else the
    file basename."""
    return r["meta"].get("arm") or fallback or os.path.basename(r["path"])


def format_multi(rounds, top=8):
    """Cross-arm table over >2 rounds: every round diffed against
    rounds[0] (the primary arm) with :func:`compare`'s math — one row
    per arm, plus each arm's worst per-query regressions vs primary.
    Rows are keyed by :func:`round_label` (recorded arm name first)."""
    primary = rounds[0]
    plabel = round_label(primary)
    lines = [f"# bench_compare cross-arm: {len(rounds)} rounds, "
             f"primary = {plabel}"]
    lines.append("")
    lines.append("| arm | queries | geomean ms | vs primary | hostSyncs "
                 "| h2d MB | ici MB | end |")
    lines.append("|---|---|---|---|---|---|---|---|")
    details = []
    for r in rounds:
        label = round_label(r)
        cmp = compare(primary, r)
        geo = (_geomean(list(r["times"].values()))
               if r["times"] else float("nan"))
        ratio = (f"{cmp['geomean_ratio']:.3f}"
                 if cmp.get("geomean_ratio") and r is not primary else
                 ("1.000" if r is primary else "-"))
        syncs = sum(e.get("hostSyncs", 0) for e in r["evidence"].values())
        h2d = sum(e.get("bytesH2d", 0)
                  for e in r["evidence"].values()) / 1e6
        ici = sum(e.get("bytesIci", 0)
                  for e in r["evidence"].values()) / 1e6
        endrec = r["end"]
        state = (endrec["status"] if endrec else
                 ("json" if r["path"].endswith(".json") else "KILLED"))
        lines.append(f"| {label} | {len(r['times'])} | {geo:.1f} "
                     f"| {ratio} | {syncs} | {h2d:.1f} | {ici:.1f} "
                     f"| {state} |")
        if r is primary:
            continue
        worst = sorted(cmp["rows"], key=lambda x: x["ratio"],
                       reverse=True)[:top]
        moved = [w for w in worst if abs(w["ratio"] - 1.0) >= 0.05]
        if moved:
            details.append(f"# {label} vs {plabel} (worst movers):")
            for w in moved:
                details.append(
                    f"#   {w['query']}: {w['a_ms']:.0f} -> "
                    f"{w['b_ms']:.0f} ms (x{w['ratio']:.2f})")
        for q, status in cmp.get("now_failing", {}).items():
            details.append(f"# {label}: {q} ok in {plabel}, {status} here")
    lines.append("")
    lines.extend(details)
    return lines


def gate(cmp, threshold=1.10, per_query_threshold=1.50,
         bytes_threshold=1.20, b_round=None, allow_missing=False):
    """Regression verdicts. Wall-clock regressions gate with headroom
    (device weather is real); DETERMINISTIC evidence regresses at zero
    tolerance — a sync-count increase or a compiled statement going
    eager is an engine change, not weather. COVERAGE also gates: a
    killed round B (no terminal record) or queries measured in A but
    absent from B fail unless ``allow_missing`` explicitly blesses a
    partial comparison — CI must never go green on a campaign that died
    (a silent death). Returns violation lines (empty =
    pass)."""
    v = []
    for q, status in cmp.get("now_failing", {}).items():
        v.append(f"{q}: ok in A, {status} in B (query stopped completing)")
    if not allow_missing:
        if b_round is not None and not b_round["path"].endswith(".json") \
                and b_round["end"] is None:
            v.append("round B has no terminal record: the campaign was "
                     "killed mid-flight (pass --allow-missing to gate a "
                     "partial round on purpose)")
        if cmp["only_a"]:
            head = ", ".join(cmp["only_a"][:5])
            more = len(cmp["only_a"]) - 5
            v.append(f"{len(cmp['only_a'])} queries measured in A are "
                     f"missing from B ({head}"
                     + (f", +{more} more" if more > 0 else "")
                     + "): incomplete round (pass --allow-missing to "
                     "gate a partial round on purpose)")
    if not cmp["common"]:
        v.append("no common queries between rounds: nothing was compared "
                 "(a gate that compares nothing must not pass)")
        return v
    if cmp["geomean_ratio"] > threshold:
        v.append(f"geomean regressed {cmp['geomean_ratio']:.3f}x > "
                 f"threshold {threshold}x")
    for r in cmp["rows"]:
        if r["ratio"] > per_query_threshold:
            v.append(f"{r['query']}: wall {r['a_ms']:.0f} -> "
                     f"{r['b_ms']:.0f} ms ({r['ratio']:.2f}x > "
                     f"{per_query_threshold}x)")
        ev = r.get("evidence") or {}
        for key, label, tol in (("syncs", "streamed-scan syncs", 0),
                                ("hostSyncs", "host syncs", 0),
                                ("eager", "eager fallbacks", 0),
                                ("collectives", "collectives", 0)):
            if key in ev:
                va, vb = ev[key]
                if vb > va + tol:
                    v.append(f"{r['query']}: {label} {va} -> {vb} "
                             "(deterministic evidence regression)")
        if "bytesH2d" in ev:
            va, vb = ev["bytesH2d"]
            if va > 0 and vb > va * bytes_threshold:
                v.append(f"{r['query']}: h2d upload {va} -> {vb} bytes "
                         f"(> {bytes_threshold}x: encoding win lost)")
    return v


def inject_drift(b, threshold):
    """Synthetically regress round B (walls past both thresholds, +2
    syncs and +1 eager fallback per query): the gate MUST reject this,
    or the gate cannot catch a real regression."""
    out = {"path": b["path"] + "<drift>", "meta": b["meta"],
           "end": b["end"], "torn": b["torn"], "perf": b["perf"]}
    out["times"] = {q: t * max(threshold * 2, 4.0)
                    for q, t in b["times"].items()}
    out["evidence"] = {}
    for q in b["times"]:
        ev = dict(b["evidence"].get(q) or {})
        ev["syncs"] = ev.get("syncs", 0) + 2
        ev["eager"] = ev.get("eager", 0) + 1
        out["evidence"][q] = ev
    return out


def emit_perf(b, out_path):
    """Render round B's per-statement table through the bench's own
    deterministic renderer and write it to ``out_path``."""
    from nds_tpu_torch.bench import PERF_KEYS, perf_text
    perf = {q: {k: rec[k] for k in PERF_KEYS if k in rec}
            for q, rec in b["perf"].items()}
    platform = (b["meta"].get("platform")
                or (b["end"] or {}).get("platform") or "unknown")
    # scale and card come from the ledger, never from this process
    text = perf_text(b["times"], perf, platform=platform,
                     scale=b["meta"].get("scale", "unknown"),
                     card=b["meta"].get("card"))
    with open(out_path, "w") as f:
        f.write(text)
    return text


# ---------------------------------------------------------------------------
# the A/B ledger against the static cost model
# ---------------------------------------------------------------------------

AB_SHARDED = (0, 2, 7)


def _ab_sweep(ledger, session, indices, suffix="", **fields):
    """Each statement cold (recorded, on cuda captured), then warm into
    the ledger: ms, syncs, rows and its streamed scans."""
    import time

    import torch

    from nds_tpu_torch.engine import ops as E
    from nds_tpu_torch.listener import drain_stream_events, stream_event_json
    from nds_tpu_torch.tools.perf_audit_diff import AB_QUERIES
    drain_stream_events()
    for i in indices:
        sql = AB_QUERIES[i]
        session.sql(sql).collect()
        drain_stream_events()
        t0 = time.perf_counter()
        s0 = E.sync_count()
        rows = session.sql(sql).collect()
        if session.device.type == "cuda":
            torch.cuda.synchronize(session.device)
        used = E.sync_count() - s0
        ms = (time.perf_counter() - t0) * 1e3
        ledger.query(f"ab{i}{suffix}", status="ok", ms=round(ms, 3),
                     hostSyncs=used, outRows=len(rows), sight="warm",
                     streamedScans=[stream_event_json(e)
                                    for e in drain_stream_events()],
                     **fields)


def record_ab(path, device="cuda"):
    """Ledger the warm sight of the 14 A/B statements (partitions forced
    to 2) and of ab0, ab2, ab7 at 2 shards sharing the device, under the
    current environment (``NDS_TPU_ENCODED`` and the campaign arm's
    knobs). The meta record carries what ``--audit-perf`` rebuilds the
    model from: row counts, chunk rows, settings (capacity included), the
    wire gate."""
    from nds_tpu_torch.analysis.mem_audit import hbm_capacity_bytes
    from nds_tpu_torch.engine import ops as E
    from nds_tpu_torch.io.columnar import encoded_enabled
    from nds_tpu_torch.parallel.exchange import sharing_devices
    from nds_tpu_torch.tools import perf_audit_diff as PD
    tables = PD.star_tables()
    conf = {"stream_partitions": PD.PARTITIONS}
    session = PD.star_session(tables, device, conf)
    with E.on_device(session.device, conf=conf):
        conf["hbm_bytes"] = hbm_capacity_bytes()
    stamp = {"arm": os.environ["NDS_CAMPAIGN_ARM"]} \
        if os.environ.get("NDS_CAMPAIGN_ARM") else None
    ledger = L.Ledger(
        path, stamp=stamp, driver="bench-compare-ab",
        platform="gpu" if session.device.type == "cuda" else "cpu",
        rowBounds={n: int(t.nrows) for n, t in session.catalog.items()},
        chunkRows=PD.CHUNK_ROWS, conf=conf, shards=PD.SHARDS,
        encoded=encoded_enabled())
    _ab_sweep(ledger, session, range(len(PD.AB_QUERIES)))
    with sharing_devices(True):
        sharded = PD.star_session(tables, device,
                                  {**conf, "stream_shards": PD.SHARDS})
        _ab_sweep(ledger, sharded, AB_SHARDED, suffix="@sharded",
                  shardsForced=PD.SHARDS)
    ledger.close("completed", queries=len(PD.AB_QUERIES) + len(AB_SHARDED))
    return path


def audit_perf(path, inject=False):
    """Hold a ``--record-ab`` ledger's byte evidence against the static
    cost model: per statement, the compiled scans' recorded ``bytesH2d``
    (sorted) equal the predictions where the model is exact and lie in
    its band otherwise; the ``@sharded`` records' ``bytesIci`` equal the
    exchange-and-reduce arithmetic (or reach it, a lower bound). The
    model takes the ledger's row counts, chunk rows, settings and wire
    gate, and the toy tables' live wire widths (structure, rebuilt from
    the seed). ``inject`` zeroes every prediction first: the check must
    fail. Returns ``(ok, lines)``."""
    from nds_tpu_torch.analysis.mem_audit import MemModel
    from nds_tpu_torch.analysis.perf_audit import (PerfAuditor,
                                                   wire_column_widths)
    from nds_tpu_torch.engine import ops as E
    from nds_tpu_torch.engine.table import ChunkedTable
    from nds_tpu_torch.tools import perf_audit_diff as PD

    data = L.load_ledger(path)
    meta = data.meta
    row_bounds = {str(k): int(v) for k, v in
                  (meta.get("rowBounds") or {}).items()}
    conf = dict(meta.get("conf") or {})
    chunk_rows = int(meta.get("chunkRows", PD.CHUNK_ROWS))
    with PD._env(NDS_TPU_ENCODED=None if meta.get("encoded", True)
                 else "0"):
        store = ChunkedTable(PD.star_tables()["store_sales"],
                             chunk_rows=chunk_rows)
        wire = {"store_sales": wire_column_widths(store)}

        def reports(settings):
            with E.on_device("cpu", conf=settings):
                model = MemModel(row_bounds=row_bounds,
                                 chunk_rows=chunk_rows)
                auditor = PerfAuditor(streamed={"store_sales"},
                                      model=model, wire_cols=wire)
                return [auditor.audit_sql(sql, query=f"ab{i}")
                        for i, sql in enumerate(PD.AB_QUERIES)]
        plain = reports(conf)
        sharded = reports({**conf, "stream_shards": meta.get("shards",
                                                             PD.SHARDS)})
    ok, lines = True, []
    for i in range(len(PD.AB_QUERIES)):
        name = f"ab{i}"
        rec = data.queries.get(name)
        rep = plain[i]
        if rec is None:
            ok = False
            lines.append(f"MISMATCH [{name}] no ledger record")
            continue
        problems = []
        preds = sorted(((c.bytes_h2d, c.bytes_h2d_min, c.h2d_exact)
                        for c in rep.scans if c.compiled), reverse=True)
        if inject:
            preds = [(0, 0, True) for _ in preds]
        got = sorted((s["bytesH2d"] for s in rec.get("streamedScans") or []
                      if s.get("path") == "compiled"
                      and s.get("bytesH2d", -1) >= 0), reverse=True)
        if len(got) != len(preds):
            problems.append(f"ledger carries {len(got)} compiled byte "
                            f"records, the model priced {len(preds)}")
        for (p, pmin, exact), g in zip(preds, got):
            if (exact and g != p) or not pmin <= g <= p:
                problems.append(f"recorded upload {g} bytes, static {p}"
                                + ("" if exact else f" (band from {pmin})"))
        srec = data.queries.get(f"{name}@sharded")
        if srec is not None:
            ici = sorted(((c.bytes_ici, c.ici_exact)
                          for c in sharded[i].scans
                          if c.compiled and c.shards > 1), reverse=True)
            if inject:
                ici = [(0, True) for _ in ici]
            got_ici = sorted((s["bytesIci"]
                              for s in srec.get("streamedScans") or []
                              if s.get("bytesIci", -1) >= 0), reverse=True)
            if len(got_ici) != len(ici):
                problems.append(f"sharded record carries {len(got_ici)} "
                                f"collective byte records, the model "
                                f"priced {len(ici)}")
            for (p, exact), g in zip(ici, got_ici):
                if (exact and g != p) or g < p:
                    problems.append(f"recorded collective {g} bytes, "
                                    f"static {p}" + ("" if exact else
                                                     " (lower bound)"))
        if problems:
            ok = False
            lines.append(f"MISMATCH [{name}]")
            lines.extend(f"    {p}" for p in problems)
        else:
            lines.append(f"ok [{name}] recorded h2d {got} == static, "
                         f"roofline {rep.roofline_ms:.6f} ms ({rep.bound})")
    return ok, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nds_tpu_torch.tools.bench_compare",
        description="diff evidence ledgers; gate on regressions; render "
        "the per-statement table")
    ap.add_argument("rounds", nargs="*",
                    help="round artifacts: ledger JSONL or JSON with a "
                    "'times' map")
    ap.add_argument("--gate", action="store_true",
                    help="exit nonzero on regressions past the thresholds")
    ap.add_argument("--threshold", type=float, default=1.10,
                    help="geomean regression gate (default 1.10x)")
    ap.add_argument("--per-query-threshold", type=float, default=1.50,
                    help="per-statement wall regression gate (default "
                    "1.50x)")
    ap.add_argument("--allow-missing", action="store_true",
                    help="gate a partial round on purpose: skip the "
                    "killed-run (no terminal record) and missing-coverage "
                    "violations")
    ap.add_argument("--inject-drift", action="store_true",
                    help="self-test: regress round B synthetically and "
                    "require the gate to fail")
    ap.add_argument("--emit-perf", metavar="PATH",
                    help="write the per-statement table of the (single) "
                    "given ledger to PATH")
    ap.add_argument("--record-ab", metavar="PATH",
                    help="run the A/B statements on the chunked toy "
                    "session and write their evidence ledger to PATH")
    ap.add_argument("--audit-perf", metavar="PATH",
                    help="hold a --record-ab ledger's byte evidence "
                    "against the perf_audit static cost model")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="device of --record-ab (default cuda; refused "
                    "when no GPU is present)")
    args = ap.parse_args(argv)

    if args.record_ab:
        from nds_tpu_torch import resolve_device
        resolve_device(args.device)
        record_ab(args.record_ab, args.device)
        print(f"# A/B evidence ledger recorded: {args.record_ab}")
        return 0

    if args.audit_perf:
        ok, lines = audit_perf(args.audit_perf, inject=args.inject_drift)
        for ln in lines:
            print(ln)
        if args.inject_drift:
            if ok:
                print("# drift fixture NOT rejected: the cost-model check "
                      "cannot see a drifted model")
                return 1
            print("# drift fixture correctly rejected (the cost-model "
                  "check is live)")
            return 0
        print("# ledger byte evidence matches the perf_audit static cost "
              "model" if ok else "# cost-model check FAILED: the ledger's "
              "bytes differ from the static predictions")
        return 0 if ok else 1

    if args.emit_perf:
        if len(args.rounds) != 1:
            ap.error("--emit-perf takes exactly one ledger round")
        b = load_round(args.rounds[0])
        emit_perf(b, args.emit_perf)
        print(f"# table written from {args.rounds[0]} -> "
              f"{args.emit_perf} ({len(b['times'])} statements)")
        return 0

    if len(args.rounds) > 2:
        # the gate stays two-round: thresholds are a pairwise judgment
        if args.gate or args.inject_drift:
            ap.error("--gate/--inject-drift take exactly two rounds "
                     "(A B); the cross-arm table is report-only")
        for ln in format_multi([load_round(p) for p in args.rounds]):
            print(ln)
        return 0

    if len(args.rounds) != 2:
        ap.error("diff mode takes exactly two rounds (A B)")
    a = load_round(args.rounds[0])
    b = load_round(args.rounds[1])
    if args.inject_drift:
        b = inject_drift(b, args.threshold)
    cmp = compare(a, b)
    for ln in format_compare(cmp, a, b):
        print(ln)
    for ln in metrics_note(a, "A") + metrics_note(b, "B"):
        print(ln)
    violations = gate(cmp, threshold=args.threshold,
                      per_query_threshold=args.per_query_threshold,
                      b_round=b, allow_missing=args.allow_missing)
    if args.inject_drift:
        if not violations:
            print("# DRIFT FIXTURE FAILED TO FAIL: the gate cannot "
                  "catch a regression")
            return 1
        print(f"# drift fixture correctly rejected "
              f"({len(violations)} violations; gate is live)")
        return 0
    if violations:
        print(f"# gate: {len(violations)} violation(s)")
        for ln in violations:
            print(f"  REGRESSION {ln}")
        return 1 if args.gate else 0
    print("# gate: no regressions past thresholds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
