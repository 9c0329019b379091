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
  the bench's own renderer.

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
    args = ap.parse_args(argv)

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
