# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The multi-arm evidence campaign as one command.

A campaign is an arm matrix (a built-in preset or a JSON file; the model
is ``nds_tpu_torch/obs/campaign.py``): each arm is an environment overlay
over ``python -m nds_tpu_torch.bench`` (prefetch depth, warm or cold chunk
store, encoded or raw wire, replay policy, stream shards), run in order
into its own ledger and traces under one campaign directory with a
versioned manifest. Rerunning the same command skips the arms whose
ledgers end ``completed``, resumes a partial arm off its own ledger, and
refuses (``CampaignResumeError``) to resume a ledger recorded under other
knobs. A failed or refused arm is classified through the ``bench-child``
fault seam, and the arms after it still run; the command then exits 2
when an arm was refused, else 1 when one failed.

The report (``report.md`` in the campaign directory, also printed) is
``bench_compare.format_multi`` over the arms' ledgers (rows keyed by the
arm name each ledger records), a per-arm table of prefetch stalls and
collective rates from ``trace_report``'s ledger collector, and the named
deltas: ``base`` against ``prefetch-off`` (the stall the ring hides),
warm against cold store, encoded against raw wire (ms and host-to-device
bytes), and each shard count whose arm ran its streamed scans at that
count (on too few cards a ``shards-N`` arm builds unsharded, and the
report says so instead of a delta). There is no ``pallas-off`` arm: on
cuda every kernel wrapper launches its hand-written kernel.

Usage:
    python -m nds_tpu_torch.tools.campaign --list-presets
    python -m nds_tpu_torch.tools.campaign --preset sf10-full --dry-run
    python -m nds_tpu_torch.tools.campaign --preset sf10-full   # run/resume
    python -m nds_tpu_torch.tools.campaign --matrix arms.json --dir out/ \\
        --bench-cmd "python -m nds_tpu_torch.bench --raw-dir /data/sf1"
    python -m nds_tpu_torch.tools.campaign --dir out/ --matrix arms.json \\
        --report --gate BASELINE.jsonl [--allow-missing]
    python -m nds_tpu_torch.tools.campaign --preset smoke --emit-perf T.md

``--audit-perf`` records, for each arm under the arm's own environment,
the A/B ledger of ``bench_compare --record-ab`` (``ab.jsonl`` in the arm's
directory, on ``--audit-device``, cuda by default) and holds it against the
static cost model (``bench_compare --audit-perf``); the worst exit code
counts. ``--audit-ab`` exits 2: it needs the sync and memory bounds
checked against a ledger (``bench_compare --audit-ab``), which the port
does not have yet.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import subprocess
import sys

from nds_tpu_torch.obs import campaign as C
from nds_tpu_torch.tools import bench_compare as BC
from nds_tpu_torch.tools import trace_report as TR

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

NO_AUDIT_AB = ("--audit-ab needs bench_compare --audit-ab (the ledger held "
               "against exec_audit's sync bounds and mem_audit's "
               "accumulator bounds), which the port does not have yet: "
               "ROADMAP Queue 1 item 2, the other auditors")


def _matrix(args):
    if args.matrix:
        with open(args.matrix) as f:
            return json.load(f), os.path.splitext(
                os.path.basename(args.matrix))[0]
    name = args.preset or "sf10-full"
    if name not in C.PRESETS:
        known = ", ".join(sorted(C.PRESETS))
        raise C.CampaignError(f"unknown preset {name!r} (known: {known})")
    return C.PRESETS[name], name


def dry_run_lines(arms, campaign_dir):
    """The matrix the run would execute: per arm, its overlay (sorted
    k=v, '' shown as unset), its fingerprint and its ledger path."""
    lines = [f"# campaign dry-run: {len(arms)} arms -> {campaign_dir}"]
    for arm in arms:
        overlay = ", ".join(
            f"{k}={'<unset>' if v == '' else v}"
            for k, v in sorted(arm.env.items())) or "(inherit)"
        lines.append(f"arm {arm.name}")
        lines.append(f"  env:         {overlay}")
        lines.append(f"  fingerprint: {C.arm_fingerprint(arm)}")
        lines.append("  ledger:      "
                     + C.arm_paths(campaign_dir, arm.name)["ledger"])
    return lines


# ---------------------------------------------------------------------------
# the cross-arm report
# ---------------------------------------------------------------------------


def _arm_rounds(arms, campaign_dir):
    """``[(arm name, round)]`` of every arm whose ledger loads with
    measured statements, named by the arm its ledger records."""
    out = []
    for arm in arms:
        path = C.arm_paths(campaign_dir, arm.name)["ledger"]
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            continue
        try:
            r = BC.load_round(path)
        except Exception as exc:
            print(f"# arm {arm.name}: unreadable ledger ({exc}); left out "
                  "of the report", file=sys.stderr)
            continue
        if r["times"]:
            out.append((BC.round_label(r, fallback=arm.name), r))
    return out


def _delta(rounds_by, a, b):
    """(geomean ratio b/a, common statements), or None."""
    if a not in rounds_by or b not in rounds_by:
        return None
    cmp = BC.compare(rounds_by[a], rounds_by[b])
    return cmp.get("geomean_ratio"), len(cmp["common"])


def _h2d(r) -> int:
    return sum(e.get("bytesH2d", 0) for e in r["evidence"].values())


def _collect(rounds_by, name):
    try:
        return TR.collect_from_ledger(rounds_by[name]["path"])
    except Exception as exc:
        print(f"# arm {name}: trace-report columns unavailable ({exc})",
              file=sys.stderr)
        return None


def report_lines(arms, campaign_dir, primary):
    """The cross-arm report: ``format_multi``, the per-arm stall and
    collective table, and the named deltas (a ratio > 1: the arm without
    the mechanism is slower, so the mechanism wins)."""
    pairs = _arm_rounds(arms, campaign_dir)
    if not pairs:
        return ["# campaign report: no arm has a readable ledger yet"]
    rounds_by = dict(pairs)
    order = [n for n, _ in pairs]
    if primary in rounds_by:
        order.remove(primary)
        order.insert(0, primary)
    lines = BC.format_multi([rounds_by[n] for n in order])
    lines.append("")
    lines.append("| arm | pf-stall ms | collective MB | collective GB/s "
                 "| %HBM roof | static-roofline % | unexplained ms |")
    lines.append("|---|---|---|---|---|---|---|")
    stalls = {}
    aggs = {name: _collect(rounds_by, name) for name in order}
    # the static cost model prices every arm's statements at once
    walls = TR.static_walls({q for agg in aggs.values() if agg
                             for q in agg["per_query"]})
    for name in order:
        agg = aggs[name]
        if not agg:
            lines.append(f"| {name} | - | - | - | - | - | - |")
            continue
        rows = agg["per_query"].values()
        stalls[name] = sum(r["pf_stall"] for r in rows)
        # the bench runs one card: its shards share it, so the collective
        # bytes move through its memory
        ici = sum(r["ici"] for r in rows)
        ms = sum(TR.collective_ms(r) for r in rows if r["ici"])
        if ici > 0 and ms > 0:
            gbs = ici / 1e9 / (ms / 1e3)
            cells = (f"{ici / 1e6:.1f} | {gbs:.1f} | "
                     f"{100 * gbs / TR.ROOFLINE_HBM_GBS:.1f}%")
        else:
            cells = "- | - | -"
        # the static cost model's walls of the priced statements against
        # their measured ms
        priced = [q for q in agg["per_query"] if q in walls]
        measured = sum(agg["per_query"][q]["total_ms"] for q in priced)
        static = TR.static_cells(measured, sum(walls[q][0] for q in priced)
                                 if priced else None)
        lines.append(f"| {name} | {stalls[name]:.0f} | {cells} |{static}")
    lines.append("# static-roofline % and unexplained ms: perf_audit's "
                 "roofline walls (SF10 catalog row bounds, the H100's "
                 "rates) of an arm's priced statements against their "
                 "measured ms")
    lines.append("")
    for title, b, note in (
            ("prefetch overlap delta", "prefetch-off",
             "prefetch ring off: the stall is exposed"),
            ("warm-vs-cold store delta", "store-cold",
             "chunk store off: every first sight encodes"),
            ("replay delta", "replay-off", "whole-statement replay off")):
        d = _delta(rounds_by, primary, b)
        if d and d[0]:
            lines.append(f"# {title}: {b} runs x{d[0]:.3f} vs {primary} "
                         f"over {d[1]} common queries ({note})")
    if primary in stalls and "prefetch-off" in stalls:
        lines.append(f"# prefetch stall: {stalls[primary]:.0f} ms waited "
                     f"with the ring ({primary}) vs "
                     f"{stalls['prefetch-off']:.0f} ms with it off (the "
                     "uploads then sit in the wall)")
    d = _delta(rounds_by, primary, "encoded-off")
    if d and d[0]:
        enc, raw = _h2d(rounds_by[primary]), _h2d(rounds_by["encoded-off"])
        ratio = f"x{raw / enc:.3f}" if enc else "-"
        lines.append(f"# encoded-vs-raw wire delta: encoded-off runs "
                     f"x{d[0]:.3f} vs {primary} over {d[1]} common queries; "
                     f"host-to-device bytes {enc} encoded vs {raw} raw "
                     f"({ratio})")
    shard_arms = sorted((n for n in rounds_by if n.startswith("shards-")),
                        key=lambda n: int(n.split("-")[1]))
    for n in shard_arms:
        # a scan asked for more shards than the visible cards hold builds
        # unsharded (outside exchange.sharing_devices()): only an arm
        # whose streamed scans ran at its count prices shard scaling
        want = int(n.split("-")[1])
        ran = max((e.get("shards", 1)
                   for e in rounds_by[n]["evidence"].values()), default=1)
        if ran != want:
            lines.append(f"# shard scaling: {n} ran its streamed scans at "
                         f"{ran} shard(s), not {want} (too few cards): "
                         "no delta")
            continue
        d = _delta(rounds_by, primary, n)
        if d and d[0]:
            lines.append(f"# shard scaling: {n} runs x{d[0]:.3f} vs "
                         f"{primary} (collective GB/s per arm above)")
    return lines


def run_gate(arms, campaign_dir, baseline, threshold, allow_missing=False):
    """``bench_compare --gate`` of every arm with a ledger against one
    baseline (bench_compare's own ``main``: its thresholds, coverage
    rules and output). Returns the worst exit code."""
    worst = 0
    for name, r in _arm_rounds(arms, campaign_dir):
        print(f"## gate: {name} vs {os.path.basename(baseline)}")
        rc = BC.main([baseline, r["path"], "--gate", "--threshold",
                      str(threshold)]
                     + (["--allow-missing"] if allow_missing else []))
        worst = max(worst, rc)
    return worst


def run_audits(arms, campaign_dir, device="cuda"):
    """``--audit-perf`` for every arm: ``bench_compare --record-ab`` under
    the arm's environment (a child process: each arm has its own knobs),
    then ``--audit-perf`` of that ledger. Returns the worst exit code."""
    worst = 0
    for arm in arms:
        paths = C.arm_paths(campaign_dir, arm.name)
        os.makedirs(paths["dir"], exist_ok=True)
        ab = os.path.join(paths["dir"], "ab.jsonl")
        if os.path.exists(ab):
            os.remove(ab)            # a fresh recording, never appended
        env = C.arm_env(arm)
        env["NDS_CAMPAIGN_ARM"] = arm.name
        for step in (["--record-ab", ab, "--device", device],
                     ["--audit-perf", ab]):
            print(f"## arm {arm.name}: {' '.join(step[:2])}", flush=True)
            rc = subprocess.call(
                [sys.executable, "-m", "nds_tpu_torch.tools.bench_compare",
                 *step], env=env, cwd=REPO)
            if rc != 0:
                print(f"## arm {arm.name}: {step[0]} FAILED (rc {rc})")
                worst = max(worst, rc)
                break
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nds_tpu_torch.tools.campaign",
        description="run, resume and report a multi-arm bench campaign "
        "(the arm model: nds_tpu_torch/obs/campaign.py)")
    ap.add_argument("--preset", help="built-in arm matrix "
                    "(default sf10-full; see --list-presets)")
    ap.add_argument("--matrix", help="JSON arm-matrix file "
                    "{v, env, arms:[{name, env}]}")
    ap.add_argument("--dir", help="campaign directory (default "
                    ".bench_cache/campaign_<preset> under the repo)")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the arms, their overlays, fingerprints and "
                    "artifact paths; run nothing")
    ap.add_argument("--list-presets", action="store_true")
    ap.add_argument("--bench-cmd", help="the command each arm runs "
                    "(default: this python -m nds_tpu_torch.bench); "
                    "shell-split, never run by a shell")
    ap.add_argument("--primary", default="base",
                    help="the arm the deltas and --emit-perf key off "
                    "(default 'base', else the first arm)")
    ap.add_argument("--report", action="store_true",
                    help="render the cross-arm report from the arms' "
                    "ledgers; run nothing")
    ap.add_argument("--gate", metavar="BASELINE",
                    help="gate every arm with a ledger against BASELINE "
                    "(bench_compare --gate)")
    ap.add_argument("--threshold", type=float, default=1.10)
    ap.add_argument("--allow-missing", action="store_true",
                    help="gate an arm that covers fewer statements than "
                    "BASELINE (bench_compare --allow-missing)")
    ap.add_argument("--audit-ab", action="store_true",
                    help="refused: needs bench_compare --audit-ab (exit 2)")
    ap.add_argument("--audit-perf", action="store_true",
                    help="per arm, record the A/B ledger under the arm's "
                    "knobs and hold its bytes against the static cost "
                    "model (bench_compare --record-ab / --audit-perf)")
    ap.add_argument("--audit-device", default="cuda",
                    choices=("cpu", "cuda"),
                    help="device of the --audit-perf recordings (default "
                    "cuda)")
    ap.add_argument("--emit-perf", metavar="PATH", nargs="?",
                    const=os.path.join(REPO, "PERF.md"),
                    help="write the primary arm's per-statement table to "
                    "PATH (default: the repo's PERF.md)")
    args = ap.parse_args(argv)

    if args.audit_ab:
        print(f"campaign: {NO_AUDIT_AB}", file=sys.stderr)
        return 2
    if args.list_presets:
        for name in sorted(C.PRESETS):
            p = C.PRESETS[name]
            print(f"{name}: {len(p['arms'])} arms — {p['description']}")
        return 0
    try:
        matrix, name = _matrix(args)
        campaign_dir = os.path.abspath(
            args.dir or os.path.join(REPO, ".bench_cache",
                                     f"campaign_{name}"))
        arms = C.expand_arms(matrix, campaign_dir)
    except (C.CampaignError, OSError, ValueError) as exc:
        print(f"campaign: {exc}", file=sys.stderr)
        return 2
    if args.dry_run:
        for ln in dry_run_lines(arms, campaign_dir):
            print(ln)
        return 0
    primary = args.primary if any(a.name == args.primary for a in arms) \
        else arms[0].name

    rc = 0
    if not args.report:
        bench_cmd = shlex.split(args.bench_cmd) if args.bench_cmd else None
        try:
            manifest = C.run_campaign(arms, campaign_dir,
                                      bench_cmd=bench_cmd, preset=name)
        except C.CampaignError as exc:
            print(f"campaign: {exc}", file=sys.stderr)
            return 2
        failed = manifest.get("failedArms", 0)
        print(f"# campaign {name}: {manifest.get('completedArms', 0)}/"
              f"{len(arms)} arms complete, {failed} failed -> "
              f"{campaign_dir}")
        refused = [a["name"] for a in manifest["arms"]
                   if (a.get("classified") or {}).get("detail")
                   == "fingerprint-mismatch"]
        for arm in refused:
            print(f"campaign: arm {arm}: CampaignResumeError: its ledger "
                  "was recorded under other knobs (manifest.json has "
                  "both fingerprints)", file=sys.stderr)
        # a refused resume exits 2, another failed arm 1
        rc = 2 if refused else 1 if failed else 0

    lines = report_lines(arms, campaign_dir, primary)
    if os.path.isdir(campaign_dir):
        with open(os.path.join(campaign_dir, "report.md"), "w") as f:
            f.write("\n".join(lines) + "\n")
    for ln in lines:
        print(ln)

    if args.gate:
        rc = max(rc, run_gate(arms, campaign_dir, args.gate, args.threshold,
                              allow_missing=args.allow_missing))
    if args.audit_perf:
        rc = max(rc, run_audits(arms, campaign_dir, args.audit_device))
    if args.emit_perf:
        ledger = C.arm_paths(campaign_dir, primary)["ledger"]
        if os.path.exists(ledger):
            BC.emit_perf(BC.load_round(ledger), args.emit_perf)
            print(f"# per-statement table of arm {primary} -> "
                  f"{args.emit_perf}")
        else:
            print(f"# --emit-perf: primary arm {primary} has no ledger yet",
                  file=sys.stderr)
            rc = max(rc, 1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
