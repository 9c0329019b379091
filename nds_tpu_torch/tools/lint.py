# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Static analysis gate of the port: the auditors and the torch lint.

Runs the :mod:`nds_tpu_torch.analysis` passes on the host (no device, no
data) and exits nonzero when a finding is not covered by the checked-in
baseline (``nds_tpu_torch/analysis/baseline.json``). New code comes in
clean; accepting a finding is an explicit act (``--update-baseline``) that
shows in review as a baseline diff.

Passes: ``torch-lint``, ``exec-audit``, ``mem-audit``, ``perf-audit`` and
``param-audit``. The reference's ``plan-audit``, ``conc-audit``,
``num-audit`` and ``driver-audit`` are not ported yet (ROADMAP Queue 1):
the text output names them on one line and the JSON lists them under
``absent``; they are never reported clean.

Usage:
    python -m nds_tpu_torch.tools.lint                 # gate on the baseline
    python -m nds_tpu_torch.tools.lint --json out.json # full findings file
    python -m nds_tpu_torch.tools.lint --format json   # findings JSON on
                                                       # stdout
    python -m nds_tpu_torch.tools.lint --stream-report # execution paths
    python -m nds_tpu_torch.tools.lint --mem-report    # peak memory bounds
    python -m nds_tpu_torch.tools.lint --perf-report   # byte totals and
                                                       # roofline walls
    python -m nds_tpu_torch.tools.lint --param-report  # literal bindability
    python -m nds_tpu_torch.tools.lint --changed       # only the files of
                                                       # the git diff
    python -m nds_tpu_torch.tools.lint --jobs 4        # passes in threads
    python -m nds_tpu_torch.tools.lint --templates DIR # another corpus
    python -m nds_tpu_torch.tools.lint --root DIR      # another package tree
    python -m nds_tpu_torch.tools.lint --update-baseline
    python -m nds_tpu_torch.tools.lint --no-baseline   # every finding

Exit codes: 0 clean against the baseline, 2 on a new finding (or a
refused option, such as ``--num-report``).
"""

import argparse
import json
import os
import subprocess
import sys
import time

from nds_tpu_torch.analysis import (BASELINE_PATH, diff_against_baseline,
                                    load_baseline, write_baseline)
from nds_tpu_torch.analysis.exec_audit import (audit_exec_corpus,
                                               format_stream_report,
                                               reports_to_findings)
from nds_tpu_torch.analysis.mem_audit import (audit_mem_corpus,
                                              format_mem_report)
from nds_tpu_torch.analysis.mem_audit import \
    reports_to_findings as mem_reports_to_findings
from nds_tpu_torch.analysis.param_audit import (audit_param_corpus,
                                                format_param_report)
from nds_tpu_torch.analysis.param_audit import \
    reports_to_findings as param_reports_to_findings
from nds_tpu_torch.analysis.perf_audit import (audit_perf_corpus,
                                               format_perf_report)
from nds_tpu_torch.analysis.perf_audit import \
    reports_to_findings as perf_reports_to_findings
from nds_tpu_torch.analysis.torch_lint import lint_file, lint_tree

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PACKAGE = "nds_tpu_torch"

# the reference's passes the port does not have yet, each with where it
# stands; named in every report, never counted as clean
ABSENT = {
    "plan-audit": "ROADMAP Queue 1 item 2 (plan_audit: 97 of 732 lines "
                  "ported)",
    "conc-audit": "ROADMAP Queue 1 item 2 (conc_audit not ported)",
    "num-audit": "ROADMAP Queue 1 item 2 (num_audit not ported)",
    "driver-audit": "ROADMAP Queue 1 item 2 (driver_audit not ported)",
}

# a change under any of these reruns the corpus-level audits: the
# auditors mirror the planner's and the engine's semantics (routing, chunk
# shapes, the wire, the exchange, the kernels' eligibility), and the
# listener's StreamEvent is the evidence the harnesses hold them against
_CORPUS_ROOTS = (f"{PACKAGE}/queries", f"{PACKAGE}/analysis",
                 f"{PACKAGE}/sql", f"{PACKAGE}/engine",
                 f"{PACKAGE}/schema.py", f"{PACKAGE}/listener.py",
                 f"{PACKAGE}/io/columnar.py", f"{PACKAGE}/io/chunk_store.py",
                 f"{PACKAGE}/parallel/", f"{PACKAGE}/obs/")


def git_changed_files():
    """Repo-relative paths changed against HEAD (staged, unstaged and
    untracked), or None when the checkout's state cannot be read (the
    caller then runs everything)."""
    try:
        out = subprocess.run(["git", "-C", REPO, "status", "--porcelain"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    paths = set()
    for ln in out.stdout.splitlines():
        if len(ln) <= 3:
            continue
        p = ln[3:].strip().strip('"')
        if " -> " in p:                  # a rename: lint the new path
            p = p.split(" -> ")[-1]
        paths.add(p)
    return sorted(paths)


def run_passes(template_dir=None, changed=None, want_reports=False,
               jobs=1, root=None):
    """Run the passes; ``changed`` (repo-relative paths) restricts the run
    to the files it names (a change under :data:`_CORPUS_ROOTS` reruns the
    corpus audits). ``root`` lints another package tree than the port's.
    ``jobs`` > 1 runs the passes in a thread pool; the findings keep the
    pass order. Returns ``(findings, pass counts, reports by pass,
    elapsed seconds)``."""
    t0 = time.time()
    reports = {"exec": [], "mem": [], "perf": [], "param": []}
    corpus_affected = (
        changed is None or template_dir is not None or want_reports
        or any(c.startswith(_CORPUS_ROOTS) for c in changed))

    def run_exec():
        reports["exec"].extend(audit_exec_corpus(template_dir))
        return reports_to_findings(reports["exec"])

    def run_mem():
        reports["mem"].extend(audit_mem_corpus(template_dir))
        return mem_reports_to_findings(reports["mem"])

    def run_perf():
        reports["perf"].extend(audit_perf_corpus(template_dir))
        return perf_reports_to_findings(reports["perf"])

    def run_param():
        reports["param"].extend(audit_param_corpus(template_dir))
        return param_reports_to_findings(reports["param"])

    def run_lint():
        if changed is None:
            return lint_tree(root or os.path.join(REPO, PACKAGE))
        out = []
        for rel in changed:
            if rel.startswith(f"{PACKAGE}/") and rel.endswith(".py") and \
                    os.path.exists(os.path.join(REPO, rel)):
                out.extend(lint_file(os.path.join(REPO, rel), rel))
        return out

    passes = []
    if corpus_affected:
        passes += [("exec-audit", run_exec), ("mem-audit", run_mem),
                   ("perf-audit", run_perf), ("param-audit", run_param)]
    passes.append(("torch-lint", run_lint))
    if jobs > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=jobs) as pool:
            futures = [(name, pool.submit(fn)) for name, fn in passes]
            results = [(name, fut.result()) for name, fut in futures]
    else:
        results = [(name, fn()) for name, fn in passes]
    findings, counts = [], {}
    for name, got in results:
        counts[name] = len(got)
        findings.extend(got)
    return findings, counts, reports, time.time() - t0


def _aggregate(findings, new):
    """The ``--format json`` entries: one per (rule, file, symbol) with its
    count and whether every occurrence is covered by the baseline."""
    new_keys = {}
    for f in new:
        k = (f.rule, f.file, f.query)
        new_keys[k] = new_keys.get(k, 0) + 1
    agg = {}
    for f in findings:
        k = (f.rule, f.file, f.query)
        e = agg.setdefault(k, {"rule": f.rule, "file": f.file,
                               "symbol": f.query, "severity": f.severity,
                               "count": 0, "baselined": True})
        e["count"] += 1
    for k in new_keys:
        agg[k]["baselined"] = False
    return [agg[k] for k in sorted(agg)]


def absent_line() -> str:
    return ("# passes not ported yet (not run, not clean): "
            + "; ".join(f"{k}: {v}" for k, v in ABSENT.items()))


def _report_docs(args, reports) -> dict:
    doc = {}
    for flag, key, name in (("stream_report", "exec", "stream_report"),
                            ("mem_report", "mem", "mem_report"),
                            ("perf_report", "perf", "perf_report"),
                            ("param_report", "param", "param_report")):
        if getattr(args, flag) and reports[key]:
            doc[name] = [r.to_dict() for r in reports[key]]
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nds_tpu_torch.tools.lint",
        description="static analysis gate of the port")
    ap.add_argument("--templates", default=None,
                    help="query template dir to audit (default: the "
                    "shipped corpus)")
    ap.add_argument("--root", default=None,
                    help="package tree the torch lint reads (default: "
                    "nds_tpu_torch/); findings are named relative to its "
                    "parent")
    ap.add_argument("--json", default=None,
                    help="write the full findings report to this path")
    ap.add_argument("--format", default="text", choices=("text", "json"),
                    help="stdout: human text (default) or one findings "
                    "JSON document (same exit codes)")
    ap.add_argument("--stream-report", action="store_true",
                    help="print the exec-audit execution path of every "
                    "statement")
    ap.add_argument("--mem-report", action="store_true",
                    help="print the mem-audit peak device-memory bounds")
    ap.add_argument("--perf-report", action="store_true",
                    help="print the perf-audit byte totals, roofline walls "
                    "at the H100's rates and bottleneck tags")
    ap.add_argument("--num-report", action="store_true",
                    help="refused: num_audit is not ported yet (exit 2)")
    ap.add_argument("--param-report", action="store_true",
                    help="print the param-audit literal bindability")
    ap.add_argument("--changed", action="store_true",
                    help="lint only the files of the current git diff "
                    "(everything when not in a git checkout)")
    ap.add_argument("--jobs", type=int, default=1, metavar="N",
                    help="run the passes in an N-thread pool (default 1)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: the checked-in one)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to accept the findings")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report every finding")
    args = ap.parse_args(argv)
    if args.num_report:
        print("lint: --num-report needs num_audit, which the port does not "
              f"have yet: {ABSENT['num-audit']}", file=sys.stderr)
        return 2
    if args.update_baseline and (args.templates or args.root) and \
            args.baseline is None:
        ap.error("--update-baseline over a --templates corpus or a --root "
                 "tree would overwrite the checked-in baseline with foreign "
                 "findings; pass an explicit --baseline path")
    if args.update_baseline and args.changed:
        ap.error("--update-baseline needs every finding; drop --changed")
    baseline_path = args.baseline or BASELINE_PATH
    changed = git_changed_files() if args.changed else None

    findings, counts, reports, elapsed = run_passes(
        args.templates, changed=changed,
        want_reports=(args.stream_report or args.mem_report
                      or args.perf_report or args.param_report),
        jobs=max(args.jobs, 1), root=args.root)
    # against the baseline as it was, so a --json written beside
    # --update-baseline shows what was just accepted
    baseline = {} if args.no_baseline else load_baseline(baseline_path)
    new = diff_against_baseline(findings, baseline)

    if args.json:
        doc = {"elapsed_s": round(elapsed, 2), "pass_counts": counts,
               "absent": sorted(ABSENT),
               "baseline_covered": len(findings) - len(new),
               "new": [f.to_dict() for f in new],
               "all": [f.to_dict() for f in findings]}
        for name, key in (("stream_report", "exec"), ("mem_report", "mem"),
                          ("perf_report", "perf"),
                          ("param_report", "param")):
            if reports[key]:
                doc[name] = [r.to_dict() for r in reports[key]]
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1)

    if args.update_baseline:
        write_baseline(findings, baseline_path)
        print(f"baseline updated: {baseline_path} "
              f"({len(findings)} accepted findings)")
        return 0

    # under --format json stdout stays one JSON document: the tables and
    # the summary go to stderr
    out = sys.stderr if args.format == "json" else sys.stdout
    for flag, key, fmt in (("stream_report", "exec", format_stream_report),
                           ("mem_report", "mem", format_mem_report),
                           ("perf_report", "perf", format_perf_report),
                           ("param_report", "param", format_param_report)):
        if getattr(args, flag) and reports[key]:
            print(fmt(reports[key]), file=out)
    for f in new:
        print(f"NEW {f}", file=out)
    n_err = sum(1 for f in new if f.severity == "error")
    summary = ", ".join(f"{name}: {n}" for name, n in counts.items())
    scope = f" ({len(changed)} changed files)" if changed is not None else ""
    print(f"# lint{scope}: {summary}; {len(findings) - len(new)} baselined, "
          f"{len(new)} new ({n_err} errors) in {elapsed:.1f}s", file=out)
    print(absent_line(), file=out)
    if args.format == "json":
        doc = {"version": 1, "elapsed_s": round(elapsed, 2),
               "pass_counts": counts, "absent": sorted(ABSENT),
               "new": len(new), "findings": _aggregate(findings, new),
               **_report_docs(args, reports)}
        print(json.dumps(doc, indent=1))
    if new:
        print("# gate FAILED: fix the findings above, suppress one with "
              "'# nds-lint: ignore[rule]', or accept it deliberately with "
              "--update-baseline", file=out)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
