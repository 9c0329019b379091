# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Static analysis of the port, run on the host with no device in the loop.

* :mod:`kernel_spec` — the fused-scan eligibility rule the K4 lowering
  and the execution auditor share;
* :mod:`mem_audit` — the survivor-bound proof the streamed pipeline sizes
  its accumulators from, and the per-statement peak device-memory bounds
  (:class:`mem_audit.MemAuditor`);
* :mod:`exec_audit` — the execution-path classifier and static host-sync
  bounds;
* :mod:`param_audit` — the literal-bindability prover whose rule the
  pipeline cache keys on;
* :mod:`perf_audit` — the static cost model: exact host-to-device bytes,
  collective bytes, the K4/K5 launch band and a roofline wall at the
  card's rates per statement;
* :mod:`torch_lint` — a Python-``ast`` lint for the port's hazards: host
  syncs in hot loops, chunk loops, capture bodies, shard bodies and the
  kernel wrappers' launch path, time and spans in capture bodies, cache
  hygiene, swallowed faults and division by a host scalar.

``python -m nds_tpu_torch.tools.lint`` runs them and gates on the findings
not covered by the checked-in :data:`BASELINE_PATH`; a code-lint finding is
suppressible in the source with ``# nds-lint: ignore[rule]``."""

from __future__ import annotations

import json
import os
import re
from dataclasses import asdict, dataclass

BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline.json")

SEVERITIES = ("error", "warning")


@dataclass(frozen=True)
class Finding:
    """One analyzer finding. ``query`` is the query/template name; ``line``
    is advisory (0 for plan findings, which carry no source positions)."""

    file: str
    query: str
    rule: str
    severity: str
    message: str
    line: int = 0

    def key(self) -> str:
        return f"{self.file}::{self.query}::{self.rule}::{self.message}"

    def to_dict(self) -> dict:
        return asdict(self)

    def __str__(self) -> str:
        loc = f"{self.file}:{self.line}" if self.line else self.file
        return f"{loc} [{self.query}] {self.severity} {self.rule}: {self.message}"


_SUPPRESS_RE = re.compile(r"#\s*nds-lint:\s*ignore(?:\[([\w\-, ]*)\])?")


def suppressed(source_lines: list, lineno: int, rule: str) -> bool:
    """True when ``# nds-lint: ignore[rule]`` (or a bare ``ignore``) is on
    the flagged line, or on a comment-only line directly above it (a
    trailing comment on the previous statement suppresses only that
    statement). ``lineno`` is 1-based, as in ``ast`` nodes."""
    for ln in (lineno, lineno - 1):
        if not 1 <= ln <= len(source_lines):
            continue
        text = source_lines[ln - 1]
        if ln != lineno and not text.lstrip().startswith("#"):
            continue
        m = _SUPPRESS_RE.search(text)
        if m:
            rules = m.group(1)
            if rules is None:
                return True
            if rule in {r.strip() for r in rules.split(",")}:
                return True
    return False


def load_baseline(path: str | None = None) -> dict:
    """The baseline as ``{finding key: accepted count}``; {} when absent."""
    path = path or BASELINE_PATH
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        doc = json.load(f)
    return dict(doc.get("keys", {}))


def baseline_reasons(path: str | None = None) -> dict:
    """``{finding key: why it is accepted}`` of the baseline's ``why``
    map; {} when absent."""
    path = path or BASELINE_PATH
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return dict(json.load(f).get("why", {}))


def write_baseline(findings, path: str | None = None) -> None:
    """Accept ``findings``: their keys with counts. The reasons of keys
    that stay accepted are kept."""
    path = path or BASELINE_PATH
    why = baseline_reasons(path)
    keys: dict = {}
    for f in findings:
        keys[f.key()] = keys.get(f.key(), 0) + 1
    doc = {"version": 1,
           "note": ("Accepted findings; python -m nds_tpu_torch.tools.lint "
                    "fails only on findings not covered here. Regenerate "
                    "with --update-baseline after review; 'why' says why "
                    "each is accepted."),
           "keys": dict(sorted(keys.items())),
           "why": {k: v for k, v in sorted(why.items()) if k in keys}}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")


def diff_against_baseline(findings, baseline: dict) -> list:
    """The findings the baseline does not cover. An entry absorbs up to
    its accepted count of identical keys, so a second instance of an
    accepted hazard in the same scope still fails the gate."""
    remaining = dict(baseline)
    new = []
    for f in findings:
        k = f.key()
        if remaining.get(k, 0) > 0:
            remaining[k] -= 1
        else:
            new.append(f)
    return new
