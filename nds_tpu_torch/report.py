# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Per-query benchmark report: JSON summary contract + status taxonomy.

The engine's equivalent of PysparkBenchReport (ref: nds/PysparkBenchReport.py:
60-127). Captures environment (with secret redaction), engine configuration
and version, wall-clock time in ms, task-failure info from the runtime
listener, and exceptions; statuses are ``Completed`` /
``CompletedWithTaskFailures`` / ``Failed``. Summary filename format
``<prefix>-<query>-<startTime>.json`` is preserved verbatim — the reference
documents it as a downstream (Power-BI) pipeline contract
(ref: nds/PysparkBenchReport.py:118-119).
"""

from __future__ import annotations

import json
import os
import time
import traceback

import nds_tpu_torch
from nds_tpu_torch.listener import FailureListener

_REDACT = ("TOKEN", "SECRET", "PASSWORD")


def _redacted_env() -> dict:
    """Environment capture with credential redaction
    (ref: nds/PysparkBenchReport.py:72-73)."""
    out = {}
    for k, v in os.environ.items():
        if any(s in k.upper() for s in _REDACT):
            out[k] = "*******"
        else:
            out[k] = v
    return out


class BenchReport:
    """Wraps one benchmark unit (a query, a table load, a maintenance
    function) and records everything the JSON summary needs."""

    def __init__(self, session=None):
        self.session = session
        self.summary = {
            "env": {
                "envVars": _redacted_env(),
                "engineConf": dict(getattr(session, "conf", {}) or {}),
                "engineVersion": nds_tpu_torch.__version__,
            },
            "queryStatus": [],
            "exceptions": [],
            "startTime": None,
            "queryTimes": [],
        }

    def report_on(self, fn, *args):
        """Run ``fn(*args)``, timing it and translating outcome into the
        status taxonomy (ref: nds/PysparkBenchReport.py:60-108).

        Returns elapsed wall-clock milliseconds (int).
        """
        self.summary["startTime"] = int(time.time() * 1000)
        listener = FailureListener().register()
        start = time.perf_counter()
        try:
            fn(*args)
            end = time.perf_counter()
            if listener.failures:
                self.summary["queryStatus"].append("CompletedWithTaskFailures")
                self.summary["exceptions"].extend(
                    f"{f.where}: {f.reason}" for f in listener.failures
                )
            else:
                self.summary["queryStatus"].append("Completed")
        except Exception:
            end = time.perf_counter()
            self.summary["queryStatus"].append("Failed")
            self.summary["exceptions"].append(traceback.format_exc())
        finally:
            listener.unregister()
        elapsed_ms = int((end - start) * 1000)
        self.summary["queryTimes"].append(elapsed_ms)
        return elapsed_ms

    def write_summary(self, query_name: str, prefix: str = "") -> None:
        """Write ``<prefix>-<query>-<startTime>.json``; filename format is a
        downstream pipeline contract (ref: nds/PysparkBenchReport.py:110-122)."""
        if not prefix:
            return
        self.summary["query"] = query_name
        filename = f"{prefix}-{query_name}-{self.summary['startTime']}.json"
        self.summary["filename"] = filename
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        with open(filename, "w") as f:
            json.dump(self.summary, f, indent=2)

    def is_success(self) -> bool:
        """True only if every wrapped unit fully Completed — runs with task
        failures are not a success, matching the reference's exit gate
        (ref: nds/PysparkBenchReport.py:124-127, nds/nds_power.py:310-322)."""
        return all(s == "Completed" for s in self.summary["queryStatus"])
