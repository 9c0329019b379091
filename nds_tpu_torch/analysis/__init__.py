# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Host-side rules the streamed path shares with its static models: the
fused-scan eligibility rule (``kernel_spec``), the survivor-bound proof and
capacity model (``mem_audit``), the execution classifier (``exec_audit``)
and the literal-bindability prover (``param_audit``) whose rule the
pipeline cache keys on."""

from __future__ import annotations

from dataclasses import asdict, dataclass


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
