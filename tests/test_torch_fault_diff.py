# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The port's fault-injection differential
(``nds_tpu_torch/tools/fault_diff.py``) on the CPU, as
``tests/test_faults.py`` holds the reference's: the whole matrix
recovers bit for bit or raises its classified error, the drift run must
fail, and the matrix's seams plus the tests named for the others are the
registry (``engine/faults.py``), the same seams as the reference's."""

import ast
import os

import pytest
import torch

from nds_tpu.engine import faults as RF
from nds_tpu_torch.engine import faults as F
from nds_tpu_torch.tools import fault_diff as FD

torch.set_num_threads(1)   # tiny tensors: spare the other workers' cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _injected_seams(path):
    seams = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and ":" in node.value:
            seam = node.value.split(":")[0]
            if seam in F.SEAMS:
                seams.add(seam)
    return seams


def test_registry_fully_covered_by_injection_matrix():
    """A new seam cannot land without an injection: the matrix's seams
    plus the named elsewhere-covered tests equal the registry, whose
    seams are the reference's; so does the reference's own union."""
    port = _injected_seams(FD.__file__) | set(FD.COVERED_ELSEWHERE)
    ref = _injected_seams(os.path.join(REPO, "tools", "fault_diff.py"))
    assert port == set(F.SEAMS) == set(RF.SEAMS) == ref | {"bench-child"}
    for where in FD.COVERED_ELSEWHERE.values():
        path, name = where.split("::")
        assert f"def {name}(" in open(os.path.join(REPO, path)).read()


def test_fault_diff_matrix_green():
    """Every entry on the CPU: the streamed ones recover bit for bit, the
    watchdog and the peer raise their classified errors, nothing is
    skipped."""
    outcomes = {}
    failures = FD.run_diff(verbose=False, device="cpu", outcomes=outcomes)
    assert not failures, "\n".join(failures)
    assert outcomes == {
        **{n: "recovered" for n, _f in FD.STATEMENT_ENTRIES
           + FD.OTHER_ENTRIES},
        "sync-hang-watchdog": "classified", "peer": "classified"}
    assert not F.drain_fault_events()


def test_fault_diff_inject_drift_must_fail():
    """Recovery suppressed (``NDS_TPU_FAULT_DRIFT``) must be caught: a
    gate that passes with the recovery machinery off is vacuous."""
    outcomes = {}
    failures = FD.run_diff(inject_drift=True, verbose=False, device="cpu",
                           outcomes=outcomes)
    assert len(failures) == 2 and all(f.startswith("drift:")
                                      for f in failures), failures
    assert outcomes == {"prefetch": "failed", "sync-retry": "failed"}
    assert "NDS_TPU_FAULT_DRIFT" not in os.environ


def test_drift_suppresses_retry_and_events(monkeypatch):
    """The knob the self-test turns: no retry, no event."""
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise F.FaultInjected("sync", "transient")
        return 7

    assert F.with_retry("sync", flaky) == 7
    assert [e.action for e in F.drain_fault_events()] == ["recovered"]
    monkeypatch.setenv("NDS_TPU_FAULT_DRIFT", "1")
    calls.clear()
    with pytest.raises(F.FaultInjected):
        F.with_retry("sync", flaky)
    F.record_fault_event("sync", "recovered")
    assert not F.drain_fault_events() and len(calls) == 1


def test_main_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FD.main([])
