# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The port's self-validation and coverage sweep
(``nds_tpu_torch/tools/self_validate.py``, ``coverage_sweep.py``) held
against the reference's root tools on the same inputs, on the CPU. Each
root tool runs as a subprocess (``tests/test_torch_tools.py``
``_ref_tree``), so it writes nothing under the repository."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from tests.test_torch_tools import (NDSGEN, REPO, SF001, _marked, _ref_tree,
                                    _run_ref)

torch.set_num_threads(1)   # tiny tensors: spare the other workers' cores


@pytest.fixture(scope="module")
def port_session():
    from nds_tpu_torch.tools import coverage_sweep as C
    if not os.path.exists(os.path.join(SF001, ".complete")):
        pytest.skip("needs .bench_cache/sf0.01")
    return C.load_session(SF001, "cpu")


# ---------------------------------------------------------------------------
# self_validate
# ---------------------------------------------------------------------------

SV_TEMPLATES = "query3.tpl,query42.tpl"


def test_self_validate_verdicts_equal_the_reference(tmp_path):
    from nds_tpu_torch.tools import self_validate as SV
    if not os.path.exists(NDSGEN):
        pytest.skip("needs a built native/ndsgen")
    rc, got = SV.run(SV_TEMPLATES.split(","), "0.01",
                     str(tmp_path / "port"), "cpu", log=lambda _l: None)
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "self_validate.py"),
         "--templates", SV_TEMPLATES, "--root", str(tmp_path / "ref")],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0 and "SELF VALIDATION: OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-2000:]
    compared = re.findall(r"=== Comparing Query: (\S+) ===", r.stdout)
    unmatched = re.search(r"=== Unmatch Queries: (.*) ===", r.stdout)
    want = {q: "Fail" if unmatched and q in unmatched.group(1) else "Pass"
            for q in compared}
    assert rc == 0 and got == want == {"query3": "Pass", "query42": "Pass"}


def test_self_validate_names_the_statement_that_differs(tmp_path):
    """A summary folder whose statement the validator failed reads
    ``Fail``; one it passed ``Pass``."""
    from nds_tpu_torch.tools import self_validate as SV
    for q, v in (("query3", "Pass"), ("query42", "Fail")):
        (tmp_path / f"app-{q}-1.json").write_text(json.dumps(
            {"query": q, "queryValidationStatus": [v]}))
    assert SV.verdicts(str(tmp_path)) == {"query3": "Pass",
                                         "query42": "Fail"}


# ---------------------------------------------------------------------------
# coverage_sweep
# ---------------------------------------------------------------------------

# cheap statements for the reference (its JAX compiles dominate)
COVERAGE_QS = ["query3", "query42", "query52", "query55", "query96"]
MESH_QS = COVERAGE_QS[:2]


def test_coverage_sweep_passes_what_the_reference_passes(port_session,
                                                         tmp_path):
    """Five templates on the port and through the root tool: the same
    pass set and the same ratchet; two of them also on a 2-shard meshed
    session (its shards sharing the CPU), rows equal to the unmeshed
    ones."""
    from nds_tpu_torch.parallel.exchange import sharing_devices
    from nds_tpu_torch.tools import coverage_sweep as C
    lines = []
    passed, failed = C.sweep(port_session, _marked(COVERAGE_QS),
                             out=lines.append)
    with sharing_devices():
        meshed = C.load_session(SF001, "cpu", {"mesh_shape": 2})
    m_passed, m_failed = C.sweep(port_session, _marked(MESH_QS), meshed, 2,
                                 out=lines.append)
    root = _ref_tree(tmp_path, "tools/coverage_sweep.py")
    r = _run_ref(root, ["tools/coverage_sweep.py", "--queries",
                        ",".join(COVERAGE_QS)])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    ref_pass = re.findall(r"^PASS (\S+)", r.stdout, re.M)
    assert [q for q, _ms in passed] == ref_pass == COVERAGE_QS
    assert [q for q, _ms in m_passed] == MESH_QS
    assert not failed and not m_failed
    assert C.summary(passed, failed)[0] == \
        re.search(r"\n=== .* ===", r.stdout).group(0) == \
        "\n=== 5 passed / 5 total ==="
    assert C.supported_names(
        [("query14_part1", 1.0), ("query3", 1.0)],
        {"X: boom": ["query14_part2"]}) == ["query3"]
    lst = tmp_path / "supported.lst"
    C.write_lst(str(lst), C.supported_names(passed, failed))
    assert lst.read_text().splitlines()[1:] == [
        f"{q}.tpl" for q in COVERAGE_QS]


def test_coverage_sweep_mesh_divergence_fails_the_statement(port_session):
    """A meshed session whose rows differ is a FAIL grouped by its first
    error line."""
    from nds_tpu_torch.tools import coverage_sweep as C

    class Off:
        def sql(self, text):
            return port_session.sql("select 1 one")

    passed, failed = C.sweep(port_session, _marked(["query42"]), Off(), 2,
                             out=lambda _l: None)
    assert not passed
    assert list(failed) == ["AssertionError: mesh(2) results diverge: "
                            "1 vs 2 rows"]
