# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The port's memory auditor and static cost model against the reference's,
on the CPU: ``MemAuditor`` (peaks, output rows, scan bounds, findings)
and ``PerfAuditor`` (byte totals, stages, walls, tags) report for report
over the 103-statement corpus, the reference's cost model under
``NDS_TPU_PALLAS=interpret`` (where it prices the fused kernels the port
always lowers) and at the H100's rates through its own knobs; the corpus's
bottleneck histogram at those rates, pinned; the rate knobs moving walls
and not bytes; the live wire widths; ``tools/perf_audit_diff`` in both
directions on the CPU (launches are not counted there); and
``bench_compare --record-ab`` / ``--audit-perf`` with its drift fixture.
Every compared value is exact."""

import os

import pytest

from nds_tpu.analysis import mem_audit as RMA
from nds_tpu.analysis import perf_audit as RPA
from nds_tpu_torch.analysis import mem_audit as PMA
from nds_tpu_torch.analysis import perf_audit as PPA
from nds_tpu_torch.tools import perf_audit_diff as PD

_N_STATEMENTS = 103

# statements whose port report departs from the reference's, with the
# reason: none. The port's cost model prices the reference's fused-kernel
# arm (K4 on every device), the reference is run under it, and the launch
# band counts per shard (the port launches K4/K5 on each shard's slice),
# which moves no corpus statement: the corpus is priced unsharded.
DEPARTURES = {}

_H100 = {"NDS_TPU_ROOFLINE_H2D_GBS": "64", "NDS_TPU_ROOFLINE_HBM_GBS": "3350",
         "NDS_TPU_ROOFLINE_ICI_GBS": "450"}


def _with_env(env, fn):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def mem_reports():
    return RMA.audit_mem_corpus(), PMA.audit_mem_corpus()


@pytest.fixture(scope="module")
def perf_reports():
    ref = _with_env({"NDS_TPU_PALLAS": "interpret", **_H100},
                    RPA.audit_perf_corpus)
    return ref, PPA.audit_perf_corpus()


@pytest.mark.parametrize("i", range(_N_STATEMENTS))
def test_mem_report_matches_reference(mem_reports, i):
    ref, port = mem_reports
    assert len(ref) == len(port) == _N_STATEMENTS
    r, p = ref[i], port[i]
    assert (p.query, p.mode, p.peak_bytes, p.out_rows) == \
        (r.query, r.mode, r.peak_bytes, r.out_rows)
    if p.query in DEPARTURES:
        assert p.to_dict() != r.to_dict(), DEPARTURES[p.query]
    else:
        assert p.to_dict() == r.to_dict()


@pytest.mark.parametrize("i", range(_N_STATEMENTS))
def test_perf_report_matches_reference(perf_reports, i):
    ref, port = perf_reports
    assert len(ref) == len(port) == _N_STATEMENTS
    r, p = ref[i], port[i]
    assert (p.query, p.classification, p.bytes_h2d, p.bytes_hbm,
            p.bytes_ici, p.bound) == \
        (r.query, r.classification, r.bytes_h2d, r.bytes_hbm, r.bytes_ici,
         r.bound)
    if p.query in DEPARTURES:
        assert p.to_dict() != r.to_dict(), DEPARTURES[p.query]
    else:
        assert p.to_dict() == r.to_dict()


def test_findings_and_reports_match(mem_reports, perf_reports):
    (rm, pm), (rp, pp) = mem_reports, perf_reports
    assert PMA.reports_to_findings(pm) == [] == RMA.reports_to_findings(rm)
    assert PPA.reports_to_findings(pp) == [] == RPA.reports_to_findings(rp)
    assert PPA.format_perf_report(pp) == _with_env(
        _H100, lambda: RPA.format_perf_report(rp))
    text = PMA.format_mem_report(pm)
    assert "16.0GiB (hbm_bytes)" in text and "NDS_TPU" not in text


def test_bottleneck_histogram_at_h100_rates_pinned(perf_reports):
    """At the H100's rates 92 statements are bound by their uploads and 11
    by device-memory traffic; nothing is sync- or interconnect-bound
    (the corpus streams compiled and unsharded)."""
    _ref, port = perf_reports
    assert PPA.roofline_gbs() == {"h2d": 64.0, "hbm": 3350.0, "ici": 450.0}
    assert PPA.bottleneck_counts(port) == {"h2d-bound": 92, "hbm-bound": 11}
    walls = PPA.corpus_walls()
    assert len(walls) == _N_STATEMENTS
    assert walls["query3"] == (port[2].roofline_ms, "h2d-bound")


def test_rate_knobs_move_walls_not_bytes(monkeypatch):
    sql = PD.AB_QUERIES[0]
    base = PPA.PerfAuditor().audit_sql(sql)
    monkeypatch.setenv("NDS_TPU_ROOFLINE_H2D_GBS", "32")
    monkeypatch.setenv("NDS_TPU_ROOFLINE_HBM_GBS", "1675")
    slow = PPA.PerfAuditor().audit_sql(sql)
    assert (slow.bytes_h2d, slow.bytes_hbm, slow.bytes_ici, slow.stages) == \
        (base.bytes_h2d, base.bytes_hbm, base.bytes_ici, base.stages)
    assert slow.wall_h2d_ms == pytest.approx(2 * base.wall_h2d_ms)
    assert slow.wall_hbm_ms == pytest.approx(2 * base.wall_hbm_ms)
    assert slow.roofline_ms == pytest.approx(2 * base.roofline_ms)
    assert base.bytes_h2d > 0


def test_wire_widths_follow_the_wire_gate(monkeypatch):
    """The live wire widths: narrow codes where the data proves them
    (toy store_sales: int16 offsets for the date and price), plain widths
    under ``NDS_TPU_ENCODED=0``, each with its validity byte."""
    from nds_tpu_torch.engine.table import ChunkedTable
    tbl = PD.star_tables()["store_sales"]
    enc = PPA.wire_column_widths(ChunkedTable(tbl, chunk_rows=2048))
    monkeypatch.setenv("NDS_TPU_ENCODED", "0")
    raw = PPA.wire_column_widths(tbl)
    assert raw == {c: 9 for c in tbl.column_names}
    assert set(enc) == set(raw) and all(enc[c] < raw[c] for c in enc)


def test_static_walls_load_no_torch():
    """The trace and campaign reports price their own statements (and
    only those) without loading torch or the engine: the settings and
    the bucket rule the models read are torch-free
    (``engine/settings.py``)."""
    import subprocess
    import sys
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys; from nds_tpu_torch.tools import trace_report as T; "
         "w = T.static_walls(['query3', 'query14_part2', 'ab0']); "
         "print(sorted(w), 'torch' in sys.modules, "
         "'nds_tpu_torch.engine.ops' in sys.modules)"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split() == ["['query14_part2',", "'query3']", "False",
                                  "False"]
    walls = PPA.corpus_walls()
    assert PPA.statement_walls(["query3", "query14_part2"]) == {
        q: walls[q] for q in ("query3", "query14_part2")}


@pytest.fixture(scope="module")
def diff_evidence():
    return PD.collect("cpu")


def test_perf_audit_diff_passes_on_the_cpu(diff_evidence):
    ok, lines, records = PD.check(diff_evidence)
    assert ok, "\n".join(lines)
    assert lines[0].startswith("# launches not counted")
    assert [r["arm"] for r in records] == ["base", "sharded", "encoded-off"]
    assert [r["statements"] for r in records] == [14, 3, 4]
    for r in records:
        assert r["h2d"][0] == r["h2d"][1] > 0
        assert r["ici"][0] == r["ici"][1]
    assert records[1]["ici"][0] > 0
    # the raw wire uploads more than the encoded one, statement for
    # statement
    base, raw = records[0]["walls"], records[2]["walls"]
    assert all(raw[q]["static_ms"] > base[q]["static_ms"] for q in raw)


def test_perf_audit_diff_rejects_drift(diff_evidence):
    ok, lines, _records = PD.check(diff_evidence, inject=True)
    assert not ok
    assert any("static 0" in ln for ln in lines)


def test_record_ab_and_audit_perf_with_drift(tmp_path, capsys):
    from nds_tpu_torch.obs import ledger as L
    from nds_tpu_torch.tools import bench_compare as BC
    path = str(tmp_path / "ab.jsonl")
    assert BC.main(["--record-ab", path, "--device", "cpu"]) == 0
    data = L.load_ledger(path)
    assert data.complete() and data.meta["platform"] == "cpu"
    assert len(data.queries) == len(PD.AB_QUERIES) + 3
    assert data.meta["rowBounds"]["store_sales"] == 20_000
    capsys.readouterr()
    assert BC.main(["--audit-perf", path]) == 0
    out = capsys.readouterr().out
    assert out.count("ok [ab") == len(PD.AB_QUERIES)
    assert "matches the perf_audit static cost model" in out
    assert BC.main(["--audit-perf", path, "--inject-drift"]) == 0
    assert "drift fixture correctly rejected" in capsys.readouterr().out
    # a ledger whose bytes moved fails the check
    ok, lines = BC.audit_perf(path)
    assert ok
    text = open(path).read().replace('"bytesH2d": 122880',
                                     '"bytesH2d": 122881')
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        f.write(text)
    ok, lines = BC.audit_perf(bad)
    assert not ok and any("122881" in ln for ln in lines)
