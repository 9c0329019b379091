# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""``nds_tpu_torch/tools/trace_report.py`` against the reference's
``tools/trace_report.py``.

The port's Power Run at SF0.01 (query3, query37 and query96, every table
past 1.5e5 bytes streamed in 4,096-row chunks) writes ``--trace-dir``
traces and a ledger; both packages' collectors read the same files and
must give equal per-query phase self-times (the port's own phases,
``stream.encode``, ``stream.upload`` and ``stream.capture``, folded into
the reference's "other"), totals, host syncs, bytes, prefetch stalls,
sync sites and fallbacks. The rates default to the H100's datasheet
figures, the port's file holds no TPU constant, a streamed scan's
uploads price against the host link (PCIe) without a clamp, and a
sharded scan's collective bytes price against the card's memory when its
shards share one card and against NVLink only when they span several."""

import functools
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from nds_tpu_torch.tools import trace_report as TR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERIES = ("query3", "query37", "query96")


@functools.lru_cache(maxsize=None)
def _reference():
    spec = importlib.util.spec_from_file_location(
        "_ref_trace_report", os.path.join(REPO, "tools", "trace_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(trace dir, ledger) of one streamed CPU Power Run of the port."""
    from tools.coverage_sweep import ensure_data

    from nds_tpu_torch.queries import generate_query_streams
    root = tmp_path_factory.mktemp("trace_report")
    generate_query_streams(str(root), streams=1, rngseed=19620718,
                           scale=0.01)
    props = root / "stream.properties"
    props.write_text("stream_bytes=1.5e5\nstream_chunk_rows=4096\n")
    traces, ledger = str(root / "traces"), str(root / "led.jsonl")
    res = subprocess.run(
        [sys.executable, "-m", "nds_tpu_torch.power", ensure_data(),
         str(root / "query_0.sql"), str(root / "t.csv"), "--input_format",
         "raw", "--device", "cpu", "--property_file", str(props),
         "--trace-dir", traces, "--ledger", ledger,
         "--sub_queries", ",".join(QUERIES)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    return traces, ledger


def _folded(row, ref_phases):
    """A port row's phases with those the reference has no column for
    folded into "other"."""
    out = {}
    for name, ms in row["phases"].items():
        key = name if name in ref_phases else "other"
        out[key] = out.get(key, 0.0) + ms
    return out


_ROW_KEYS = ("total_ms", "syncs", "h2d", "logical", "stream_ms", "ici",
             "sync_ms", "pf_stall")


@pytest.mark.parametrize("source", ["traces", "ledger"])
def test_collectors_match_the_reference(run, source):
    ref = _reference()
    traces, ledger = run
    if source == "traces":
        got, want = TR.collect_from_traces(traces), \
            ref.collect_from_traces(traces)
    else:
        got, want = TR.collect_from_ledger(ledger), \
            ref.collect_from_ledger(ledger)
    assert sorted(got["per_query"]) == sorted(want["per_query"]) == \
        sorted(QUERIES)
    for q in QUERIES:
        g, w = got["per_query"][q], want["per_query"][q]
        folded = _folded(g, ref.PHASES)
        assert set(folded) == {k for k, v in w["phases"].items()
                               if v or k in folded}, q
        for name, ms in w["phases"].items():
            assert folded.get(name, 0.0) == pytest.approx(ms, abs=1e-9), \
                (q, name)
        for key in _ROW_KEYS:
            assert g[key] == pytest.approx(w[key], abs=1e-9), (q, key)
    assert got["sites"] == want["sites"]
    assert got["site_tag"] == want["site_tag"]
    assert dict(got["fallbacks"]) == dict(want["fallbacks"])
    for key in ("drive_ms", "drive_n", "mat_ms", "mat_n"):
        assert got[key] == pytest.approx(want[key], abs=1e-9), key
    # the streamed statements are there, and their setup phases too
    assert all(got["per_query"][q]["h2d"] > 0 for q in QUERIES)
    if source == "traces":
        assert all(got["per_query"][q]["phases"].get("stream.encode")
                   for q in QUERIES)


def test_port_phases_in_pipeline_order():
    ref = _reference()
    own = [p for p in TR.PHASES if p not in ref.PHASES]
    assert own == ["stream.encode", "stream.upload", "stream.capture"]
    assert [p for p in TR.PHASES if p in ref.PHASES] == list(ref.PHASES)


def test_report_renders_both_sources(run):
    traces, ledger = run
    for source in (traces, ledger):
        lines = TR.report(source)
        assert lines[0] == f"# trace report: 3 queries from {source}"
        head = lines[2]
        assert "| stream.drive |" in head
        assert "| h2d GB/s | %PCIe roof |" in head
        assert "static-roofline %" in head
        walls = TR.static_walls(QUERIES)
        assert set(walls) == set(QUERIES)
        for q, row in zip(sorted(QUERIES), lines[4:7]):
            cells = [c.strip() for c in row.strip("|").split("|")]
            total, pct, unexplained = (float(cells[1]), float(cells[-2]),
                                       float(cells[-1]))
            assert row.startswith(f"| {q} |")
            # the cells come from the unrounded total, the row shows it
            # to 0.1 ms
            lo, hi = total - 0.05, total + 0.05
            assert walls[q][0] / hi * 100 - 0.05 <= pct <= \
                walls[q][0] / lo * 100 + 0.05
            assert max(lo - walls[q][0], 0.0) - 0.05 <= unexplained <= \
                max(hi - walls[q][0], 0.0) + 0.05
        assert any("perf_audit" in ln for ln in lines)
        assert any(ln.startswith("# next bottleneck") for ln in lines)


def test_cli_prints_the_report(run):
    traces, _ledger = run
    res = subprocess.run(
        [sys.executable, "-m", "nds_tpu_torch.tools.trace_report", traces,
         "--top", "2"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("# trace report: 3 queries")
    res = subprocess.run(
        [sys.executable, "-c", "import sys; "
         "from nds_tpu_torch.tools import trace_report; "
         "print('torch' in sys.modules, 'jax' in sys.modules)"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert res.stdout.split() == ["False", "False"]


def test_defaults_are_the_h100s():
    res = subprocess.run(
        [sys.executable, "-c", "from nds_tpu_torch.tools import "
         "trace_report as T; print(T.ROOFLINE_H2D_GBS, T.ROOFLINE_HBM_GBS, "
         "T.ROOFLINE_ICI_GBS)"],
        cwd=REPO, capture_output=True, text=True, timeout=60,
        env={k: v for k, v in os.environ.items()
             if not k.startswith("NDS_TPU_ROOFLINE")})
    assert res.stdout.split() == ["64.0", "3350.0", "450.0"]
    res = subprocess.run(
        [sys.executable, "-c", "from nds_tpu_torch.tools import "
         "trace_report as T; print(T.ROOFLINE_H2D_GBS, T.ROOFLINE_HBM_GBS, "
         "T.ROOFLINE_ICI_GBS)"],
        cwd=REPO, capture_output=True, text=True, timeout=60,
        env=dict(os.environ, NDS_TPU_ROOFLINE_H2D_GBS="32",
                 NDS_TPU_ROOFLINE_HBM_GBS="2000",
                 NDS_TPU_ROOFLINE_ICI_GBS="900"))
    assert res.stdout.split() == ["32.0", "2000.0", "900.0"]
    with open(TR.__file__) as f:
        text = f.read()
    for tpu in ("819", "186", "v5e", "ICI roof"):
        assert tpu not in text, tpu


def _trace(path, query, cards, ici=8_000_000, h2d=1_000_000):
    """A synthetic trace of one sharded streamed scan."""
    events = [
        {"name": "query", "ph": "X", "ts": 0, "dur": 10_000, "args": {}},
        {"name": "stream", "ph": "X", "ts": 100, "dur": 9_000,
         "args": {"bytesH2d": h2d, "bytesIci": ici,
                  "shardCards": cards, "scanLaunches": 4,
                  "probeLaunches": 0, "prefetchStallMs": 0.5}},
        {"name": "stream.drive", "ph": "X", "ts": 200, "dur": 4_000,
         "args": {}},
        {"name": "stream.exchange", "ph": "X", "ts": 4_300, "dur": 2_000,
         "args": {}},
        {"name": "stream.materialize", "ph": "X", "ts": 6_400, "dur": 2_000,
         "args": {}},
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "nds": {"query": query}}, f)


def test_collective_columns_follow_the_cards(tmp_path):
    _trace(tmp_path / "shared.trace.json", "shared", 1)
    lines = TR.report(str(tmp_path))
    head = lines[2]
    assert "collective MB | collective GB/s | %HBM roof" in head
    assert "nvlink" not in head
    # 8 MB over the 4 ms of exchange and materialize: 2 GB/s of 3,350
    row = next(ln for ln in lines if ln.startswith("| shared |"))
    assert "| 8.0 | 2.00 | 0.1 |" in row
    _trace(tmp_path / "distinct.trace.json", "distinct", 2)
    lines = TR.report(str(tmp_path))
    assert "nvlink MB | nvlink GB/s | %NVLink roof" in lines[2]
    row = next(ln for ln in lines if ln.startswith("| distinct |"))
    assert "| - | - | - | 8.0 | 2.00 | 0.4 |" in row
    assert any("kernel coverage: 2/2" in ln for ln in lines)
    ranked = [what for _ms, what, _a in TR.bottlenecks(
        TR.collect_from_traces(str(tmp_path)))]
    assert any(w.startswith("shared-card collective HBM headroom")
               for w in ranked)
    assert any(w.startswith("NVLink roofline headroom") for w in ranked)


def test_uploads_price_against_the_host_link(tmp_path):
    """A streamed scan's uploads cross PCIe: its rate is held against the
    host link's, never the card's memory, and the share is not clamped."""
    # 288 MB over the scan's 9 ms: 32 GB/s, half of PCIe Gen5 x16's 64
    _trace(tmp_path / "half.trace.json", "half", 1, ici=0, h2d=288_000_000)
    lines = TR.report(str(tmp_path))
    assert "h2d MB | h2d GB/s | %PCIe roof" in lines[2]
    row = next(ln for ln in lines if ln.startswith("| half |"))
    assert "| 288.0 | 288.0 | 32.00 | 50.0 |" in row
    ranked = TR.bottlenecks(TR.collect_from_traces(str(tmp_path)))
    ms, what, _a = next(t for t in ranked if t[1].startswith("host-link"))
    assert "32.0 GB/s = 50.0% of 64 PCIe" in what
    assert abs(ms - 4.5) < 1e-9
    # a byte count the link cannot carry shows as a share above 100%
    _trace(tmp_path / "half.trace.json", "half", 1, ici=0, h2d=1_152_000_000)
    ranked = TR.bottlenecks(TR.collect_from_traces(str(tmp_path)))
    ms, what, _a = next(t for t in ranked if t[1].startswith("host-link"))
    assert "128.0 GB/s = 200.0% of 64 PCIe" in what and ms < 0
