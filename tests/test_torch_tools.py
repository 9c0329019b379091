# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The port's measuring tools (``nds_tpu_torch/tools/``) held against the
reference's root tools on the same inputs, on the CPU: replay_sweep,
replay_ab, sync_profile, obs_live, throughput_sweep, self_validate and
coverage_sweep (fault_diff: ``tests/test_torch_fault_diff.py``).

A root tool that runs at import or writes under the repository's
``.bench_cache`` runs here as a subprocess from a copy of itself in a
temporary tree that mirrors the repository (its data directory and
``native/ndsgen`` linked in), so it writes only there; the reference
package comes from the checkout on ``PYTHONPATH``. The full 103-statement
sweeps carry the ``slow`` marker."""

import csv
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_slice import slice_setup  # noqa: F401

torch.set_num_threads(1)   # tiny tensors: spare the other workers' cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SF001 = os.path.join(REPO, ".bench_cache", "sf0.01")
ORACLE_STREAM = os.path.join(REPO, ".bench_cache", "oracle_stream",
                             "query_0.sql")
NDSGEN = os.path.join(REPO, "native", "ndsgen", "ndsgen")


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_tree(tmp_path, *files):
    """A temporary tree that mirrors the repository for a root tool: the
    named files copied, the SF0.01 raw data and ``native/ndsgen`` linked,
    the oracle stream as the sweep stream."""
    if not (os.path.exists(os.path.join(SF001, ".complete"))
            and os.path.exists(NDSGEN) and os.path.exists(ORACLE_STREAM)):
        pytest.skip("needs .bench_cache/sf0.01, the oracle stream and a "
                    "built native/ndsgen")
    root = tmp_path / "ref_tree"
    for rel in files:
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(REPO, rel), root / rel)
    (root / ".bench_cache" / "sweep_stream").mkdir(parents=True)
    os.symlink(SF001, root / ".bench_cache" / "sf0.01")
    shutil.copy(ORACLE_STREAM,
                root / ".bench_cache" / "sweep_stream" / "query_0.sql")
    (root / "native" / "ndsgen").mkdir(parents=True)
    os.symlink(NDSGEN, root / "native" / "ndsgen" / "ndsgen")
    return root


def _run_ref(root, args, **env):
    r = subprocess.run(
        [sys.executable, *args], cwd=root, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=REPO,
                              JAX_PLATFORMS="cpu", **env))
    return r


def _marked(queries):
    """The oracle stream's statements with their markers, as the tools
    read a stream."""
    from nds_tpu_torch.power import gen_sql_from_stream
    allq = gen_sql_from_stream(ORACLE_STREAM)
    return {q: allq[q] for q in queries}


# ---------------------------------------------------------------------------
# replay_sweep
# ---------------------------------------------------------------------------

REPLAY_QS = ["query3", "query7", "query19", "query42"]


def test_replay_sweep_passes_what_the_reference_passes(slice_setup,
                                                       tmp_path):
    from nds_tpu_torch.tools import replay_sweep as RS
    _ref, port, _q = slice_setup
    lines = []
    passed, failed, nocompile = RS.parity(port, _marked(REPLAY_QS),
                                          out=lines.append)
    root = _ref_tree(tmp_path, "tools/replay_sweep.py",
                     "tools/coverage_sweep.py")
    r = _run_ref(root, ["tools/replay_sweep.py", ",".join(REPLAY_QS)])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    ref_pass = re.findall(r"^PASS (\S+)", r.stdout, re.M)
    assert sorted(passed) == sorted(ref_pass) == sorted(REPLAY_QS)
    assert not failed and not nocompile
    # the closing line in the reference's words
    want = re.search(r"=== replay parity: .* ===", r.stdout).group(0)
    assert want in "\n".join(lines)
    assert not RS.rows_eq([(1, 2.0)], [(1, 2.1)])
    assert RS.rows_eq([(1, 2.0), (3, None)], [(3, None), (1, 2.0)])


# ---------------------------------------------------------------------------
# replay_ab
# ---------------------------------------------------------------------------

AB_QS = ["query3", "query42"]


def test_replay_ab_rows_and_aggregate_match_the_reference(slice_setup,
                                                          tmp_path):
    from nds_tpu_torch import bench as B
    from nds_tpu_torch.tools import replay_ab as RA
    _ref, port, _q = slice_setup
    cfg = B.Config(scale="0.01", cache_root=str(tmp_path / "cache"))
    queries = dict(B.bench_queries(cfg))
    out = []
    rows = RA.sweep(port, queries, AB_QS, out=out.append)
    agg = RA.aggregate(rows, "cpu", "0.01")
    assert [json.loads(x) for x in out] == rows
    root = _ref_tree(tmp_path, "tools/replay_ab.py", "bench.py")
    r = _run_ref(root, ["tools/replay_ab.py", "--queries", ",".join(AB_QS),
                        "--out", str(root / "ab.json")],
                 NDS_BENCH_SCALE="0.01")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    ref = json.load(open(root / "ab.json"))
    assert set(agg) == set(ref)
    assert [set(x) for x in rows] == [set(x) for x in ref["results"]]
    assert agg["backend"] == "cpu" and agg["n_replayed"] == \
        ref["n_replayed"] == 2
    assert all(x["compiled"] and x["segmented"] == 0 for x in rows)
    # the statements the two packages time are the same texts
    from nds_tpu.queries import SUPPORTED_QUERIES
    from nds_tpu_torch.queries import SUPPORTED_QUERIES as PORT_SUPPORTED
    assert PORT_SUPPORTED == SUPPORTED_QUERIES
    assert not port._replay_cache and not port._replay_seen


def test_replay_ab_keeps_first_replay_apart_and_medians_reps(slice_setup):
    """``measure`` runs each stage in the reference's order, ``reps``
    timed runs of eager and steady replay, with a caller's ``run``."""
    from nds_tpu_torch.tools import replay_ab as RA
    _ref, port, queries = slice_setup
    clock = iter(range(1, 100))
    seen = []

    def run(stage, sql):
        seen.append((stage, port.sql(sql).collect() and stage,
                     os.environ.get("NDS_TPU_REPLAY")))
        return stage, float(next(clock))

    try:
        row, runs = RA.measure(port, queries["query42"], reps=3, run=run)
    finally:
        RA.reset(port)
    assert [s for s, _r, _m in seen] == (
        ["eager"] * 4 + ["seen", "record", "replay_first"] + ["replay"] * 3)
    assert [m for _s, _r, m in seen] == ["off"] * 4 + ["force"] * 6
    assert [r for _s, r, _t in runs] == [s for s, _r, _m in seen]
    assert row["eager_s"] == 3.0 and row["record_compile_s"] == 6.0
    assert row["replay_first_s"] == 7.0 and row["replay_s"] == 9.0
    assert row["speedup"] == round(3 / 9, 2)


# ---------------------------------------------------------------------------
# sync_profile
# ---------------------------------------------------------------------------

SYNC_QS = ["query3", "query42", "query96"]


def test_sync_profile_totals_equal_the_reference(slice_setup):
    from nds_tpu.engine import ops as RE
    from nds_tpu.obs import trace as ref_trace
    from nds_tpu_torch.tools import sync_profile as SP
    ref_tool = _load_tool("sync_profile")
    ref, port, queries = slice_setup
    got = SP.profile(port, queries, SYNC_QS)
    for (name, used, sites, full) in got:
        ref_trace.drain_spans()
        s0 = RE.sync_count()
        ref.sql(queries[name]).collect()
        want = RE.sync_count() - s0
        ref_sites = ref_tool.site_histogram(ref_trace.drain_spans())
        assert used == want == sum(sites.values()) == \
            sum(ref_sites.values()), (name, used, want, sites, ref_sites)
        assert not full
    lines = SP.live_lines(got)
    assert lines[0] == f"\n== {SYNC_QS[0]}: {got[0][1]} syncs =="


def _sync_ledger(mod, path):
    led = mod.Ledger(str(path), driver="bench")
    led.query("query9", status="ok", ms=5.0, hostSyncs=7, tracePhases={
        "syncSites": [{"tag": "count", "site": "ops.py:10", "syncs": 2},
                      {"tag": "resolve", "site": "planner.py:7",
                       "syncs": 5}]})
    led.query("query3", status="ok", ms=1.0, hostSyncs=1)
    led.close("completed")


def test_sync_profile_ledger_mode_equals_the_reference(tmp_path):
    from nds_tpu.obs import ledger as ref_ledger
    from nds_tpu_torch.obs import ledger as port_ledger
    from nds_tpu_torch.tools import sync_profile as SP
    ref_tool = _load_tool("sync_profile")
    for name, mod in (("ref", ref_ledger), ("port", port_ledger)):
        path = tmp_path / f"{name}.jsonl"
        _sync_ledger(mod, path)
        for wanted in (set(), {"query9"}):
            assert SP.ledger_histograms(str(path), wanted) == \
                ref_tool.ledger_histograms(str(path), wanted)
    assert "    5  resolve      planner.py:7" in SP.ledger_histograms(
        str(tmp_path / "port.jsonl"))


# ---------------------------------------------------------------------------
# obs_live
# ---------------------------------------------------------------------------


def test_obs_live_renders_as_the_reference(tmp_path, monkeypatch):
    from nds_tpu_torch.obs import metrics as M
    from nds_tpu_torch.tools import obs_live as OL
    ref_tool = _load_tool("obs_live")
    for arm, walls in (("a1", [100.0, 200.0]), ("a2", [4000.0, 7.5])):
        r = M.Registry(clock=lambda: 50.0)
        for w in walls:
            r.observe(M.QUERY_WALL, w)
        r.observe(M.STALL, 12.0)
        r.inc("queries.total", len(walls))
        r.inc(M.PIPE_HIT, 3)
        r.inc(M.PIPE_MISS, 1)
        monkeypatch.setenv("NDS_TPU_METRICS_FILE",
                           str(tmp_path / arm / "metrics.json"))
        M.export_live(registry=r, extra={"done": len(walls), "total": 9,
                                         "query": "q88", "phase": "Power"})
    monkeypatch.delenv("NDS_TPU_METRICS_FILE")
    for source in (str(tmp_path), str(tmp_path / "a1" / "metrics.json")):
        pairs = [(label, OL.load_snapshot(path))
                 for label, path in OL.find_snapshots(source)]
        assert pairs == [(label, ref_tool.load_snapshot(path)) for label, path
                         in ref_tool.find_snapshots(source)]
        assert OL.render(pairs, now=1e9) == ref_tool.render(pairs, now=1e9)
    text = "\n".join(OL.render(pairs, now=1e9))
    assert "2/9" in text and "3/1" in text
    assert any(ln.startswith("TOTAL") for ln in OL.render(
        [(lb, OL.load_snapshot(p)) for lb, p in
         OL.find_snapshots(str(tmp_path))], now=1e9))
    assert subprocess.run(
        [sys.executable, "-c", "import sys; "
         "from nds_tpu_torch.tools import obs_live; "
         "sys.exit('torch' in sys.modules)"], cwd=REPO).returncode == 0


# ---------------------------------------------------------------------------
# throughput_sweep
# ---------------------------------------------------------------------------


def _rows(path, rows):
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)


@pytest.mark.parametrize("crashed", [False, True])
def test_throughput_sweep_json_equals_the_reference(tmp_path, monkeypatch,
                                                    crashed):
    """The same synthetic time logs give the same record; a stream with
    a start marker and no end marker is recorded, not raised."""
    from nds_tpu_torch.tools import throughput_sweep as TS
    ref_tool = _load_tool("throughput_sweep")
    base = str(tmp_path / "s2_a1")
    _rows(base + "_1.csv", [
        ["app", "query", "time"], ["a", "CreateTempView item", "900"],
        ["a", "CreateTempView store_sales", "2100"],
        ["a", "Power Start Time", "1000"], ["a", "query1", "5"],
        ["a", "query2", "7"], ["a", "Power End Time", "1010"]])
    second = [["app", "query", "time"], ["a", "CreateTempView item", "800"],
              ["a", "Power Start Time", "1002"], ["a", "query1", "6"]]
    if not crashed:
        second.append(["a", "Power End Time", "1013"])
    _rows(base + "_2.csv", second)
    cmds = []

    def fake(cmd, **kw):
        cmds.append((cmd, kw["env"]))
        return subprocess.CompletedProcess(cmd, int(crashed), "",
                                           "killed" if crashed else "")

    for mod in (TS, ref_tool):
        monkeypatch.setattr(mod.subprocess, "run", fake)
    got = TS.run_config(2, 1, "data", "streams", str(tmp_path), "query1",
                        "parquet", device="cpu")
    want = ref_tool.run_config(2, 1, "data", "streams", str(tmp_path),
                               "query1", "parquet")
    regs = {i: s.pop("register_s") for i, s in got["streams"].items()}
    got.pop("launcher_wall_s")
    want.pop("launcher_wall_s")
    assert got == want
    assert regs == {1: 3.0, 2: 0.8}
    if crashed:
        assert got["streams"][2] == {"error": "missing end marker",
                                     "queries": 1}
        assert got["Ttt_s"] == 10
    else:
        assert got["Ttt_s"] == 13 and got["total_queries"] == 3
    (cmd, env), _ref_cmd = cmds
    assert cmd[1:4] == ["-m", "nds_tpu_torch.throughput", "1,2"]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert env["NDS_TPU_CONCURRENT_QUERIES"] == "1"
    assert env["NDS_TPU_ADMISSION_DIR"] == base + "_slots"


def test_throughput_sweep_goes_on_past_a_failed_configuration(tmp_path,
                                                               monkeypatch):
    from nds_tpu_torch.tools import throughput_sweep as TS
    monkeypatch.setattr(TS.subprocess, "run", lambda cmd, **kw:
                        subprocess.CompletedProcess(cmd, 1, "", "boom"))
    out = tmp_path / "tt.json"
    res = TS.sweep("data", "streams", str(out), streams="1,2",
                   admission="0,1", work_dir=str(tmp_path), device="cpu",
                   log=lambda _l: None)
    assert [(r["n_streams"], r["admission_slots"]) for r in res] == \
        [(1, 0), (1, 1), (2, 0), (2, 1)]
    assert all(r["streams"][1] == {"error": "no report"} for r in res)
    assert json.load(open(out))["configs"] == json.loads(json.dumps(res))


# ---------------------------------------------------------------------------
# the whole stream (slow)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_replay_sweep_every_statement(slice_setup):
    from nds_tpu_torch.power import gen_sql_from_stream
    from nds_tpu_torch.tools import replay_sweep as RS
    _ref, port, _q = slice_setup
    queries = gen_sql_from_stream(ORACLE_STREAM)
    passed, failed, _n = RS.parity(port, queries, out=lambda _l: None)
    assert not failed and len(passed) == len(queries) == 103


@pytest.mark.slow
def test_coverage_sweep_every_statement_matches_supported_lst(slice_setup):
    from nds_tpu_torch.power import gen_sql_from_stream
    from nds_tpu_torch.queries import SUPPORTED_QUERIES
    from nds_tpu_torch.tools import coverage_sweep as C
    _ref, port, _q = slice_setup
    passed, failed = C.sweep(port, gen_sql_from_stream(ORACLE_STREAM),
                             out=lambda _l: None)
    assert not failed and len(passed) == 103
    assert [f"{n}.tpl" for n in C.supported_names(passed, failed)] == \
        list(SUPPORTED_QUERIES)
    assert np.all([ms > 0 for _q, ms in passed])
