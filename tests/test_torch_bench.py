# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The port's bench entry (``python -m nds_tpu_torch.bench``) and its
comparison tool (``python -m nds_tpu_torch.tools.bench_compare``), as the
reference's ``tests/test_bench.py`` and the gate half of
``tests/test_ledger.py`` test theirs: budgets from the port's own baseline
(none, or one of another card or scale, gives every statement the cap),
the hung-child budget, the circuit breaker, the SIGTERM partial line and
the resume, the fault seams of the parent, and the gate. Stub children
stand in for the serving process; one test runs the real entry on the
CPU at SF0.01. Everything is written under ``tmp_path``."""

import json
import os
import subprocess
import sys
import time

import pytest

from nds_tpu_torch import bench
from nds_tpu_torch.engine import faults as F
from nds_tpu_torch.obs import ledger as L
from nds_tpu_torch.tools import bench_compare as BC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = {"card": "NVIDIA H100 80GB HBM3", "powerLimit": "700.00 W"}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in list(os.environ):
        if k.startswith(("NDS_BENCH_", "NDS_TPU_", "NDS_CAMPAIGN")):
            monkeypatch.delenv(k, raising=False)
    F.reset_fault_counts()
    F.drain_fault_events()
    yield
    F.reset_fault_counts()
    F.drain_fault_events()


def _times(ms, n, start=0):
    return {f"query{i}": float(ms) for i in range(start, start + n)}


def _base(path, times, stamp=CARD, scale="1"):
    with open(path, "w") as f:
        json.dump({"times": times, "scale": scale, **stamp}, f)
    return str(path)


# ---------------------------------------------------------------------------
# configuration and the port's own baseline
# ---------------------------------------------------------------------------


def test_config_from_args_and_child_args(tmp_path, monkeypatch):
    monkeypatch.setenv("NDS_BENCH_SCALE", "10")
    monkeypatch.setenv("NDS_BENCH_QUERY_TIMEOUT_S", "33")
    monkeypatch.setenv("NDS_BENCH_RESULTS_JSONL", str(tmp_path / "l.jsonl"))
    monkeypatch.chdir(tmp_path)
    ap = ["--cache-root", "cache", "--raw-dir", "raw", "--device", "cpu",
          "--sub_queries", "query3,query7"]
    seen = {}
    monkeypatch.setattr(bench, "run_parent",
                        lambda cfg, t: seen.update(cfg=cfg))
    bench.main(ap)
    cfg = seen["cfg"]
    assert cfg.scale == "10" and cfg.query_timeout_s == 33.0
    assert cfg.cache_root == str(tmp_path / "cache")
    assert cfg.raw_dir == str(tmp_path / "raw")
    assert cfg.sub_queries == ["query3", "query7"]
    assert cfg.ledger == str(tmp_path / "l.jsonl")
    # the child rebuilds the same config from its arguments
    monkeypatch.setattr(bench, "run_server",
                        lambda c: seen.update(child=c))
    bench.main(["--serve"] + cfg.child_args())
    assert seen["child"] == cfg
    # the table never goes to the repository root
    assert cfg.perf_dir == str(tmp_path / "cache" / "bench_sf10_torch")


def test_card_stamp_on_the_host():
    assert bench.card_stamp("cpu") == {"card": "cpu", "powerLimit": None}


@pytest.mark.parametrize("stamp,scale,found", [
    (CARD, "1", True),
    ({"card": "NVIDIA A100-SXM4-80GB", "powerLimit": "400.00 W"}, "1",
     False),
    ({"card": CARD["card"], "powerLimit": "500.00 W"}, "1", False),
    (CARD, "10", False),
])
def test_baseline_of_another_card_or_scale_counts_as_missing(
        tmp_path, stamp, scale, found):
    f = _base(tmp_path / "b.json", {"query1": 100.0}, stamp, scale)
    got = bench.read_baseline(f, CARD, "1")
    assert (got is not None) == found
    budgets = bench.derive_budgets(["query1", "query2"], got, cap_s=420.0,
                                   headroom=2.0, floor_s=5.0)
    assert budgets == ({"query1": 5.0, "query2": 420.0} if found
                       else {"query1": 420.0, "query2": 420.0})


def test_budgets_without_a_baseline_keep_the_cap(tmp_path):
    assert bench.read_baseline(None, CARD, "1") is None
    assert bench.read_baseline(str(tmp_path / "none.json"), CARD, "1") \
        is None
    (tmp_path / "junk.json").write_text("{not json")
    assert bench.read_baseline(str(tmp_path / "junk.json"), CARD, "1") \
        is None
    assert bench.derive_budgets(["q1"], None, cap_s=420.0) == {"q1": 420.0}


def test_derived_budgets_clamp_to_floor_and_cap(tmp_path, monkeypatch):
    base = {"times": {"a": 100.0, "b": 10_000.0, "c": 100_000.0}}
    monkeypatch.setenv("NDS_BENCH_BUDGET_HEADROOM", "10")
    monkeypatch.setenv("NDS_BENCH_BUDGET_FLOOR_S", "30")
    assert bench.derive_budgets(["a", "b", "c", "d"], base, cap_s=400.0) \
        == {"a": 30.0, "b": 100.0, "c": 400.0, "d": 400.0}


def test_order_by_history():
    base = {"times": {"b": 5.0, "a": 50.0}}
    assert bench.order_by_history(["a", "c", "b"], base) == ["b", "a", "c"]
    assert bench.order_by_history(["a", "c"], None) == ["a", "c"]


def test_resolve_baseline_refuses_missing_and_foreign(tmp_path,
                                                     monkeypatch):
    missing = tmp_path / "base.json"
    assert bench.resolve_baseline(str(missing), _times(100, 3), CARD,
                                  "1") == 0.0
    assert not missing.exists()
    assert bench.resolve_baseline(None, _times(100, 3), CARD, "1") == 0.0
    foreign = _base(tmp_path / "a100.json", _times(50, 3),
                    {"card": "other", "powerLimit": "1 W"})
    before = open(foreign).read()
    monkeypatch.setenv("NDS_BENCH_SEED_BASELINE", "1")
    assert bench.resolve_baseline(foreign, _times(100, 3), CARD, "1") == 0.0
    assert open(foreign).read() == before       # another card's lineage


def test_resolve_baseline_seeds_then_compares(tmp_path, monkeypatch):
    f = tmp_path / "base.json"
    monkeypatch.setenv("NDS_BENCH_SEED_BASELINE", "1")
    assert bench.resolve_baseline(str(f), _times(100, 3), CARD, "1") == 1.0
    doc = json.load(open(f))
    assert (doc["card"], doc["powerLimit"], doc["scale"]) == \
        (CARD["card"], CARD["powerLimit"], "1")
    monkeypatch.delenv("NDS_BENCH_SEED_BASELINE")
    vs = bench.resolve_baseline(str(f), _times(50, 4), CARD, "1")
    assert abs(vs - 2.0) < 1e-9
    base = json.load(open(f))["times"]
    assert base["query0"] == 100.0 and base["query3"] == 50.0


# ---------------------------------------------------------------------------
# the parent loop, with stub children
# ---------------------------------------------------------------------------


def _cfg(tmp_path, **kw):
    return bench.Config(scale="1", cache_root=str(tmp_path / "cache"),
                        device="cpu", heartbeat_s=0.0, **kw)


def _patch(monkeypatch, names, child_cls, signals=None):
    monkeypatch.setattr(bench, "ensure_data", lambda cfg: None)
    monkeypatch.setattr(bench, "bench_queries",
                        lambda cfg: [(n, f"select {i}")
                                     for i, n in enumerate(names)])
    monkeypatch.setattr(bench, "ChildServer", child_cls)
    monkeypatch.setattr(bench, "card_stamp", lambda device: dict(CARD))
    if signals is not None:
        monkeypatch.setattr(bench.signal, "signal",
                            lambda signum, fn: signals.setdefault(signum,
                                                                  fn))

        def fake_exit(code):
            raise SystemExit(code)
        monkeypatch.setattr(bench.os, "_exit", fake_exit)


class _Child:
    """A stub serving child: ``plan`` maps a statement to a result dict,
    None (hung or crashed) or a callable run in its place."""

    plan: dict = {}

    def __init__(self, cfg):
        self.proc = None
        self.started = False
        self.asked = []

    def alive(self):
        return self.started

    def start(self, deadline_left):
        self.started = True
        return {"ready": True, "platform": "torch-cuda",
                "device": CARD["card"]}

    def run_query(self, name, timeout):
        self.asked.append((name, timeout))
        got = self.plan.get(name, "ok")
        if callable(got):
            return got()
        if got == "ok":
            return {"name": name, "ms": 100.0, "passMs": [100.0, 101.0],
                    "hostSyncs": 1, "syncWaitMs": 1.0}
        return got

    def stop(self):
        self.started = False


def test_hung_child_costs_its_budget_not_the_run(tmp_path, monkeypatch,
                                                 capsys):
    led_path = tmp_path / "run.jsonl"
    monkeypatch.setenv("NDS_BENCH_BUDGET_FLOOR_S", "5")
    monkeypatch.setenv("NDS_BENCH_BUDGET_HEADROOM", "2")
    children = []

    class Hanging(_Child):
        plan = {"query2": None}

        def __init__(self, cfg):
            super().__init__(cfg)
            children.append(self)

    _patch(monkeypatch, ["query1", "query2", "query3"], Hanging)
    base = _base(tmp_path / "b.json",
                 {"query1": 100.0, "query2": 1000.0, "query3": 100.0})
    cfg = _cfg(tmp_path, baseline=base, ledger=str(led_path))
    bench.run_parent(cfg, time.perf_counter())
    out = capsys.readouterr()
    msg = json.loads(out.out.strip().splitlines()[-1])
    assert msg["metric"] == "power_geomean_ms" and msg["n_queries"] == 2
    assert msg["value"] == pytest.approx(100.0) and "aborted" not in msg
    asked = dict(children[0].asked)
    assert asked["query2"] == pytest.approx(5.0)   # 1 s x 2, floored at 5
    assert "timeout after 5s (budget)" in out.err
    data = L.load_ledger(str(led_path))
    assert [r["status"] for r in data.attempts if r["name"] == "query2"] \
        == ["timeout", "timeout"]
    assert data.queries["query2"]["limiter"] == "budget"
    assert data.times() == {"query1": 100.0, "query3": 100.0}
    assert data.end["status"] == "completed" and data.end["queries"] == 2
    assert data.meta["platform"] == "torch-cuda"
    assert data.meta["card"] == CARD["card"]
    assert data.meta["powerLimit"] == CARD["powerLimit"]
    assert data.meta["deviceName"] == CARD["card"]
    assert data.queries["query1"]["passMs"] == [100.0, 101.0]
    table = open(os.path.join(cfg.perf_dir, "perf_table.md")).read()
    assert "query1" in table and "100.0/101.0" in table
    assert not os.path.exists(os.path.join(REPO, "perf_table.md"))
    # the rolling rollup after every statement, schema-versioned
    assert [m["scope"] for m in data.metrics] == ["query"] * 2 + ["stream"]
    assert all(m["metricsV"] == L.METRICS_VERSION for m in data.metrics)


def test_setup_circuit_breaker(tmp_path, monkeypatch, capsys):
    starts = []

    class Dead(_Child):
        def alive(self):
            return False

        def start(self, deadline_left):
            starts.append(deadline_left)
            return None

    _patch(monkeypatch, ["query1"], Dead)
    with pytest.raises(SystemExit):
        bench.run_parent(_cfg(tmp_path), time.perf_counter())
    assert len(starts) == 2
    out = capsys.readouterr()
    msg = json.loads(out.out.strip().splitlines()[-1])
    assert msg["n_queries"] == 0 and msg["value"] is None
    assert msg["aborted"] == "child-setup-failure"


def test_sigterm_prints_the_partial_line_and_the_ledger_resumes(
        tmp_path, monkeypatch, capsys):
    """A kill while query2 runs: the final line and the ledger's
    ``aborted`` record cover query1. The next run on the same ledger
    measures only what is missing."""
    led_path = str(tmp_path / "run.jsonl")
    handlers = {}

    class Killed(_Child):
        plan = {"query2": lambda: handlers[bench.signal.SIGTERM](
            bench.signal.SIGTERM, None)}

    _patch(monkeypatch, ["query1", "query2"], Killed, signals=handlers)
    with pytest.raises(SystemExit):
        bench.run_parent(_cfg(tmp_path, ledger=led_path),
                         time.perf_counter())
    msg = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert msg["n_queries"] == 1 and msg["value"] == pytest.approx(100.0)
    data = L.load_ledger(led_path)
    assert data.times() == {"query1": 100.0}
    assert data.end["status"] == "aborted" and data.end["reason"] == "signal"

    children = []

    class Resumed(_Child):
        def __init__(self, cfg):
            super().__init__(cfg)
            children.append(self)

    handlers.clear()
    _patch(monkeypatch, ["query1", "query2"], Resumed, signals=handlers)
    bench.run_parent(_cfg(tmp_path, ledger=led_path), time.perf_counter())
    out = capsys.readouterr()
    assert [n for n, _t in children[0].asked] == ["query2"]
    assert "resume: 1 statements pre-loaded" in out.err
    msg = json.loads(out.out.strip().splitlines()[-1])
    assert msg["n_queries"] == 2
    data = L.load_ledger(led_path)
    assert data.complete() and data.end["status"] == "completed"
    assert set(data.times()) == {"query1", "query2"}


def test_resume_refuses_a_ledger_of_other_knobs(tmp_path, monkeypatch):
    led_path = str(tmp_path / "run.jsonl")
    _patch(monkeypatch, ["query1"], _Child)
    bench.run_parent(_cfg(tmp_path, ledger=led_path), time.perf_counter())
    monkeypatch.setenv("NDS_BENCH_SCALE", "10")
    from nds_tpu_torch.obs.campaign import CampaignResumeError
    with pytest.raises(CampaignResumeError):
        bench.run_parent(_cfg(tmp_path, ledger=led_path),
                         time.perf_counter())


def test_round_budget_exhaustion_labeled_truthfully(tmp_path, monkeypatch,
                                                    capsys):
    led_path = str(tmp_path / "run.jsonl")

    class Hung(_Child):
        plan = {"query1": None}

    _patch(monkeypatch, ["query1"], Hung)
    with pytest.raises(SystemExit):          # nothing measured: exit 1
        bench.run_parent(_cfg(tmp_path, ledger=led_path, budget_s=28.0),
                         time.perf_counter())
    err = capsys.readouterr().err
    assert "(round-budget)" in err and "(budget)" not in err
    data = L.load_ledger(led_path)
    assert data.queries["query1"]["status"] == "timeout"
    assert data.queries["query1"]["limiter"] == "round-budget"


def test_child_error_and_watchdog_timeout_statuses(tmp_path, monkeypatch,
                                                   capsys):
    led_path = str(tmp_path / "run.jsonl")

    class Failing(_Child):
        plan = {"query1": {"name": "query1", "error": "ExecError: boom"},
                "query2": {"name": "query2", "error": "StatementTimeout",
                           "timeout": True,
                           "faultEvents": [{"seam": "sync",
                                            "action": "timeout"}]}}

    _patch(monkeypatch, ["query1", "query2", "query3"], Failing)
    bench.run_parent(_cfg(tmp_path, ledger=led_path), time.perf_counter())
    capsys.readouterr()
    data = L.load_ledger(led_path)
    assert data.queries["query1"]["status"] == "error"
    assert data.queries["query2"]["status"] == "timeout"
    assert data.queries["query2"]["faultEvents"][0]["action"] == "timeout"
    roll = [m for m in data.metrics if m["scope"] == "stream"][-1]
    assert roll["errorCount"] == 1 and roll["timeoutShed"] == 1


def test_restart_backoff_deterministic_and_jittered(monkeypatch):
    assert bench.restart_backoff_s(1) == 0.0
    seq = [bench.restart_backoff_s(n) for n in range(2, 8)]
    assert seq == [bench.restart_backoff_s(n) for n in range(2, 8)]
    assert all(b > 0 for b in seq) and max(seq) <= 30.0
    assert len(set(round(b / (2 ** min(n - 2, 4)), 6)
                   for n, b in zip(range(2, 8), seq))) > 1   # jittered
    monkeypatch.setenv("NDS_BENCH_RESTART_BACKOFF_S", "0")
    assert bench.restart_backoff_s(5) == 0.0


def test_bench_child_fault_takes_the_restart_path(tmp_path, monkeypatch):
    monkeypatch.setenv("NDS_TPU_FAULT", "bench-child:error:1")
    child = bench.ChildServer(_cfg(tmp_path))
    assert child.start(10.0) is None and child.proc is None
    led = L.Ledger(str(tmp_path / "p.jsonl"), driver="bench")
    (ev,) = bench.drain_parent_faults(led)
    led.close("completed")
    assert (ev.seam, ev.action) == ("bench-child", "degrade")
    notes = [json.loads(ln) for ln in open(tmp_path / "p.jsonl")
             if '"progress"' in ln]
    assert notes[0]["note"] == "fault-event"
    assert notes[0]["seam"] == "bench-child"


def test_error_result_drains_this_statements_faults():
    F.record_fault_event("sync", "timeout", detail="blocked")
    out = bench.error_result("query9", F.StatementTimeout("sync", "late"))
    assert out["timeout"] is True and out["name"] == "query9"
    assert out["faultEvents"] == [{"seam": "sync", "action": "timeout",
                                   "detail": "blocked"}]
    assert not F.drain_fault_events()
    assert "timeout" not in bench.error_result("q", ValueError("x"))


# ---------------------------------------------------------------------------
# bench_compare
# ---------------------------------------------------------------------------


def _round(path, times, syncs=None, eager=0):
    led = L.Ledger(str(path), driver="bench", platform="torch-cuda",
                   scale="1", **CARD)
    for q, ms in times.items():
        led.query(q, status="ok", ms=ms, passMs=[ms, ms],
                  hostSyncs=(syncs or {}).get(q, 2), syncWaitMs=1.0,
                  scanBytes=1000000, scanGBps=0.5, warmS=1.0, compileS=0.5,
                  streamedScans=[{"table": "store_sales", "chunks": 10,
                                  "syncs": (syncs or {}).get(q, 2),
                                  "path": "compiled", "bytesH2d": 5000}]
                  + [{"table": "item", "chunks": 2, "syncs": 9,
                      "path": "eager", "reason": "r"}] * eager)
    led.close("completed", queries=len(times))
    return str(path)


def test_gate_passes_identical_rounds(tmp_path, capsys):
    a = _round(tmp_path / "a.jsonl", {"q1": 100.0, "q2": 200.0})
    assert BC.main([a, a, "--gate"]) == 0
    out = capsys.readouterr().out
    assert "no regressions" in out and "ratio 1.0000" in out


def test_gate_fails_under_inject_drift(tmp_path, capsys):
    a = _round(tmp_path / "a.jsonl", {"q1": 100.0, "q2": 200.0})
    assert BC.main([a, a, "--gate", "--inject-drift"]) == 0
    assert "drift fixture correctly rejected" in capsys.readouterr().out


def test_gate_fails_on_wall_regression(tmp_path, capsys):
    a = _round(tmp_path / "a.jsonl", {"q1": 100.0, "q2": 200.0})
    b = _round(tmp_path / "b.jsonl", {"q1": 400.0, "q2": 800.0})
    assert BC.main([a, b, "--gate"]) == 1
    assert "geomean regressed" in capsys.readouterr().out
    assert BC.main([a, b]) == 0              # report only without --gate
    b2 = _round(tmp_path / "b2.jsonl", {"q1": 160.0, "q2": 200.0})
    assert BC.main([a, b2, "--gate", "--threshold", "1.5",
                    "--per-query-threshold", "1.5"]) == 1
    assert "q1: wall 100 -> 160 ms" in capsys.readouterr().out


def test_gate_fails_on_evidence_regression(tmp_path, capsys):
    a = _round(tmp_path / "a.jsonl", {"q1": 100.0})
    b = _round(tmp_path / "b.jsonl", {"q1": 100.0}, syncs={"q1": 4},
               eager=1)
    assert BC.main([a, b, "--gate"]) == 1
    out = capsys.readouterr().out
    assert "host syncs 2 -> 4" in out and "eager fallbacks 0 -> 1" in out


def test_gate_fails_when_a_statement_stops_completing(tmp_path, capsys):
    a = _round(tmp_path / "a.jsonl", {"q1": 100.0, "q2": 200.0})
    led = L.Ledger(str(tmp_path / "b.jsonl"), driver="bench")
    led.query("q1", status="ok", ms=100.0, hostSyncs=2)
    led.query("q2", status="error", error="ExecError: boom")
    led.close("completed", queries=1)
    assert BC.main([a, str(tmp_path / "b.jsonl"), "--gate"]) == 1
    assert "q2: ok in A, error in B" in capsys.readouterr().out


def test_gate_fails_on_a_killed_round_unless_allowed(tmp_path, capsys):
    a = _round(tmp_path / "a.jsonl", {"q1": 100.0})
    led = L.Ledger(str(tmp_path / "b.jsonl"), driver="bench")
    led.query("q1", status="ok", ms=100.0, hostSyncs=2)
    led.close(None)
    b = str(tmp_path / "b.jsonl")
    assert BC.main([a, b, "--gate"]) == 1
    assert "no terminal record" in capsys.readouterr().out
    assert BC.main([a, b, "--gate", "--allow-missing"]) == 0


def test_gate_refuses_disjoint_rounds(tmp_path, capsys):
    a = _round(tmp_path / "a.jsonl", {"q1": 100.0})
    b = _round(tmp_path / "b.jsonl", {"q9": 100.0})
    assert BC.main([a, b, "--gate"]) == 1
    assert "nothing was compared" in capsys.readouterr().out


def test_compare_accepts_the_baseline_file(tmp_path):
    a = _round(tmp_path / "a.jsonl", {"q1": 100.0, "q2": 200.0})
    bj = _base(tmp_path / "base.json", {"q1": 50.0, "q2": 100.0})
    cmp = BC.compare(BC.load_round(bj), BC.load_round(a))
    assert cmp["common"] == ["q1", "q2"]
    assert abs(cmp["geomean_ratio"] - 2.0) < 1e-9


def test_emit_perf_deterministic_from_the_ledger(tmp_path, capsys):
    a = _round(tmp_path / "a.jsonl", {"q1": 100.0, "q2": 200.0})
    p1, p2 = tmp_path / "T1.md", tmp_path / "T2.md"
    assert BC.main([a, "--emit-perf", str(p1)]) == 0
    assert BC.main([a, "--emit-perf", str(p2)]) == 0
    t1 = p1.read_text()
    assert t1 == p2.read_text()
    assert "platform: torch-cuda" in t1 and CARD["card"] in t1
    assert "Scale factor 1;" in t1 and "| q1 | 100.0 | 100.0/100.0 |" in t1


def test_cross_arm_table_and_two_round_gate(tmp_path, capsys):
    a = _round(tmp_path / "a.jsonl", {"q1": 100.0})
    b = _round(tmp_path / "b.jsonl", {"q1": 120.0})
    c = _round(tmp_path / "c.jsonl", {"q1": 80.0})
    assert BC.main([a, b, c]) == 0
    out = capsys.readouterr().out
    assert "cross-arm: 3 rounds" in out and "1.200" in out
    with pytest.raises(SystemExit):
        BC.main([a, b, c, "--gate"])


# ---------------------------------------------------------------------------
# the real entry on the CPU
# ---------------------------------------------------------------------------


def test_bench_entry_end_to_end_on_the_cpu(tmp_path):
    """``python -m nds_tpu_torch.bench --device cpu`` at SF0.01 (the raw
    data the port's tests share) with a cache root under ``tmp_path``:
    the final line, a ledger that loads with both timed walls per
    statement and a terminal ``completed``, and a gate of the run
    against itself that passes."""
    from tools.coverage_sweep import ensure_data
    led = tmp_path / "run.jsonl"
    env = {**os.environ, "NDS_BENCH_SCALE": "0.01",
           "NDS_BENCH_RESULTS_JSONL": str(led),
           "NDS_BENCH_HEARTBEAT_S": "0",
           "OMP_NUM_THREADS": "1"}    # spare the other test workers' cores
    res = subprocess.run(
        [sys.executable, "-m", "nds_tpu_torch.bench", "--device", "cpu",
         "--raw-dir", ensure_data(), "--cache-root", str(tmp_path / "c"),
         "--sub_queries", "query3,query96"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    msg = json.loads(res.stdout.strip().splitlines()[-1])
    assert msg["metric"] == "power_geomean_ms" and msg["n_queries"] == 2
    data = L.load_ledger(str(led))
    assert data.complete() and data.end["status"] == "completed"
    assert data.meta["platform"] == "torch-cpu"
    for rec in data.queries.values():
        assert rec["status"] == "ok" and len(rec["passMs"]) == 2
        assert rec["ms"] == min(rec["passMs"])
        assert set(rec["kernelLaunches"]) == {
            "segment_sum_i64", "segment_sum_f64", "segment_minmax_f64",
            "chunk_scan", "join_probe"}
    assert os.path.exists(tmp_path / "c" / "sf0.01_torch_parquet" /
                          ".complete")
    assert BC.main([str(led), str(led), "--gate"]) == 0
