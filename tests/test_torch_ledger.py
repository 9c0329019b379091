# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The port's evidence path: the ledger (``nds_tpu_torch/obs/ledger.py``),
the live-metrics registry (``obs/metrics.py``) and the campaign stamp and
arm model (``obs/campaign.py``), mirroring the reference's
``test_ledger.py``, ``test_metrics.py`` and ``test_campaign.py``; the
ledgers of both packages read each other's records; loading the port's
evidence modules brings in neither torch nor anything of the reference;
and the differential: the same statements through
``python -m nds_tpu_torch.power --ledger`` and ``nds_power.py --ledger``
(the reference on the CPU, ``NDS_TPU_PALLAS=off``) give ledgers that agree
record for record."""

import io
import itertools
import json
import os
import subprocess
import sys
import threading
import types

import pytest

from nds_tpu_torch.engine import faults as F
from nds_tpu_torch.obs import campaign as C
from nds_tpu_torch.obs import ledger as L
from nds_tpu_torch.obs import metrics as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for k in C.FINGERPRINT_KNOBS + ("NDS_CAMPAIGN_ARM", "NDS_FAKE_MODE",
                                    "NDS_TPU_METRICS_FILE"):
        monkeypatch.delenv(k, raising=False)
    F.reset_fault_counts()
    F.drain_fault_events()
    yield
    F.reset_fault_counts()
    F.drain_fault_events()


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------


def test_ledger_round_trip(tmp_path):
    p = tmp_path / "run.jsonl"
    led = L.Ledger(str(p), driver="bench", platform="torch-cuda", scale="1")
    led.query("query1", status="ok", ms=123.4, hostSyncs=3,
              streamedScans=[
                  {"table": "store_sales", "chunks": 10, "syncs": 2,
                   "path": "compiled", "bytesH2d": 1000, "rows": 50,
                   "partitions": 2, "partRows": [30, 20]},
                  {"table": "catalog_sales", "chunks": 4, "syncs": 9,
                   "path": "eager", "reason": "not chunk-invariant"}])
    led.query("query2", status="timeout", error="timeout after 90s",
              budgetS=90.0)
    led.query("query2", status="ok", ms=80.0)
    led.progress(query="query3", done=2, total=3)
    led.close("completed", queries=2, wallS=200.0)
    data = L.load_ledger(str(p))
    assert data.platform == "torch-cuda" and data.meta["scale"] == "1"
    assert data.complete() and data.end["queries"] == 2
    assert data.progress == 1 and not data.torn
    assert data.times() == {"query1": 123.4, "query2": 80.0}
    ev = data.queries["query1"]["evidence"]
    assert ev["scans"] == 2 and ev["compiled"] == 1 and ev["eager"] == 1
    assert ev["syncs"] == 11 and ev["bytesH2d"] == 1000
    assert ev["partitions"] == 2
    assert ev["fallbackReasons"] == ["not chunk-invariant"]
    assert [r["status"] for r in data.attempts
            if r["name"] == "query2"] == ["timeout", "ok"]


@pytest.mark.parametrize("rec,match", [
    ({"v": 99, "kind": "query", "t": 0, "name": "q", "status": "ok"},
     "version 99"),
    ({"kind": "query", "name": "q9", "ms": 5.0, "status": "ok"}, "version"),
    ({"v": 1, "kind": "query", "t": 0}, "missing required"),
    ({"v": 1, "kind": "query", "t": 0, "name": "q", "status": "exploded"},
     "status"),
    ({"v": 1, "kind": "end", "t": 0, "status": "half"}, "status"),
    ({"v": 1, "kind": "wat", "t": 0}, "unknown record kind"),
    ({"v": 1, "kind": "metrics", "t": 0, "scope": "query",
      "metricsV": 99}, "metrics record version 99"),
    ({"v": 1, "kind": "metrics", "t": 0, "scope": "query"},
     "metrics record version"),
])
def test_invalid_records_refused_wherever_they_sit(tmp_path, rec, match):
    good = json.dumps({"v": 1, "kind": "query", "t": 0, "name": "q0",
                       "status": "ok", "ms": 1.0})
    p = tmp_path / "bad.jsonl"
    p.write_text(json.dumps(rec) + "\n" + good + "\n")
    with pytest.raises(L.LedgerError, match=match):
        L.load_ledger(str(p))


def test_metrics_records_load(tmp_path):
    p = tmp_path / "m.jsonl"
    led = L.Ledger(str(p), driver="power")
    led.metrics(scope="stream", qps=2.5)
    led.close("completed")
    data = L.load_ledger(str(p))
    assert len(data.metrics) == 1 and data.metrics[0]["qps"] == 2.5
    assert data.metrics[0]["metricsV"] == M.METRICS_VERSION


def test_torn_final_line_absorbed(tmp_path):
    p = tmp_path / "killed.jsonl"
    good = json.dumps({"v": 1, "kind": "query", "t": 1.0,
                       "name": "query1", "status": "ok", "ms": 50.0})
    p.write_text(good + "\n" + '{"v": 1, "kind": "query", "name": "q2", "st')
    data = L.load_ledger(str(p))
    assert data.torn and data.times() == {"query1": 50.0}
    assert data.end is None


def test_reopen_seals_a_torn_tail(tmp_path):
    p = tmp_path / "killed.jsonl"
    good = json.dumps({"v": 1, "kind": "query", "t": 1.0,
                       "name": "query1", "status": "ok", "ms": 50.0})
    p.write_text(good + "\n" + '{"v": 1, "kind": "query", "na')
    led = L.Ledger(str(p), driver="bench")
    led.query("query2", status="ok", ms=60.0)
    led.close("completed", queries=2)
    data = L.load_ledger(str(p))
    assert data.times() == {"query1": 50.0, "query2": 60.0}
    assert data.complete() and not data.torn


def test_legacy_resume_lines_normalized(tmp_path):
    p = tmp_path / "legacy.jsonl"
    p.write_text("\n".join([
        json.dumps({"name": "query3", "ms": 1234.5, "hostSyncs": 2}),
        "stray non-json chatter",
        json.dumps({"name": "query9", "error": "boom"}),
        json.dumps({"platform": "torch-cuda"})]) + "\n")
    data = L.load_ledger(str(p))
    assert data.times() == {"query3": 1234.5}
    assert data.queries["query9"]["status"] == "error"
    assert data.platform == "torch-cuda"


def test_stale_end_record_cleared_by_resumed_activity(tmp_path):
    p = tmp_path / "resumed.jsonl"
    led = L.Ledger(str(p), driver="bench")
    led.query("q1", status="ok", ms=1.0)
    led.close("completed", queries=1)
    led2 = L.Ledger(str(p), driver="bench")
    led2.query("q2", status="ok", ms=2.0)
    led2.close(None)                      # killed: no end record
    data = L.load_ledger(str(p))
    assert not data.complete() and data.times() == {"q1": 1.0, "q2": 2.0}
    assert sum(1 for ln in open(p) if '"meta"' in ln) == 1
    L.Ledger(str(p), driver="bench").close("completed", queries=2)
    assert L.load_ledger(str(p)).complete()


def test_write_validates_before_touching_disk(tmp_path):
    led = L.Ledger(str(tmp_path / "v.jsonl"), driver="bench")
    with pytest.raises(L.LedgerError):
        led.query("q", status="not-a-status")
    led.close("completed")
    assert L.load_ledger(str(tmp_path / "v.jsonl")).queries == {}


@pytest.mark.parametrize("nth,lost", [(1, 0), ("persistent", 1)])
def test_ledger_write_seam_retries_then_degrades(tmp_path, monkeypatch,
                                                 nth, lost):
    """One injected write fault recovers on the retry; a write that
    keeps failing is dropped, counted, and the run continues."""
    p = tmp_path / "w.jsonl"
    led = L.Ledger(str(p), driver="bench")
    if nth == "persistent":
        def always(seam, detail=""):
            if seam == "ledger-write":
                raise F.FaultInjected(seam, "disk full")
        monkeypatch.setattr(F, "fault_point", always)
    else:
        monkeypatch.setenv("NDS_TPU_FAULT", f"ledger-write:error:{nth}")
    led.query("q1", status="ok", ms=1.0)
    monkeypatch.undo()
    led.query("q2", status="ok", ms=2.0)
    led.close("completed")
    assert led.write_failures == lost
    data = L.load_ledger(str(p))
    assert set(data.times()) == ({"q2"} if lost else {"q1", "q2"})
    actions = [e.action for e in F.drain_fault_events()]
    assert actions == (["degrade"] if lost else ["recovered"])


def test_stream_evidence_matches_json_derivation():
    from nds_tpu_torch.listener import (StreamEvent, stream_event_json,
                                        stream_evidence)
    events = [StreamEvent("store_sales", 10, 2, "compiled", rows=50,
                          partitions=2, part_rows=(30, 20),
                          bytes_h2d=1000, scan_launches=10),
              StreamEvent("item", 4, 9, "eager",
                          reason="not chunk-invariant")]
    ev = stream_evidence(events)
    assert ev == L.evidence_from_scans(
        [stream_event_json(e) for e in events])
    assert ev["compiled"] == 1 and ev["eager"] == 1 and ev["syncs"] == 11


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_ledger(tmp_path, writer):
    """The record schema is the reference's: a ledger written by either
    package loads through the other's reader to the same times, statuses
    and evidence."""
    from nds_tpu.obs import ledger as RL
    w, r = (L, RL) if writer == "port" else (RL, L)
    p = tmp_path / "x.jsonl"
    led = w.Ledger(str(p), driver="bench", platform="p", scale="1",
                   stamp={"envFingerprint": "fp"})
    led.query("q1", ms=5.0, hostSyncs=2,
              streamedScans=[{"table": "t", "chunks": 3, "syncs": 1,
                              "path": "compiled"}])
    led.query("q2", status="error", error="boom")
    led.metrics(scope="stream", qps=1.0)
    led.close("completed", queries=1)
    a, b = w.load_ledger(str(p)), r.load_ledger(str(p))
    assert a.times() == b.times() == {"q1": 5.0}
    assert {n: x["status"] for n, x in a.queries.items()} == \
        {n: x["status"] for n, x in b.queries.items()}
    assert a.queries["q1"]["evidence"] == b.queries["q1"]["evidence"]
    assert a.meta == b.meta and a.end == b.end
    assert len(a.metrics) == len(b.metrics) == 1


def test_metrics_versions_pinned():
    from nds_tpu.obs import ledger as RL
    from nds_tpu.obs import metrics as RM
    assert L.METRICS_VERSION == M.METRICS_VERSION == RM.METRICS_VERSION
    assert L.LEDGER_VERSION == RL.LEDGER_VERSION
    assert M.EDGES == RM.EDGES


# ---------------------------------------------------------------------------
# the heartbeat
# ---------------------------------------------------------------------------


def test_heartbeat_writes_progress_and_stderr(tmp_path):
    p = tmp_path / "hb.jsonl"
    led = L.Ledger(str(p), driver="bench")
    out = io.StringIO()
    hb = L.Heartbeat(0.05, ledger=led,
                     status=lambda: {"query": "query7", "done": 3}, out=out)
    with hb:
        import time
        deadline = time.time() + 5.0
        while hb.beats < 2 and time.time() < deadline:
            time.sleep(0.01)
    led.close(None)
    assert hb.beats >= 2
    assert L.load_ledger(str(p)).progress >= 2
    assert "heartbeat" in out.getvalue() and "query=query7" in out.getvalue()
    beats = [json.loads(ln) for ln in open(p) if '"progress"' in ln]
    assert beats[0]["query"] == "query7" and "elapsedS" in beats[0]


def test_heartbeat_survives_status_exception():
    hb = L.Heartbeat(0.05, status=lambda: 1 / 0, out=None)
    assert hb.beat()["beat"] == 1


def test_heartbeat_carries_rolling_rollup_and_live_file(tmp_path,
                                                        monkeypatch):
    reg = M.Registry(clock=lambda: 30.0)
    for w in (120.0, 80.0):
        reg.observe(M.QUERY_WALL, w)
    live = tmp_path / "live.json"
    monkeypatch.setenv("NDS_TPU_METRICS_FILE", str(live))
    led = L.Ledger(str(tmp_path / "hb.jsonl"), driver="bench")
    hb = L.Heartbeat(3600.0, ledger=led,
                     status=lambda: {"done": 2, **reg.heartbeat_rollup()},
                     out=None)
    fields = hb.beat()
    led.close("completed")
    assert fields["qpm"] == 2.0 and "ewmaWallMs" in fields
    with open(live) as f:
        doc = json.load(f)
    assert doc["metricsV"] == M.METRICS_VERSION and doc["done"] == 2


# ---------------------------------------------------------------------------
# live metrics
# ---------------------------------------------------------------------------


def _fed(values, clock=lambda: 50.0, **kw):
    r = M.Registry(clock=clock, **kw)
    for v in values:
        r.observe("x", v)
    return r


def test_bucket_index_edges_and_clamps():
    for i in (0, 1, 7, 8, 35, 70, 71):
        assert M.bucket_index(M.EDGES[i]) == i
    assert M.bucket_index(M.EDGES[10] * 1.0001) == 11
    for v in (0.0, -5.0, float("nan")):
        assert M.bucket_index(v) == 0
    assert M.bucket_index(M.EDGES[-1] * 100) == len(M.EDGES) - 1
    idxs = [M.bucket_index(10.0 ** (e / 10) / 10) for e in range(0, 80)]
    assert idxs == sorted(idxs)


def test_quantiles_empty_and_single_sample():
    assert M.quantile_from_buckets({}, 0.5) is None
    snap = _fed([42.0]).snapshot()["hists"]["x"]
    want = round(M.bucket_value(M.bucket_index(42.0)), 6)
    for key in ("p50", "p95", "p99"):
        assert snap[key] == want and snap["rolling"][key] == want


def test_window_rotation_across_time_boundary():
    now = {"t": 0.0}
    r = M.Registry(window_s=60.0, slots=6, clock=lambda: now["t"])
    r.observe("x", 10.0)
    now["t"] = 30.0
    r.observe("x", 1000.0)
    assert r.snapshot()["hists"]["x"]["rolling"]["count"] == 2
    now["t"] = 65.0                      # the first sample's slot is stale
    roll = r.snapshot()["hists"]["x"]["rolling"]
    assert roll["count"] == 1 and roll["sum"] == 1000.0
    assert r.snapshot()["hists"]["x"]["count"] == 2      # cumulative


def test_merge_associative_and_order_independent():
    parts = [_fed([1.0, 5.0, 30.0]), _fed([200.0]), _fed([7.0, 7.0])]
    snaps = [p.snapshot()["hists"]["x"] for p in parts]
    outs = [M.merge_hist_snapshots(list(order))
            for order in itertools.permutations(snaps)]
    key = lambda m: {k: m[k] for k in ("count", "buckets", "p50", "p95",  # noqa: E731
                                       "p99", "min", "max")}
    assert all(key(o) == key(outs[0]) for o in outs)
    whole = _fed([1.0, 5.0, 30.0, 200.0, 7.0, 7.0]).snapshot()["hists"]["x"]
    assert key(outs[0]) == key(whole)


def test_quantiles_deterministic_under_contention():
    """Eight threads feed one registry with a short switch interval: no
    update is lost, and the quantiles equal a single thread's."""
    r = M.Registry(clock=lambda: 10.0)
    vals = [float(v) for v in range(1, 401)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda k=k: [
            r.observe("x", v) for v in vals[k::8]]) for k in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    got = r.snapshot()["hists"]["x"]
    want = _fed(vals, clock=lambda: 10.0).snapshot()["hists"]["x"]
    assert got["count"] == 400
    assert [got[k] for k in ("p50", "p95", "p99")] == \
        [want[k] for k in ("p50", "p95", "p99")]


def test_export_live_atomic_and_env_gated(tmp_path, monkeypatch):
    r = _fed([10.0, 20.0])
    assert M.export_live(registry=r) is None
    target = tmp_path / "arm" / "m-{pid}.json"
    monkeypatch.setenv("NDS_TPU_METRICS_FILE", str(target))
    p = M.export_live(registry=r, extra={"done": 1, "total": 3})
    assert p == str(target).replace("{pid}", str(os.getpid()))
    with open(p) as f:
        doc = json.load(f)
    assert doc["done"] == 1 and doc["hists"]["x"]["count"] == 2
    M.export_live(registry=r)
    assert not [fn for fn in os.listdir(tmp_path / "arm") if ".tmp." in fn]


def test_rollups_feed_the_driver_records():
    r = M.Registry(clock=lambda: 5.0)
    for status, ms in (("ok", 100.0), ("ok", 300.0), ("timeout", 50.0)):
        r.inc("queries.total")
        r.inc(f"queries.{status}")
        r.observe(M.QUERY_WALL, ms)
    r.inc(M.PIPE_HIT, 2)
    q = r.query_rollup()
    assert q["queries"] == 3 and q["okCount"] == 2 and q["timeoutCount"] == 1
    assert q["pipeHit"] == 2 and q["qpm"] > 0
    s = r.stream_rollup(10.0)
    assert s["timeoutShed"] == 1 and s["qps"] == 0.3 and s["wallMeanMs"] == 150


# ---------------------------------------------------------------------------
# campaign stamp and arm model
# ---------------------------------------------------------------------------


def test_fingerprint_and_stamp():
    a = C.env_fingerprint({})
    b = C.env_fingerprint({"NDS_BENCH_SCALE": "1"})
    assert a != b and "<unset>" in a and "NDS_BENCH_SCALE=1" in b
    assert "arm" not in C.campaign_stamp({})
    st = C.campaign_stamp({"NDS_CAMPAIGN_ARM": "base"})
    assert st["arm"] == "base" and st["envFingerprint"] == a
    assert C.default_bench_cmd()[1:] == ["-m", "nds_tpu_torch.bench"]


# each knob added since the campaign model came, and the value an arm
# differing only in it sets
_ADDED_KNOBS = [("NDS_TPU_CHUNK_STORE", "{dir}/store"),
                ("NDS_TPU_REPLAY", "off"),
                ("NDS_TPU_REPLAY_SYNC_THR", "0"),
                ("NDS_TPU_CONCURRENT_QUERIES", "2"),
                ("NDS_TPU_PREFETCH_DEPTH", "0"),
                ("NDS_TPU_STREAM_SHARDS", "2"),
                ("NDS_TPU_ENCODED", "0")]


@pytest.mark.parametrize("knob,value", _ADDED_KNOBS)
def test_arm_differing_in_one_knob_refuses_resume(tmp_path, knob, value):
    """An arm that differs from the arm whose ledger it would resume in
    one knob alone raises CampaignResumeError naming that knob."""
    d = str(tmp_path)
    (base, other), = [C.expand_arms({"arms": [
        {"name": "a1"}, {"name": "a2", "env": {knob: value}}]}, d)]
    assert base.env == {} and other.env == {knob: value.replace("{dir}", d)}
    path = C.arm_paths(d, base.name)["ledger"]
    led = L.Ledger(path, stamp=C.campaign_stamp(C.arm_env(base, {})),
                   driver="bench")
    led.query("query1", ms=10.0)
    led.close(None)
    assert C.arm_status(base, d, {})[0] == "partial"
    with pytest.raises(C.CampaignResumeError) as info:
        C.arm_status(C.Arm(base.name, other.env), d, {})
    assert f"{knob}=<unset>" in str(info.value)
    assert f"{knob}={other.env[knob]}" in str(info.value)


def test_resume_fingerprint_refusal_names_both():
    C.check_resume_fingerprint(None, "x")           # legacy: resumes
    C.check_resume_fingerprint("x", "x")
    with pytest.raises(C.CampaignResumeError) as info:
        C.check_resume_fingerprint("NDS_BENCH_SCALE=1", "NDS_BENCH_SCALE=10")
    assert "NDS_BENCH_SCALE=1" in str(info.value)
    assert "NDS_BENCH_SCALE=10" in str(info.value)


@pytest.mark.parametrize("matrix,msg", [
    ({"arms": []}, "non-empty"),
    ({"v": 99, "arms": [{"name": "a"}]}, "version"),
    ({"arms": [{"name": "a"}, {"name": "a"}]}, "duplicate"),
    ({"arms": [{"name": "../evil"}]}, "safe"),
    ({"arms": [{"env": {}}]}, "name"),
])
def test_matrix_validation_is_loud(tmp_path, matrix, msg):
    with pytest.raises(C.CampaignError, match=msg):
        C.expand_arms(matrix, str(tmp_path))


def test_manifest_round_trip_and_version_refusal(tmp_path):
    arms = C.expand_arms({"env": {"NDS_TPU_STREAM_BYTES": "{dir}/x"},
                          "arms": [{"name": "a"}, {"name": "b", "env": {
                              "NDS_TPU_STREAM_BYTES": ""}}]},
                         str(tmp_path))
    assert arms[0].env["NDS_TPU_STREAM_BYTES"] == f"{tmp_path}/x"
    assert "NDS_TPU_STREAM_BYTES=<unset>" in C.arm_fingerprint(arms[1], {})
    m = C.new_manifest(arms, str(tmp_path))
    C.write_manifest(str(tmp_path), m)
    assert C.load_manifest(str(tmp_path)) == m
    with open(C.manifest_path(str(tmp_path)), "w") as f:
        json.dump({"v": 99}, f)
    with pytest.raises(C.CampaignError, match="version"):
        C.load_manifest(str(tmp_path))


def test_arm_status_pending_partial_done_refused(tmp_path):
    arm = C.Arm("a1", {})
    d = str(tmp_path)
    assert C.arm_status(arm, d, {})[0] == "pending"
    path = C.arm_paths(d, arm.name)["ledger"]
    led = L.Ledger(path, stamp=C.campaign_stamp(C.arm_env(arm, {})),
                   driver="bench")
    led.query("query1", ms=10.0)
    led.close(None)
    assert C.arm_status(arm, d, {})[0] == "partial"
    L.Ledger(path, driver="bench").close("completed")
    assert C.arm_status(arm, d, {})[0] == "done"
    with pytest.raises(C.CampaignResumeError):
        C.arm_status(C.Arm("a1", {"NDS_BENCH_SCALE": "10"}), d, {})


_STUB = """\
import os, sys
sys.path.insert(0, {repo!r})
from nds_tpu_torch.obs import campaign as C, ledger as L
if os.environ.get("NDS_FAKE_MODE") == "fail":
    sys.exit(3)
led = L.Ledger(os.environ["NDS_BENCH_RESULTS_JSONL"],
               stamp=C.campaign_stamp(), driver="bench", scale="1")
led.query("query1", ms=100.0, hostSyncs=1)
led.close("completed", queries=1)
"""


def test_run_campaign_with_a_stub_bench(tmp_path, monkeypatch):
    monkeypatch.setattr(C, "signal", types.SimpleNamespace(
        signal=lambda *a: None, SIGTERM=15, SIGINT=2))
    stub = tmp_path / "fake_bench.py"
    stub.write_text(_STUB.format(repo=REPO))
    d = str(tmp_path / "camp")
    arms = C.expand_arms({"arms": [{"name": "a1"}, {
        "name": "bad", "env": {"NDS_FAKE_MODE": "fail"}}, {"name": "a3"}]},
        d)
    m = C.run_campaign(arms, d, bench_cmd=[sys.executable, str(stub)],
                       out=io.StringIO())
    by = {a["name"]: a for a in m["arms"]}
    assert by["a1"]["status"] == by["a3"]["status"] == "completed"
    assert by["bad"]["status"] == "failed" and by["bad"]["rc"] == 3
    assert by["bad"]["classified"]["seam"] == "bench-child"
    data = L.load_ledger(C.arm_paths(d, "a1")["ledger"])
    assert data.meta["arm"] == "a1"
    assert data.meta["envFingerprint"] == C.arm_fingerprint(arms[0])
    again = C.run_campaign(arms[:1], d, bench_cmd=[sys.executable,
                                                   str(stub)],
                           out=io.StringIO())
    assert again["arms"][0]["status"] == "done"


# ---------------------------------------------------------------------------
# the import rule at run time
# ---------------------------------------------------------------------------


def test_evidence_modules_load_nothing_of_the_reference(tmp_path):
    """In a fresh interpreter, the port's ledger, campaign, bench parent
    and bench_compare write, read, gate and beat without putting any
    ``nds_tpu`` module, any by-path ``_nds_*`` module, torch or jax into
    ``sys.modules``."""
    code = f"""
import io, json, sys
sys.path.insert(0, {REPO!r})
from nds_tpu_torch.obs import ledger as L, campaign as C, metrics as M
from nds_tpu_torch import bench
from nds_tpu_torch.tools import bench_compare as BC
p = {str(tmp_path / "l.jsonl")!r}
led = L.Ledger(p, driver="bench", stamp=C.campaign_stamp())
led.query("q1", ms=1.0, hostSyncs=1)
L.Heartbeat(60, ledger=led, out=None).beat()
led.close("completed")
L.load_ledger(p)
import contextlib
with contextlib.redirect_stdout(io.StringIO()):
    assert BC.main([p, p, "--gate"]) == 0
bad = sorted(m for m in sys.modules if m == "nds_tpu"
             or m.startswith(("nds_tpu.", "_nds_", "torch", "jax")))
print(json.dumps(bad))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


# ---------------------------------------------------------------------------
# the differential: the port's Power Run ledger against the reference's
# ---------------------------------------------------------------------------

_DIFF_QUERIES = "query3,query42,query96,query14_part1"
_DIFF_STREAMED = "query3,query96"


@pytest.fixture(scope="module")
def diff_inputs(tmp_path_factory):
    from tools.coverage_sweep import ensure_data

    from nds_tpu_torch.bench import transcode
    from nds_tpu_torch.queries import generate_query_streams
    d = tmp_path_factory.mktemp("diff")
    generate_query_streams(str(d), streams=1, rngseed=19620718, scale=0.01)
    raw = ensure_data()
    transcode(raw, str(d / "pq"), threads=2)
    return raw, str(d / "pq"), str(d / "query_0.sql")


def _ledger_run(cmd, env, cwd):
    res = subprocess.run(cmd, cwd=cwd, env={**os.environ, **env},
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]


def _records(ledger_mod, path):
    data = ledger_mod.load_ledger(path)
    assert data.complete() and data.end["status"] == "completed"
    return [(r["name"], r["status"], r.get("hostSyncs"),
             [(s["table"], s["path"], s["chunks"])
              for s in r.get("streamedScans", ())])
            for r in data.attempts]


@pytest.mark.parametrize("streamed", [False, True],
                         ids=["resident", "streamed"])
def test_power_ledger_matches_the_reference(diff_inputs, tmp_path,
                                            streamed):
    """Record for record: name, status and host syncs, and for the
    streamed case each scan's table, path and chunk count; each ledger
    loads through its own package's reader."""
    from nds_tpu.obs import ledger as RL
    raw, pq, stream = diff_inputs
    queries = _DIFF_STREAMED if streamed else _DIFF_QUERIES
    port_extra, ref_env = [], {}
    if streamed:
        props = tmp_path / "stream.properties"
        props.write_text("stream_bytes=1.5e6\nstream_chunk_rows=4096\n")
        port_extra = ["--property_file", str(props)]
        ref_env = {"NDS_TPU_STREAM_BYTES": "1.5e6",
                   "NDS_TPU_STREAM_CHUNK_ROWS": "4096"}
    data, port_fmt, ref_fmt = (pq, "parquet", "parquet") if streamed \
        else (raw, "raw", "csv")
    port_led, ref_led = str(tmp_path / "port.jsonl"), str(
        tmp_path / "ref.jsonl")
    _ledger_run([sys.executable, "-m", "nds_tpu_torch.power", data, stream,
                 str(tmp_path / "p.csv"), "--input_format", port_fmt,
                 "--device", "cpu", "--sub_queries", queries,
                 "--ledger", port_led] + port_extra,
                {"OMP_NUM_THREADS": "1"}, REPO)  # spare the other workers
    _ledger_run([sys.executable, os.path.join(REPO, "nds_power.py"), data,
                 stream, str(tmp_path / "r.csv"), "--input_format",
                 ref_fmt, "--device", "cpu", "--sub_queries", queries,
                 "--ledger", ref_led],
                {"JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "1",
                 "NDS_TPU_PALLAS": "off", **ref_env}, REPO)
    port, ref = _records(L, port_led), _records(RL, ref_led)
    assert [r[0] for r in port] == queries.split(",")
    assert all(r[1] == "ok" for r in port)
    assert port == ref
    if streamed:
        assert all(r[3] and all(p == "compiled" for _t, p, _c in r[3])
                   for r in port)
