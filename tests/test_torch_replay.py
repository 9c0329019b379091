# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Whole-statement replay in the port (``nds_tpu_torch/engine/replay.py``
and the session's tiers) on ``device="cpu"``: the counterparts of
``tests/test_replay.py`` (the reference's segmentation test has none: a
CUDA graph has no program-size gate to split under), the capture-safety
rules that the CPU can hold (counts dropped on leaving a replay, no cache
filled while capturing, the staged uploads), the tier's spans and
reports, and the 25 CI statements at SF0.01 replayed (forced) against
the JAX reference's eager rows. The capture itself runs on the card:
``tests/test_torch_gpu.py``."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from tests.test_oracle import CI_QUERIES
from tests.test_torch_slice import slice_setup, tables_agree  # noqa: F401

torch.set_num_threads(1)   # tiny tensors: spare the other workers' cores

Q = ("select grp, count(*) c, sum(v) s, avg(v) a from f, dim "
     "where d = sk and k < 40 group by grp order by grp")


def _fact(rng, n, nulls=True):
    return pa.table({
        "k": pa.array(rng.integers(0, 50, n), pa.int64()),
        "d": pa.array(rng.integers(1, 300, n), pa.int64()),
        "v": pa.array([None if nulls and x % 13 == 0 else int(x % 9973)
                       for x in rng.integers(0, 10**6, n)], pa.int64()),
    })


@pytest.fixture
def replay_session(monkeypatch, rng):
    monkeypatch.setenv("NDS_TPU_REPLAY", "force")
    from nds_tpu_torch.engine.session import Session
    s = Session(device="cpu")
    s.create_temp_view("f", _fact(rng, 8_000), base=True)
    s.create_temp_view("dim", pa.table({
        "sk": pa.array(np.arange(1, 301), pa.int64()),
        "grp": pa.array([f"g{i % 9}" for i in range(300)]),
    }), base=True)
    return s


# ---------------------------------------------------------------------------
# the counterparts of tests/test_replay.py
# ---------------------------------------------------------------------------


def test_replay_three_tier_parity(replay_session):
    s = replay_session
    r1 = s.sql(Q).collect()          # eager
    assert s.last_tier == "eager"
    r2 = s.sql(Q).collect()          # record + compile
    assert s._replay_cache, "no compiled statement after the second run"
    assert s.last_tier == "record"
    r3 = s.sql(Q).collect()          # replay
    assert s.last_tier == "replayed"
    assert r1 == r2 == r3
    assert r1, "statement unexpectedly empty"


def test_replay_sync_budget(replay_session):
    """The replayed execution makes at most ONE host sync, the result
    count, with the result fetch."""
    from nds_tpu_torch.engine import ops as E
    s = replay_session
    s.sql(Q).collect()
    s.sql(Q).collect()
    before = E.sync_count()
    s.sql(Q).collect()
    assert s.last_tier == "replayed"
    assert E.sync_count() - before <= 1


def test_replay_invalidation_on_catalog_change(replay_session, rng):
    s = replay_session
    r1 = s.sql(Q).collect()
    s.sql(Q).collect()
    assert s._replay_cache
    version = s._data_version
    # replace the fact table: compiled entries must not serve stale data
    s.create_temp_view("f", _fact(rng, 2_000, nulls=False), base=True)
    assert s._data_version == version + 1
    assert not s._replay_cache and not s._replay_seen
    r2 = s.sql(Q).collect()
    assert r2 != r1                   # genuinely recomputed
    assert s.last_tier == "eager"
    key_hit = [k for k in s._replay_cache if k[0] == Q]
    assert not key_hit or key_hit[0][1] == s._data_version


def test_chunked_table_does_not_disable_replay_for_others(
        replay_session, rng):
    """A streamed table in the catalog must not strip OTHER statements of
    replay; a statement binding the chunked scan itself stays on the
    chunk loop with correct rows, blacklisted with its reason."""
    from nds_tpu_torch.engine.table import ChunkedTable
    s = replay_session
    big = pa.table({"bk": pa.array(rng.integers(0, 50, 5_000), pa.int64()),
                    "bv": pa.array(rng.integers(0, 100, 5_000), pa.int64())})
    s.create_temp_view("big", ChunkedTable(big, chunk_rows=1024), base=True)
    r1 = s.sql(Q).collect()
    s.sql(Q).collect()
    r3 = s.sql(Q).collect()
    assert s._replay_cache, "device-only statement lost replay eligibility"
    assert r1 == r3 and s.last_tier == "replayed"
    qb = "select bk, sum(bv) s from big where bk < 10 group by bk order by bk"
    b1 = s.sql(qb).collect()
    s.sql(qb).collect()
    b3 = s.sql(qb).collect()
    assert b1 == b3 and len(b1) == 10
    assert not any(k[0] == qb for k in s._replay_cache), \
        "chunked-scan statement must stay on the chunk loop"
    assert s.replay_reason(qb) == "binds a streamed table"
    assert s.last_tier == "blacklisted: binds a streamed table"
    assert not s.replay_pending(qb)


def test_replay_record_tier_preserves_scalar_subquery_error(replay_session):
    """A multi-row scalar subquery must raise its SQL runtime error on
    EVERY tier — the record tier's compile handler must not swallow the
    deferred check into a silent blacklist."""
    from nds_tpu_torch.sql.planner import ExecError
    s = replay_session
    bad = "select k, (select sk from dim where sk < 5) x from f where k = 1"
    for _ in range(3):                 # eager, record, record again
        with pytest.raises(ExecError, match="more than one row"):
            s.sql(bad).collect()
    assert not s._replay_cache and not s._replay_blacklist


def test_replay_off_by_default_on_cpu(monkeypatch):
    monkeypatch.delenv("NDS_TPU_REPLAY", raising=False)
    from nds_tpu_torch.engine.session import Session
    s = Session(device="cpu")
    assert s._replay_mode() == "off"
    s.create_temp_view("t", pa.table({"x": pa.array([1, 2, 3])}))
    for _ in range(3):
        s.sql("select sum(x) from t").collect()
    assert not s._replay_cache and not s._replay_seen
    assert s.last_tier == "eager"
    # the conf key and the environment name the same policy
    assert Session(device="cpu", conf={"replay": "auto"})._replay_mode() \
        == "auto"
    monkeypatch.setenv("NDS_TPU_REPLAY", "on")
    assert Session(device="cpu", conf={"replay": "off"})._replay_mode() \
        == "on"


def test_hybrid_auto_records_only_high_sync_statements(replay_session,
                                                       monkeypatch):
    """'auto': a statement records only when its first-sight eager run
    made more host syncs than the threshold; below it, it stays eager."""
    monkeypatch.setenv("NDS_TPU_REPLAY", "auto")
    s = replay_session
    # threshold above anything Q counts: never records
    monkeypatch.setenv("NDS_TPU_REPLAY_SYNC_THR", "10000")
    r1 = s.sql(Q).collect()
    s.sql(Q).collect()
    s.sql(Q).collect()
    assert not s._replay_cache, "low-sync statement must stay eager"
    assert s.last_tier == "eager"
    key = (Q, s._data_version)
    assert key in s._replay_syncs
    # threshold 0: any syncing statement qualifies on its next sight
    monkeypatch.setenv("NDS_TPU_REPLAY_SYNC_THR", "0")
    assert s._replay_syncs[key] > 0, "Q should count at least one sync"
    assert s.replay_pending(Q)
    r2 = s.sql(Q).collect()           # record + compile
    assert s._replay_cache, "high-sync statement must record under auto"
    assert s.replay_pending(Q)        # first replay still pending
    r3 = s.sql(Q).collect()           # first replay
    assert not s.replay_pending(Q)
    assert r1 == r2 == r3 and r1
    # the conf key sets the threshold when the environment does not
    monkeypatch.delenv("NDS_TPU_REPLAY_SYNC_THR")
    s.conf["replay_sync_threshold"] = 17
    assert s._sync_threshold() == 17


# ---------------------------------------------------------------------------
# what the port adds: eviction, mismatch, spans, reports, capture rules
# ---------------------------------------------------------------------------


def test_slow_replays_are_evicted_after_two_strikes(replay_session):
    """Two consecutive replays slower than 1.1x the recorded eager wall
    evict the compiled statement; it stays eager with the reason."""
    s = replay_session
    s.sql(Q).collect()
    s.sql(Q).collect()
    cq = next(iter(s._replay_cache.values()))
    s.sql(Q).collect()                # first replay: never a strike
    cq.eager_s = 0.0                  # every replay now reads as slower
    s.sql(Q).collect()
    assert cq.strikes == 1 and s._replay_cache
    rows = s.sql(Q).collect()
    assert not s._replay_cache
    assert s.replay_reason(Q) == "replay slower than eager twice"
    assert s.sql(Q).collect() == rows
    assert s.last_tier == "blacklisted: replay slower than eager twice"


def test_replay_mismatch_blacklists_and_runs_eagerly(replay_session):
    """A replay whose reads diverge from the recording raises
    ReplayMismatch; the statement is blacklisted with the reason and the
    same execution runs eagerly with correct rows."""
    s = replay_session
    r1 = s.sql(Q).collect()
    s.sql(Q).collect()
    cq = next(iter(s._replay_cache.values()))
    cq.log = [("no-such-read", None)] + list(cq.log)
    assert s.sql(Q).collect() == r1
    assert not s._replay_cache
    assert s.replay_reason(Q).startswith("replay mismatch:")
    assert s.last_tier.startswith("blacklisted: replay mismatch:")


def test_replay_spans_are_recorded(replay_session):
    """The tiers' spans reach the trace ring: a replay region silences
    every other span, never ``replay.*``."""
    from nds_tpu_torch.obs import trace as obs_trace
    s = replay_session
    s.sql(Q).collect()
    obs_trace.drain_spans()
    s.sql(Q).collect()
    names = [getattr(r, "name", None) for r in obs_trace.drain_spans()]
    assert "replay.record" in names and "replay.compile" in names
    s.sql(Q).collect()
    recs = [r for r in obs_trace.drain_spans()
            if getattr(r, "name", None) is not None]
    assert [r.name for r in recs if r.name.startswith("replay.")] == \
        ["replay.drive"]
    # the planner's own spans inside the replayed region stay silent
    assert not [r for r in recs if r.name == "plan"]


def test_counts_made_while_replaying_leave_the_pending_list():
    """Counts created inside a replay region never reach a later batched
    resolve, nor do deferred checks against them; those that existed
    before the region stay."""
    from nds_tpu_torch.engine import ops as E
    E.resolve_counts()
    outer = E.DeviceCount(torch.tensor(3), 8)
    hits = []
    with E.replaying([]):
        inner = E.DeviceCount(torch.tensor(5), 8)
        E.defer_check(inner, hits.append)
        E.defer_check(outer, hits.append)
    pending = E._pending_counts()
    assert any(c is outer for c in pending)
    assert not any(c is inner for c in pending)
    E.flush_deferred_checks()
    assert hits == [3]
    assert outer.to_int() == 3


def test_module_caches_are_bypassed_while_staging():
    """While a graph is prepared or captured, a module-level cache neither
    answers nor fills (a tensor kept from the capture would come from the
    graph's pool, and the warm-up and the capture must take one path);
    outside, it does both."""
    from nds_tpu_torch.engine import ops as E
    from nds_tpu_torch.engine import prim
    x = torch.arange(4, dtype=torch.float64)
    d = 1234.5678
    for k in [k for k in prim._DIVISORS if k[0] == d]:
        prim._DIVISORS.pop(k)
    arr = np.arange(3)
    cache = {}
    E._identity_cache(cache, 4, (arr,), lambda: "old")
    for serve in (False, True):
        with E.staged_uploads(E.UploadStage(), serve=serve) as stage:
            assert E.staging() and stage.serving == serve
            assert torch.equal(prim.true_div(x, d), x / d)
            assert E._identity_cache(cache, 4, (arr,), lambda: "v") == "v"
            assert E._identity_cache({}, 4, (arr,), lambda: "w") == "w"
    assert not E.staging()
    assert not [k for k in prim._DIVISORS if k[0] == d]
    assert E._identity_cache(cache, 4, (arr,), lambda: "v") == "old"
    prim.true_div(x, d)
    assert [k for k in prim._DIVISORS if k[0] == d]


def test_upload_stage_refuses_a_copy_the_warm_up_did_not_make():
    """Serving, the stage hands out what it kept (in order, by content)
    and raises CaptureError for anything else."""
    from nds_tpu_torch.engine import ops as E
    stage = E.UploadStage()
    t = torch.tensor([1, 2, 3])
    key = (str(t.dtype), tuple(t.shape), t.numpy().tobytes())
    kept = [torch.tensor([1, 2, 3]), torch.tensor([1, 2, 3])]
    stage.kept[key] = list(kept)
    with E.staged_uploads(stage, serve=True):
        assert stage.take(t, "cpu") is kept[0]
        assert stage.take(t.clone(), "cpu") is kept[1]
        with pytest.raises(E.CaptureError, match="did not make"):
            stage.take(t, "cpu")
        with pytest.raises(E.CaptureError):
            stage.take(torch.tensor([1, 2, 4]), "cpu")


def test_power_summary_and_ledger_name_the_tier(
        slice_setup, tmp_path, monkeypatch):  # noqa: F811
    """Each Power Run summary and ledger record carries its statement's
    replay tier; a statement runs once there, so it stays eager even when
    replay is forced."""
    import json

    from tools.coverage_sweep import ensure_data
    from nds_tpu_torch.obs.ledger import load_ledger
    from nds_tpu_torch.power import run_query_stream
    _ref, _port, queries = slice_setup
    monkeypatch.setenv("NDS_TPU_REPLAY", "force")
    js, led = tmp_path / "js", tmp_path / "l.jsonl"
    run_query_stream(ensure_data(), None, queries, str(tmp_path / "t.csv"),
                     sub_queries=["query3", "query96"], input_format="raw",
                     json_summary_folder=str(js), device="cpu",
                     ledger_path=str(led))
    tiers = {}
    for fn in sorted(js.iterdir()):
        with open(fn) as f:
            d = json.load(f)
        tiers[d["query"]] = d["replayTier"]
    assert tiers == {"query3": "eager", "query96": "eager"}
    recs = load_ledger(str(led)).queries
    assert {n: r["replayTier"] for n, r in recs.items()} == tiers


# ---------------------------------------------------------------------------
# the 25 CI statements, replayed, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qname", CI_QUERIES)
def test_replayed_statement_matches_reference(
        slice_setup, qname):  # noqa: F811
    """Each CI statement's third sight (forced) replays from its log with
    at most one host sync, and its rows equal the JAX reference's eager
    rows (exact kinds bit for bit, doubles within rel 1e-5)."""
    from nds_tpu_torch.engine import ops as E
    ref, port, queries = slice_setup
    port.conf["replay"] = "force"
    sql = queries[qname]
    port.sql(sql)
    port.sql(sql)
    assert port.last_tier == "record", port.replay_reason(sql)
    s0 = E.sync_count()
    got = port.sql(sql).to_arrow()
    assert port.last_tier == "replayed"
    assert E.sync_count() - s0 <= 1
    why = tables_agree(ref.sql(sql).to_arrow(), got)
    assert why is None, f"{qname}: {why}"
