# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The port's fault registry and recovery policies
(``nds_tpu_torch/engine/faults.py``) and their seams in the engine.

Unit contract, as the reference's: deterministic ``NDS_TPU_FAULT``
parsing that refuses unknown seams, single-fire occurrence counting,
bounded retry that never masks a non-transient error, the statement
watchdog's classified ``StatementTimeout``, thread-scoped events. Engine
contract: the ``sync`` seam retries a blocking read and charges the sync
accounting as the reference does (held against the reference on the same
statement), the watchdog marks a hung statement ``timeout``, the prefetch
ring re-records worker recoveries on the driver, and the streamed path
takes the compiled -> eager step only on a classified fault. Without a
fault or a deadline the fetch stays inline on the calling thread."""

import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from nds_tpu_torch.engine import faults as F
from nds_tpu_torch.engine import ops as E
from nds_tpu_torch.engine import prefetch as PF
from nds_tpu_torch.engine import stream as S
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.listener import drain_stream_events

torch.set_num_threads(1)   # tiny tensors: spare the other workers' cores

_ITEM_SQL = ("select i_item_sk, i_brand_id from item where i_item_sk > 3 "
             "order by i_item_sk")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("NDS_TPU_FAULT", "NDS_TPU_FAULT_HANG_S",
              "NDS_TPU_STATEMENT_DEADLINE_S"):
        monkeypatch.delenv(k, raising=False)
    F.reset_fault_counts()
    F.drain_fault_events()
    yield
    F.reset_fault_counts()
    F.drain_fault_events()


def _item_table():
    rng = np.random.default_rng(7)
    return pa.table({
        "i_item_sk": pa.array(np.arange(1, 41), pa.int64()),
        "i_brand_id": pa.array(rng.integers(1000, 1010, 40), pa.int64())})


def _port_item_session():
    s = Session(device="cpu")
    s.create_temp_view("item", _item_table(), base=True)
    return s


# ---------------------------------------------------------------------------
# registry and injection
# ---------------------------------------------------------------------------


def test_registry_matches_the_reference():
    """Every seam of the reference is registered with the same
    classification and retry policy, those without a call site yet
    included (chunk store, exchange, peer)."""
    from nds_tpu.engine import faults as RF
    assert list(F.SEAMS) == list(RF.SEAMS)
    for name, seam in F.SEAMS.items():
        ref = RF.SEAMS[name]
        assert (seam.classify, seam.retries, seam.retry_on) == \
            (ref.classify, ref.retries, ref.retry_on), name
        assert seam.where and seam.recovery


@pytest.mark.parametrize("env,want", [
    ("sync", ("sync", "error", 1)),
    ("prefetch:hang:3", ("prefetch", "hang", 3)),
    ("device-put:error:2", ("device-put", "error", 2)),
    ("ledger-write::4", ("ledger-write", "error", 4)),
    ("bench-child:error:0", ("bench-child", "error", 1)),
])
def test_fault_spec_parsing(monkeypatch, env, want):
    monkeypatch.setenv("NDS_TPU_FAULT", env)
    assert F.fault_spec() == want


@pytest.mark.parametrize("env,match", [
    ("no-such-seam:error:1", "unregistered seam"),
    ("Sync:error:1", "unregistered seam"),
    ("sync:explode:1", "kind"),
])
def test_fault_spec_refuses_unknown(monkeypatch, env, match):
    monkeypatch.setenv("NDS_TPU_FAULT", env)
    with pytest.raises(ValueError, match=match):
        F.fault_spec()
    with pytest.raises(ValueError, match=match):
        F.fault_point("sync")       # a typo must never pass vacuously


def test_fault_point_fires_exactly_once_at_nth(monkeypatch):
    monkeypatch.setenv("NDS_TPU_FAULT", "sync:error:2")
    F.fault_point("sync")
    with pytest.raises(F.FaultInjected) as info:
        F.fault_point("sync", "detail")
    assert info.value.seam == "sync" and "detail" in str(info.value)
    F.fault_point("sync")
    F.fault_point("sync")
    assert F.fired_count("sync") == 4
    F.fault_point("prefetch")            # untargeted seam: free
    assert F.fired_count("prefetch") == 0


def test_fault_point_occurrences_deterministic_under_threads(monkeypatch):
    monkeypatch.setenv("NDS_TPU_FAULT", "sync:error:5")
    raised = []
    barrier = threading.Barrier(4)

    def worker():
        barrier.wait()
        for _ in range(10):
            try:
                F.fault_point("sync")
            except F.FaultInjected:
                raised.append(1)

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert len(raised) == 1
    assert F.fired_count("sync") == 40


def test_hang_kind_sleeps_then_raises(monkeypatch):
    monkeypatch.setenv("NDS_TPU_FAULT", "sync:hang:1")
    monkeypatch.setenv("NDS_TPU_FAULT_HANG_S", "0.2")
    t0 = time.monotonic()
    with pytest.raises(F.FaultInjected):
        F.fault_point("sync")
    assert time.monotonic() - t0 >= 0.2


# ---------------------------------------------------------------------------
# bounded retry and the watchdog
# ---------------------------------------------------------------------------


def test_with_retry_recovers_transient_and_records_once():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise F.FaultInjected("sync", "transient flake")
        return 42

    assert F.with_retry("sync", flaky) == 42
    assert [(e.seam, e.action, e.attempt) for e in
            F.drain_fault_events()] == [("sync", "recovered", 1)]


def test_with_retry_propagates_non_transient_first_attempt():
    calls = {"n": 0}

    def bug():
        calls["n"] += 1
        raise ValueError("engine bug")

    with pytest.raises(ValueError, match="engine bug"):
        F.with_retry("prefetch", bug)
    assert calls["n"] == 1
    assert not F.drain_fault_events()


@pytest.mark.parametrize("seam", ["sync", "prefetch", "device-put",
                                  "ledger-write"])
def test_with_retry_exhaustion_reraises_classified(seam):
    calls = {"n": 0}

    def always():
        calls["n"] += 1
        raise F.FaultInjected(seam, "persistent")

    with pytest.raises(F.FaultInjected, match="persistent"):
        F.with_retry(seam, always)
    assert calls["n"] == F.SEAMS[seam].retries + 1
    assert not F.drain_fault_events()


def test_bounded_call_inline_without_deadline():
    tid = []
    assert F.bounded_call(
        "sync", lambda: tid.append(threading.get_ident()) or 7) == 7
    assert tid == [threading.get_ident()]


def test_bounded_call_times_out_classified(monkeypatch):
    monkeypatch.setenv("NDS_TPU_STATEMENT_DEADLINE_S", "0.3")
    t0 = time.monotonic()
    with pytest.raises(F.StatementTimeout):
        F.bounded_call("sync", lambda: time.sleep(5))
    assert time.monotonic() - t0 < 4
    assert [(e.seam, e.action) for e in F.drain_fault_events()] == \
        [("sync", "timeout")]


def test_bounded_call_charges_one_statement_budget(monkeypatch):
    monkeypatch.setenv("NDS_TPU_STATEMENT_DEADLINE_S", "0.4")
    with F.statement_scope():
        assert F.bounded_call("sync", lambda: 1) == 1
        time.sleep(0.5)
        t0 = time.monotonic()
        with pytest.raises(F.StatementTimeout, match="exhausted"):
            F.bounded_call("sync", lambda: time.sleep(5))
        assert time.monotonic() - t0 < 1.0


def test_bounded_call_propagates_helper_exception(monkeypatch):
    monkeypatch.setenv("NDS_TPU_STATEMENT_DEADLINE_S", "5")

    def boom():
        raise KeyError("inner")

    with pytest.raises(KeyError, match="inner"):
        F.bounded_call("sync", boom)


def test_statement_scope_reentrant_keeps_outer_clock():
    with F.statement_scope():
        start = F._stmt_tls.start
        with F.statement_scope():
            assert F._stmt_tls.start == start
        assert F._stmt_tls.start == start
    assert getattr(F._stmt_tls, "start", None) is None


def test_fault_events_thread_scoped_and_json_shape():
    F.record_fault_event("sync", "recovered")
    got = {}
    t = threading.Thread(target=lambda: got.update(
        events=F.drain_fault_events()))
    t.start()
    t.join(timeout=30)
    assert got["events"] == []
    (e,) = F.drain_fault_events()
    assert F.fault_event_json(e) == {"seam": "sync", "action": "recovered"}
    j = F.fault_event_json(F.FaultEvent("prefetch", "degrade", attempt=2,
                                        detail="x" * 300))
    assert j["attempt"] == 2 and len(j["detail"]) == 200


# ---------------------------------------------------------------------------
# the sync seam in the engine, against the reference
# ---------------------------------------------------------------------------


def test_unarmed_fetch_runs_inline_armed_on_a_helper(monkeypatch):
    """No deadline: the fetch runs on the calling thread (no helper, no
    added sync). Armed: on a helper thread, still charged one sync on the
    caller."""
    seen = []

    def fetch():
        seen.append(threading.get_ident())
        return 5

    s0 = E.sync_count()
    assert E.timed_read("t", fetch) == 5
    assert seen == [threading.get_ident()] and E.sync_count() - s0 == 1
    monkeypatch.setenv("NDS_TPU_STATEMENT_DEADLINE_S", "30")
    assert E.timed_read("t", fetch) == 5
    assert seen[1] != threading.get_ident()
    assert E.sync_count() - s0 == 2


@pytest.mark.parametrize("read", ["host_sync", "timed_read", "counts"])
def test_retried_read_charges_syncs_as_the_reference(monkeypatch, read):
    """An injected fault at the sync seam recovers in place; the read
    counts one sync, as the unfaulted read does, in both engines."""
    import jax.numpy as jnp

    from nds_tpu.engine import faults as RF
    from nds_tpu.engine import ops as RE

    def drive(ops, arr):
        s0 = ops.sync_count()
        if read == "host_sync":
            val = ops.host_sync(arr(5))
        elif read == "timed_read":
            val = ops.timed_read("t", lambda: 5)
        else:
            c = ops.DeviceCount(arr(5), 8)
            ops.resolve_counts()
            val = ops.count_int(c)
        return val, ops.sync_count() - s0

    got = {}
    for name, ops, faults, arr in (
            ("port", E, F, lambda v: torch.tensor(v, dtype=torch.int64)),
            ("ref", RE, RF, lambda v: jnp.asarray(v, dtype=jnp.int64))):
        monkeypatch.delenv("NDS_TPU_FAULT", raising=False)
        clean = drive(ops, arr)
        faults.reset_fault_counts()
        faults.drain_fault_events()
        monkeypatch.setenv("NDS_TPU_FAULT", "sync:error:1")
        faulted = drive(ops, arr)
        events = faults.drain_fault_events()
        assert [(e.seam, e.action) for e in events] == \
            [("sync", "recovered")], name
        got[name] = (clean, faulted)
        faults.reset_fault_counts()
    assert got["port"] == got["ref"] == ((5, 1), (5, 1))


def test_statement_under_sync_fault_matches_reference(monkeypatch):
    """The same statement through both engines with the sync seam's
    first occurrence injected: the same rows, one recovered event, and
    the unfaulted run's host syncs."""
    from nds_tpu.engine import faults as RF
    from nds_tpu.engine.session import Session as RefSession

    def run(make, faults):
        s = make()
        monkeypatch.delenv("NDS_TPU_FAULT", raising=False)
        s0 = syncs()
        clean = s.sql(_ITEM_SQL).collect()
        clean_syncs = syncs() - s0
        faults.reset_fault_counts()
        faults.drain_fault_events()
        monkeypatch.setenv("NDS_TPU_FAULT", "sync:error:1")
        s0 = syncs()
        rows = s.sql(_ITEM_SQL).collect()
        used = syncs() - s0
        events = [(e.seam, e.action) for e in faults.drain_fault_events()]
        faults.reset_fault_counts()
        return clean, clean_syncs, rows, used, events

    def ref_session():
        s = RefSession()
        s.create_temp_view("item", _item_table(), base=True)
        return s

    from nds_tpu.engine import ops as RE
    syncs = RE.sync_count
    ref = run(ref_session, RF)
    syncs = E.sync_count
    port = run(_port_item_session, F)
    assert port == ref
    assert port[4] == [("sync", "recovered")] and port[0] == port[2]
    assert port[1] >= 1


def test_armed_watchdog_marks_a_hung_read_timeout(monkeypatch):
    s = _port_item_session()
    monkeypatch.setenv("NDS_TPU_FAULT", "sync:hang:1")
    monkeypatch.setenv("NDS_TPU_FAULT_HANG_S", "3")
    monkeypatch.setenv("NDS_TPU_STATEMENT_DEADLINE_S", "0.5")
    t0 = time.monotonic()
    with pytest.raises(F.StatementTimeout):
        s.sql(_ITEM_SQL).collect()
    assert time.monotonic() - t0 < 2.5
    assert [(e.seam, e.action) for e in F.drain_fault_events()] == \
        [("sync", "timeout")]
    monkeypatch.delenv("NDS_TPU_FAULT")
    assert len(s.sql(_ITEM_SQL).collect()) == 37   # the session serves on


@pytest.mark.gpu
def test_armed_watchdog_reads_on_the_callers_stream(monkeypatch):
    """Armed, the fetch runs on a helper thread, whose current stream is
    the default one: it must read on the caller's stream, after the
    kernel that writes the value."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the race is between CUDA streams")
    monkeypatch.setenv("NDS_TPU_STATEMENT_DEADLINE_S", "60")
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        x = torch.zeros(1 << 20, dtype=torch.int64, device="cuda")
        torch.cuda._sleep(200_000_000)          # about 0.1 s of spinning
        x.fill_(1)
        assert E.host_sync(x.sum()) == 1 << 20


# ---------------------------------------------------------------------------
# the prefetch ring and the streamed path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_seam_recovers_and_reaches_the_driver(monkeypatch, depth):
    monkeypatch.setenv("NDS_TPU_FAULT", "prefetch:error:2")
    ring = PF.chunk_ring(range(5), prepare=lambda x: 10 * x, depth=depth)
    got = []
    try:
        while True:
            v = ring.next_chunk()
            if v is None:
                break
            got.append(v)
    finally:
        ring.close()
    assert got == [0, 10, 20, 30, 40]
    assert [(e.seam, e.action) for e in F.drain_fault_events()] == \
        [("prefetch", "recovered")]


def _streamed_session(seed=42):
    from tests.test_torch_stream import _port_star
    S._PIPELINE_CACHE.clear()
    return _port_star(seed, {})


# an A/B statement of tests/test_synccount.py that streams compiled
_STREAMED_SQL = (
    "select ss_item_sk, count(*) c, sum(ss_ext_sales_price) s "
    "from store_sales where ss_ext_sales_price > 5000 "
    "group by ss_item_sk order by ss_item_sk")


def _streamed_run(s):
    drain_stream_events()
    rows = s.sql(_STREAMED_SQL).collect()
    return rows, drain_stream_events(), \
        [(e.seam, e.action) for e in F.drain_fault_events()]


@pytest.fixture(scope="module")
def streamed_rows():
    rows, events, _ = _streamed_run(_streamed_session())
    assert [e.path for e in events] == ["compiled"]
    return rows


def test_pipeline_compile_fault_degrades_to_eager(monkeypatch,
                                                  streamed_rows):
    monkeypatch.setenv("NDS_TPU_FAULT", "pipeline-compile:error:1")
    rows, events, faults = _streamed_run(_streamed_session())
    assert rows == streamed_rows
    assert [e.path for e in events] == ["eager"]
    assert "pipeline-compile" in events[0].reason
    assert faults == [("pipeline-compile", "degrade")]


def test_device_put_fault_recovers_in_place(monkeypatch, streamed_rows):
    monkeypatch.setenv("NDS_TPU_FAULT", "device-put:error:1")
    rows, events, faults = _streamed_run(_streamed_session())
    assert rows == streamed_rows
    assert [e.path for e in events] == ["compiled"]
    assert faults == [("device-put", "recovered")]


def test_exhausted_drive_fault_takes_the_ladder(monkeypatch,
                                               streamed_rows):
    def broken(self, chunk):
        raise F.FaultInjected("device-put", "persistent upload fault")

    monkeypatch.setattr(S.StreamPipeline, "_prepare_first", broken)
    rows, events, faults = _streamed_run(_streamed_session())
    assert rows == streamed_rows
    assert [e.path for e in events] == ["eager"]
    assert "degraded to eager" in events[0].reason
    assert faults == [("device-put", "degrade")]


@pytest.mark.parametrize("exc", [
    F.StatementTimeout("sync", "deadline"), ValueError("engine bug")])
def test_other_drive_errors_still_raise(monkeypatch, exc):
    """A statement timeout is not rerun (it would pay the hang again), and
    an error that is not a classified fault never hides behind the eager
    loop."""
    def broken(self, chunk):
        raise exc

    monkeypatch.setattr(S.StreamPipeline, "_prepare_first", broken)
    with pytest.raises(type(exc)):
        _streamed_session().sql(_STREAMED_SQL).collect()
