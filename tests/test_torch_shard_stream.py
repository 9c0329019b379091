# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Sharded streamed execution of the port (``stream_shards``,
``engine/stream.py`` with ``parallel/exchange.py``) against the reference's
(``NDS_TPU_STREAM_SHARDS``) on the CPU: the A/B templates 0, 2 and 7 of
``tests/test_synccount.py`` (``_STREAM_AB_SHARDED``: the star join, the
grouped aggregate, the partitioned fan-out join whose chunks cross the
shards through the hash exchange) on the port's star session with its
shards sharing the CPU, against the reference on its virtual mesh with the
same shard count, both at the forced partition count of 2 the reference's
sharded sweep uses (``NDS_TPU_PALLAS=off`` on its side). Rows bit for bit,
per-shard survivor counts, partition counts, collectives and their bytes
equal to the reference's; the compiled path within 6 host syncs. Then the
port's own contracts: one shard is the unsharded pipeline, a pipeline
built for one shard count never serves another, a fault at the exchange
seam reruns the statement eagerly with the same rows, too few devices
without sharing builds unsharded, and the pipeline cache's budget counts
graph-pool bytes (a stand-in on the CPU). Inputs come from fixed numpy seeds."""

import numpy as np
import pytest
import torch

from tests.test_synccount import (_STREAM_AB_PARTITION_COUNT,
                                  _STREAM_AB_QUERIES, _STREAM_AB_SHARDED,
                                  _chunked_star_session, _forced_pallas,
                                  _forced_stream_partitions,
                                  _forced_stream_shards)
from tests.test_torch_stream import _port_star, _run

from nds_tpu_torch.engine import faults as F
from nds_tpu_torch.engine import stream as S
from nds_tpu_torch.listener import drain_stream_events
from nds_tpu_torch.parallel import exchange as X

torch.set_num_threads(1)

_EXCHANGE = 7                           # the fan-out template


def _conf(shards, **more):
    return {"stream_partitions": _STREAM_AB_PARTITION_COUNT,
            "stream_shards": shards, **more}


@pytest.fixture(autouse=True)
def shared_cpu():
    """The port's shards share the one CPU device."""
    with X.sharing_devices():
        yield


def _reference(indices, shards):
    """(rows, events) of each template through the reference's sharded
    pipeline on its virtual mesh."""
    from nds_tpu.listener import drain_stream_events as ref_drain
    out = {}
    with _forced_stream_partitions(), _forced_stream_shards(shards), \
            _forced_pallas("off"):
        s = _chunked_star_session(np.random.default_rng(42))
        ref_drain()
        for i in indices:
            rows = s.sql(_STREAM_AB_QUERIES[i][0]).collect()
            out[i] = (rows, ref_drain())
    return out


@pytest.fixture(scope="module")
def reference():
    import jax
    if len(jax.devices()) < 4:
        pytest.skip("needs the reference's virtual mesh")
    got = {2: _reference(_STREAM_AB_SHARDED, 2),
           4: _reference((_EXCHANGE,), 4)}
    drain_stream_events()
    return got


@pytest.fixture(scope="module")
def sessions():
    return {n: _port_star(42, _conf(n)) for n in (1, 2, 4)}


_CASES = [(2, i) for i in _STREAM_AB_SHARDED] + [(4, _EXCHANGE)]


@pytest.mark.parametrize("shards,i", _CASES)
def test_sharded_template_matches_reference(reference, sessions, shards, i):
    q = _STREAM_AB_QUERIES[i][0]
    want_rows, want_events = reference[shards][i]
    rows, syncs, events = _run(sessions[shards], q)
    assert rows == want_rows and rows, q
    assert syncs <= 6, f"{syncs} host syncs (budget 6): {q}"
    assert [e.path for e in events] == ["compiled"] * len(want_events)
    for e, w in zip(events, want_events):
        assert e.shards == w.shards == shards
        assert e.shard_rows == tuple(w.shard_rows)
        assert sum(e.shard_rows) == e.rows == w.rows
        assert (e.partitions, tuple(e.part_rows)) == \
            (w.partitions, tuple(w.part_rows))
        assert (e.collectives, e.bytes_ici) == (w.collectives, w.bytes_ici)
        assert e.graph == "uncaptured"
    if i == _EXCHANGE:
        (e,) = events
        # the exchange pass ran every chunk: an all-to-all of each chunk
        # buffer, the partition ids and the validity plane
        assert e.collectives >= e.chunks * 3
        pipe = next(p for p in S._PIPELINE_CACHE.values()
                    if p.n_shards == shards and p.exchange)
        assert pipe.coll_chunk["a2a"] >= 3 and pipe.body_plen == \
            shards * pipe.cap_ex


@pytest.mark.parametrize("i", _STREAM_AB_SHARDED)
def test_one_shard_is_the_unsharded_pipeline(sessions, i):
    q = _STREAM_AB_QUERIES[i][0]
    plain = _port_star(42, {"stream_partitions":
                            _STREAM_AB_PARTITION_COUNT})
    want, _s, want_ev = _run(plain, q)
    rows, _s, events = _run(sessions[1], q)
    assert rows == want
    assert [(e.shards, e.shard_rows, e.collectives, e.rows, e.part_rows)
            for e in events] == \
        [(1, (), -1, e.rows, e.part_rows) for e in want_ev]
    assert all(p.mesh is None for p in S._PIPELINE_CACHE.values()
               if p.n_shards == 1)


def test_eager_drive_equals_static_drive_sharded(sessions):
    s = sessions[2]
    for i in _STREAM_AB_SHARDED:
        q = _STREAM_AB_QUERIES[i][0]
        rows, _s, events = _run(s, q)
        drain_stream_events()
        eager = s.sql(q, graph=False).collect()
        ev = drain_stream_events()
        assert eager == rows, q
        assert [(e.graph, e.shard_rows) for e in ev] == \
            [("eager drive", e.shard_rows) for e in events]


def test_cache_key_misses_across_shard_counts():
    s = _port_star(42, _conf(2))
    q = _STREAM_AB_QUERIES[2][0]
    _run(s, q)
    keys = set(S._PIPELINE_CACHE)
    rows2, _s, ev2 = _run(s, q)
    assert set(S._PIPELINE_CACHE) == keys           # a hit
    s.conf["stream_shards"] = 4
    rows4, _s, ev4 = _run(s, q)
    new = set(S._PIPELINE_CACHE) - keys
    assert len(new) == 1 and S._PIPELINE_CACHE[new.pop()].n_shards == 4
    s.conf["stream_shards"] = 2
    with X.sharing_devices(False):          # no mesh: another pipeline
        rows1, _s, ev1 = _run(s, q)
    assert len(set(S._PIPELINE_CACHE) - keys) == 2
    assert rows2 == rows4 == rows1
    assert [e.shards for e in ev2 + ev4 + ev1] == [2, 4, 1]


def test_exchange_fault_degrades_bit_for_bit(sessions, monkeypatch):
    q = _STREAM_AB_QUERIES[_EXCHANGE][0]
    want, _s, _e = _run(sessions[2], q)
    monkeypatch.setenv("NDS_TPU_FAULT", "exchange:error:1")
    F.reset_fault_counts()
    F.drain_fault_events()
    try:
        rows, _s, events = _run(sessions[2], q)
        faults = F.drain_fault_events()
    finally:
        F.reset_fault_counts()
    assert rows == want
    assert [e.path for e in events] == ["eager"]
    assert "fault: exchange" in events[0].reason
    assert [(f.seam, f.action) for f in faults] == [("exchange", "degrade")]


def test_too_few_devices_without_sharing_builds_unsharded():
    s = _port_star(42, {"stream_partitions": _STREAM_AB_PARTITION_COUNT,
                        "stream_shards": 2})
    plain = _port_star(42, {"stream_partitions":
                            _STREAM_AB_PARTITION_COUNT})
    q = _STREAM_AB_QUERIES[0][0]
    with X.sharing_devices(False):
        rows, _s, events = _run(s, q)
    assert rows == _run(plain, q)[0]
    assert [(e.path, e.shards) for e in events] == [("compiled", 1)]


def test_shard_row_bound_matches_reference():
    from nds_tpu.analysis import mem_audit as RM
    from nds_tpu_torch.analysis import mem_audit as M
    for args in ((10_000, 2, 1, 0, 4), (10_001, 4, 2, 1, 4),
                 (1 << 22, 8, 16, 2, 4), (7, 2, 1, 1, 2)):
        for skew in (1, 2, 3):
            assert M.shard_row_bound(*args, skew=skew) == \
                RM.shard_row_bound(*args, skew=skew)


class _Pipe:
    """A stand-in pipeline holding one ``_Static``."""

    def __init__(self, static_bytes, pool_bytes, graph=True):
        st = S._Static([torch.zeros(static_bytes, dtype=torch.uint8)],
                       torch.zeros((), dtype=torch.int64), [], [], [], [])
        st.static_bytes = static_bytes
        st.pool_bytes = pool_bytes
        st.graph = object() if graph else None
        self._static = st


def test_budget_counts_graph_pool_bytes(monkeypatch):
    monkeypatch.setattr(S, "_hbm_bytes", lambda: 4 * 1000)   # budget 1000
    monkeypatch.setattr(S, "_POOL_FREE", 0)
    monkeypatch.setattr(S, "_STATIC", S.weakref.WeakValueDictionary())
    old = _Pipe(100, 600)
    mid = _Pipe(100, 150)
    for p in (old, mid):
        S._STATIC[id(p)] = p
    assert S.static_report()["pool_bytes"] == 750
    with S._STATIC_LOCK:
        S._enforce_budget(mid)              # 950: within the budget
    assert old._static is not None
    new = _Pipe(100, 0)
    S._STATIC[id(new)] = new
    # the capture grew the pool by 50; nothing was free yet: 1,000 in all
    # before the capture, 1,100 after, so the oldest pipeline goes and its
    # 600 pool bytes stay in the pool, free for the next capture
    S.StreamPipeline._charge_pool(new, new._static, 50)
    assert old._static is None and mid._static is not None
    assert new._static.pool_bytes == 50
    rep = S.static_report()
    assert rep == {"pipelines": 2, "static_bytes": 200, "pool_bytes": 200,
                   "free_pool_bytes": 600, "budget": 1000}
    # the next capture may reuse all of the free pool bytes: it is
    # charged with them; then 250 + 150 + 610 passes the budget, so the
    # oldest (mid) goes, and its 150 pool bytes are the free ones now
    last = _Pipe(10, 0)
    S._STATIC[id(last)] = last
    S.StreamPipeline._charge_pool(last, last._static, 0)
    assert last._static.pool_bytes == 600
    assert mid._static is None and new._static is not None
    assert S.static_report()["free_pool_bytes"] == 150
    # a pipeline an execution holds is never released
    held = _Pipe(10, 900)
    S._STATIC[id(held)] = held
    held._static.lock.acquire()
    with S._STATIC_LOCK:
        S._enforce_budget(last)
    assert held._static is not None and new._static is None
    held._static.lock.release()


def test_pipeline_statics_report_on_the_cpu(sessions):
    _run(sessions[2], _STREAM_AB_QUERIES[0][0])
    rep = S.static_report()
    assert rep["pipelines"] >= 1 and rep["static_bytes"] > 0
    assert rep["pool_bytes"] == 0            # nothing captured on the CPU


@pytest.mark.parametrize("i", _STREAM_AB_SHARDED)
def test_distinct_device_drive_matches(sessions, monkeypatch, i):
    """The drive for shards on distinct cards (each shard's slice
    uploaded to its own device by the prefetch worker, the parts and
    operands copied to every device, the eager drive), run on the CPU by
    a mesh that reports its devices distinct: the shared-device rows and
    shard counts."""
    q = _STREAM_AB_QUERIES[i][0]
    want, _s, want_ev = _run(sessions[2], q)
    monkeypatch.setattr(X.Mesh, "one_device", lambda self: False)
    rows, syncs, events = _run(sessions[2], q)
    assert rows == want and syncs <= 6
    assert [(e.graph, e.shard_rows, e.collectives) for e in events] == \
        [("eager drive: 2 shards on 1 devices", e.shard_rows,
          e.collectives) for e in want_ev]



@pytest.mark.parametrize("free,emptied", [(9, True), (10, False)])
def test_capture_hands_cached_blocks_back_when_the_card_is_full(
        monkeypatch, free, emptied):
    """Before a capture, less than an eighth of the card free hands the
    allocator's cached blocks back (a stand-in device on the CPU)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (free, 80))
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: calls.append(1))
    S._make_room(torch.device("cuda"))
    assert calls == ([1] if emptied else [])
