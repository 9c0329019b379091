# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The raw wire of the port (``NDS_TPU_ENCODED=0``) against the reference.

With the gate off, streamed int-path columns go up at their plain widths:
the chunked star fixture of ``tests/test_synccount.py`` streams through
the port with the gate off and on, and through the reference with the
gate off and ``NDS_TPU_PALLAS=off``, and all three give the same rows bit
for bit, the encoded upload below the raw one (as
``tests/test_streaming.py`` measures the reference's). Flipping the gate
between two executions in one session builds the other wire plan and
another pipeline, and flipping it back hits both again; a chunk-store
entry saved under one setting is a miss under the other. K4's plain
version on plain int32, int64, date and decimal lanes (the ``"id"`` float
mode, the decimal divisor, the int lane on stored values) equals the
reference's ``scan_reference``, and the spec lowering of plain columns is
the reference's. ``NDS_TPU_PREFETCH_DEPTH`` and ``NDS_TPU_STREAM_SHARDS``
override the session's settings when set, and leave them alone when
unset."""

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from nds_tpu.engine import kernels as RK
from nds_tpu_torch.engine import kernels as K
from nds_tpu_torch.engine import ops as E
from nds_tpu_torch.engine import stream as S
from nds_tpu_torch.engine.table import ChunkedTable
from nds_tpu_torch.io import chunk_store as CS
from nds_tpu_torch.listener import drain_stream_events
from tests.test_synccount import _STREAM_AB_QUERIES, _chunked_star_session
from tests.test_torch_stream import _port_star

torch.set_num_threads(1)   # tiny tensors: spare the other workers' cores

# a star join with a group, a filter on the fact alone, and a grouped
# aggregate of the fact alone
_AB = (0, 1, 2)


def _run(session, sql):
    drain_stream_events()
    rows = session.sql(sql).collect()
    return rows, drain_stream_events()


@pytest.fixture(scope="module")
def reference_raw_rows():
    mp = pytest.MonkeyPatch()
    mp.setenv("NDS_TPU_ENCODED", "0")
    mp.setenv("NDS_TPU_PALLAS", "off")
    try:
        s = _chunked_star_session(np.random.default_rng(42))
        return [s.sql(_STREAM_AB_QUERIES[i][0]).collect() for i in _AB]
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def port_runs():
    """``{gate: [(rows, events), ...]}`` of one port session, the raw
    runs first, then the encoded ones."""
    mp = pytest.MonkeyPatch()
    mp.delenv("NDS_TPU_CHUNK_STORE", raising=False)
    s = _port_star(42, {})
    out = {}
    try:
        for gate in ("0", "1"):
            mp.setenv("NDS_TPU_ENCODED", gate)
            out[gate] = [_run(s, _STREAM_AB_QUERIES[i][0]) for i in _AB]
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("k", range(len(_AB)))
def test_raw_wire_rows_match_encoded_and_reference(port_runs,
                                                   reference_raw_rows, k):
    raw, raw_ev = port_runs["0"][k]
    enc, enc_ev = port_runs["1"][k]
    assert raw == enc == reference_raw_rows[k]
    assert raw
    for events in (raw_ev, enc_ev):
        assert [e.path for e in events] == ["compiled"], events
        assert events[0].chunks == 10
    # the narrow codes shrink the upload; the raw wire sends every int64
    # column at 8 bytes a row
    assert 0 < enc_ev[0].bytes_h2d < raw_ev[0].bytes_h2d


def test_flip_rebuilds_wire_plan_and_pipeline(monkeypatch):
    monkeypatch.delenv("NDS_TPU_CHUNK_STORE", raising=False)
    s = _port_star(7, {})
    sql = _STREAM_AB_QUERIES[2][0]
    chunked = s.catalog["store_sales"].chunked \
        if hasattr(s.catalog["store_sales"], "chunked") \
        else s.catalog["store_sales"]
    assert isinstance(chunked, ChunkedTable)
    for key in list(S._PIPELINE_CACHE):    # another test's pipelines
        S._evict(key)
    seen = []
    for gate in ("1", "0", "1", "0"):
        monkeypatch.setenv("NDS_TPU_ENCODED", gate)
        before = dict(S._PIPELINE_CACHE)
        rows, events = _run(s, sql)
        built = {k for k, p in S._PIPELINE_CACHE.items()
                 if before.get(k) is not p}
        seen.append((rows, events[0].bytes_h2d, built))
    (r1, b1, new1), (r0, b0, new0), (r1b, b1b, new1b), (r0b, b0b, new0b) \
        = seen
    assert r1 == r0 == r1b == r0b
    assert b1 == b1b < b0 == b0b
    # the first sight under each setting builds its pipeline; the flip
    # back finds it cached
    assert len(new1) == len(new0) == 1 and new1 != new0
    assert not new1b and not new0b
    gates = sorted(key[-1] for key in chunked._wire_store)
    assert gates == [False, True]
    # the plan under the gate off holds no narrow code
    monkeypatch.setenv("NDS_TPU_ENCODED", "0")
    assert chunked._int_encodings() == {}
    assert all(wc.enc is None for wc in chunked._wire_plan().values())
    monkeypatch.setenv("NDS_TPU_ENCODED", "1")
    assert chunked._int_encodings()
    assert any(wc.enc is not None for wc in chunked._wire_plan().values())


def _store_table():
    rng = np.random.default_rng(5)
    from decimal import Decimal
    return pa.table({
        "k": pa.array(rng.integers(1, 300, 5000), pa.int64()),
        "d": pa.array(rng.integers(10000, 10400, 5000).astype(np.int32),
                      pa.int32()).cast(pa.date32()),
        "v": pa.array(rng.integers(0, 1 << 40, 5000), pa.int64()),
        "p": pa.array([Decimal(int(x)) / 100 for x in
                       rng.integers(-99_999, 99_999, 5000)],
                      pa.decimal128(7, 2)),
    })


def test_chunk_store_entry_is_a_miss_under_the_other_setting(
        tmp_path, monkeypatch):
    monkeypatch.setenv("NDS_TPU_CHUNK_STORE", str(tmp_path))
    arrow = _store_table()
    types = {"k": "int64", "d": "date", "v": "int64",
             "p": "decimal(7,2)"}
    prints = {}
    for gate in ("1", "0"):
        monkeypatch.setenv("NDS_TPU_ENCODED", gate)
        prints[gate] = CS.table_fingerprint(arrow, types)
        assert f"enc={gate}" not in prints[gate]       # a digest, not text
    assert prints["0"] != prints["1"]
    monkeypatch.setenv("NDS_TPU_ENCODED", "1")
    ChunkedTable(arrow, chunk_rows=1024, canonical_types=types)._wire_plan()
    assert CS.load_plan(str(tmp_path), arrow, types) is not None
    monkeypatch.setenv("NDS_TPU_ENCODED", "0")
    assert CS.load_plan(str(tmp_path), arrow, types) is None
    # the raw run saves its own entry, which the encoded setting misses
    plan = ChunkedTable(arrow, chunk_rows=1024,
                        canonical_types=types)._wire_plan()
    assert all(wc.enc is None for wc in plan.values())
    loaded = CS.load_plan(str(tmp_path), arrow, types)
    assert loaded is not None and all(wc.enc is None
                                      for wc in loaded.values())
    monkeypatch.setenv("NDS_TPU_ENCODED", "1")
    assert CS.load_plan(str(tmp_path), arrow, types) is None


# K4 on plain lanes: (data slot, valid slot, fmode, base, table, sdiv)
def _plain_lane_case(seed):
    rng = np.random.default_rng(seed)
    cap = 2048
    i32 = rng.integers(-5000, 5000, cap).astype(np.int32)
    i64 = rng.integers(-(1 << 40), 1 << 40, cap).astype(np.int64)
    i64v = rng.random(cap) > 0.1
    date = rng.integers(10950, 12000, cap).astype(np.int32)   # days
    dec = rng.integers(-100_000, 900_000, cap).astype(np.int64)  # x100
    decv = rng.random(cap) > 0.2
    bufs = (i32, None, i64, i64v, date, None, dec, decv)
    cols = [(0, -1, "id", 0, -1, 1.0), (2, 3, "id", 0, -1, 1.0),
            (4, -1, "id", 0, -1, 1.0), (6, 7, "id", 0, -1, 100.0)]
    entries = [
        ("irange", 0, -2500, 4000), ("inotin", 0, (0, 7, -9)),
        ("fgt", 0, -4999.5), ("ige", 1, -(1 << 39)),
        ("ile", 1, (1 << 40) - 12345), ("inotin", 1, tuple(i64[:5].tolist())),
        ("irange", 2, 11000, 11900), ("ine", 2, 11111),
        ("ige", 3, -50_000), ("fge", 3, -400.25), ("flt", 3, 8000.0),
        ("fnotin", 3, (12.34, 56.78)), ("notnull", 3),
    ]
    return bufs, 1900, entries, cols


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("keys", [(), (2, 6)])
def test_chunk_scan_plain_on_plain_lanes_matches_reference(seed, keys):
    bufs, n, entries, cols = _plain_lane_case(seed)
    rspec = RK.ScanSpec(entries, cols, key_slots=keys)
    pspec = K.ScanSpec(entries, cols, key_slots=keys)
    jflat = tuple(None if b is None else jnp.asarray(b) for b in bufs)
    m_ref, h_ref = RK.scan_reference(jflat, jnp.asarray(n, jnp.int64),
                                     rspec)
    m, h = K.chunk_scan(tuple(None if b is None else torch.from_numpy(b)
                              for b in bufs),
                        torch.tensor(n, dtype=torch.int64), pspec)
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    assert 0 < int(m.sum()) < n
    if keys:
        np.testing.assert_array_equal(h.numpy().view(np.uint32),
                                      np.asarray(h_ref))
    else:
        assert h is None and h_ref is None


_PLAIN_WHERE = ["l_i32 between 100 and 2000", "l_i32 > 7.5",
                "l_i64 >= 1099511627776", "l_i64 in (1, 2, 3)",
                "l_date >= date '2000-01-03'",
                "l_date between '2000-01-01' and '2000-03-01'",
                "l_i64 not in (5, 9)"]


def test_lower_scan_spec_of_plain_columns_matches_reference():
    from nds_tpu.engine import exprs as RX
    from nds_tpu.sql import parser as RP
    from nds_tpu_torch.engine import exprs as PX
    from nds_tpu_torch.sql import parser as PP

    def meta(i, name, kind):
        return {"name": f"l.{name}", "kind": kind, "enc": None,
                "dict_values": None, "data_slot": 2 * i,
                "valid_slot": 2 * i + 1}
    cols = [meta(0, "l_i32", "i32"), meta(1, "l_i64", "i64"),
            meta(2, "l_date", "date")]

    def conjuncts(parse):
        return [parse("select 1 from l where " + w).body.where
                for w in _PLAIN_WHERE]
    rspec, rkept = RX.lower_scan_spec(conjuncts(RP.parse), cols,
                                      lambda c: True)
    pspec, pkept = PX.lower_scan_spec(conjuncts(PP.parse), cols,
                                      lambda c: True)
    assert rkept == [] and pkept == []
    assert pspec.entries == rspec.entries
    assert pspec.cols == rspec.cols
    # every plain column decodes through the "id" float mode
    assert {c[2] for c in pspec.cols} == {"id"}


def test_env_knobs_override_the_session_setting(monkeypatch):
    from nds_tpu_torch.analysis.mem_audit import stream_shards
    from nds_tpu_torch.engine import prefetch as PF
    for k in E.SETTING_ENV.values():
        monkeypatch.delenv(k, raising=False)
    conf = {"prefetch_depth": 3, "stream_shards": 2}
    with E.on_device("cpu", conf):
        assert PF.prefetch_depth() == 3 and stream_shards() == 2
        monkeypatch.setenv("NDS_TPU_PREFETCH_DEPTH", "0")
        monkeypatch.setenv("NDS_TPU_STREAM_SHARDS", "4")
        assert PF.prefetch_depth() == 0 and stream_shards() == 4
        monkeypatch.setenv("NDS_TPU_PREFETCH_DEPTH", "")   # an unset arm
        assert PF.prefetch_depth() == 3
    with E.on_device("cpu", {}):
        monkeypatch.delenv("NDS_TPU_STREAM_SHARDS")
        assert stream_shards() == 1 and PF.prefetch_depth() == 2


def test_env_knobs_take_effect_on_a_streamed_statement(monkeypatch):
    from nds_tpu_torch.parallel.exchange import sharing_devices
    for k in E.SETTING_ENV.values():
        monkeypatch.delenv(k, raising=False)
    s = _port_star(42, {"prefetch_depth": 2})
    sql = _STREAM_AB_QUERIES[2][0]
    want, events = _run(s, sql)
    assert events[0].shards == 1
    monkeypatch.setenv("NDS_TPU_STREAM_SHARDS", "2")
    with sharing_devices():
        rows, events = _run(s, sql)
    assert rows == want and events[0].shards == 2
    monkeypatch.delenv("NDS_TPU_STREAM_SHARDS")
    # the ring built at depth 0 is the inline pump: the chunk loop never
    # waits on a worker
    seen = []
    real = S._PF.prefetch_depth

    def spy():
        seen.append(real())
        return seen[-1]
    monkeypatch.setattr(S._PF, "prefetch_depth", spy)
    monkeypatch.setenv("NDS_TPU_PREFETCH_DEPTH", "0")
    rows, events = _run(s, sql)
    assert rows == want and seen and set(seen) == {0}
