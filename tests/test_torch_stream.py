# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The streamed path of the torch port as a whole (``ChunkedTable``, the
prefetch ring, the chunk pipeline of ``engine/stream.py``) against the
reference on the CPU: the ``tests/test_streaming.py`` cases and the 14
``tests/test_synccount.py`` A/B statements give the reference's rows in the
reference's order; every ``must_stream`` statement runs through the
pipeline (``path == "compiled"``) within 6 host syncs; a forced partition
count of 2 partitions the fan-out subset; the eager loop gives the same
rows, and so do the 14 statements with the chunk store on. The compiled
drive (on the CPU the static-slot program, uncaptured) gives the eager
drive's rows and resets its static operands between two executions of a
cached pipeline; a chunk-derived host read that the log would replay
sends its statement to the eager loop. Inputs are made from fixed numpy
seeds."""

import os
import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

from tests.test_streaming import CASES, _tables
from tests.test_synccount import (_STREAM_AB_PARTITIONED,
                                  _STREAM_AB_QUERIES, _chunked_star_session)

from nds_tpu_torch.engine import kernels as K
from nds_tpu_torch.engine import ops as E
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.engine.table import ChunkedTable, upload_chunk
from nds_tpu_torch.listener import drain_stream_events

torch.set_num_threads(1)   # tiny tensors: spare the other workers' cores

# the reference's own default (its CPU tests choose partitions against it)
_HBM = 16 << 30


def _port_star(seed, conf, chunk_rows=2048):
    """tests/test_synccount._chunked_star_session, built on the port: the
    same tables from the same seed (draws in the same order)."""
    rng = np.random.default_rng(seed)
    n_fact, n_dim = 20_000, 365
    s = Session(conf={"hbm_bytes": _HBM, **conf}, device="cpu")
    s.create_temp_view("date_dim", pa.table({
        "d_date_sk": pa.array(np.arange(1, n_dim + 1), pa.int64()),
        "d_year": pa.array(1998 + np.arange(n_dim) // 120, pa.int64()),
        "d_moy": pa.array(1 + (np.arange(n_dim) // 30) % 12, pa.int64()),
    }), base=True)
    s.create_temp_view("item", pa.table({
        "i_item_sk": pa.array(np.arange(1, 201), pa.int64()),
        "i_brand_id": pa.array(rng.integers(1000, 1020, 200), pa.int64()),
    }), base=True)
    s.create_temp_view("store_returns", pa.table({
        "sr_item_sk": pa.array(np.repeat(np.arange(1, 201), 3), pa.int64()),
        "sr_ticket_number": pa.array(np.arange(600), pa.int64()),
        "sr_return_amt": pa.array(rng.integers(1, 100, 600), pa.int64()),
    }), base=True)
    s.create_temp_view("store_sales", ChunkedTable(pa.table({
        "ss_sold_date_sk": pa.array(
            rng.integers(1, n_dim + 40, n_fact), pa.int64()),
        "ss_item_sk": pa.array(rng.integers(1, 230, n_fact), pa.int64()),
        "ss_ticket_number": pa.array(
            np.arange(n_fact) % 1200, pa.int64()),
        "ss_ext_sales_price": pa.array(
            rng.integers(1, 10_000, n_fact), pa.int64()),
    }), chunk_rows=chunk_rows), base=True)
    return s


def _run(session, sql):
    """(rows, host syncs, drained stream events) of one statement."""
    drain_stream_events()
    before = E.sync_count()
    rows = session.sql(sql).collect()
    return rows, E.sync_count() - before, drain_stream_events()


@pytest.fixture(scope="module")
def reference_rows():
    """The reference's rows of the 14 A/B statements, through its own
    streamed executor."""
    s = _chunked_star_session(np.random.default_rng(42))
    return [s.sql(q).collect() for q, _must in _STREAM_AB_QUERIES]


@pytest.fixture(scope="module")
def port_sessions():
    return {
        "compiled": _port_star(42, {}),
        "partitioned": _port_star(42, {"stream_partitions": 2}),
        "eager": _port_star(42, {"stream_exec": "eager"}),
    }


_AB = range(len(_STREAM_AB_QUERIES))


@pytest.mark.parametrize("i", _AB)
def test_ab_statement_matches_reference(port_sessions, reference_rows, i):
    q, must_stream = _STREAM_AB_QUERIES[i]
    rows, syncs, events = _run(port_sessions["compiled"], q)
    assert rows == reference_rows[i], q
    assert rows, q
    if must_stream:
        # a multi-pass statement may chain SEVERAL pipelines (the inner
        # subquery's + the outer scan's); every one of them must hold
        assert events and all(e.path == "compiled" for e in events), \
            [(e.path, e.reason) for e in events]
        assert all(e.chunks == 10 for e in events)
        assert syncs <= 6, f"{syncs} host syncs (budget 6): {q}"


@pytest.mark.parametrize("i", _AB)
def test_ab_statement_partitioned_and_eager(port_sessions, reference_rows,
                                            i):
    q, must_stream = _STREAM_AB_QUERIES[i]
    rows, syncs, events = _run(port_sessions["partitioned"], q)
    assert rows == reference_rows[i], q
    if must_stream:
        assert events and all(e.path == "compiled" for e in events)
        assert syncs <= 6, f"{syncs} host syncs (budget 6): {q}"
    if i in _STREAM_AB_PARTITIONED:
        (e,) = events
        assert e.partitions == 2, (q, e)
        assert len(e.part_rows) == 2
        assert sum(e.part_rows) == e.rows
    eager, _syncs, ev = _run(port_sessions["eager"], q)
    assert eager == rows, q
    assert {e.path for e in ev} == {"eager"}


@pytest.fixture(scope="module")
def store_session(tmp_path_factory):
    """The star session whose streamed scans read their wire plans
    through a chunk store (cold for the first statement of a column set,
    then warm)."""
    return _port_star(42, {}), str(tmp_path_factory.mktemp("chunk_store"))


@pytest.mark.parametrize("i", _AB)
def test_ab_statement_with_the_chunk_store_matches_reference(
        store_session, reference_rows, monkeypatch, i):
    s, root = store_session
    monkeypatch.setenv("NDS_TPU_CHUNK_STORE", root)
    q, must_stream = _STREAM_AB_QUERIES[i]
    rows, _syncs, events = _run(s, q)
    assert rows == reference_rows[i], q
    if must_stream:
        assert events and all(e.path == "compiled" for e in events)
    assert os.listdir(root)


@pytest.mark.parametrize("i", _AB)
@pytest.mark.parametrize("sess", ["compiled", "partitioned"])
def test_static_drive_equals_eager_drive_and_resets(port_sessions,
                                                    monkeypatch, sess, i):
    """The compiled drive (on the CPU the static-slot, in-place program
    run uncaptured) gives the eager drive's rows; a second execution of
    the same cached pipeline reuses its static operands, reset by
    kernels, and gives the same rows again."""
    from nds_tpu_torch.engine import stream as S
    made = []
    real = S._Static.__init__

    def counting(self, *a, **k):
        made.append(1)
        real(self, *a, **k)

    monkeypatch.setattr(S._Static, "__init__", counting)
    s = port_sessions[sess]
    q, _must = _STREAM_AB_QUERIES[i]
    first, _s1, ev1 = _run(s, q)
    made.clear()
    again, _s2, ev2 = _run(s, q)
    drain_stream_events()
    eager = s.sql(q, graph=False).collect()
    ev3 = drain_stream_events()
    assert first == again == eager, q
    compiled = [e for e in ev2 if e.path == "compiled"]
    assert all(e.graph == "uncaptured" for e in compiled)
    assert not made or not compiled, "a cached pipeline reallocated"
    assert all(e.graph == "eager drive" for e in ev3
               if e.path == "compiled")
    assert [e.path for e in ev3] == [e.path for e in ev2]


def test_chunk_derived_host_read_takes_the_eager_loop(rich_sessions):
    """``year``/``month`` of a streamed date column and a cast of a
    streamed column to a string are whole-column host reads of chunk
    data: recorded on the first chunk and replayed, every chunk would get
    the first chunk's values. The record refuses them, so the statement
    takes the eager chunk loop and gives the resident rows. The compare
    is with the resident rows because the reference's streamed result is
    the wrong one there (its log replays the first chunk's values)."""
    _ref, resident, streamed = rich_sessions
    for q in ("select count(*) c, sum(l_price) s from lineitem "
              "where year(l_date) = 2000",
              "select month(l_date) m, count(*) c from lineitem "
              "where month(l_date) >= 6 group by month(l_date) order by m",
              "select count(*) c from lineitem "
              "where cast(l_key as string) like '1%'"):
        got, _syncs, events = _run(streamed, q)
        assert got == resident.sql(q).collect() and got, q
        assert [(e.path, e.reason) for e in events] == \
            [("eager", "not chunk-invariant")], q


def test_dimension_side_host_read_stays_compiled(port_sessions):
    """The same kind of read over a non-streamed part is chunk-invariant:
    the statement stays on the pipeline, with the eager loop's rows."""
    q = ("select d_year, count(*) c from store_sales, date_dim "
         "where ss_sold_date_sk = d_date_sk "
         "and cast(d_year as string) = '1998' group by d_year")
    rows, _syncs, events = _run(port_sessions["compiled"], q)
    assert [e.path for e in events] == ["compiled"]
    eager, _s, _e = _run(port_sessions["eager"], q)
    assert rows == eager and rows


def test_ab_statements_take_the_kernels(port_sessions, monkeypatch):
    """On the CPU the wrappers take their plain versions (nothing
    launches), so count the calls: the lowered predicates go through K4
    once per chunk and the stream-bounds joins through K5."""
    calls = {"chunk_scan": 0, "join_probe": 0}
    for name in calls:
        real = getattr(K, name)

        def counting(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(K, name, counting)
    s = port_sessions["compiled"]
    rows, _syncs, events = _run(s, _STREAM_AB_QUERIES[1][0])
    assert calls["chunk_scan"] == 10 and events[0].kernel_fused_stages == 2
    _run(s, _STREAM_AB_QUERIES[7][0])       # ss x sr fan-out join
    assert calls["join_probe"] >= 10


# ------------------------------------------------ test_streaming CASES


@pytest.fixture(scope="module")
def case_sessions():
    from nds_tpu.engine.session import Session as RefSession
    from nds_tpu.engine.table import ChunkedTable as RefChunked
    sales, items, dates = _tables()
    ref = RefSession()
    streamed = Session(conf={"hbm_bytes": _HBM}, device="cpu")
    resident = Session(device="cpu")
    for s in (ref, streamed, resident):
        s.create_temp_view("items", items, base=True)
        s.create_temp_view("dates", dates, base=True)
    # 7 chunks of 800 rows exercise the partial trailing chunk too
    ref.create_temp_view("sales", RefChunked(sales, chunk_rows=800),
                         base=True)
    streamed.create_temp_view("sales", ChunkedTable(sales, chunk_rows=800),
                              base=True)
    resident.create_temp_view("sales", sales, base=True)
    return ref, streamed, resident


@pytest.mark.parametrize("case", range(len(CASES)))
def test_streaming_case_matches_reference_and_resident(case_sessions, case):
    ref, streamed, resident = case_sessions
    want = ref.sql(CASES[case]).collect()
    got, _syncs, events = _run(streamed, CASES[case])
    assert got == want
    assert resident.sql(CASES[case]).collect() == want
    assert events and all(e.path == "compiled" and e.chunks == 7
                          for e in events)


def _lineitem(rng, n=6000):
    cats = np.asarray(["alpha", "beta", "gamma", "delta"], dtype=object)
    qty = rng.integers(0, 50, n).astype(float)
    qty[rng.random(n) < 0.15] = np.nan
    amt = [None if i % 11 == 0 else f"{v / 100:.2f}"
           for i, v in enumerate(rng.integers(-5000, 900000, n))]
    import decimal
    return pa.table({
        "l_key": pa.array(rng.integers(1, 500, n), pa.int64()),
        "l_cat": pa.array(cats[rng.integers(0, 4, n)]),
        "l_qty": pa.array(qty),
        "l_price": pa.array(rng.integers(1, 10_000, n), pa.int64()),
        "l_amt": pa.array([None if a is None else decimal.Decimal(a)
                           for a in amt], pa.decimal128(7, 2)),
        "l_date": pa.array(rng.integers(10950, 11400, n).astype("int32"),
                           pa.int32()).cast(pa.date32()),
    })


_RICH = [
    "select count(*) c, sum(l_price) s from lineitem where l_cat = 'beta'",
    "select count(*) c from lineitem where l_cat <> 'omega'",
    "select count(*) c from lineitem where l_key in (1, 2, 3, 499)",
    "select count(*) c from lineitem where l_key not in (7, 9) "
    "and l_price > 50",
    "select count(*) c from lineitem where l_qty is null",
    "select count(*) c, sum(l_price) s from lineitem "
    "where l_qty is not null and l_price > 2500.5",
    "select count(*) c from lineitem where l_cat not in ('omega', 'zeta')",
    "select count(*) c, sum(l_price) s from lineitem "
    "where l_price between 100.5 and 5000",
    "select count(*) c from lineitem where l_price not between 100 and 5000",
    "select count(*) c, sum(l_amt) s from lineitem where l_amt >= 12.34",
    "select count(*) c from lineitem where l_amt between 0.5 and 99.99",
    "select count(*) c from lineitem where l_amt in (1.25, 3.5, 21.07)",
    "select count(*) c from lineitem where l_amt > 2500.5 and l_qty < 20",
    "select count(*) c from lineitem "
    "where l_date between date '2000-02-01' and date '2000-06-30'",
    "select l_cat, count(*) c from lineitem where l_qty >= 25.5 "
    "group by l_cat order by l_cat",
]


@pytest.fixture(scope="module")
def rich_sessions():
    from nds_tpu.engine.session import Session as RefSession
    t = _lineitem(np.random.default_rng(11))
    ref, resident = RefSession(), Session(device="cpu")
    streamed = Session(conf={"hbm_bytes": _HBM, "stream_bytes": 1},
                       device="cpu")
    for s in (ref, resident):
        s.create_temp_view("lineitem", t, base=True)
    streamed.create_temp_view("lineitem", ChunkedTable(t, chunk_rows=1024),
                              base=True)
    return ref, resident, streamed


@pytest.mark.parametrize("i", range(len(_RICH)))
def test_lowered_predicates_match_resident(rich_sessions, monkeypatch, i):
    """Predicate shapes the star session never lowers — string equality
    against the whole-table dictionary, IN-lists, IS [NOT] NULL, float and
    decimal literals, dates — each through K4's plain version, equal to
    the port's resident run and to the reference."""
    ref, resident, streamed = rich_sessions
    calls = []
    real = K.chunk_scan
    monkeypatch.setattr(K, "chunk_scan",
                        lambda *a: calls.append(1) or real(*a))
    got, _syncs, events = _run(streamed, _RICH[i])
    assert [e.path for e in events] == ["compiled"]
    assert len(calls) == 6, "the K4 pass did not engage"
    assert got == resident.sql(_RICH[i]).collect()
    assert got == ref.sql(_RICH[i]).collect()


# ------------------------------------------------------ ChunkedTable


def test_chunked_table_matches_reference_chunks():
    """Uniform capacity, trailing partial chunk, shared dictionaries and
    narrow codes: the port's chunks hold the reference's buffers."""
    from nds_tpu.engine.table import ChunkedTable as RefChunked
    t = _lineitem(np.random.default_rng(3), n=2500)
    ours, theirs = ChunkedTable(t, chunk_rows=700), RefChunked(
        t, chunk_rows=700)
    got = [upload_chunk(hc, "cpu") for hc in ours.host_chunks()]
    want = list(theirs.padded_chunks())
    assert ours.num_chunks() == theirs.num_chunks() == len(got) == 4
    assert ours.chunk_cap == theirs.chunk_cap == 1024
    assert [c.nrows for c in got] == [700, 700, 700, 400]
    for a, b in zip(got, want):
        assert a.plen == b.plen == 1024
        assert a.column_names == b.column_names
        for n in a.column_names:
            x, y = a[n], b[n]
            assert x.kind == y.kind
            np.testing.assert_array_equal(x.data.numpy(), np.asarray(y.data))
            np.testing.assert_array_equal(x.valid.numpy(),
                                          np.asarray(y.valid))
            assert (x.enc is None) == (y.enc is None)
            if x.enc is not None:
                assert (x.enc.mode, x.enc.base) == (y.enc.mode, y.enc.base)
            if x.kind == "str":
                assert x.dict_values is got[0][n].dict_values


def test_session_streams_tables_past_the_threshold(tmp_path):
    from nds_tpu_torch.io.columnar import write_table
    sales, _items, _dates = _tables(3000)
    write_table(sales, str(tmp_path / "sales"), "parquet")
    s = Session(conf={"stream_bytes": 10_000, "stream_chunk_rows": 1000},
                device="cpu")
    s.read_columnar_view("sales", str(tmp_path / "sales"))
    t = s.catalog["sales"]
    assert isinstance(t, ChunkedTable) and t.chunk_rows == 1000
    rows, _syncs, events = _run(
        s, "select count(*) c, sum(s_qty) q from sales where s_qty > 10")
    assert rows == [(int((np.asarray(sales["s_qty"]) > 10).sum()),
                     int(np.asarray(sales["s_qty"])[
                         np.asarray(sales["s_qty"]) > 10].sum()))]
    assert [(e.path, e.chunks) for e in events] == [("compiled", 3)]


# ------------------------------------------------------- prefetch ring


def _ring_payloads(depth):
    from nds_tpu_torch.engine.prefetch import chunk_ring
    from nds_tpu_torch.engine.table import upload_chunk
    t = _lineitem(np.random.default_rng(5), n=3000)
    ct = ChunkedTable(t, chunk_rows=512)
    ring = chunk_ring(ct.host_chunks(), depth=depth,
                      prepare=lambda hc: upload_chunk(hc, "cpu"))
    out = []
    try:
        while True:
            c = ring.next_chunk()
            if c is None:
                break
            out.append(c)
    finally:
        ring.close()
    return out


def test_prefetch_depth_zero_equals_depth_two():
    inline, ringed = _ring_payloads(0), _ring_payloads(2)
    assert len(inline) == len(ringed) == 6
    for a, b in zip(inline, ringed):
        assert a.nrows == b.nrows
        for n in a.column_names:
            x, y = a[n].data, b[n].data
            if x.dtype.is_floating_point:       # bits: NaN == NaN
                x, y = x.view(torch.int64), y.view(torch.int64)
            assert torch.equal(x, y)
            assert torch.equal(a[n].valid, b[n].valid)


def test_prefetch_statement_rows_do_not_depend_on_depth(port_sessions):
    q = _STREAM_AB_QUERIES[0][0]
    want = port_sessions["compiled"].sql(q).collect()
    for depth in (0, 1, 3):
        s = _port_star(42, {"prefetch_depth": depth})
        rows, _syncs, events = _run(s, q)
        assert rows == want and events[0].path == "compiled"


def test_prefetch_worker_error_surfaces_and_close_joins():
    from nds_tpu_torch.engine.prefetch import ChunkRing

    def source():
        yield 1
        yield 2
        raise ValueError("bad chunk")

    ring = ChunkRing(source(), prepare=lambda x: x * 10, depth=2,
                     name="nds-prefetch-test")
    assert ring.next_chunk() == 10
    assert ring.next_chunk() == 20
    with pytest.raises(ValueError, match="bad chunk"):
        ring.next_chunk()
    ring.close()
    # a ring closed while its worker is blocked on a full queue
    blocked = ChunkRing(iter(range(100)), depth=1, name="nds-prefetch-test")
    assert blocked.next_chunk() == 0
    blocked.close()
    assert not any(th.name == "nds-prefetch-test" and th.is_alive()
                   for th in threading.enumerate())


# ----------------------------------------------- replay discipline


def test_host_read_outside_the_log_raises():
    """Inside the per-chunk program a count resolution raises
    StreamSyncError, and a host read the log does not serve raises
    ReplayMismatch."""
    d = E.DeviceCount(torch.tensor(3), 8)
    with E.stream_bounds():
        with pytest.raises(E.StreamSyncError):
            d.to_int()
        with pytest.raises(E.StreamSyncError):
            E.host_sync(torch.tensor(1))
    with E.replaying([("dense_dim", None)]):
        with pytest.raises(E.ReplayMismatch):
            E.timed_read("group_ranges", lambda: 1)
    E.resolve_counts()


def test_pipeline_whose_replay_reads_the_host_falls_back(monkeypatch):
    """A per-chunk program that reads the host outside its log raises
    StreamSyncError inside the drive: the statement reruns through the
    eager loop, with the same rows, and says why."""
    from nds_tpu_torch.engine import stream as S
    s = _port_star(7, {})
    q = _STREAM_AB_QUERIES[0][0]
    want, _syncs, _ev = _run(s, q)
    real = S.StreamPipeline._body

    def reading_body(self, *a, **k):
        with E.stream_bounds():          # as inside the replayed graph
            E.host_sync(torch.tensor(1))
        return real(self, *a, **k)

    monkeypatch.setattr(S.StreamPipeline, "_body", reading_body)
    rows, _syncs, events = _run(s, q)
    assert rows == want
    assert [e.path for e in events] == ["eager"]
    assert "StreamSyncError" in events[0].reason


def test_pipeline_engine_error_raises(monkeypatch):
    """An error inside the drive that is not one of the two replay
    exceptions (an engine bug, a kernel refusing its launch) raises to the
    caller: the statement does not rerun through the eager loop."""
    from nds_tpu_torch.engine import stream as S
    s = _port_star(7, {})
    q = _STREAM_AB_QUERIES[0][0]

    def failing_body(self, *a, **k):
        raise ValueError("kernel refused its launch")

    monkeypatch.setattr(S.StreamPipeline, "_body", failing_body)
    drain_stream_events()
    with pytest.raises(ValueError, match="refused its launch"):
        s.sql(q).collect()
    assert not [e for e in drain_stream_events() if e.path == "eager"]
