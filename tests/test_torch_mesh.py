# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The port's meshed resident session (``Session(conf={"mesh_shape": n})``,
``engine/sharded.py``, the repartition join ``ops._exchange_inner_join``)
on the CPU, its shards sharing the one device inside
``exchange.sharing_devices()``.

Held against the unmeshed port and the JAX reference's meshed session
(``tests/test_distributed.py``: its three SQL cases on the reference's 8
virtual CPU devices) at meshes of 2, 4 and 8 shards and three placements:
everything replicated (the default threshold), the fact table row-sharded
under replicated dimensions, and everything row-sharded
(``NDS_TPU_BROADCAST_BYTES=64``, where two row-sharded sides join through
the exchange). Exact kinds bit for bit, doubles within rel 1e-5, row order
exact. Then the repartition join of ``tests/test_distributed.py``, the 25
CI statements at SF0.01 (everything row-sharded, mesh 4) against the
unmeshed port, the session's refusals, INSERT and DELETE placing the new
snapshot again, and the replay tiers of a meshed session. Inputs come from
fixed numpy seeds and the cached SF0.01 data."""

import math
import os
from unittest import mock

import numpy as np
import pyarrow as pa
import pytest
import torch

from tests.test_distributed import SQL_CASES, _sql_fixture_tables
from tests.test_oracle import CI_QUERIES
from tests.test_torch_slice import tables_agree

from nds_tpu_torch.engine import ops as E
from nds_tpu_torch.engine import sharded as SH
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.engine.table import ChunkedTable, DeviceTable
from nds_tpu_torch.parallel import exchange as X

torch.set_num_threads(1)

MESHES = (2, 4, 8)
# placement -> (broadcast threshold, the specs the fixture tables take)
PLACEMENTS = {
    "replicated": (None, {"sales": "rep", "items": "rep", "dates": "rep"}),
    "fact_sharded": (20000, {"sales": "row", "items": "rep",
                             "dates": "rep"}),
    "all_sharded": (64, {"sales": "row", "items": "row", "dates": "row"}),
}


def rows_agree(a, b):
    """None when two collected row lists agree (exact, doubles within
    rel 1e-5), else the first difference."""
    if len(a) != len(b):
        return f"{len(a)} rows vs {len(b)}"
    for i, (ra, rb) in enumerate(zip(a, b)):
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                if not math.isclose(x, y, rel_tol=1e-5, abs_tol=1e-12):
                    return f"row {i}: {ra} vs {rb}"
            elif x != y:
                return f"row {i}: {ra} vs {rb}"
    return None


def meshed(n, conf=None, **kw):
    with X.sharing_devices():
        return Session({"mesh_shape": n, **(conf or {})}, device="cpu", **kw)


def _register(s, tables):
    for name, t in tables.items():
        s.create_temp_view(name, t)
    return s


@pytest.fixture(scope="module")
def fixture_tables():
    return _sql_fixture_tables()


@pytest.fixture(scope="module")
def reference_rows(fixture_tables):
    """The reference's meshed session's rows of each SQL case."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs the reference's 8 virtual CPU devices")
    from nds_tpu.engine.session import Session as RefSession
    ref = _register(RefSession(conf={"mesh_shape": 8}), fixture_tables)
    assert ref.mesh is not None
    return [ref.sql(q).collect() for q in SQL_CASES]


@pytest.fixture(scope="module")
def unmeshed_rows(fixture_tables):
    plain = _register(Session(device="cpu"), fixture_tables)
    return [plain.sql(q).collect() for q in SQL_CASES]


@pytest.mark.parametrize("case", range(len(SQL_CASES)))
@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("placement", sorted(PLACEMENTS))
def test_meshed_session_matches_unmeshed_and_reference(
        fixture_tables, reference_rows, unmeshed_rows, placement, n, case):
    limit, specs = PLACEMENTS[placement]
    conf = {} if limit is None else {"broadcast_bytes": limit}
    s = _register(meshed(n, conf), fixture_tables)
    assert s.mesh.size == n
    assert {k: t.spec for k, t in s.catalog.items()} == specs
    got = s.sql(SQL_CASES[case]).collect()
    assert got == unmeshed_rows[case]
    why = rows_agree(got, reference_rows[case])
    assert why is None, why


@pytest.mark.parametrize("n", MESHES)
def test_exchange_repartition_join_matches_single_device(monkeypatch, n):
    """``tests/test_distributed.py``'s repartition join: two row-sharded
    sides join through the exchange and give the unmeshed port's rows and
    the JAX reference's."""
    monkeypatch.setenv("NDS_TPU_BROADCAST_BYTES", "64")
    rng = np.random.default_rng(5)
    m = 4096
    tables = {p: pa.table({
        f"{p}_k": pa.array(rng.integers(1, 300, m), pa.int64()),
        f"{p}_v": pa.array(rng.integers(1, 1000, m), pa.int64()),
    }) for p in ("a", "b")}
    sql = ("select a_k, count(*) c, sum(a_v + b_v) s from a, b "
           "where a_k = b_k and a_v < b_v group by a_k order by a_k")
    single = _register(Session(device="cpu"), tables)
    s = _register(meshed(n), tables)
    assert all(t.spec == "row" for t in s.catalog.values())
    calls = []
    orig = E._exchange_inner_join
    monkeypatch.setattr(
        E, "_exchange_inner_join",
        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    with X.collective_trace() as trace:
        got = s.sql(sql).collect()
    assert calls, "the repartition join did not engage on sharded inputs"
    assert trace.counts["a2a"] > 0 and trace.counts["bytes"] > 0
    assert got == single.sql(sql).collect()
    why = rows_agree(got, repartition_reference_rows(tables, sql))
    assert why is None, why


def repartition_reference_rows(tables, sql):
    """The JAX reference's rows of ``sql`` on ``tables`` (its single-device
    session)."""
    from nds_tpu.engine.session import Session as RefSession
    return _register(RefSession(), tables).sql(sql).collect()


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("keys,right_rows,fetches", [
    (300, 4096, 0),         # pairs outnumber both sides: both gather whole
    (1000, 512, 1),         # fewer pairs than the left side's rows
    (100000, 4096, 2),      # a few pairs: every shard hands over its rows
])
def test_exchange_join_moves_the_fewer_rows(monkeypatch, n, keys,
                                            right_rows, fetches):
    """Each side of the repartition join reaches the first shard's device
    by the cheaper move: the shards' matched rows when there are fewer
    pairs than the side has rows, else the whole side. Either way the
    rows are the unmeshed port's, in its order, and the JAX reference's;
    string and null columns included."""
    monkeypatch.setenv("NDS_TPU_BROADCAST_BYTES", "64")
    rng = np.random.default_rng(keys)
    m = 4096
    tables = {
        "a": pa.table({"a_k": pa.array(rng.integers(0, keys, m), pa.int64()),
                       "a_v": pa.array([None if x % 13 == 0 else int(x)
                                        for x in rng.integers(0, 999, m)],
                                       pa.int64())}),
        "b": pa.table({"b_k": pa.array(rng.integers(0, keys, right_rows),
                                       pa.int64()),
                       "b_s": pa.array(rng.choice(["p", "q", "r"],
                                                  right_rows)),
                       "b_v": pa.array(rng.random(right_rows), pa.float64())}),
    }
    sql = "select a_v, b_s, b_v, a_k from a, b where a_k = b_k"
    want = _register(Session(device="cpu"), tables).sql(sql).collect()
    s = _register(meshed(n), tables)
    SH.COUNTS.update(exchange_joins=0, fetches=0)
    got = s.sql(sql).collect()
    assert (SH.COUNTS["exchange_joins"], SH.COUNTS["fetches"]) == \
        (1, fetches)
    assert got == want and len(want) > 0
    ref = repartition_reference_rows(tables, sql)
    key = lambda r: tuple((x is None, x) for x in r)     # noqa: E731
    why = rows_agree(sorted(got, key=key), sorted(ref, key=key))
    assert why is None, why


def test_exchange_join_rows_keep_the_unmeshed_order(monkeypatch):
    """Without an ORDER BY, the exchange join's rows come out in the
    unmeshed join's order (left row, then right row), nulls dropped, and
    they are the JAX reference's rows."""
    monkeypatch.setenv("NDS_TPU_BROADCAST_BYTES", "64")
    rng = np.random.default_rng(8)
    m = 3000
    keys = [None if x % 11 == 0 else int(x)
            for x in rng.integers(1, 60, m)]
    tables = {"l": pa.table({"l_k": pa.array(keys, pa.int64()),
                             "l_i": pa.array(np.arange(m), pa.int64())}),
              "r": pa.table({"r_k": pa.array(rng.integers(1, 60, 500),
                                             pa.int64()),
                             "r_s": pa.array(rng.choice(["x", "y"], 500))})}
    sql = "select l_i, r_k, r_s from l, r where l_k = r_k and l_i % 3 = 1"
    want = _register(Session(device="cpu"), tables).sql(sql).collect()
    SH.COUNTS["exchange_joins"] = 0
    got = _register(meshed(4), tables).sql(sql).collect()
    assert SH.COUNTS["exchange_joins"] == 1
    assert got == want and len(want) > 1000
    # the same multiset of rows as the JAX reference (its unordered join
    # need not list them in the port's order)
    assert sorted(got) == sorted(repartition_reference_rows(tables, sql))


# ---------------------------------------------------------------------------
# the 25 CI statements at SF0.01, everything row-sharded
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ci_sessions():
    from tools.coverage_sweep import ensure_data
    from nds_tpu_torch.power import gen_sql_from_stream, strip_stream_markers
    from nds_tpu_torch.schema import get_schemas
    data = ensure_data()
    stream = os.path.join(os.path.dirname(data), "oracle_stream",
                          "query_0.sql")
    if not os.path.exists(stream):
        from nds_tpu_torch.queries import generate_query_streams
        generate_query_streams(os.path.dirname(stream), streams=1,
                               rngseed=19620718, scale=0.01)
    queries = {k: strip_stream_markers(v)
               for k, v in gen_sql_from_stream(stream).items()}
    plain = Session(device="cpu")
    for tname, fields in get_schemas(use_decimal=True).items():
        plain.read_raw_view(tname, os.path.join(data, f"{tname}.dat"),
                            fields)
    with mock.patch.dict(os.environ, {"NDS_TPU_BROADCAST_BYTES": "64"}):
        m = meshed(4)
        for name, t in plain.catalog.items():
            m.create_temp_view(name, t, base=name in plain.base_tables)
    assert all(t.spec == "row" for t in m.catalog.values())
    return plain, m, queries


@pytest.mark.parametrize("qname", CI_QUERIES)
def test_ci_statement_meshed_matches_unmeshed(ci_sessions, qname):
    plain, m, queries = ci_sessions
    sql = queries[qname]
    why = tables_agree(plain.sql(sql).to_arrow(), m.sql(sql).to_arrow())
    assert why is None, f"{qname}: {why}"


def test_ci_statements_engage_the_exchange(ci_sessions):
    """Everything row-sharded, the fact-to-fact joins of the CI set take
    the repartition join (query37's inventory x catalog_sales, query50's
    store_sales x store_returns)."""
    plain, m, queries = ci_sessions
    for q in ("query37", "query50"):
        SH.COUNTS["exchange_joins"] = 0
        m.sql(queries[q]).to_arrow()
        assert SH.COUNTS["exchange_joins"] >= 1, q


# ---------------------------------------------------------------------------
# the session's contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,match", [
    (3, "power of two"), (6, "power of two"), (32, "bucket floor")])
def test_mesh_shape_refusals(shape, match):
    with pytest.raises(ValueError, match=match):
        meshed(shape)


def test_more_shards_than_devices_is_refused_outside_the_seam():
    """The CPU has one device: two shards need the sharing seam, and
    without it the session raises instead of building unmeshed."""
    with X.sharing_devices(False):
        with pytest.raises(ValueError, match="under-shard"):
            Session({"mesh_shape": 2}, device="cpu")
    assert Session({"mesh_shape": 1}, device="cpu").mesh is None


def test_mesh_shape_from_the_environment(monkeypatch):
    monkeypatch.setenv("NDS_MESH_SHAPE", "4")
    with X.sharing_devices():
        s = Session(device="cpu")
    assert s.mesh.size == 4 and s.mesh.one_device()
    monkeypatch.setenv("NDS_MESH_SHAPE", "3")
    with pytest.raises(ValueError, match="power of two"):
        meshed(0)


def test_placement_rule_and_even_split():
    """At or under the threshold a table is replicated, past it
    row-sharded: even contiguous physical parts whose gather is the
    unmeshed table, pads in the last parts."""
    n = 1000
    t = pa.table({"k": pa.array(np.arange(n), pa.int64()),
                  "v": pa.array([None if i % 7 == 0 else float(i)
                                 for i in range(n)], pa.float64()),
                  "s": pa.array([f"s{i % 13}" for i in range(n)])})
    plain = Session(device="cpu")
    plain.create_temp_view("t", t)
    whole = plain.catalog["t"]
    nbytes = SH.table_bytes(whole)
    s = meshed(4, {"broadcast_bytes": nbytes})
    s.create_temp_view("t", t)
    assert s.catalog["t"].spec == "rep"
    s = meshed(4, {"broadcast_bytes": nbytes - 1})
    s.create_temp_view("t", t)
    sh = s.catalog["t"]
    assert sh.spec == "row" and len(sh.parts) == 4
    assert [p.plen for p in sh.parts] == [whole.plen // 4] * 4
    assert [p.nrows for p in sh.parts] == [256, 256, 256, 232]
    got = SH.gather(sh)
    assert got.nrows == n and got.plen == whole.plen
    for name, c in whole.columns.items():
        assert torch.equal(got[name].data, c.data), name
        if c.dict_values is not None:
            # one dictionary for every part: the gather keeps it
            assert all(p[name].dict_values is got[name].dict_values
                       for p in sh.parts)
            assert list(got[name].dict_values) == list(c.dict_values)
    assert s.sql("select count(*), sum(k) from t where v > 500").collect() \
        == plain.sql("select count(*), sum(k) from t where v > 500").collect()


def test_meshed_session_never_streams_nor_prewarms(tmp_path):
    """A table past ``stream_bytes`` row-shards instead of streaming, and
    no dense dimension map is prewarmed at registration."""
    import pyarrow.parquet as pq
    n = 5000
    t = pa.table({"d_date_sk": pa.array(np.arange(1, n + 1), pa.int64()),
                  "d_v": pa.array(np.arange(n) % 17, pa.int64())})
    os.makedirs(tmp_path / "d")
    pq.write_table(t, tmp_path / "d" / "part-0.parquet")
    E._dense_dim_cache.clear()
    s = meshed(2, {"stream_bytes": 1000, "broadcast_bytes": 1000})
    s.read_columnar_view("d", str(tmp_path / "d"))
    got = s.catalog["d"]
    assert not isinstance(got, ChunkedTable) and got.spec == "row"
    assert not E._dense_dim_cache
    plain = Session({"stream_bytes": 1000}, device="cpu")
    plain.read_columnar_view("d", str(tmp_path / "d"))
    assert isinstance(plain.catalog["d"], ChunkedTable)


@pytest.mark.parametrize("verb", ["insert", "delete"])
def test_dml_places_the_new_snapshot_again(tmp_path, verb):
    """INSERT and DELETE register the new snapshot through
    create_temp_view: row-sharded again, with the unmeshed session's
    rows."""
    from nds_tpu_torch.warehouse import Warehouse
    rng = np.random.default_rng(4)
    fact = pa.table({"f_k": pa.array(rng.integers(0, 50, 600), pa.int64()),
                     "f_d": pa.array(rng.integers(0, 9, 600), pa.int32())})
    src = pa.table({"s_k": pa.array([7, 8, 9], pa.int64()),
                    "s_d": pa.array([70, 80, 90], pa.int32())})
    stmt = ("insert into fact (select s_k as f_k, s_d as f_d from src)"
            if verb == "insert" else "delete from fact where f_d > 4")
    q = "select f_k, count(*) c, sum(f_d) d from fact group by f_k " \
        "order by f_k"
    out = []
    for name, s in (("plain", Session(device="cpu")),
                    ("mesh", meshed(4, {"broadcast_bytes": 1000}))):
        w = Warehouse(str(tmp_path / name))
        w.create("fact", fact)
        s.warehouse = w
        s.create_temp_view("fact", w.read("fact"))
        s.create_temp_view("src", src)
        before = s.catalog["fact"]
        s.sql(stmt)
        after = s.catalog["fact"]
        if name == "mesh":
            assert before.spec == after.spec == "row"
            assert after is not before
            assert E.count_int(after.nrows) != E.count_int(before.nrows)
        out.append(s.sql(q).collect())
    assert out[0] == out[1]


def test_meshed_statement_replays_on_a_shared_device():
    """Shards sharing one device: the 2nd sight records, the 3rd replays,
    the same rows every time."""
    tables = _sql_fixture_tables()
    s = _register(meshed(4, {"broadcast_bytes": 20000, "replay": "force"}),
                  tables)
    rows = []
    for tier in ("eager", "record", "replayed"):
        rows.append(s.sql(SQL_CASES[0]).collect())
        assert s.last_tier == tier, s.replay_reason(SQL_CASES[0])
    assert rows[0] == rows[1] == rows[2]


def test_distinct_device_mesh_is_blacklisted_with_its_reason(monkeypatch):
    """Shards on distinct devices take the eager tier, blacklisted with
    the reason (no CUDA graph spans them)."""
    s = _register(meshed(2, {"replay": "force"}), _sql_fixture_tables())
    monkeypatch.setattr(X.Mesh, "one_device", lambda self: False)
    for _ in range(3):
        s.sql(SQL_CASES[2]).collect()
    assert s.last_tier.startswith("blacklisted: meshed over distinct")
    assert "no CUDA graph" in s.replay_reason(SQL_CASES[2])


def test_sharded_table_reads_no_gather_for_metadata():
    """Names, sizes, aliases and projections of a row-sharded table read
    its parts; only rows gather."""
    t = pa.table({"k": pa.array(np.arange(100), pa.int64())})
    s = meshed(2, {"broadcast_bytes": 8})
    s.create_temp_view("t", t)
    sh = s.catalog["t"]
    SH.COUNTS["gathers"] = 0
    assert sh.column_names == ["k"] and "k" in sh and sh.nbytes == 128 * 8
    assert sh.select(["k"]).spec == "row"
    assert SH.COUNTS["gathers"] == 0
    assert isinstance(sh.whole(), DeviceTable)
    assert SH.COUNTS["gathers"] == 1


def test_row_local_operators_stay_row_sharded(fixture_tables):
    """A filter, a plain projection and the join of the row-sharded fact
    with a replicated dimension run shard by shard: the statement's table
    is still row-sharded, with the unmeshed rows in order; a view created
    from it is placed again by the rule."""
    sql = ("select s_item * 2 as i2, s_tag, i_cat from sales, items "
           "where s_item = i_item and s_qty > 40")
    want = _register(Session(device="cpu"), fixture_tables).sql(sql)
    s = _register(meshed(4, {"broadcast_bytes": 20000}), fixture_tables)
    SH.COUNTS["gathers"] = 0
    got = s.sql(sql)
    assert SH.is_row(got.table) and SH.COUNTS["gathers"] == 0
    assert got.collect() == want.collect()
    s.sql(f"create temp view v as {sql}")
    assert s.catalog["v"].spec == "rep"       # about 12 KB: replicated
    assert s.sql("select * from v").collect() == want.collect()
