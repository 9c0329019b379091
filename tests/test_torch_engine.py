# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Column, expression and window parity of the torch port with the
reference engine: arrow round trips, decimals, CASE, LIKE, substr and the
window functions — analogues of the matching ``test_engine.py`` tests, run
as SQL through both engines on the same small tables (made with numpy from
a seed) — plus carrying a reference table's codes across with
``from_reference_arrays``."""

import datetime
import decimal
import math

import numpy as np
import pyarrow as pa
import pytest
import torch

from nds_tpu.engine.column import from_arrow as ref_from_arrow
from nds_tpu.engine.session import Session as RefSession
from nds_tpu_torch.engine.column import from_arrow as port_from_arrow
from nds_tpu_torch.engine.session import Session as PortSession
from nds_tpu_torch.engine.table import from_reference_arrays

torch.set_num_threads(1)   # tiny tensors: spare the other workers' cores


def _table(seed=0, n=64):
    rng = np.random.default_rng(seed)
    price = [None if rng.random() < 0.1 else
             decimal.Decimal(int(rng.integers(-99999, 99999))).scaleb(-2)
             for _ in range(n)]
    names = ["apple", "banana", "cherry", "date", None, "Elder", "fig"]
    return pa.table({
        "k": pa.array(rng.integers(0, 5, size=n), type=pa.int32()),
        "id": pa.array(np.arange(n), type=pa.int64()),
        "price": pa.array(price, type=pa.decimal128(7, 2)),
        "qty": pa.array([None if rng.random() < 0.1 else int(x)
                         for x in rng.integers(0, 100, size=n)],
                        type=pa.int32()),
        "x": pa.array([None if rng.random() < 0.05 else float(x)
                       for x in rng.normal(scale=50, size=n)],
                      type=pa.float64()),
        "s": pa.array([names[i % len(names)] for i in
                       rng.integers(0, 100, size=n)], type=pa.string()),
        "d": pa.array([datetime.date(2000, 1, 1) + datetime.timedelta(
            days=int(v)) for v in rng.integers(0, 1000, size=n)],
            type=pa.date32()),
    })


@pytest.fixture(scope="module")
def sessions():
    t = _table()
    r, p = RefSession(), PortSession(device="cpu")
    r.create_temp_view("t", t)
    p.create_temp_view("t", t)
    return r, p


def _agree(a: pa.Table, b: pa.Table):
    assert a.column_names == b.column_names
    assert a.num_rows == b.num_rows
    for i in range(a.num_columns):
        ca, cb = a.column(i), b.column(i)
        assert ca.type == cb.type, a.column_names[i]
        la, lb = ca.to_pylist(), cb.to_pylist()
        if pa.types.is_floating(ca.type):
            for x, y in zip(la, lb):
                assert (x is None) == (y is None)
                if x is not None and not (math.isnan(x) and math.isnan(y)):
                    assert math.isclose(x, y, rel_tol=1e-5, abs_tol=1e-12)
        else:
            assert la == lb, a.column_names[i]


SQL = {
    "decimal_arith": "select id, price + 1.5 a, price * qty b, price - price"
                     " c, price / 3 e, cast(price as decimal(7,1)) f,"
                     " round(price, 1) g, -price h from t order by id",
    "decimal_agg": "select k, sum(price) s, avg(price) a, min(price) mn,"
                   " max(price) mx, count(price) c, count(*) n from t"
                   " group by k order by k",
    "double_agg": "select k, sum(x) s, avg(x) a, min(x) mn, max(x) mx,"
                  " stddev_samp(x) sd from t group by k order by k",
    "case": "select id, case when qty > 50 then 'big' when qty > 10 then"
            " 'mid' else 'small' end c, case k when 1 then price else 0 end"
            " p, coalesce(qty, -1) q from t order by id",
    "like_substr": "select id, s like 'b%' b, s like '%e%' e, s not like"
                   " '_i%' ni, substr(s, 2, 3) sub, upper(s) u, length(s) l"
                   " from t order by id",
    "string_group": "select substr(s, 1, 1) f, count(*) n, min(s) mn,"
                    " max(s) mx from t group by substr(s, 1, 1) order by f",
    "window_rank": "select id, k, rank() over (partition by k order by"
                   " price desc) r, dense_rank() over (partition by k order"
                   " by qty) dr, row_number() over (order by id desc) rn"
                   " from t order by id",
    "window_agg": "select id, sum(price) over (partition by k) sp,"
                  " avg(x) over (partition by k) ax, min(qty) over"
                  " (partition by k) mq, sum(qty) over (partition by k"
                  " order by id) rs, max(x) over (partition by k order by"
                  " id rows between unbounded preceding and current row)"
                  " mx from t order by id",
    "dates": "select id, d + 30 d1, d - 7 d2, year(d) y, month(d) m,"
             " d between date '2000-06-01' and date '2001-06-01' b"
             " from t order by id",
    "in_null_kleene": "select id, k in (1, 3) i, qty is null n,"
                      " (qty > 50 and x > 0) a, (qty > 50 or x > 0) o,"
                      " not (qty > 50) ng from t order by id",
    "distinct_limit": "select distinct k, s from t order by k desc, s"
                      " limit 7",
    "self_join": "select a.id, b.id bid from t a join t b on a.k = b.k and"
                 " a.qty = b.qty where a.id < b.id order by a.id, b.id",
}


@pytest.mark.parametrize("name", sorted(SQL))
def test_sql_matches_reference(sessions, name):
    r, p = sessions
    _agree(r.sql(SQL[name]).to_arrow(), p.sql(SQL[name]).to_arrow())


def test_arrow_roundtrip_and_codes_match_reference():
    t = _table(seed=3, n=100)
    ref = ref_from_arrow(t)
    port = port_from_arrow(t, device="cpu")
    assert port.nrows == ref.nrows == 100
    assert port.plen == ref.plen == 128
    for name in t.column_names:
        rc, pc = ref[name], port[name]
        assert rc.kind == pc.kind, name
        assert np.array_equal(np.asarray(rc.data), pc.data.numpy()), name
        if rc.valid is None:
            assert pc.valid is None
        else:
            assert np.array_equal(np.asarray(rc.valid), pc.valid.numpy())
        if rc.kind == "str":
            assert list(rc.dict_values) == list(pc.dict_values)
    back = port.to_arrow()
    for name in t.column_names:
        want = t.column(name).to_pylist()
        got = back.column(name).to_pylist()
        if name == "price":
            got = [None if v is None else v.normalize() for v in got]
            want = [None if v is None else v.normalize() for v in want]
        assert got == want, name


def test_from_reference_arrays_is_bit_identical_to_from_arrow():
    t = _table(seed=5, n=77)
    ref = ref_from_arrow(t)
    cols = {n: (c.kind, np.asarray(c.data),
                None if c.valid is None else np.asarray(c.valid),
                c.dict_values) for n, c in ref.columns.items()}
    carried = from_reference_arrays(cols, ref.nrows, device="cpu")
    own = port_from_arrow(t, device="cpu")
    assert carried.nrows == own.nrows and carried.plen == own.plen
    for n in t.column_names:
        a, b = carried[n], own[n]
        assert a.kind == b.kind and a.data.dtype == b.data.dtype
        assert torch.equal(a.data, b.data), n
        assert (a.valid is None) == (b.valid is None)
        if a.valid is not None:
            assert torch.equal(a.valid, b.valid)
        if a.kind == "str":
            assert list(a.dict_values) == list(b.dict_values)
    assert carried.to_arrow().equals(own.to_arrow())


def test_session_refuses_cuda_without_a_gpu_and_big_tables(monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            PortSession()
    s = PortSession(device="cpu")
    s.conf["stream_bytes"] = "100"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        s._check_resident("big", _table(n=64))


def _ref_cols(t):
    ref = ref_from_arrow(t)
    return {n: (c.kind, np.asarray(c.data),
                None if c.valid is None else np.asarray(c.valid),
                c.dict_values) for n, c in ref.columns.items()}, ref.nrows


@pytest.mark.parametrize("builder", ["from_arrow", "DeviceTable.from_arrow",
                                     "from_reference_arrays"])
def test_table_builders_default_to_cuda(builder):
    """With no ``device`` a builder means ``cuda``: it raises without a GPU
    and never quietly builds on the host."""
    from nds_tpu_torch.engine.table import DeviceTable
    t = _table(seed=9, n=40)
    build = {
        "from_arrow": lambda: port_from_arrow(t),
        "DeviceTable.from_arrow": lambda: DeviceTable.from_arrow(t),
        "from_reference_arrays": lambda: from_reference_arrays(*_ref_cols(t)),
    }[builder]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build()
        return
    out = build()
    assert all(c.data.device.type == "cuda" for c in out.columns.values())


def test_session_refuses_a_table_off_its_device():
    host = port_from_arrow(_table(seed=3, n=40), device="cpu")
    s = PortSession(device="cpu")
    s.create_temp_view("t", host)                # same device: accepted
    assert s.sql("select count(*) from t").collect() == [(40,)]
    # a session on the card must refuse the host-built table; the check
    # reads only devices, so a cpu session re-pointed at cuda shows it
    s.device = torch.device("cuda")
    with pytest.raises(ValueError, match="lies on cpu"):
        s.create_temp_view("t2", host)
    assert "t2" not in s.catalog


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs a CUDA GPU: a cuda Session cannot exist "
                           "without one")
def test_cuda_session_refuses_a_cpu_built_table():
    host = port_from_arrow(_table(seed=3, n=40), device="cpu")
    s = PortSession(device="cuda")
    with pytest.raises(ValueError, match="lies on cpu"):
        s.create_temp_view("t", host)
    s.create_temp_view("t", port_from_arrow(_table(seed=3, n=40),
                                            device="cuda"))
    assert s.sql("select count(*) from t").collect() == [(40,)]
