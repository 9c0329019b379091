# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Parameterized plans on the port's streamed path, on the CPU.

* The harness (``nds_tpu_torch.tools.param_audit_diff``): each template in
  the ``base``, ``partitioned`` and ``sharded`` arms builds one pipeline
  and hits K-1 times over K=4 vectors (``fold-inlist`` builds K), its
  rows bit for bit those of the port with ``NDS_TPU_PARAM_BIND=0`` (the
  cache cleared per vector), of the port's resident plain-width run and of
  the reference's engine on the same tables; ``--inject-drift`` rejects
  both directions.
* K4's bound words: for every vector, the entries a bound spec takes from
  a value select the rows a fresh lowering of the same SQL selects (the
  plain version over random chunks with nulls), with opcodes and word
  count independent of the value and equal words where the opcodes agree,
  for i64, dec:2, dec:3-on-dec(7,2) and f64 slots on id, FOR and dict
  columns.
* query37 and query28 at SF0.01 with the facts streamed, over 4 vectors of
  their bindable slots: one build, the rows within ``rel_tol=1e-5``
  (doubles; everything else exact) of the reference's, and the last
  vector's bit for bit the unbound port's.
"""

import os

import numpy as np
import pytest
import torch

from nds_tpu_torch.engine import kernels as K
from nds_tpu_torch.engine import stream as S
from nds_tpu_torch.tools import param_audit_diff as D

torch.set_num_threads(1)   # tiny tensors: spare the other workers' cores


@pytest.fixture(scope="module")
def harness():
    tables = D.toy_tables(np.random.default_rng(20260117))
    return (tables, D.reference(tables, "cpu"),
            D.fresh_recording(tables, "cpu"), D.static_reports())


@pytest.fixture(scope="module")
def reference_rows(harness):
    """The reference's engine (resident, on the CPU) on the same tables."""
    from nds_tpu.engine.session import Session
    tables = harness[0]
    s = Session()
    for name, tbl in tables.items():
        s.create_temp_view(name, tbl, base=True)
    return {t["name"]: [s.sql(t["sql"](v)).collect() for v in t["vectors"]]
            for t in D.TEMPLATES}


_ARMS = {name: (conf, share) for name, conf, share in D.ARMS}
_ARM_RUNS: dict = {}


def _arm(harness, name):
    if name not in _ARM_RUNS:
        conf, share = _ARMS[name]
        _ARM_RUNS[name] = D.run_bind_arm(name, conf, share, harness[0], "cpu")
    return _ARM_RUNS[name]


@pytest.mark.parametrize("template", [t["name"] for t in D.TEMPLATES])
@pytest.mark.parametrize("arm", list(_ARMS))
def test_one_build_serves_every_vector(harness, reference_rows, arm,
                                       template):
    _tables, expect, fresh, reports = harness
    got = _arm(harness, arm)["templates"][template]
    t = next(t for t in D.TEMPLATES if t["name"] == template)
    K_ = len(t["vectors"])
    assert got["paths"] == ["compiled"] * K_
    assert got["graphs"] == ["uncaptured"] * K_
    assert got["shards"] == [2 if arm == "sharded" else 1] * K_
    assert got["rows"] == fresh[template] == expect[template] \
        == reference_rows[template]
    if t["bindable"]:
        assert (got["n_keys"], got["misses"], got["hits"]) == (1, 1, K_ - 1)
        assert reports[template].n_bindable == t["slots"]
    else:
        assert (got["n_keys"], got["misses"], got["hits"]) == (K_, K_, 0)
        assert reports[template].n_bindable == 0
    # the vectors select different rows: a baked first vector would show
    assert len({repr(r) for r in got["rows"]}) == K_
    ok, lines = D.compare(expect, fresh, _arm(harness, arm), reports, "cpu")
    assert ok, [ln for ln in lines if not ln.startswith("ok")]


def test_harness_cli_and_inject_drift(capsys):
    assert D.main(["--device", "cpu", "--inject-drift"]) == 0
    out = capsys.readouterr().out
    assert out.count("correctly rejected") == 2
    assert "both directions rejected" in out
    # without a GPU the default device refuses
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            D.main([])


def test_bind_off_bakes_every_literal(harness, monkeypatch):
    """``NDS_TPU_PARAM_BIND=0``: every vector builds its own pipeline, and
    none carries a bound slot (the behaviour before binding)."""
    from nds_tpu_torch.listener import drain_stream_events
    monkeypatch.setenv("NDS_TPU_PARAM_BIND", "0")
    s = D.make_session(harness[0], "cpu", chunked=True)
    t = D.TEMPLATES[1]
    S._PIPELINE_CACHE.clear()
    drain_stream_events()
    for v in t["vectors"]:
        s.sql(t["sql"](v)).collect()
    ev = drain_stream_events()
    assert len(S._PIPELINE_CACHE) == len(t["vectors"])
    assert all(p.param_nodes == () and (p.scan_spec is None
                                        or p.scan_spec.binds == ())
               for p in S._PIPELINE_CACHE.values())
    assert [(e.param_k4, e.param_graph, e.param_ms) for e in ev] == \
        [(0, 0, -1.0)] * len(t["vectors"])


def test_concurrent_execution_evaluates_its_own_values(harness):
    """A second execution while the static slots are held takes the eager
    drive with its own values."""
    s = D.make_session(harness[0], "cpu", chunked=True)
    t = D.TEMPLATES[0]
    S._PIPELINE_CACHE.clear()
    first = s.sql(t["sql"](t["vectors"][0])).collect()
    (pipe,) = S._PIPELINE_CACHE.values()
    assert pipe._static.lock.acquire(blocking=False)
    try:
        from nds_tpu_torch.listener import drain_stream_events
        drain_stream_events()
        busy = s.sql(t["sql"](t["vectors"][2])).collect()
        (ev,) = drain_stream_events()
        assert ev.graph == "busy: eager drive"
        assert ev.param_k4 == 1
    finally:
        pipe._static.lock.release()
    again = s.sql(t["sql"](t["vectors"][2])).collect()
    assert busy == again != first


def test_overflow_rerun_evaluates_its_own_values(harness):
    """A cached pipeline whose accumulator overflows (a ceiling of 64
    rows) reruns the statement eagerly, with that execution's values: the
    rows are the reference's for every vector."""
    from nds_tpu_torch.listener import drain_stream_events
    _tables, expect, _fresh, _reports = harness
    s = D.make_session(harness[0], "cpu", chunked=True,
                       conf={"stream_acc_rows": 64})
    t = D.TEMPLATES[1]
    S._PIPELINE_CACHE.clear()
    drain_stream_events()
    rows = [s.sql(t["sql"](v)).collect() for v in t["vectors"]]
    reasons = [e.reason for e in drain_stream_events()]
    assert rows == expect[t["name"]]
    assert reasons.count("bound-bucket overflow") >= 3, reasons
    assert len(S._PIPELINE_CACHE) == 1


def test_param_binding_context_is_scoped():
    """The planner sees a binding only inside ``param_binding``: its
    Literal arm reads the slot's scalar as an expanded view there, and
    bakes the value outside."""
    from nds_tpu_torch.engine import exprs as X
    from nds_tpu_torch.sql import ast as A
    node, other = A.Literal(5), A.Literal(5)
    scalar = torch.tensor(7, dtype=torch.int64)
    assert not X.param_bindings_active()
    assert X.bound_literal(node, 3) is None
    with X.param_binding({id(node): ("dec:2", scalar)}):
        assert X.param_bindings_active()
        col = X.bound_literal(node, 3)
        assert col.kind == "dec(38,2)" and col.data.tolist() == [7, 7, 7]
        assert col.data.data_ptr() == scalar.data_ptr()   # a view, no copy
        assert X.bound_literal(other, 3) is None
        scalar.fill_(9)
        assert col.data.tolist() == [9, 9, 9]
    assert not X.param_bindings_active()


# ------------------------------------------------------------ K4 words

def _enc(mode, base=0, values=None):
    from nds_tpu_torch.engine.column import Encoding
    return Encoding(mode, base, values)


_COLS = {
    # name: (kind, encoding mode, stored dtype)
    "i_id": ("i64", None, torch.int64),
    "i_for": ("i64", "for", torch.int16),
    "i_dict": ("i64", "dict", torch.int16),
    "d_id": ("dec(7,2)", None, torch.int64),
    "d_for": ("dec(7,2)", "for", torch.int32),
    "d_dict": ("dec(7,2)", "dict", torch.int16),
    "f_id": ("f64", None, torch.float64),
}
_DICT = np.asarray([-250, -3, 0, 7, 40, 41, 99, 1000, 12_345], np.int64)


def _column(name, rng, n):
    """(cols_meta entry without slots, data tensor, valid tensor)."""
    kind, mode, dtype = _COLS[name]
    if mode == "dict":
        data = torch.as_tensor(rng.integers(0, len(_DICT), n), dtype=dtype)
        enc = _enc("dict", 0, _DICT)
    elif mode == "for":
        data = torch.as_tensor(rng.integers(0, 200, n), dtype=dtype)
        enc = _enc("for", -150)
    elif kind == "f64":
        data = torch.as_tensor(rng.integers(-40, 80, n) / 8.0,
                               dtype=dtype)
        enc = None
    else:
        data = torch.as_tensor(rng.integers(-20, 60, n), dtype=dtype)
        enc = None
    valid = torch.as_tensor(rng.random(n) > 0.1)
    return {"name": f"l.{name}", "kind": kind, "enc": enc,
            "dict_values": None}, data, valid


# (column, SQL shape with {} per slot, K=4 vectors of literal texts)
_WORD_CASES = [
    (c, shape, vecs)
    for c in ("i_id", "i_for", "i_dict")
    for shape, vecs in (
        ("{c} = {}", (("7",), ("8",), ("0",), ("4611686018427387904",))),
        ("{c} <> {}", (("41",), ("42",), ("0",), ("1000",))),
        ("{c} < {}", (("7",), ("0",), ("12346",), ("2",))),
        ("{c} >= {}", (("7",), ("99",), ("4611686018427387904",), ("1",))),
        ("{c} between {} and {}", (("0", "40"), ("41", "41"), ("42", "7"),
                                   ("1", "4611686018427387904"))),
        ("{c} = {}", (("7.00",), ("7.50",), ("40.00",), ("0.01",))),
        ("{c} not between {} and {}", (("1.5", "40.25"), ("0.0", "0.0"),
                                       ("7.0", "7.0"), ("99.9", "1000.1"))),
        ("{c} > {}", (("6.5e0",), ("40e0",), ("0e0",), ("1e300",))),
        ("{c} between {} and {}", (("0", "40.5e0"), ("7", "1e300"),
                                   ("99", "0e0"), ("2", "41e0"))),
    )
] + [
    (c, shape, vecs)
    for c in ("d_id", "d_for", "d_dict")
    for shape, vecs in (
        ("{c} = {}", (("0.07",), ("0.40",), ("123.45",), ("0.41",))),
        ("{c} <> {}", (("0.07",), ("0.08",), ("0.00",), ("10.00",))),
        ("{c} <= {}", (("0.40",), ("0.41",), ("0.00",), ("123.45",))),
        ("{c} = {}", (("0.070",), ("0.075",), ("0.400",), ("0.001",))),
        ("{c} > {}", (("0.405",), ("0.999",), ("123.449",), ("0.000",))),
        ("{c} between {} and {}", (("0.005", "0.995"), ("0.070", "0.070"),
                                   ("0.071", "0.409"), ("1.000", "0.000"))),
        ("{c} between {} and {}", (("0", "1"), ("2", "2"), ("1", "0"),
                                   ("3", "123"))),
        ("{c} >= {}", (("0.07e0",), ("0.4e0",), ("1e300",), ("2.5e0",))),
    )
] + [
    ("f_id", shape, vecs)
    for shape, vecs in (
        ("{c} = {}", (("2.5e0",), ("7e0",), ("0.125e0",), ("1e300",))),
        ("{c} < {}", (("2",), ("0",), ("37",), ("4611686018427387904",))),
        ("{c} between {} and {}", (("0.25", "2.50"), ("1.00", "1.00"),
                                   ("3.75", "1.25"), ("0.00", "9.99"))),
        ("{c} not between {} and {}", (("0.25", "2.00"), ("1.00", "1.00"),
                                       ("3.00", "0.00"), ("0.00", "30.00"))),
    )
]


def _where(shape, col, vals):
    return shape.format(*vals, c=col)


@pytest.mark.parametrize("case", range(len(_WORD_CASES)))
def test_bound_k4_words_select_what_fresh_lowering_selects(case):
    from nds_tpu_torch.analysis import param_audit as PA
    from nds_tpu_torch.engine import exprs as X
    from nds_tpu_torch.sql import parser as PP
    col, shape, vecs = _WORD_CASES[case]
    rng = np.random.default_rng(case)
    n = 512
    meta, data, valid = _column(col, rng, n)
    meta.update(data_slot=0, valid_slot=1)
    # the dict table's own values appear in the data: every code is live
    flat = (data, valid)
    nd = torch.tensor(n - 9, dtype=torch.int64)

    def conj(vals):
        text = _where(shape, col, vals)
        return PP.parse(f"select 1 from l where {text}").body.where

    def lower(c, bound=None):
        spec, kept = X.lower_scan_spec([c], [dict(meta)], lambda _c: True,
                                       bound)
        assert kept == [] and spec is not None
        return spec

    build = conj(vecs[0])
    slots = PA.conjunct_bind_slots(build, True, False)
    assert len(slots) == shape.count("{}")
    spec = lower(build, {id(nd_): k for k, (_p, nd_, _t)
                         in enumerate(slots)})
    assert {k for (_i, _f, k, _m) in spec.binds} == set(range(len(slots)))
    words0, lay = K.packed_scan_spec(spec)
    kinds = [e[0] for e in spec.entries]
    for vals in vecs:
        c = conj(vals)
        values = [nd_.value for (_p, nd_, _t)
                  in PA.conjunct_bind_slots(c, True, False)]
        entries = K.bind_scan_entries(spec, values)
        words = K.bind_scan_words(spec, entries)
        # the shape of the spec never depends on the value
        assert [e[0] for e in entries] == kinds
        assert len(words) == lay.off_cols
        full = words0.copy()
        full[:lay.off_cols] = words
        assert len(full) == lay.total
        fresh = lower(c)
        m_fresh, _ = K.chunk_scan_plain(flat, nd, fresh)
        m_bound, _ = K.chunk_scan_plain(flat, nd, spec, entries)
        assert torch.equal(m_bound, m_fresh), (vals, entries, fresh.entries)
        # the kernel's input: the words a reader decodes give these rows
        from tests.test_torch_scan import _read_packed
        read, _cols = _read_packed(full, lay)
        m_read, _ = K.chunk_scan_plain(flat, nd, spec, tuple(read))
        assert torch.equal(m_read, m_fresh)
        if [e[0] for e in fresh.entries] == kinds:
            fw, flay = K.pack_scan_spec(fresh)
            assert flay == lay
            np.testing.assert_array_equal(fw, full)


def test_word_cases_select_some_rows_and_drop_others():
    """The cases are not trivial: over the vectors of each case some rows
    survive and some do not."""
    from nds_tpu_torch.engine import exprs as X
    from nds_tpu_torch.sql import parser as PP
    for case, (col, shape, vecs) in enumerate(_WORD_CASES):
        meta, data, valid = _column(col, np.random.default_rng(case), 512)
        meta.update(data_slot=0, valid_slot=1)
        counts = set()
        for vals in vecs:
            c = PP.parse("select 1 from l where "
                         + _where(shape, col, vals)).body.where
            spec, _ = X.lower_scan_spec([c], [meta], lambda _c: True)
            m, _ = K.chunk_scan_plain((data, valid),
                                      torch.tensor(503), spec)
            counts.add(int(m.sum()))
        assert len(counts) > 1 and max(counts) > 0, (col, shape, counts)


# ----------------------------------------------------- query37, query28

_SF = ".bench_cache/sf0.01"
_QUERIES = ("query37", "query28")
# the streamed facts and their chunk rows (each at least two chunks)
_STREAMED = {"inventory": 131_072, "store_sales": 16_384}


@pytest.fixture(scope="module")
def sf001():
    from tools.coverage_sweep import ensure_data
    from nds_tpu.engine.session import Session as RefSession
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.engine.table import ChunkedTable
    from nds_tpu_torch.io import read_raw_table
    from nds_tpu_torch.schema import get_schemas
    data = ensure_data()
    schemas = get_schemas(use_decimal=True)
    port = {"on": Session(device="cpu"), "off": Session(device="cpu")}
    ref = RefSession()
    from nds_tpu.schema import get_schemas as ref_schemas
    rs = ref_schemas(use_decimal=True)
    for name in ("item", "inventory", "date_dim", "catalog_sales",
                 "store_sales"):
        path = os.path.join(data, f"{name}.dat")
        arrow = read_raw_table(path, schemas[name])
        for s in port.values():
            if name in _STREAMED:
                s.create_temp_view(name, ChunkedTable(
                    arrow, {f.name: f.type for f in schemas[name]},
                    _STREAMED[name]), base=True)
            else:
                s.create_temp_view(name, arrow, base=True)
        ref.read_raw_view(name, path, rs[name])
    return port, ref


@pytest.mark.parametrize("qname", _QUERIES)
def test_streamed_statement_over_four_vectors(sf001, qname, monkeypatch):
    from tests.test_torch_slice import tables_agree
    from nds_tpu_torch.listener import drain_stream_events
    port, ref = sf001
    _sql, slots, texts = D.statement_vectors(qname)
    assert len(texts) == 4 and len(set(texts)) == 4
    S._PIPELINE_CACHE.clear()
    drain_stream_events()
    bound = [port["on"].sql(t).to_arrow() for t in texts]
    ev = drain_stream_events()
    scans = len(ev) // 4
    assert len(S._PIPELINE_CACHE) == scans      # one build per scan
    assert all(e.path == "compiled" and e.chunks >= 2 for e in ev)
    assert sum(e.param_k4 + e.param_graph for e in ev[:scans]) == \
        len(slots)
    for t, got in zip(texts, bound):
        why = tables_agree(ref.sql(t).to_arrow(), got)
        assert why is None, why
    # the last vector bit for bit as a fresh recording (binding off)
    monkeypatch.setenv("NDS_TPU_PARAM_BIND", "0")
    S._PIPELINE_CACHE.clear()
    assert port["off"].sql(texts[-1]).to_arrow().equals(bound[-1])
    # the vectors do not all give the same rows
    assert len({repr(b.to_pylist()) for b in bound}) > 1
