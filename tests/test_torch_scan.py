# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The streamed path's kernels in the torch port (K4 ``chunk_scan``, K5
``join_probe``) against the reference, bit for bit: the port's plain
versions (what a CPU tensor takes) against ``nds_tpu.engine.kernels``'
``scan_reference``, the interpret-mode Pallas ``fused_chunk_scan``,
``probe_reference``, the interpret-mode ``fused_probe`` and the reference's
own stream-bounds ``ops._probe_candidates``; and the port's
``lower_scan_spec`` against the reference's on the same parsed conjuncts.
The CUDA kernels themselves run only on a GPU
(``tests/test_torch_gpu.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nds_tpu.engine import kernels as RK
from nds_tpu_torch.engine import kernels as K
from tests.test_torch_gpu import _SCAN_CASES, _probe_case, _scan_case, _t

torch.set_num_threads(1)   # tiny tensors: spare the other workers' cores


def _j(a):
    return None if a is None else jnp.asarray(a)


def _both_specs(entries, cols, tables=(), key_slots=()):
    return (RK.ScanSpec(entries, cols, tables=tables, key_slots=key_slots),
            K.ScanSpec(entries, cols, tables=tables, key_slots=key_slots))


@pytest.mark.parametrize("name", _SCAN_CASES)
def test_chunk_scan_plain_matches_reference(name):
    bufs, n, entries, cols, tables, key_slots = _scan_case(name)
    rspec, pspec = _both_specs(entries, cols, tables, key_slots)
    jflat = tuple(_j(b) for b in bufs)
    nd = jnp.asarray(n, dtype=jnp.int64)
    m_ref, h_ref = RK.scan_reference(jflat, nd, rspec)
    m_pal, h_pal = RK.fused_chunk_scan(jflat, nd, rspec, interpret=True)
    m, h = K.chunk_scan(tuple(None if b is None else _t(b) for b in bufs),
                        torch.tensor(n, dtype=torch.int64), pspec)
    assert m.dtype == torch.bool
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_pal))
    if not key_slots:
        assert h is None and h_ref is None
        return
    assert h.dtype == torch.int32
    np.testing.assert_array_equal(h.numpy().view(np.uint32),
                                  np.asarray(h_ref))
    np.testing.assert_array_equal(h.numpy().view(np.uint32),
                                  np.asarray(h_pal))


def test_chunk_scan_cases_are_not_trivial():
    """The rich case keeps some rows and drops others (a mask of all True
    or all False would not test the entries)."""
    bufs, n, entries, cols, tables, key_slots = _scan_case(
        "rich_predicates")
    _r, pspec = _both_specs(entries[:4], cols, tables, key_slots)
    m, _h = K.chunk_scan(tuple(None if b is None else _t(b) for b in bufs),
                         torch.tensor(n, dtype=torch.int64), pspec)
    assert 0 < int(m.sum()) < n


_EVERY_KIND = [("false", 0), ("true", 1), ("isnull", 0), ("notnull", 1),
               ("ieq", 0, 5), ("ine", 0, -5), ("ile", 0, 2 ** 70),
               ("ige", 0, -2 ** 70), ("irange", 0, 1, 9),
               ("nrange", 0, 3, 4), ("iin", 0, (1, 2, 3)),
               ("inotin", 0, (7,)), ("feq", 1, 0.5), ("fne", 1, -0.0),
               ("flt", 1, 1.5), ("fle", 1, 2.5), ("fgt", 1, 3.5),
               ("fge", 1, 4.5), ("fin", 1, (0.25, 0.75)),
               ("fnotin", 1, (9.0,)), ("frange", 1, 1.0, 2.0),
               ("fnrange", 1, -1.0, 1.0)]
_OP_NAMES = {v: k for k, v in K._SCAN_OPS.items()}
_FMODE_NAMES = {v: k for k, v in K._FMODES.items()}


def _f64(bits):
    return float(np.asarray(bits, dtype=np.int64).view(np.float64))


def _read_packed(words, lay):
    """A reader of the packed layout that knows only its word format:
    (entries, [(fmode, base, table or None, sdiv)]) as the spec gave
    them (thresholds clamped to int64)."""
    assert lay.total == len(words)
    ent = words[:lay.off_cols].reshape(-1, K.SCAN_ENT_WORDS)
    cols = words[lay.off_cols:lay.off_ivals].reshape(-1, K.SCAN_COL_WORDS)
    iv = words[lay.off_ivals:lay.off_fvals]
    fv = words[lay.off_fvals:lay.off_tables]
    tb = words[lay.off_tables:]
    assert len(ent) == lay.nentries and len(cols) == lay.ncols
    entries = []
    for op, ci, a, b, fa, fb, off, ln in ent.tolist():
        kind = _OP_NAMES[op]
        if kind in ("iin", "inotin"):
            entries.append((kind, ci, tuple(iv[off:off + ln].tolist())))
        elif kind in ("fin", "fnotin"):
            entries.append((kind, ci, tuple(_f64(x) for x in
                                            fv[off:off + ln])))
        elif kind in ("frange", "fnrange"):
            entries.append((kind, ci, _f64(fa), _f64(fb)))
        elif kind[0] == "f" and kind != "false":
            entries.append((kind, ci, _f64(fa)))
        elif kind in ("irange", "nrange"):
            entries.append((kind, ci, a, b))
        elif kind in ("ieq", "ine", "ile", "ige"):
            entries.append((kind, ci, a))
        else:
            entries.append((kind, ci))
    out_cols = [(_FMODE_NAMES[fm], base, tb[off:off + ln].tolist()
                 if _FMODE_NAMES[fm] == "dict" else None, _f64(sd))
                for fm, base, sd, off, ln in cols.tolist()]
    return entries, out_cols


def _as_packed(spec):
    """The spec as :func:`_read_packed` gives it back."""
    def clamp(v):
        return max(min(int(v), (1 << 63) - 1), -(1 << 63))
    entries = []
    for e in spec.entries:
        kind = e[0]
        if kind in ("iin", "inotin"):
            entries.append((kind, e[1], tuple(clamp(v) for v in e[2])))
        elif kind in ("fin", "fnotin"):
            entries.append((kind, e[1], tuple(float(v) for v in e[2])))
        elif kind[0] == "f" and kind != "false":
            entries.append((kind, e[1], *(float(v) for v in e[2:])))
        else:
            entries.append((kind, e[1], *(clamp(v) for v in e[2:])))
    cols = [(fm, int(base), np.asarray(spec.tables[tbl]).tolist()
             if fm == "dict" else None, float(sd))
            for (_d, _v, fm, base, tbl, sd) in spec.cols]
    return entries, cols


def _bitwise(x):
    """Floats by their bits (so -0.0 and NaN compare exactly)."""
    if isinstance(x, float):
        return ("f", int(np.asarray(x).view(np.int64)))
    if isinstance(x, (tuple, list)):
        return tuple(_bitwise(v) for v in x)
    return x


def test_scan_blob_flattens_every_entry_kind():
    """The spec the CUDA kernel reads: one row of (op, column, a, b, fa
    bits, fb bits, offset, length) per entry, whatever the kind (a
    ``false`` entry included, which carries no operand), then the column
    rows, the int and the float IN-lists, the tables."""
    spec = K.ScanSpec(_EVERY_KIND, [(0, -1, "id", 0, -1, 1.0),
                                    (2, 3, "for", 10, -1, 100.0)])
    words, lay = K.packed_scan_spec(spec)
    # packed once a spec, uploaded once a device
    assert K.packed_scan_spec(spec)[0] is words
    blob = K._scan_blob(spec, torch.device("cpu"))
    assert K._scan_blob(spec, torch.device("cpu")) is blob
    assert blob.tolist() == words.tolist()
    ent = words[:lay.off_cols].reshape(-1, 8).tolist()
    big = (1 << 63) - 1
    assert lay == K.ScanLayout(22, 2, 176, 186, 190, 193, 193)
    assert [r[0] for r in ent] == list(range(22))
    assert [r[1] for r in ent] == [e[1] for e in _EVERY_KIND]
    assert [r[2:4] for r in ent[4:10]] == [
        [5, 0], [-5, 0], [big, 0], [-big - 1, 0], [1, 9], [3, 4]]
    assert [r[6:] for r in ent[10:12]] == [[0, 3], [3, 1]]
    assert words[lay.off_ivals:lay.off_fvals].tolist() == [1, 2, 3, 7]
    assert [r[6:] for r in ent[18:20]] == [[0, 2], [2, 1]]
    assert words[lay.off_fvals:lay.off_tables].view(np.float64).tolist() \
        == [0.25, 0.75, 9.0]
    fent = words[:lay.off_cols].reshape(-1, 8)[:, 4:6].copy().view(
        np.float64).tolist()
    assert fent[12:18] == [[0.5, 0.0], [-0.0, 0.0], [1.5, 0.0],
                           [2.5, 0.0], [3.5, 0.0], [4.5, 0.0]]
    assert np.signbit(fent[13][0])
    assert fent[20:] == [[1.0, 2.0], [-1.0, 1.0]]
    assert all(r[2:] == [0] * 6 for r in ent[:4])
    assert fent[:12] == [[0.0, 0.0]] * 12
    cols = words[lay.off_cols:lay.off_ivals].reshape(-1, 5)
    assert cols[:, [0, 1, 3, 4]].tolist() == [[0, 0, 0, 0], [1, 10, 0, 0]]
    assert cols[:, 2].copy().view(np.float64).tolist() == [1.0, 100.0]


@pytest.mark.parametrize("name", _SCAN_CASES + ["every_kind"])
def test_packed_spec_reads_back(name):
    """A reader that knows only the packed word format gives back every
    entry, column decode and dict table of the spec."""
    if name == "every_kind":
        spec = K.ScanSpec(_EVERY_KIND, [
            (0, -1, "id", 0, -1, 1.0), (2, 3, "dict", 0, 1, 100.0)],
            tables=(np.asarray([5, 6], np.int64),
                    np.asarray([-1, 0, 1 << 50], np.int64)))
    else:
        _b, _n, entries, cols, tables, key_slots = _scan_case(name)
        spec = K.ScanSpec(entries, cols, tables=tables, key_slots=key_slots)
    words, lay = K.pack_scan_spec(spec)
    assert words.dtype == np.int64
    assert _bitwise(_read_packed(words, lay)) == _bitwise(_as_packed(spec))


def _eval_packed(words, lay, datas, valids, n_dev):
    """The survivor mask computed from the packed words alone, entry by
    entry as the kernel reads them."""
    ent = words[:lay.off_cols].reshape(-1, K.SCAN_ENT_WORDS)
    cols = words[lay.off_cols:lay.off_ivals].reshape(-1, K.SCAN_COL_WORDS)
    iv = words[lay.off_ivals:lay.off_fvals]
    fv = words[lay.off_fvals:lay.off_tables].view(np.float64)
    tb = words[lay.off_tables:]
    plen = len(datas[0])
    m = np.ones(plen, dtype=bool)
    for op, ci, a, b, fa, fb, off, ln in ent.tolist():
        kind = _OP_NAMES[op]
        v = np.ones(plen, dtype=bool) if valids[ci] is None else valids[ci]
        if kind == "false":
            m[:] = False
            continue
        if kind in ("true", "notnull", "isnull"):
            m &= ~v if kind == "isnull" else v
            continue
        with np.errstate(invalid="ignore"):   # NaN rows of a float lane
            x = datas[ci].astype(np.int64)
        if op <= K._SCAN_OPS["inotin"]:
            hit = np.isin(x, iv[off:off + ln])
            c = {"ieq": x == a, "ine": x != a, "ile": x <= a, "ige": x >= a,
                 "irange": (x >= a) & (x <= b),
                 "nrange": ~((x >= a) & (x <= b)), "iin": hit,
                 "inotin": ~hit}[kind]
        else:
            fm, base, sd, toff, tlen = cols[ci].tolist()
            fmode = _FMODE_NAMES[fm]
            if fmode == "for":
                val = (x + np.int64(base)).astype(np.float64)
            elif fmode == "dict":
                val = tb[toff + np.clip(x, 0, tlen - 1)].astype(np.float64)
            else:
                val = datas[ci].astype(np.float64)
            if _f64(sd) != 1.0:
                val = val / _f64(sd)
            L, H = _f64(fa), _f64(fb)
            with np.errstate(invalid="ignore"):
                hit = (val[:, None] == fv[None, off:off + ln]).any(axis=1)
                c = {"feq": val == L, "fne": val != L, "flt": val < L,
                     "fle": val <= L, "fgt": val > L, "fge": val >= L,
                     "frange": (val >= L) & (val <= H),
                     "fnrange": ~((val >= L) & (val <= H)), "fin": hit,
                     "fnotin": ~hit}[kind]
        m &= c & v
    return m & (np.arange(plen) < n_dev)


@pytest.mark.parametrize("name", _SCAN_CASES)
def test_packed_spec_evaluates_like_plain(name):
    """The packed words alone (IN-list offsets from their region, table
    offsets from theirs, divisor bits) give the plain version's mask."""
    bufs, n, entries, cols, tables, key_slots = _scan_case(name)
    spec = K.ScanSpec(entries, cols, tables=tables, key_slots=key_slots)
    words, lay = K.pack_scan_spec(spec)
    datas = [bufs[c[0]] for c in cols]
    valids = [None if c[1] < 0 else bufs[c[1]] for c in cols]
    want, _h = K.chunk_scan_plain(
        tuple(None if b is None else _t(b) for b in bufs),
        torch.tensor(n, dtype=torch.int64), spec)
    np.testing.assert_array_equal(_eval_packed(words, lay, datas, valids, n),
                                  want.numpy())


def _dict_spec(table_len, in_list=0):
    return K.ScanSpec(
        [("fge", 0, 1.0), ("iin", 0, tuple(range(in_list)))],
        [(0, -1, "dict", 0, 0, 1.0)],
        tables=(np.arange(table_len, dtype=np.int64),))


def test_staged_words_at_the_edge_of_the_budget():
    """A block stages whole regions while they fit 48 KB with the
    kernel's static records: the dict table up to the last word, then only
    what comes before it (also where the words alone would fit 48 KB); an
    IN-list past the budget leaves entries and columns; entries past it
    stage nothing."""
    assert K.SCAN_SMEM_BUDGET + K.SCAN_STATIC_SMEM == 48 * 1024
    budget_words = K.SCAN_SMEM_BUDGET // 8
    head = K.pack_scan_spec(_dict_spec(0))[1].total       # words but table
    fits = K.pack_scan_spec(_dict_spec(budget_words - head))[1]
    assert fits.total == budget_words
    assert K.scan_staged_words(fits) == fits.total
    over = K.pack_scan_spec(_dict_spec(budget_words - head + 1))[1]
    assert K.scan_staged_words(over) == over.off_tables < over.total
    for words in (budget_words + 72, 48 * 1024 // 8):
        mid = K.pack_scan_spec(_dict_spec(words - head))[1]
        assert mid.total == words
        assert K.scan_staged_words(mid) == mid.off_tables
    lists = K.pack_scan_spec(_dict_spec(4, in_list=budget_words))[1]
    assert K.scan_staged_words(lists) == lists.off_ivals
    assert K.scan_staged_words(lists, budget=8 * lists.off_cols - 8) == 0
    plan = K.scan_plan(1 << 22, _dict_spec(budget_words - head + 1), 132)
    assert (plan.staged, plan.smem) == (over.off_tables,
                                        8 * over.off_tables)


def test_scan_plan_rule():
    spec = _dict_spec(16)
    full = K.scan_plan(1 << 22, spec, 132)
    assert full.threads == K.SCAN_THREADS
    assert full.grid == 132 * K.SCAN_PER_SM       # persistent grid
    assert full.smem == 8 * full.staged == 8 * K.pack_scan_spec(spec)[1].total
    # no more blocks than the tiles fill
    small = K.scan_plan(5000, spec, 132)
    assert small.grid == -(-(-(-5000 // K.SCAN_ROWS)) // K.SCAN_THREADS)
    assert K.scan_plan(1, spec, 132).grid == 1
    assert K.scan_plan(0, spec, 132).grid == 0
    # the threads an SM cap the blocks, and so does the staged spec
    assert K.scan_plan(1 << 24, spec, 132, per_sm=16).grid == 132 * 8
    big = _dict_spec(K.SCAN_SMEM_BUDGET // 8 - 40)
    assert K.scan_plan(1 << 24, big, 132, per_sm=8).grid == 132 * (
        K.SMEM_SM // (K.scan_plan(1, big).smem + K.SCAN_STATIC_SMEM
                      + K.SMEM_RESERVED))
    with pytest.raises(ValueError):
        K.scan_plan(100, spec, 132, threads=512)
    with pytest.raises(ValueError):
        K.scan_plan(100, spec, 132, threads=100)


def test_scan_plans_cover_every_tile_size():
    """The sweep's plans: the card's own among them, each distinct, 256-
    and 128-thread blocks, and no grid past the tiles of ``SCAN_ROWS``
    rows that the chunk holds."""
    spec = _dict_spec(16)
    plen = 1 << 22
    plans = K.scan_plans(plen, spec, 132)
    assert K.scan_plan(plen, spec, 132) in plans
    assert len(set(plans)) == len(plans)
    assert {p.threads for p in plans} == {256, 128}
    assert all(1 <= p.grid <= -(-(plen // K.SCAN_ROWS) // p.threads)
               and p.smem == 8 * p.staged for p in plans)
    small = K.scan_plans(K.SCAN_ROWS * 128 + 1, spec, 132)
    assert {p.grid for p in small} == {1, 2}


def test_hash_mix_matches_reference_partition_pass():
    rng = np.random.default_rng(5)
    d = rng.integers(-(1 << 62), 1 << 62, 4096).astype(np.int64)
    f = rng.standard_normal(4096)
    ref = RK._fold_hash([jnp.asarray(d), jnp.asarray(f)])
    got = K.fold_hash([_t(d), _t(f)])
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(ref))


# ------------------------------------------------ scan-spec lowering


_LOWERING_WHERE = [
    "l_cat = 'beta'", "l_cat <> 'omega'", "l_price between 100 and 5000",
    "l_key in (1, 2, 3, 499)", "l_key not in (7, 9)", "l_price > 50",
    "l_qty is null", "l_qty is not null", "l_price > 2500.5",
    "l_cat not in ('omega', 'zeta')", "l_key not in (2.5, 3.5)",
    "l_price between 100.5 and 5000", "l_price not between 100 and 5000",
    "l_date >= date '2000-01-03'",
    "l_date between '2000-01-01' and '2000-03-01'", "l_wide = 1000000000000",
    "l_wide <= 1500000000000", "l_key = l_price", "l_key + 1 > 3",
    "l_cat like 'a%'", "l_key in (1, null)", "l_key not in (1, null)",
    "5 < l_key", "l_qty = 3", "l_key is not null",
]


# conjuncts on a decimal column: the reference's lowering raises NameError
# on them (nds_tpu/engine/exprs.py uses dec_scale without importing it) and
# its except turns that into "no fused pass"; the port lowers them, and
# test_torch_stream.py holds their results against the resident engines
_DECIMAL_WHERE = ["l_amt >= 12.34", "l_amt < 7",
                  "l_amt in (1.25, 3.5, 2.125)", "l_amt between 1 and 99.99",
                  "l_amt > 2500.5"]


def _lowering_cols(enc_cls):
    """cols_meta of a chunk (both packages describe it identically)."""
    cats = np.asarray(["alpha", "beta", "delta", "gamma"], dtype=object)

    def meta(i, name, kind, enc=None, dv=None, valid=True):
        return {"name": f"l.{name}", "kind": kind, "enc": enc,
                "dict_values": dv, "data_slot": 2 * i,
                "valid_slot": 2 * i + 1 if valid else -1}
    return [
        meta(0, "l_key", "i64", enc_cls("for", 1, None), valid=False),
        meta(1, "l_cat", "str", dv=cats),
        meta(2, "l_qty", "f64"),
        meta(3, "l_price", "i64", enc_cls("for", 3, None)),
        meta(4, "l_amt", "dec(7,2)", enc_cls("for", -250, None)),
        meta(5, "l_date", "date", enc_cls("for", 10950, None)),
        meta(6, "l_wide", "i64", enc_cls(
            "dict", 0, np.asarray([10 ** 12, 2 * 10 ** 12], np.int64))),
    ]


def test_lower_scan_spec_matches_reference():
    from nds_tpu.engine import exprs as RX
    from nds_tpu.engine.column import Encoding as REnc
    from nds_tpu.sql import parser as RP
    from nds_tpu_torch.engine import exprs as PX
    from nds_tpu_torch.engine.column import Encoding as PEnc
    from nds_tpu_torch.sql import parser as PP

    def conjuncts(parse):
        stmt = parse("select 1 from l where " + " and ".join(
            f"({w})" for w in _LOWERING_WHERE))
        out, e = [], stmt.body.where
        while hasattr(e, "op") and e.op == "and":
            out.append(e.right)
            e = e.left
        out.append(e)
        return out[::-1]

    rconj, pconj = conjuncts(RP.parse), conjuncts(PP.parse)
    assert len(rconj) == len(_LOWERING_WHERE)
    rspec, rkept = RX.lower_scan_spec(rconj, _lowering_cols(REnc),
                                      lambda c: True)
    pspec, pkept = PX.lower_scan_spec(pconj, _lowering_cols(PEnc),
                                      lambda c: True)
    assert pspec.entries == rspec.entries
    assert pspec.n_conjuncts == rspec.n_conjuncts
    assert pspec.cols == rspec.cols
    assert len(pspec.tables) == len(rspec.tables)
    for a, b in zip(pspec.tables, rspec.tables):
        np.testing.assert_array_equal(a, b)
    assert [PP.expr_key(c) for c in pkept] == \
        [RP.expr_key(c) for c in rkept]
    # the lowering splits: some conjuncts lower, some stay in the graph
    assert 0 < len(pkept) < len(pconj)
    assert pspec.n_conjuncts == len(pconj) - len(pkept)


def test_lower_scan_spec_lowers_decimal_conjuncts():
    from nds_tpu_torch.engine import exprs as PX
    from nds_tpu_torch.engine.column import Encoding as PEnc
    from nds_tpu_torch.sql import parser as PP
    conj = [PP.parse("select 1 from l where " + w).body.where
            for w in _DECIMAL_WHERE]
    spec, kept = PX.lower_scan_spec(conj, _lowering_cols(PEnc),
                                    lambda c: True)
    assert kept == [] and spec.n_conjuncts == len(_DECIMAL_WHERE)
    assert spec.entries[:2] == (("ige", 0, 1484), ("ile", 0, 949))
    assert spec.entries[-1] == ("ige", 0, 250301)   # 2500.51 and up


# ------------------------------------------------------------- K5


@pytest.mark.parametrize("n,r,nkeys,n_valid", [
    (600, 200, 1, 580), (1024, 40_000, 1, 1000), (900, 5000, 2, 900),
    (512, 1, 1, 300)])
def test_join_probe_plain_matches_reference(n, r, nkeys, n_valid):
    from nds_tpu.engine import ops as RO
    from nds_tpu_torch.engine import ops as PO
    lk, lv, excl, rk, rv = _probe_case(n, r, nkeys, n + r)
    r_live = r - r // 7
    rh = RO._key_hash_impl(tuple(_j(x) for x in rk),
                           tuple(_j(x) for x in rv), 1, False, r_live, None)
    rh_sorted = jnp.sort(rh)
    ph = PO.unsigned_order(PO._key_hash_impl(
        tuple(_t(x) for x in rk), tuple(None if x is None else _t(x)
                                        for x in rv), 1, False, r_live,
        None))
    ph_sorted = torch.sort(ph).values
    np.testing.assert_array_equal(
        (ph_sorted.numpy() ^ np.int64(-1 << 63)).view(np.uint64),
        np.asarray(rh_sorted))
    views = tuple(_j(x) for x in lk)
    valids = tuple(_j(x) for x in lv)
    c_ref, lo_ref = RK.probe_reference(views, valids, n_valid, _j(excl),
                                       rh_sorted)
    c_pal, lo_pal = RK.fused_probe(views, valids,
                                   jnp.asarray(n_valid, dtype=jnp.int64),
                                   _j(excl), rh_sorted, interpret=True)
    c, lo = K.join_probe(tuple(_t(x) for x in lk),
                         tuple(None if x is None else _t(x) for x in lv),
                         torch.tensor(n_valid, dtype=torch.int64),
                         _t(excl), ph_sorted)
    for want_c, want_lo in ((c_ref, lo_ref), (c_pal, lo_pal)):
        np.testing.assert_array_equal(c.numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(lo.numpy(), np.asarray(want_lo))
    assert int(c.sum()) > 0


@pytest.mark.parametrize("r", [300, 40_000])
def test_probe_candidates_under_stream_bounds_match_reference(r):
    """The port's stream-bounds probe (K5's seam) against the reference's
    own ``_probe_candidates`` in a stream-bounds region: counts, starts
    and the build-side order, with null keys, pad rows on both sides and
    an exclusion mask."""
    from nds_tpu.engine import ops as RO
    from nds_tpu.engine.column import Column as RC
    from nds_tpu_torch.engine import ops as PO
    from nds_tpu_torch.engine.column import Column as PC
    n = 2048
    lk, lv, excl, rk, rv = _probe_case(n, r, 1, r)
    rl = [RC("i64", jnp.asarray(lk[0]), jnp.asarray(lv[0]))]
    rr = [RC("i64", jnp.asarray(rk[0]))]
    pl = [PC("i64", _t(lk[0]), _t(lv[0]))]
    pr = [PC("i64", _t(rk[0]))]
    with RO.stream_bounds():
        want = RO._probe_candidates(rl, rr, False, 2000, r - 3,
                                    jnp.asarray(excl), None)
    calls = []
    real = K.join_probe

    def counting(*a):
        calls.append(1)
        return real(*a)

    K.join_probe = counting
    try:
        with PO.stream_bounds():
            got = PO._probe_candidates(pl, pr, False, 2000, r - 3,
                                       _t(excl), None)
    finally:
        K.join_probe = real
    assert calls == [1]
    assert want[3] is None and got[3] is None
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_string_lowering_looks_codes_up_in_an_unsorted_dictionary():
    """Whole-table string dictionaries keep first-appearance order, so the
    lowering must look a literal's code up (a bisect, which assumes a
    sorted table, finds no or a wrong code there)."""
    from nds_tpu_torch.engine import exprs as PX
    from nds_tpu_torch.sql import parser as PP
    dv = np.asarray(["gamma", "beta", "alpha", "delta"], dtype=object)
    meta = [{"name": "l.l_cat", "kind": "str", "enc": None,
             "dict_values": dv, "data_slot": 0, "valid_slot": 1}]
    want = {"l_cat = 'beta'": ("ieq", 0, 1),
            "l_cat <> 'alpha'": ("ine", 0, 2),
            "l_cat = 'omega'": ("false", 0),
            "l_cat <> 'omega'": ("true", 0),
            "l_cat in ('delta', 'zeta', 'gamma')": ("iin", 0, (3, 0)),
            "l_cat not in ('alpha')": ("inotin", 0, (2,))}
    for w, ent in want.items():
        c = PP.parse("select 1 from l where " + w).body.where
        spec, kept = PX.lower_scan_spec([c], meta, lambda c: True)
        assert kept == [] and spec.entries == (ent,), w
    codes = torch.tensor([0, 1, 2, 3, 1, 0], dtype=torch.int32)
    valid = torch.tensor([True, True, True, True, False, True])
    spec, _ = PX.lower_scan_spec(
        [PP.parse("select 1 from l where l_cat = 'beta'").body.where],
        meta, lambda c: True)
    m, _h = K.chunk_scan((codes, valid), torch.tensor(6), spec)
    assert m.tolist() == [False, True, False, False, False, False]
