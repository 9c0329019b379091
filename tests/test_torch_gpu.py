# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The port's CUDA kernels against their plain PyTorch versions on a card:
K1-K3 (grouped aggregation), K4 ``chunk_scan`` and K5 ``join_probe``. Every
test here is ``gpu``-marked and skips without a CUDA device. The module
imports neither jax nor the reference package, so it also runs where only
the port's requirements are installed::

    python -m pytest tests/test_torch_gpu.py -m gpu

The input builders double as the cases of ``tests/test_torch_scan.py``,
which holds the plain versions against the reference on the CPU."""

import os

import numpy as np
import pytest
import torch

from nds_tpu_torch.engine import kernels as K

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)   # tiny tensors: spare the other workers' cores

I64_MAX = np.iinfo(np.int64).max
I64_MIN = np.iinfo(np.int64).min


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gids(rng, n, G, pads=True):
    """Group ids with nulls (-1), pads (>= G) and some empty groups."""
    g = rng.integers(0, G, size=n)
    if G > 4:
        g = np.where(g == 3, 2, g)                      # group 3 stays empty
    u = rng.random(n)
    g = np.where(u < 0.1, -1, g)
    if pads:
        g = np.where((u >= 0.1) & (u < 0.15), G + (g % 3), g)
    return g.astype(np.int64)


def _scan_case(name):
    """(numpy chunk buffers, live rows, entries, cols, tables, key_slots)
    of one K4 case."""
    rng = np.random.default_rng(_SCAN_CASES.index(name))
    if name == "all_survivors":
        cap = 1024
        return ((np.arange(cap, dtype=np.int64), None), 700,
                [("ige", 0, 0)], [(0, -1, "id", 0, -1, 1.0)], (), ())
    if name == "zero_survivors":
        cap = 512
        return ((np.arange(cap, dtype=np.int64), None), cap,
                [("ige", 0, 3), ("false", 0), ("ile", 0, 400)],
                [(0, -1, "id", 0, -1, 1.0)], (), ())
    if name == "tile_boundary_rows":
        vals = np.zeros(2048, dtype=np.int64)
        vals[[510, 511, 512, 513, 1029, 1030]] = 7
        return ((vals, None), 1030, [("ieq", 0, 7)],
                [(0, -1, "id", 0, -1, 1.0)], (), ())
    if name == "dict_code_out_of_range":
        codes = np.array([0, 1, 2, 2, 0, -3, 9, 1], dtype=np.int16)
        table = np.asarray([10, 20, 30], dtype=np.int64)
        return ((codes, None), 8,
                [("ige", 0, 3), ("fge", 0, 15.0), ("ile", 0, -1)],
                [(0, -1, "dict", 0, 0, 1.0)], (table,), ())
    if name == "validity_and_hash":
        cap = 1024
        d = rng.integers(0, 100, cap).astype(np.int64)
        v = rng.random(cap) > 0.3
        k2 = rng.integers(-(1 << 40), 1 << 40, cap).astype(np.int64)
        return ((d, v, k2, None), cap, [("ige", 0, 0)],
                [(0, 1, "id", 0, -1, 1.0)], (), (0, 2))
    if name == "rich_predicates":
        cap = 2048
        q16 = rng.integers(-200, 3000, cap).astype(np.int16)   # FOR codes
        qv = rng.random(cap) > 0.1
        p32 = rng.integers(0, 1 << 20, cap).astype(np.int32)   # FOR codes
        dc = rng.integers(-2, 12, cap).astype(np.int16)        # dict codes
        dv = rng.random(cap) > 0.2
        s32 = rng.integers(0, 6, cap).astype(np.int32)         # str codes
        table = np.asarray([-500, 7, 99, 1000, 1001, 4096, 123456, 10 ** 9,
                            10 ** 12, 2 ** 40], dtype=np.int64)
        entries = [
            ("irange", 0, -50, 2500), ("nrange", 1, 1000, 2000),
            ("iin", 2, (0, 3, 5)), ("inotin", 3, (1, 4)),
            ("notnull", 0), ("true", 1),
            ("fge", 2, 0.5), ("flt", 2, 1.2e7), ("fne", 1, 12.34),
            ("fin", 2, (0.07, 1000.0, 9.99e4)), ("frange", 1, -1.0, 9e4),
            ("fnotin", 0, (1.5, 2.5)), ("fnrange", 0, 100.0, 200.0),
            ("fle", 0, 25.0), ("fgt", 1, 0.0), ("feq", 3, 3.0),
            ("ine", 3, 2), ("ile", 1, 900000), ("ige", 0, -100),
        ]
        cols = [(0, 1, "for", -1000, -1, 100.0),
                (2, -1, "for", 12345, -1, 100.0),
                (4, 5, "dict", 0, 0, 100.0),
                (6, -1, "id", 0, -1, 1.0)]
        return ((q16, qv, p32, None, dc, dv, s32, None), 1900, entries,
                cols, (table,), (2, 6))
    if name == "float_lane_nan_and_signed_zero":
        vals = np.array([np.nan, -0.0, 0.0, 1.5, -np.inf, np.inf, -1e-300,
                         2.0] * 64, dtype=np.float64)
        v = np.tile(np.array([1, 1, 1, 0, 1, 1, 1, 1], dtype=bool), 64)
        f32 = vals.astype(np.float32)
        entries = [("fne", 0, 1.5), ("fle", 0, np.inf),
                   ("fnotin", 0, (2.0, float("nan"))),
                   ("fnrange", 0, 1.0, 1.9)]
        return ((vals, v, f32, None), 500, entries,
                [(0, 1, "id", 0, -1, 1.0)], (), (0, 2))
    if name == "narrow_codes_sign_extend":
        c8 = np.arange(-128, 128, dtype=np.int8).repeat(2)
        return ((c8, None), 512, [("ile", 0, -1), ("iin", 0, (-128, -1, 5))],
                [(0, -1, "id", 0, -1, 1.0)], (), (0,))
    if name == "every_dtype_tag":
        # one column of each tag, an int and a float entry on each, half
        # with validity; 1,000 + 7 rows: no multiple of a tile
        cap = 1007
        bufs, entries, cols = [], [], []
        for ci, dt in enumerate(_TAG_DTYPES):
            d = _tag_data(rng, dt, cap)
            v = rng.random(cap) > 0.05 if ci % 2 else None
            bufs += [d, v]
            lo, hi = np.quantile(d.astype(np.float64), [0.05, 0.97])
            fmode = ("id", "for", "dict")[ci % 3]
            if fmode == "dict" and np.dtype(dt).kind == "f":
                fmode = "id"    # the reference gathers only at int codes
            cols.append((2 * ci, 2 * ci + 1 if v is not None else -1, fmode,
                         -3 if fmode == "for" else 0,
                         0 if fmode == "dict" else -1,
                         10.0 if ci % 4 == 3 else 1.0))
            entries += [("irange", ci, int(lo), int(hi) + 1),
                        ("fgt", ci, -1e300)]
        table = np.arange(-5, 300, dtype=np.int64) * 3
        return (tuple(bufs), cap - 20, entries, cols, (table,), (0, 6, 8))
    if name == "wide_16_cols_8_keys":
        cap = 3005
        dts = (np.int64, np.float32, np.float64, np.int32)
        bufs, entries, cols = [], [], []
        for ci in range(16):
            d = _tag_data(rng, dts[ci % 4], cap)
            v = rng.random(cap) > 0.02 if ci % 3 == 0 else None
            bufs += [d, v]
            cols.append((2 * ci, 2 * ci + 1 if v is not None else -1, "id",
                         0, -1, 1.0))
            entries.append(("fge", ci, float(np.quantile(
                d.astype(np.float64), 0.04))))
        # keys: the first 8 columns, int64, float32, float64 and int32
        return (tuple(bufs), cap, entries, cols, (),
                tuple(2 * k for k in range(8)))
    if name == "in_lists_of_200":
        cap = 4099
        d = rng.integers(0, 1000, cap).astype(np.int32)
        f = rng.integers(0, 1000, cap).astype(np.float64) / 4
        ivals = tuple(int(x) for x in rng.choice(1000, 200, replace=False))
        fvals = tuple(float(x) / 4 for x in rng.choice(1000, 200,
                                                       replace=False))
        return ((d, None, f, None), cap - 3,
                [("iin", 0, ivals), ("fnotin", 1, fvals[:100]),
                 ("inotin", 0, ivals[:200:7]), ("fin", 1, fvals + (0.25,))],
                [(0, -1, "id", 0, -1, 1.0), (2, -1, "id", 0, -1, 1.0)],
                (), ())
    if name == "dict_table_over_budget":
        # 7,000 values (56,000 B) > the 48 KB staging budget: the table
        # stays in global memory
        cap = 5003
        table = np.sort(rng.integers(-(1 << 40), 1 << 40, 7000)).astype(
            np.int64)
        # negative codes clip to the first value; none past the table (the
        # reference's Pallas kernel pads its tables to 128 with zeros and
        # reads a zero there, where its jnp twin clips to the last value)
        codes = rng.integers(-5, 7000, cap).astype(np.int16)
        v = rng.random(cap) > 0.1
        return ((codes, v), cap - 1,
                [("fge", 0, float(table[1000]) / 100),
                 ("flt", 0, float(table[6500]) / 100), ("ine", 0, 17)],
                [(0, 1, "dict", 0, 0, 100.0)], (table,), (0,))
    if name == "nan_and_zeros_at_tile_edges":
        cap = 16 * 40 + 9
        f64 = rng.random(cap) * 4 - 2
        for edge in range(4, cap - 2, 4):
            f64[edge - 1:edge + 2] = (np.nan, -0.0, 0.0)[edge % 3:] + \
                (np.nan, -0.0, 0.0)[:edge % 3]
        f32 = f64.astype(np.float32)
        return ((f64, None, f32, None), cap - 2,
                [("fne", 0, 1.0), ("fge", 0, -0.0), ("fle", 1, 0.0),
                 ("fnotin", 1, (float("nan"), 5.0)), ("fnrange", 0, 0.5,
                                                      0.75)],
                [(0, -1, "id", 0, -1, 1.0), (2, -1, "id", 0, -1, 1.0)],
                (), (0, 2))
    raise KeyError(name)


_SCAN_CASES = ["all_survivors", "zero_survivors", "tile_boundary_rows",
               "dict_code_out_of_range", "validity_and_hash",
               "rich_predicates", "float_lane_nan_and_signed_zero",
               "narrow_codes_sign_extend", "every_dtype_tag",
               "wide_16_cols_8_keys", "in_lists_of_200",
               "dict_table_over_budget", "nan_and_zeros_at_tile_edges"]
# one column dtype for each of K4's dtype tags (bool shares uint8's)
_TAG_DTYPES = (np.int8, np.int16, np.int32, np.int64, np.float32,
               np.float64, np.uint8, np.bool_)


def _tag_data(rng, dt, n):
    """``n`` values of dtype ``dt`` spanning its range, with its extremes
    (finite floats, so the int lane's truncation is defined)."""
    dt = np.dtype(dt)
    if dt == np.bool_:
        return rng.random(n) > 0.5
    if dt.kind == "f":
        x = (rng.standard_normal(n) * 1e3).astype(dt)
        x[:3] = (-0.0, 0.0, 1e18)
        return x
    info = np.iinfo(dt)
    x = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
    x[:2] = (info.min, info.max)
    return x



def _probe_case(n, r, nkeys, seed):
    rng = np.random.default_rng(seed)
    lk = [rng.integers(0, 90, n).astype(np.int64 if k == 0 else np.int32)
          for k in range(nkeys)]
    lv = [rng.random(n) > 0.1 if k == 0 else None for k in range(nkeys)]
    excl = rng.random(n) > 0.8
    rk = [rng.integers(0, 100, r).astype(np.int64 if k == 0 else np.int32)
          for k in range(nkeys)]
    rv = [None if k == 0 else rng.random(r) > 0.05 for k in range(nkeys)]
    return lk, lv, excl, rk, rv


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 1000, 100000])
def test_cuda_kernels_match_plain(cuda, G):
    rng = np.random.default_rng(G)
    n = 1 << 20
    g = _t(_gids(rng, n, G)).to(cuda)
    iv = _t(rng.integers(I64_MIN, I64_MAX, size=n, dtype=np.int64)).to(cuda)
    fv = _t(rng.random(n) * 1000).to(cuda)
    a, b = K.segment_sum_i64(iv, g, G), K.segment_sum_i64_plain(iv, g, G)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    a, b = K.segment_sum_f64(fv, g, G), K.segment_sum_f64_plain(fv, g, G)
    assert torch.equal(a[1], b[1])
    torch.testing.assert_close(a[0], b[0], rtol=1e-9, atol=0)
    fv[::1000] = float("nan")
    a, b = (K.segment_minmax_f64(fv, g, G),
            K.segment_minmax_f64_plain(fv, g, G))
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int64), y.view(torch.int64))


@pytest.mark.gpu
def test_launcher_matches_the_wrapper_and_counts_nothing(cuda):
    rng = np.random.default_rng(3)
    n, G = 1 << 16, 100
    g = _t(_gids(rng, n, G)).to(cuda)
    iv = _t(rng.integers(-1000, 1000, size=n, dtype=np.int64)).to(cuda)
    fv = _t(rng.random(n)).to(cuda)
    want = {"segment_sum_i64": K.segment_sum_i64(iv, g, G),
            "segment_sum_f64": K.segment_sum_f64(fv, g, G),
            "segment_minmax_f64": K.segment_minmax_f64(fv, g, G)}
    before = dict(K.LAUNCHES)
    for name, vals in (("segment_sum_i64", iv), ("segment_sum_f64", fv),
                       ("segment_minmax_f64", fv)):
        outs = K.launcher(name, vals, g, G)()
        got = (outs[1][0], outs[1][1]) if name == "segment_minmax_f64" \
            else outs
        for x, y in zip(got, want[name]):
            torch.testing.assert_close(x, y, rtol=1e-12, atol=0,
                                       equal_nan=True)
    assert K.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("name", _SCAN_CASES)
def test_cuda_chunk_scan_matches_plain(cuda, name):
    bufs, n, entries, cols, tables, key_slots = _scan_case(name)
    spec = K.ScanSpec(entries, cols, tables=tables, key_slots=key_slots)
    flat = tuple(None if b is None else _t(b).to(cuda) for b in bufs)
    nd = torch.tensor(n, dtype=torch.int64, device=cuda)
    before = K.LAUNCHES["chunk_scan"]
    m, h = K.chunk_scan(flat, nd, spec)
    assert K.LAUNCHES["chunk_scan"] == before + 1
    pm, ph = K.chunk_scan_plain(flat, nd, spec)
    assert torch.equal(m, pm)
    assert (h is None) == (ph is None)
    if h is not None:
        assert torch.equal(h, ph)


def _assert_scan_equal(flat, nd, spec, plan=None):
    """K4 (its wrapper, or a raw launch of ``plan``) against the plain
    version: mask and hash bit for bit."""
    if plan is None:
        m, h = K.chunk_scan(flat, nd, spec)
    else:
        _keep, m, h = K.launcher("chunk_scan", flat, nd, spec, plan=plan)()
    pm, ph = K.chunk_scan_plain(flat, nd, spec)

    def where(a, b):
        rows = torch.nonzero(a != b).flatten()[:4].tolist()
        return (plan, spec.entries, spec.cols, rows,
                [(flat[spec.cols[0][0]][r].item(), a[r].item(), b[r].item())
                 for r in rows])
    assert torch.equal(m, pm), where(m, pm)
    assert (h is None) == (ph is None)
    if h is not None:
        assert torch.equal(h, ph), where(h, ph)


def _k4_plans(plen, spec, dev):
    """Every plan the sweep times, and the card's own with a grid of 3
    blocks (each thread walks many tiles)."""
    sms = K._sm_count(dev)
    return K.scan_plans(plen, spec, sms) + [
        K.scan_plan(plen, spec, sms)._replace(grid=3)]


def _offset_view(t):
    """``t`` as a view at storage offset 1 (no 16-byte alignment)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t
    return buf[1:]


@pytest.mark.gpu
@pytest.mark.parametrize("name", _SCAN_CASES)
def test_k4_every_plan_bit_exact(cuda, name):
    """Every plan at n_dev 0, the case's own and plen; then with every
    buffer a view at storage offset 1, and with one column alone so (the
    scalar loads inside the same kernel)."""
    bufs, n, entries, cols, tables, key_slots = _scan_case(name)
    spec = K.ScanSpec(entries, cols, tables=tables, key_slots=key_slots)
    flat = tuple(None if b is None else _t(b).to(cuda) for b in bufs)
    plen = flat[0].shape[0]
    plans = _k4_plans(plen, spec, cuda)
    for live in (0, n, plen):
        nd = torch.tensor(live, dtype=torch.int64, device=cuda)
        for plan in plans:
            _assert_scan_equal(flat, nd, spec, plan)
    nd = torch.tensor(n, dtype=torch.int64, device=cuda)
    shifted = tuple(None if b is None else _offset_view(b) for b in flat)
    one = tuple(_offset_view(b) if i == cols[-1][0] else b
                for i, b in enumerate(flat))
    for views in (shifted, one):
        _assert_scan_equal(views, nd, spec)
        for plan in plans:
            _assert_scan_equal(views, nd, spec, plan)


def _k4_edge_case(rng, plen):
    d16 = rng.integers(-300, 300, plen).astype(np.int16)
    v = rng.random(plen) > 0.2
    f64 = rng.standard_normal(plen)
    k32 = rng.integers(-(1 << 31), 1 << 31, plen).astype(np.int32)
    entries = [("irange", 0, -200, 250), ("fge", 1, -1.0),
               ("iin", 0, (1, 2, 3, -7, 150))]
    cols = [(0, 1, "for", 3, -1, 1.0), (2, -1, "id", 0, -1, 1.0)]
    return (d16, v, f64, None, k32, None), entries, cols, (0, 2, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("plen", [0, 1, 15, 16, 17, 4099])
def test_k4_plen_edges(cuda, plen):
    """plen 0, 1, R - 1, R, R + 1 for the tile of R = 16 rows, and one
    that is no multiple of a tile, under every plan and n_dev 0 / plen."""
    bufs, entries, cols, key_slots = _k4_edge_case(
        np.random.default_rng(plen), plen)
    spec = K.ScanSpec(entries, cols, key_slots=key_slots)
    flat = tuple(None if b is None else _t(b).to(cuda) for b in bufs)
    for live in (0, plen):
        nd = torch.tensor(live, dtype=torch.int64, device=cuda)
        _assert_scan_equal(flat, nd, spec)
        for plan in _k4_plans(plen, spec, cuda):
            _assert_scan_equal(flat, nd, spec, plan)


def _k4_dict_spec(table, key_slots=(0,)):
    return K.ScanSpec([("fge", 0, float(table[len(table) // 7]) / 100),
                       ("flt", 0, float(table[-len(table) // 9]) / 100),
                       ("ine", 0, 17)],
                      [(0, 1, "dict", 0, 0, 100.0)], tables=(table,),
                      key_slots=key_slots)


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [0, 1, 72, 144])
def test_k4_dict_table_at_the_staging_budget(cuda, extra):
    """A packed spec of ``SCAN_SMEM_BUDGET`` words plus ``extra``: the
    whole spec staged (0), then its table left in global memory, one word
    over (1), in the middle of (72) and at the end of (144) the words the
    kernel's static records take from 48 KB. Every launch starts and
    agrees with the plain version bit for bit."""
    rng = np.random.default_rng(extra)
    head = K.pack_scan_spec(
        _k4_dict_spec(np.zeros(1, np.int64)))[1].off_tables
    words = K.SCAN_SMEM_BUDGET // 8 + extra
    table = np.sort(rng.integers(-(1 << 40), 1 << 40, words - head))
    spec = _k4_dict_spec(table.astype(np.int64))
    lay = K.pack_scan_spec(spec)[1]
    assert lay.total == words
    assert K.scan_staged_words(lay) == (words if extra == 0
                                        else lay.off_tables)
    cap = 16 * 300 + 3
    codes = rng.integers(-5, len(table), cap).astype(np.int16)
    v = rng.random(cap) > 0.1
    flat = (_t(codes).to(cuda), _t(v).to(cuda))
    for live in (0, cap - 1, cap):
        nd = torch.tensor(live, dtype=torch.int64, device=cuda)
        _assert_scan_equal(flat, nd, spec)
        for plan in _k4_plans(cap, spec, cuda):
            _assert_scan_equal(flat, nd, spec, plan)


_INT_KINDS = ("ieq", "ine", "ile", "ige", "irange", "nrange", "iin",
              "inotin")
_FLOAT_KINDS = ("feq", "fne", "flt", "fle", "fgt", "fge", "frange",
                "fnrange", "fin", "fnotin")


def _k4_entries(kind, ci, vals):
    """One entry of ``kind`` on column ``ci`` with operands drawn from the
    values it compares (``vals``: the int lane's or the float lane's)."""
    finite = vals[np.isfinite(vals.astype(np.float64))]
    q = [finite[int(len(finite) * f)] for f in (0.1, 0.5, 0.9)]
    cast = float if kind[0] == "f" else int
    lo, mid, hi = (cast(x) for x in sorted(q))
    if kind in ("iin", "inotin", "fin", "fnotin"):
        return (kind, ci, tuple(cast(x) for x in finite[:40:3]) + (mid,))
    if kind in ("irange", "nrange", "frange", "fnrange"):
        return (kind, ci, lo, hi)
    return (kind, ci, mid)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", _TAG_DTYPES, ids=lambda d: np.dtype(d).name)
def test_k4_every_opcode_and_tag(cuda, dt):
    """Each opcode alone on a column of each dtype tag (the float lane
    through identity, FOR and dict decodes), with validity, with and
    without the hash over the column, under every plan."""
    rng = np.random.default_rng(np.dtype(dt).num)
    n = 16 * 64 + 5
    d = _tag_data(rng, dt, n)
    v = rng.random(n) > 0.1
    table = np.arange(-3, 200, dtype=np.int64) * 7
    cols = [(0, 1, "id", 0, -1, 1.0), (0, 1, "for", -5, -1, 100.0),
            (0, -1, "dict", 0, 0, 10.0)]
    flat = (_t(d).to(cuda), _t(v).to(cuda))
    nd = torch.tensor(n - 2, dtype=torch.int64, device=cuda)
    ints = d.astype(np.int64)
    lanes = {0: d.astype(np.float64),
             1: (ints + np.int64(-5)).astype(np.float64) / 100.0,
             2: table[np.clip(ints, 0, len(table) - 1)].astype(
                 np.float64) / 10.0}
    entries = [(kind, 0) for kind in ("false", "true", "isnull",
                                      "notnull")]
    entries += [_k4_entries(kind, 0, ints) for kind in _INT_KINDS]
    entries += [_k4_entries(kind, ci, lanes[ci]) for kind in _FLOAT_KINDS
                for ci in range(3)]
    for entry in entries:
        # with and without the hash: the kernels with and without its path
        for key_slots in ((0,), ()):
            spec = K.ScanSpec([entry], cols, tables=(table,),
                              key_slots=key_slots)
            _assert_scan_equal(flat, nd, spec)
            for plan in _k4_plans(n, spec, cuda):
                _assert_scan_equal(flat, nd, spec, plan)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [1, 2, 3, 4])
def test_true_div_gives_the_cpu_quotient(cuda, scale):
    """On the card torch divides by a host scalar as a multiplication by
    its reciprocal; ``prim.true_div`` (the decimal decode of K4's plain
    version and of the eager engine) gives the CPU's IEEE quotient bit for
    bit."""
    from nds_tpu_torch.engine import prim
    x = torch.arange(-400_000, 400_000, dtype=torch.float64)
    want = x / 10.0 ** scale
    got = prim.true_div(x.to(cuda), 10.0 ** scale).cpu()
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))


@pytest.mark.gpu
@pytest.mark.parametrize("n,r,nkeys,n_valid", [
    (600, 200, 1, 580), (1 << 16, 102_000, 1, 60000), (900, 5000, 2, 900)])
def test_cuda_join_probe_matches_plain(cuda, n, r, nkeys, n_valid):
    from nds_tpu_torch.engine import ops as PO
    lk, lv, excl, rk, rv = _probe_case(n, r, nkeys, n + r)
    ph = PO.unsigned_order(PO._key_hash_impl(
        tuple(_t(x).to(cuda) for x in rk),
        tuple(None if x is None else _t(x).to(cuda) for x in rv), 1, False,
        r, None))
    ph_sorted = torch.sort(ph).values
    args = (tuple(_t(x).to(cuda) for x in lk),
            tuple(None if x is None else _t(x).to(cuda) for x in lv),
            torch.tensor(n_valid, dtype=torch.int64, device=cuda),
            _t(excl).to(cuda), ph_sorted)
    c, lo = K.join_probe(*args)
    pc, plo = K.join_probe_plain(*args)
    assert torch.equal(c, pc) and torch.equal(lo, plo)
    c2, lo2 = K.join_probe(*args[:2], n_valid, *args[3:])   # host n_valid
    assert torch.equal(c2, pc) and torch.equal(lo2, plo)


# ------------------------------------------------------ K1 paths, K5 directory


def _k1_case(rng, n, G):
    g = _gids(rng, n, G)
    v = rng.integers(I64_MIN, I64_MAX, size=n, dtype=np.int64)
    # wrap: extremes in group 0, many times over
    v[:8] = [I64_MAX, I64_MAX, I64_MIN, I64_MIN, I64_MAX, -1, 1, I64_MIN]
    g[:8] = 0
    return g, v


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 2, 31, 1000, K.G_PRIV, K.G_PRIV + 1,
                               100000])
def test_k1_paths_bit_exact(cuda, G):
    """Every K1 path against the plain version, with wrapping extremes, an
    odd row count that is no multiple of a block, and views offset by one
    row (8-byte loads instead of 16-byte ones)."""
    rng = np.random.default_rng(G + 17)
    n = (1 << 18) + 1235
    g, v = _k1_case(rng, n, G)
    gt, vt = _t(g).to(cuda), _t(v).to(cuda)
    plan = K.segment_plan(n, G, K._sm_count(cuda))
    assert plan.path == ("private" if G <= K.G_PRIV else "global")
    for a, b in ((vt, gt), (vt[1:], gt[1:]), (vt[1:], gt[:-1])):
        s, c = K.segment_sum_i64(a, b, G)
        ps, pc = K.segment_sum_i64_plain(a, b, G)
        assert torch.equal(s, ps) and torch.equal(c, pc)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 1000, 100000])
def test_k1_empty_input_and_all_rows_dropped(cuda, G):
    e = torch.empty(0, dtype=torch.int64, device=cuda)
    for s in K.segment_sum_i64(e, e, G):
        assert s.shape == (G,) and not bool(s.any())
    n = 5000
    g = torch.where(torch.arange(n, device=cuda) % 2 == 0,
                    torch.full((n,), -1, device=cuda),
                    torch.full((n,), G + 3, device=cuda))
    v = torch.arange(n, dtype=torch.int64, device=cuda)
    for s in K.segment_sum_i64(v, g, G):
        assert not bool(s.any())


@pytest.mark.gpu
def test_k1_every_plan_gives_the_same_sums(cuda):
    """The sweep's plans (private at 1-4 blocks an SM, global) all compute
    the plain version's bits."""
    rng = np.random.default_rng(5)
    n, G = 1 << 20, 256
    g, v = _k1_case(rng, n, G)
    gt, vt = _t(g).to(cuda), _t(v).to(cuda)
    ps, pc = K.segment_sum_i64_plain(vt, gt, G)
    sms = K._sm_count(cuda)
    plans = K.segment_plans(n, G, sms)
    assert [p.path for p in plans] == ["private"] * 4 + ["global"]
    for plan in plans:
        s, c = K.launcher("segment_sum_i64", vt, gt, G, plan=plan)()
        assert torch.equal(s, ps) and torch.equal(c, pc)


def _fanout_build(rng, r):
    """r build keys: fanout 4 over distinct keys, one key repeated up to
    1,000 times, null build rows and pad rows past the live count."""
    hot = min(1000, r // 2)
    keys = np.concatenate([np.full(hot, 5, dtype=np.int64), np.repeat(
        rng.integers(10, 1 << 40, (r - hot + 3) // 4), 4)[:r - hot]])
    valid = rng.random(r) > 0.05
    return keys, valid, r - r // 50


@pytest.mark.gpu
@pytest.mark.parametrize("r", [0, 1, 1000, 102_000, 1 << 20])
@pytest.mark.parametrize("probe", ["mixed", "unmatchable"])
def test_k5_directory_probe_bit_exact(cuda, r, probe):
    from nds_tpu_torch.engine import ops as PO
    rng = np.random.default_rng(r + len(probe))
    keys, valid, live = _fanout_build(rng, r)
    rh = PO.unsigned_order(PO._key_hash_impl(
        (_t(keys).to(cuda),), (_t(valid).to(cuda),), 1, False, live, None))
    rh_sorted = torch.sort(rh).values
    n = 1 << 16
    pool = keys if r else np.arange(1, 10, dtype=np.int64)
    lk = np.where(rng.random(n) < 0.7, rng.choice(pool, n),
                  rng.integers(1 << 41, 1 << 42, n))
    lv = rng.random(n) > 0.05
    excl = rng.random(n) > 0.9
    if probe == "unmatchable":
        lv[:] = False
    args = ((_t(lk).to(cuda),), (_t(lv).to(cuda),),
            torch.tensor(n - 100, dtype=torch.int64, device=cuda),
            _t(excl).to(cuda), rh_sorted)
    before = K.LAUNCHES["join_probe"]
    c, lo = K.join_probe(*args)
    assert K.LAUNCHES["join_probe"] == before + 1
    pc, plo = K.join_probe_plain(*args)
    assert torch.equal(c, pc) and torch.equal(lo, plo)
    if probe == "unmatchable":
        assert not bool(c.any())
    elif r >= 1000:
        # the hot key's live, non-null build rows all match
        assert int(c.max()) == int(valid[:min(1000, r // 2)].sum())
    # the card's directory against its plain version
    import ctypes
    block, keep, c2, _lo2 = K._probe_args(*args)
    K._check("join_probe", K._lib().nds_join_probe(ctypes.byref(block),
                                                   K._stream(c2)))
    torch.cuda.synchronize()
    assert torch.equal(keep[1], K.probe_directory_plain(
        rh_sorted, K.probe_bits(r)))


@pytest.mark.gpu
@pytest.mark.parametrize("live", [0, 3, 40])
def test_k5_directory_of_a_sparse_build_side(cuda, live):
    """A 2^20-row build side of which all but ``live`` rows are null:
    the few real hashes leave gaps of thousands of buckets, which whole
    blocks fill."""
    from nds_tpu_torch.engine import ops as PO
    rng = np.random.default_rng(live)
    r = 1 << 20
    keys = rng.integers(0, 1 << 40, r)
    valid = np.zeros(r, dtype=bool)
    valid[rng.choice(r, live, replace=False)] = True
    rh_sorted = torch.sort(PO.unsigned_order(PO._key_hash_impl(
        (_t(keys).to(cuda),), (_t(valid).to(cuda),), 1, False, r,
        None))).values
    n = 4096
    lk = np.concatenate([keys[valid], rng.integers(0, 1 << 40,
                                                   n - live)])
    args = ((_t(lk).to(cuda),), (None,), n, None, rh_sorted)
    c, lo = K.join_probe(*args)
    pc, plo = K.join_probe_plain(*args)
    assert torch.equal(c, pc) and torch.equal(lo, plo)
    assert live == 0 or int(c[:live].min()) >= 1
    import ctypes
    block, keep, c2, _lo2 = K._probe_args(*args)
    K._check("join_probe", K._lib().nds_join_probe(ctypes.byref(block),
                                                   K._stream(c2)))
    torch.cuda.synchronize()
    assert torch.equal(keep[1], K.probe_directory_plain(rh_sorted, 20))


# ------------------------------------------------------------- K2, K3 paths

_K23 = [("segment_sum_f64", False), ("segment_sum_f64", True),
        ("segment_minmax_f64", False)]


def _k23_case(rng, n, G):
    """Group ids with nulls, pads and an empty group; doubles with NaN,
    -0.0, +0.0 and both infinities."""
    g = _gids(rng, n, G)
    v = rng.standard_normal(n) * 1000.0
    v[::4099] = np.nan
    v[1::1021] = -0.0
    v[2::1021] = 0.0
    v[3::65537] = np.inf
    v[4::65537] = -np.inf
    return g, v


def _gb(count_only):
    """Shared-memory bytes a group takes: 32-bit counts alone for a
    count-only K2 launch, 16 otherwise."""
    return 4 if count_only else 16


def _assert_k23_equal(name, got, want):
    """K3 and every count bit for bit, K2 sums within rel 1e-9 (float
    atomics add in no fixed order)."""
    if name == "segment_minmax_f64":
        for x, y in zip(got, want):
            assert torch.equal(x.view(torch.int64), y.view(torch.int64))
        return
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=1e-9, atol=0,
                               equal_nan=True)


def _k23_call(name, count_only, v, g, G, plan=None):
    vals = None if count_only else v
    if plan is None:
        return getattr(K, name)(vals, g, G)
    outs = K.launcher(name, vals, g, G, plan=plan)()
    return (outs[1][0], outs[1][1]) if name == "segment_minmax_f64" \
        else outs


@pytest.mark.gpu
@pytest.mark.parametrize("name,count_only", _K23)
@pytest.mark.parametrize("G", [1, 2, 16, 1000, "cap", "cap+1", 100000])
def test_k23_every_path_matches_plain(cuda, name, count_only, G):
    """K2 (with values, count-only) and K3 on every path at G from 1 past
    the shared-memory cap, with an odd row count and views offset by one
    row (8-byte loads instead of 16-byte ones)."""
    n = (1 << 18) + 1235
    cap = K.SMEM_BLOCK_CAP // _gb(count_only)
    G = {"cap": cap, "cap+1": cap + 1}.get(G, G)
    rng = np.random.default_rng(G + 7 * count_only)
    g, v = _k23_case(rng, n, G)
    gt, vt = _t(g).to(cuda), _t(v).to(cuda)
    plain = getattr(K, name + "_plain")
    want = plain(None if count_only else vt, gt, G)
    sms = K._sm_count(cuda)
    plan = K.segment_plan(n, G, sms, group_bytes=_gb(count_only))
    assert (plan.path == "private") == (G <= cap)
    before = K.LAUNCHES[name]
    _assert_k23_equal(name, _k23_call(name, count_only, vt, gt, G), want)
    assert K.LAUNCHES[name] == before + 1
    for p in K.segment_plans(n, G, sms, group_bytes=_gb(count_only)):
        _assert_k23_equal(name, _k23_call(name, count_only, vt, gt, G, p),
                          want)
    for a, b in ((vt[1:], gt[1:]), (vt[1:], gt[:-1])):
        _assert_k23_equal(name, _k23_call(name, count_only, a, b, G),
                          plain(None if count_only else a, b, G))


@pytest.mark.gpu
@pytest.mark.parametrize("name,count_only", _K23)
@pytest.mark.parametrize("G", [1, 1000, 100000])
def test_k23_empty_input_and_all_rows_dropped(cuda, name, count_only, G):
    e = torch.empty(0, dtype=torch.int64, device=cuda)
    ef = torch.empty(0, dtype=torch.float64, device=cuda)
    _assert_k23_equal(name, _k23_call(name, count_only, ef, e, G),
                      getattr(K, name + "_plain")(
                          None if count_only else ef, e, G))
    n = 5001
    g = torch.where(torch.arange(n, device=cuda) % 2 == 0,
                    torch.full((n,), -1, device=cuda),
                    torch.full((n,), G + 3, device=cuda))
    v = torch.arange(n, dtype=torch.float64, device=cuda)
    got = _k23_call(name, count_only, v, g, G)
    if name == "segment_minmax_f64":
        assert bool((got[0] == float("inf")).all())
        assert bool((got[1] == float("-inf")).all())
    else:
        assert not bool(got[0].any()) and not bool(got[1].any())


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 2, 5])
def test_k3_nan_and_signed_zeros_at_block_boundaries(cuda, G):
    """NaN, -0.0 and +0.0 on both sides of every block's first share of
    rows (1,024 rows: 512 threads of two rows), in groups that span the
    boundaries; every plan gives the plain version's bits (NaN wins both,
    -0.0 is the min and +0.0 the max of the zeros)."""
    rng = np.random.default_rng(G)
    n = 1024 * 300 + 1
    g = rng.integers(0, G, n)
    v = rng.random(n) + 1.0
    special = np.array([np.nan, -0.0, 0.0, -0.0, 0.0, 0.0])
    for edge in range(1024, n - 8, 1024):
        for k, x in enumerate(special):
            v[edge - 3 + k] = x
            g[edge - 3 + k] = (k + edge // 1024) % G
    gt, vt = _t(g).to(cuda), _t(v).to(cuda)
    want = K.segment_minmax_f64_plain(vt, gt, G)
    for p in K.segment_plans(n, G, K._sm_count(cuda)):
        _assert_k23_equal("segment_minmax_f64",
                          _k23_call("segment_minmax_f64", False, vt, gt, G,
                                    p), want)
    # the same zeros without the NaN rows: -0.0 / +0.0 decide
    vz = torch.where(torch.isnan(vt), torch.ones_like(vt), vt)
    vz = torch.where(vz >= 1.0, torch.full_like(vz, 0.0), vz)
    mn, mx = K.segment_minmax_f64(vz, gt, G)
    assert bool(torch.signbit(mn).all()) and not bool(torch.signbit(mx).any())


@pytest.mark.gpu
def test_k23_every_plan_gives_the_same_result(cuda):
    """The sweep's plans all compute the plain version's counts and K3
    bits, and K2 sums within rel 1e-9."""
    rng = np.random.default_rng(6)
    n, G = 1 << 20, 256
    g, v = _k23_case(rng, n, G)
    gt, vt = _t(g).to(cuda), _t(v).to(cuda)
    sms = K._sm_count(cuda)
    for name, count_only in _K23:
        want = getattr(K, name + "_plain")(None if count_only else vt, gt, G)
        plans = K.segment_plans(n, G, sms, group_bytes=_gb(count_only))
        assert [p.path for p in plans] == ["private"] * 4 + ["global"]
        for plan in plans:
            _assert_k23_equal(name, _k23_call(name, count_only, vt, gt, G,
                                              plan), want)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 16, 100000])
def test_count_only_launcher_matches_the_wrapper(cuda, G):
    rng = np.random.default_rng(G + 1)
    n = (1 << 16) + 3
    g = _t(_gids(rng, n, G)).to(cuda)
    want = K.segment_sum_f64(None, g, G)
    before = dict(K.LAUNCHES)
    s, c = K.launcher("segment_sum_f64", None, g, G)()
    assert torch.equal(c, want[1]) and not bool(s.any())
    assert K.LAUNCHES == before


# ---------------------------------------------------------------------------
# whole-statement replay: a recorded statement captured as one CUDA graph
# ---------------------------------------------------------------------------

REPLAY_Q = ("select grp, count(*) c, sum(v) s, avg(v) a, min(x) lo, "
            "max(x) hi from f, dim where d = sk and k < 40 and g in "
            "('g1', 'g3', 'g5') group by grp order by grp")


@pytest.fixture()
def replay_session(cuda, monkeypatch):
    import pyarrow as pa

    from nds_tpu_torch.engine.session import Session
    monkeypatch.setenv("NDS_TPU_REPLAY", "force")
    rng = np.random.default_rng(7)
    n = 50_000
    s = Session(device="cuda")
    s.create_temp_view("f", pa.table({
        "k": pa.array(rng.integers(0, 50, n), pa.int64()),
        "d": pa.array(rng.integers(1, 300, n), pa.int64()),
        "v": pa.array([None if x % 13 == 0 else int(x % 9973)
                       for x in rng.integers(0, 10**6, n)], pa.int64()),
        "x": pa.array(rng.normal(size=n), pa.float64()),
    }), base=True)
    s.create_temp_view("dim", pa.table({
        "sk": pa.array(np.arange(1, 301), pa.int64()),
        "grp": pa.array([f"g{i % 9}" for i in range(300)]),
        "g": pa.array([f"g{i % 7}" for i in range(300)]),
    }), base=True)
    return s


def _replay_tiers(s, sql):
    """Three sights of ``sql``: per sight its rows, syncs before the
    fetch and kernel launches."""
    from nds_tpu_torch.engine import ops as E
    out = []
    for _ in range(3):
        l0, s0 = dict(K.LAUNCHES), E.sync_count()
        res = s.sql(sql)
        syncs = E.sync_count() - s0
        rows = res.collect()
        out.append((rows, syncs, {k: v - l0[k] for k, v in K.LAUNCHES.items()},
                    s.last_tier))
    return out


@pytest.mark.gpu
def test_replay_captures_the_statement_as_one_graph(replay_session):
    """The third sight replays one captured graph: the eager rows, at most
    one sync before the fetch, and per kernel the eager launches."""
    s = replay_session
    (r1, s1, l1, t1), (r2, _s2, _l2, t2), (r3, s3, l3, t3) = \
        _replay_tiers(s, REPLAY_Q)
    assert (t1, t2, t3) == ("eager", "record", "replayed"), \
        s.replay_reason(REPLAY_Q)
    cq = next(iter(s._replay_cache.values()))
    assert cq.graph is not None
    assert r1 == r2 == r3 and r1
    assert s3 <= 1 and s1 >= 1
    assert l3 == l1 and l1["segment_sum_i64"] > 0 \
        and l1["segment_minmax_f64"] > 0
    assert cq.launches == cq.warm_launches == \
        {k: v for k, v in l1.items() if v}


@pytest.mark.gpu
def test_replay_keeps_a_held_result(replay_session):
    """A result the caller holds is its own copy: overwriting the graph's
    static outputs (as the next replay does) leaves it as it was, and the
    next replay writes them again."""
    s = replay_session
    want = _replay_tiers(s, REPLAY_Q)[0][0]
    held = s.sql(REPLAY_Q)
    cq = next(iter(s._replay_cache.values()))
    for c in cq.static_out.columns.values():
        c.data.zero_()
    assert held.collect() == want
    assert s.sql(REPLAY_Q).collect() == want


@pytest.mark.gpu
def test_no_cached_tensor_is_allocated_while_capturing(replay_session,
                                                       monkeypatch):
    """Caches emptied between the warm-up and the capture stay free of the
    graph's pool: every tensor the module caches hold afterwards lies in a
    segment of the default pool."""
    from nds_tpu_torch.engine import ops as E
    from nds_tpu_torch.engine import prim
    real = E.staged_uploads
    warm = []

    def emptying(stage, serve=False):
        if serve:                    # the capture starts: caches cold
            warm.append(len(prim._DIVISORS) + len(E._dev_cache))
            prim._DIVISORS.clear()
            E._dev_cache.clear()
        return real(stage, serve)

    monkeypatch.setattr(E, "staged_uploads", emptying)
    s = replay_session
    assert _replay_tiers(s, REPLAY_Q)[2][3] == "replayed"
    assert warm and warm[0] > 0, "the statement fills no cache"
    segs = [seg for seg in torch.cuda.memory_snapshot()
            if seg.get("device", 0) == torch.cuda.current_device()]
    assert all("segment_pool_id" in seg for seg in segs)

    def pool_of(t):
        p = t.data_ptr()
        for seg in segs:
            if seg["address"] <= p < seg["address"] + seg["total_size"]:
                return tuple(seg["segment_pool_id"])
        raise AssertionError("tensor outside every segment")

    cached = [t for t in prim._DIVISORS.values() if t.is_cuda]
    cached += [v[1] for v in E._dev_cache.values()
               if torch.is_tensor(v[1]) and v[1].is_cuda]
    graph_pools = {pool_of(c.data) for cq in s._replay_cache.values()
                   for c in cq.static_out.columns.values()}
    assert graph_pools and (0, 0) not in graph_pools
    assert {pool_of(t) for t in cached} <= {(0, 0)}


@pytest.mark.gpu
def test_failed_capture_blacklists_with_its_reason(replay_session,
                                                   monkeypatch):
    """A pageable host-to-device copy inside the capture fails it: the
    statement is blacklisted with the reason, every sight still returns
    the eager rows on the card, and no launch is left counted for the
    capture."""
    real = K.segment_sum_i64

    def copying(values, gids, ngroups):
        if torch.cuda.is_current_stream_capturing():
            torch.as_tensor(np.arange(4)).to(gids.device)  # pageable
        return real(values, gids, ngroups)

    monkeypatch.setattr(K, "segment_sum_i64", copying)
    s = replay_session
    (r1, _s1, l1, t1), (r2, _s2, l2, t2), (r3, _s3, l3, t3) = \
        _replay_tiers(s, REPLAY_Q)
    assert r1 == r2 == r3 and r1
    reason = s.replay_reason(REPLAY_Q)
    assert reason and reason.startswith("capture failed")
    assert t2 == t3 == f"blacklisted: {reason}"
    assert not s._replay_cache
    # the record pass and the warm-up replay launched; the capture did not
    assert l3 == l1 and l2 == {k: 2 * v for k, v in l1.items()}
    assert torch.cuda.get_sync_debug_mode() == 0


# ---------------------------------------------------------------------------
# the streamed per-chunk program captured as one CUDA graph
# ---------------------------------------------------------------------------

# a star join (K4 + K5), a scan of the fact alone, and a fan-out join
# (K5; at 2 partitions the P bodies of one graph)
STREAM_QS = [
    "select d_year, i_brand_id, sum(ss_price) s from store_sales, "
    "date_dim, item where ss_date = d_date_sk and ss_item = i_item_sk "
    "and d_moy = 11 and ss_price > 100 group by d_year, i_brand_id "
    "order by d_year, s desc, i_brand_id",
    "select ss_item, count(*) c, sum(ss_price) s from store_sales "
    "where ss_price > 5000 group by ss_item order by ss_item",
    "select ss_item, count(*) c, sum(sr_amt) r from store_sales, "
    "store_returns where ss_item = sr_item and ss_price > 5000 "
    "group by ss_item order by ss_item",
]


def _stream_session(conf=None, device="cuda", seed=42):
    import pyarrow as pa

    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.engine.table import ChunkedTable
    rng = np.random.default_rng(seed)
    n, nd = 200_000, 365
    s = Session(conf=dict(conf or {}), device=device)
    s.create_temp_view("date_dim", pa.table({
        "d_date_sk": pa.array(np.arange(1, nd + 1), pa.int64()),
        "d_year": pa.array(1998 + np.arange(nd) // 120, pa.int64()),
        "d_moy": pa.array(1 + (np.arange(nd) // 30) % 12, pa.int64()),
    }), base=True)
    s.create_temp_view("item", pa.table({
        "i_item_sk": pa.array(np.arange(1, 201), pa.int64()),
        "i_brand_id": pa.array(rng.integers(1000, 1020, 200), pa.int64()),
    }), base=True)
    s.create_temp_view("store_returns", pa.table({
        "sr_item": pa.array(np.repeat(np.arange(1, 201), 3), pa.int64()),
        "sr_ticket": pa.array(np.arange(600), pa.int64()),
        "sr_amt": pa.array(rng.integers(1, 100, 600), pa.int64()),
    }), base=True)
    s.create_temp_view("store_sales", ChunkedTable(pa.table({
        "ss_date": pa.array(rng.integers(1, nd + 40, n), pa.int64()),
        "ss_item": pa.array(rng.integers(1, 230, n), pa.int64()),
        "ss_price": pa.array(rng.integers(1, 10_000, n), pa.int64()),
    }), chunk_rows=1 << 15), base=True)
    return s


def _drive_launches(events):
    """K4 and K5 launches of the compiled drives (a first execution's
    record of the program is not a drive)."""
    return [(e.scan_launches, e.probe_launches) for e in events]


def _streamed(s, q, graph=True):
    """(rows, K4 and K5 launches, drained stream events) of one
    statement."""
    from nds_tpu_torch.listener import drain_stream_events
    drain_stream_events()
    l0 = dict(K.LAUNCHES)
    rows = s.sql(q, graph=graph).collect()
    return (rows, {k: K.LAUNCHES[k] - l0[k]
                   for k in ("chunk_scan", "join_probe")},
            drain_stream_events())


@pytest.fixture()
def stream_sessions(cuda):
    from nds_tpu_torch.engine import stream as S
    S._PIPELINE_CACHE.clear()
    return {"one": _stream_session(),
            "partitioned": _stream_session({"stream_partitions": 2})}


@pytest.mark.gpu
@pytest.mark.parametrize("sess", ["one", "partitioned"])
@pytest.mark.parametrize("q", range(len(STREAM_QS)))
def test_stream_graph_equals_the_eager_drive(stream_sessions, sess, q):
    """The first drive captures the per-chunk program, the next replays
    it: both give the eager drive's rows with its K4 and K5 launches (the
    first execution also records the program, which launches on its
    own)."""
    s, sql = stream_sessions[sess], STREAM_QS[q]
    r1, l1, e1 = _streamed(s, sql)
    r2, l2, e2 = _streamed(s, sql)
    r3, l3, e3 = _streamed(s, sql, graph=False)
    assert r1 == r2 == r3 and r1
    assert [e.graph for e in e1] == ["captured"], \
        [(e.path, e.reason, e.graph) for e in e1]
    assert [e.graph for e in e2] == ["replayed"]
    assert [e.graph for e in e3] == ["eager drive"]
    assert l2 == l3 and l2["chunk_scan"] + l2["join_probe"] > 0
    assert _drive_launches(e1) == _drive_launches(e2) == \
        _drive_launches(e3)
    if sess == "partitioned" and q == 2:
        assert [e.partitions for e in e2] == [2]


@pytest.mark.gpu
def test_stream_graph_loop_makes_no_synchronizing_call(stream_sessions,
                                                       monkeypatch):
    """Every step of the chunk loop (the copy into the slots, the replay,
    the ring's fetch) runs under sync debug mode ``error``: a
    synchronizing call would raise."""
    from nds_tpu_torch.engine import prefetch as PF
    from nds_tpu_torch.engine import stream as S
    steps = []

    def strict(real):
        def run(*a, **k):
            steps.append(1)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return real(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run

    s = stream_sessions["one"]
    want = _streamed(s, STREAM_QS[0])[0]            # captured
    monkeypatch.setattr(S.StreamPipeline, "_step",
                        strict(S.StreamPipeline._step))
    for ring in (PF.ChunkRing, PF._InlineRing):
        monkeypatch.setattr(ring, "next_chunk", strict(ring.next_chunk))
    rows, _l, events = _streamed(s, STREAM_QS[0])
    assert rows == want and [e.graph for e in events] == ["replayed"]
    assert len(steps) >= 2 * events[0].chunks - 1


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [0, 1, 2])
def test_stream_graph_rows_do_not_depend_on_ring_depth(cuda, depth):
    from nds_tpu_torch.engine import stream as S
    S._PIPELINE_CACHE.clear()
    want = _streamed(_stream_session(), STREAM_QS[2], graph=False)[0]
    s = _stream_session({"prefetch_depth": depth})
    for graph in ("captured", "replayed"):
        rows, _l, events = _streamed(s, STREAM_QS[2])
        assert rows == want and [e.graph for e in events] == [graph]


@pytest.mark.gpu
def test_refused_capture_records_its_reason(stream_sessions, monkeypatch):
    """A pageable host-to-device copy inside the capture refuses it: the
    statement runs the eager drive with the eager rows and launches, the
    event says why, and later executions stay on the eager drive."""
    s = stream_sessions["one"]
    _streamed(s, STREAM_QS[0], graph=False)           # records
    want, launches, _e = _streamed(s, STREAM_QS[0], graph=False)
    real = K.chunk_scan

    def copying(*a):
        if torch.cuda.is_current_stream_capturing():
            torch.as_tensor(np.arange(4)).to("cuda")      # pageable
        return real(*a)

    monkeypatch.setattr(K, "chunk_scan", copying)
    for _ in range(2):
        rows, got, events = _streamed(s, STREAM_QS[0])
        assert rows == want and got == launches
        (e,) = events
        assert e.path == "compiled" and \
            e.graph.startswith("refused: capture failed"), e.graph
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.gpu
def test_stream_cache_across_sessions_rebuilds_and_captures(cuda):
    """Sessions over seeds 42 and 7 (equal shapes, other dimension
    content) driven A, B, A in one process: each execution evicts the
    other session's pipeline and builds and captures its own (path
    ``compiled``, never an eager rerun), with that session's cpu rows."""
    from nds_tpu_torch.engine import stream as S
    S._PIPELINE_CACHE.clear()
    q = STREAM_QS[0]
    want = {seed: _stream_session(device="cpu", seed=seed).sql(q).collect()
            for seed in (42, 7)}
    assert want[42] != want[7]
    sessions = {seed: _stream_session(seed=seed) for seed in (42, 7)}
    for seed in (42, 7, 42):
        rows, launches, events = _streamed(sessions[seed], q)
        assert rows == want[seed]
        assert [(e.path, e.graph) for e in events] == \
            [("compiled", "captured")], [(e.path, e.reason) for e in events]
        assert launches["chunk_scan"] > 0


@pytest.mark.gpu
def test_stream_graph_recaptures_after_its_pipeline_is_dropped(cuda):
    """A pipeline whose graph was the only one in the session's pool is
    dropped (as an eviction or a pipeline rebuilt for new parts drops
    it); the next execution captures into the same pool again."""
    from nds_tpu_torch.engine import stream as S
    S._PIPELINE_CACHE.clear()
    s = _stream_session()
    want, _l, e1 = _streamed(s, STREAM_QS[1])
    for _ in range(2):
        S._PIPELINE_CACHE.clear()
        rows, _l, events = _streamed(s, STREAM_QS[1])
        assert rows == want and [e.graph for e in events] == ["captured"], \
            [e.graph for e in events]
    assert [e.graph for e in e1] == ["captured"]


# ---------------------------------------------------------------------------
# Data Maintenance and device admission on the card
# ---------------------------------------------------------------------------


def _dm_inputs(root):
    """(base warehouse dir, refresh set 1 dir) at SF0.01, made by the
    port's own data generation and Load Test."""
    import argparse

    from nds_tpu_torch import datagen, transcode
    gen = dict(type="local", scale="0.01", parallel=2, range=None,
               overwrite_output=True, rngseed=None)
    raw, refresh = str(root / "raw"), str(root / "refresh_1")
    datagen.generate_data(argparse.Namespace(data_dir=raw, update=None,
                                             **gen))
    datagen.generate_data(argparse.Namespace(data_dir=refresh, update="1",
                                             **gen))
    base = str(root / "warehouse")
    transcode.transcode(argparse.Namespace(
        input_prefix=raw, output_prefix=base,
        report_file=str(root / "load.txt"), output_format="iceberg",
        tables=None, compression=None, update=False, floats=False,
        allow_missing=False))
    return raw, base, refresh


def _arrow_agree(a, b) -> str | None:
    """None when two arrow tables agree: schema equal, exact kinds equal,
    doubles within rel 1e-5."""
    import math

    import pyarrow as pa
    if a.schema != b.schema or a.num_rows != b.num_rows:
        return f"schema or rows: {a.schema} {a.num_rows} vs {b.num_rows}"
    for name in a.column_names:
        x, y = a[name].to_pylist(), b[name].to_pylist()
        if pa.types.is_floating(a.schema.field(name).type):
            for r, (u, v) in enumerate(zip(x, y)):
                if (u is None) != (v is None) or (u is not None and not (
                        math.isnan(u) and math.isnan(v)) and not math.isclose(
                        u, v, rel_tol=1e-5, abs_tol=1e-12)):
                    return f"{name} row {r}: {u} vs {v}"
        elif x != y:
            r = next(i for i, (u, v) in enumerate(zip(x, y)) if u != v)
            return f"{name} row {r}: {x[r]!r} vs {y[r]!r}"
    return None


@pytest.mark.gpu
def test_data_maintenance_cuda_matches_cpu(cuda, tmp_path):
    """The 11 refresh functions of set 1 at SF0.01 commit the same
    snapshots on cuda as on cpu."""
    import shutil

    from nds_tpu_torch.maintenance import run_maintenance
    from nds_tpu_torch.warehouse import Warehouse
    _raw, base, refresh = _dm_inputs(tmp_path)
    dm_sql = os.path.join(REPO, "data_maintenance")
    whs = {}
    for dev in ("cuda", "cpu"):
        whs[dev] = str(tmp_path / f"wh_{dev}")
        shutil.copytree(base, whs[dev])
        _s, failed = run_maintenance(whs[dev], refresh, dm_sql,
                                     str(tmp_path / f"{dev}.csv"),
                                     device=dev)
        assert failed == [], dev
    a, b = Warehouse(whs["cuda"]), Warehouse(whs["cpu"])
    changed = 0
    for table in a.tables():
        snaps = [s["id"] for s in a.snapshots(table)]
        assert snaps == [s["id"] for s in b.snapshots(table)], table
        changed += len(snaps) > 1
        for sid in snaps:
            why = _arrow_agree(a.read(table, sid), b.read(table, sid))
            assert why is None, (table, sid, why)
    assert changed == 7


@pytest.mark.gpu
def test_admission_across_two_cuda_streams(cuda, tmp_path):
    """Two Throughput streams on the card, one admission slot: both
    complete, every query waited for its slot, and no two queries of the
    two processes ran at once."""
    import glob
    import json
    import subprocess
    import sys

    from nds_tpu_torch.queries import generate_query_streams
    raw, _base, _refresh = _dm_inputs(tmp_path)
    generate_query_streams(str(tmp_path / "streams"), streams=2,
                           rngseed=1017, scale=0.01)
    env = dict(os.environ, PYTHONPATH=REPO, NDS_TPU_CONCURRENT_QUERIES="1",
               NDS_TPU_ADMISSION_DIR=str(tmp_path / "slots"))
    res = subprocess.run(
        [sys.executable, "-m", "nds_tpu_torch.throughput", "0,1", raw,
         str(tmp_path / "streams" / "query_{}.sql"),
         str(tmp_path / "tt_{}.csv"), "--input_format", "raw",
         "--sub_queries", "query3,query52,query96",
         "--json_summary_folder", str(tmp_path / "js_{}")],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    spans = []
    for sid in ("0", "1"):
        for fn in glob.glob(str(tmp_path / f"js_{sid}" / "*.json")):
            with open(fn) as f:
                d = json.load(f)
            assert d["queryStatus"] == ["Completed"] and \
                d["device"].startswith("cuda")
            assert d["concurrentQueries"] == 1 and d["hbmBytesInUse"] > 0
            spans.append((d["startTime"], d["startTime"] +
                          d["queryTimes"][-1]))
    assert len(spans) == 6
    spans.sort()
    for (_s0, e0), (s1, _e1) in zip(spans, spans[1:]):
        assert s1 >= e0 - 1, spans


# ---------------------------------------------------------------------------
# sharded streaming and the exchange on the card
# ---------------------------------------------------------------------------


def _sharded_conf(shards):
    return {"stream_partitions": 2, "stream_shards": shards}


@pytest.fixture()
def shared_card(cuda):
    """The shards of the streamed pipelines built in the test share the
    card."""
    from nds_tpu_torch.parallel import exchange as X
    with X.sharing_devices():
        yield


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("q", range(len(STREAM_QS)))
def test_sharded_stream_graph_equals_unsharded(shared_card, shards, q):
    """Shards sharing the card: the first drive captures the sharded
    per-chunk program as one graph, the next replays it; both give the
    unsharded rows, per-shard counts that sum to the survivors, and (the
    fan-out join) the exchange's all-to-alls every chunk."""
    from nds_tpu_torch.engine import stream as S
    S._PIPELINE_CACHE.clear()
    want = _streamed(_stream_session({"stream_partitions": 2}),
                     STREAM_QS[q], graph=False)[0]
    s = _stream_session(_sharded_conf(shards))
    r1, l1, e1 = _streamed(s, STREAM_QS[q])
    r2, l2, e2 = _streamed(s, STREAM_QS[q])
    r3, _l3, e3 = _streamed(s, STREAM_QS[q], graph=False)
    assert r1 == r2 == r3 == want and want
    assert [e.graph for e in e1] == ["captured"], [e.graph for e in e1]
    assert [e.graph for e in e2] == ["replayed"]
    assert [e.graph for e in e3] == ["eager drive"]
    for e in e1 + e2 + e3:
        assert e.shards == shards and sum(e.shard_rows) == e.rows
    assert [e.shard_rows for e in e2] == [e.shard_rows for e in e3]
    assert _drive_launches(e2) == _drive_launches(e3)
    assert l2["chunk_scan"] > 0
    if q == 2:
        assert e2[0].collectives >= 3 * e2[0].chunks
        assert l2["join_probe"] > 0


@pytest.mark.gpu
def test_sharded_stream_loop_makes_no_synchronizing_call(shared_card,
                                                         monkeypatch):
    from nds_tpu_torch.engine import prefetch as PF
    from nds_tpu_torch.engine import stream as S
    S._PIPELINE_CACHE.clear()
    s = _stream_session(_sharded_conf(2))
    want = _streamed(s, STREAM_QS[2])[0]             # captured

    def strict(real):
        def run(*a, **k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return real(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run

    monkeypatch.setattr(S.StreamPipeline, "_step",
                        strict(S.StreamPipeline._step))
    for ring in (PF.ChunkRing, PF._InlineRing):
        monkeypatch.setattr(ring, "next_chunk", strict(ring.next_chunk))
    rows, _l, events = _streamed(s, STREAM_QS[2])
    assert rows == want and [e.graph for e in events] == ["replayed"]


@pytest.mark.gpu
def test_capture_charges_its_pool_bytes(shared_card):
    from nds_tpu_torch.engine import stream as S
    S._PIPELINE_CACHE.clear()
    s = _stream_session(_sharded_conf(2))
    _streamed(s, STREAM_QS[0])
    rep = S.static_report()
    assert rep["pipelines"] >= 1 and rep["pool_bytes"] > 0
    assert rep["static_bytes"] + rep["pool_bytes"] <= rep["budget"]


@pytest.mark.gpu
def test_sharded_stream_across_distinct_cards(cuda):
    """Without sharing, two shards take two cards (the eager drive, which
    says why), with the unsharded rows."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from nds_tpu_torch.engine import stream as S
    S._PIPELINE_CACHE.clear()
    want = _streamed(_stream_session({"stream_partitions": 2}),
                     STREAM_QS[2])[0]
    s = _stream_session(_sharded_conf(2))
    for _ in range(2):
        rows, _l, events = _streamed(s, STREAM_QS[2])
        assert rows == want
        assert [(e.shards, e.graph) for e in events] == \
            [(2, "eager drive: 2 shards on 2 devices")], \
            [(e.path, e.reason) for e in events]


def _dead_row_join_inputs(frac, n=4096):
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 200, n)
    dead = rng.random(n) < frac
    row_ids = np.arange(n, dtype=np.uint64)
    lh = np.where(dead, (row_ids << 3) | 2,
                  (keys.astype(np.uint64) << 3) | 4).view(np.int64)
    rh = np.where(dead, (row_ids << 3) | 1,
                  (keys.astype(np.uint64) << 3) | 4).view(np.int64)
    return keys, dead, lh, rh


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("case", ["dead50", "dead95", "skew"])
def test_exchange_join_cuda_matches_cpu(cuda, shards, case):
    from nds_tpu_torch.parallel import exchange as X
    if case == "skew":
        rng = np.random.default_rng(9)
        keys = np.where(rng.random(1024) < 0.8, 7,
                        rng.integers(0, 50, 1024))
        lh = rh = ((keys.astype(np.uint64) << 3) | 4).view(np.int64)
        dead = np.zeros(1024, bool)
    else:
        keys, dead, lh, rh = _dead_row_join_inputs(
            {"dead50": 0.5, "dead95": 0.95}[case])
    rows = np.arange(lh.shape[0], dtype=np.int64)
    got = {}
    for dev in ("cpu", "cuda"):
        m = X.make_mesh(shards, device=dev, share=True)
        got[dev] = [t.cpu().numpy() for t in X.exchange_join_pairs(
            _t(lh).to(dev), _t(rows).to(dev), _t(rh).to(dev),
            _t(rows).to(dev), m)]
    for a, b in zip(got["cpu"], got["cuda"]):
        assert np.array_equal(a, b)
    live = got["cuda"][2]
    assert int(live.sum()) == sum(int(c) * int(c)
                                  for c in np.bincount(keys[~dead]))


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 8])
def test_distributed_q3_cuda_matches_cpu(cuda, shards):
    import math

    from nds_tpu_torch.parallel import distributed as D
    rng = np.random.default_rng(11)
    n, ni, nd = 8_001, 200, 400
    item = {"i_item_sk": np.arange(1, ni + 1, dtype=np.int64),
            "i_manufact_id": rng.integers(1, 10, ni).astype(np.int64),
            "i_brand_id": rng.integers(1000, 1020, ni).astype(np.int64)}
    date_dim = {"d_date_sk": np.arange(1, nd + 1, dtype=np.int64),
                "d_moy": rng.integers(1, 13, nd).astype(np.int64),
                "d_year": 1998 + (np.arange(nd, dtype=np.int64) // 100)}
    ss = {"ss_item_sk": rng.integers(1, ni + 50, n).astype(np.int64),
          "ss_sold_date_sk": rng.integers(1, nd + 30, n).astype(np.int64),
          "ss_ext_sales_price": rng.integers(1, 10_000, n).astype(np.int64)}
    out = {dev: D.run_distributed_q3(
        D.make_mesh(shards, device=dev, share=True), ss, date_dim, item,
        manufact_id=3, moy=11) for dev in ("cpu", "cuda")}
    for k in ("d_year", "i_brand_id", "item_index", "count"):
        assert np.array_equal(out["cpu"][k], out["cuda"][k]), k
    assert all(math.isclose(a, b, rel_tol=1e-5) for a, b in zip(
        out["cpu"]["sum_agg"], out["cuda"]["sum_agg"]))
    assert len(out["cuda"]["count"]) > 0



@pytest.mark.gpu
def test_capture_on_a_nearly_full_card_empties_the_cache(cuda, monkeypatch):
    """A capture that finds less than an eighth of the card free hands the
    allocator's cached blocks back first, then captures."""
    from nds_tpu_torch.engine import stream as S
    S._PIPELINE_CACHE.clear()
    want = _streamed(_stream_session(), STREAM_QS[1], graph=False)[0]
    s = _stream_session()
    real_info, calls = torch.cuda.mem_get_info, []
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (1, real_info(dev)[1]))
    real_empty = torch.cuda.empty_cache
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: (calls.append(1), real_empty()))
    rows, _l, events = _streamed(s, STREAM_QS[1])
    assert rows == want and calls
    assert [e.graph for e in events] == ["captured"]


@pytest.mark.gpu
def test_exchange_and_q3_across_distinct_cards(cuda):
    """The repartition join and q3 on a mesh of distinct cards (each shard
    its own device, the all-to-all a copy between cards) equal the same
    calls on the CPU."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two CUDA devices")
    from nds_tpu_torch.parallel import distributed as D
    from nds_tpu_torch.parallel import exchange as X
    shards = 1 << (min(n_cards, 8).bit_length() - 1)
    keys, _dead, lh, rh = _dead_row_join_inputs(0.5)
    rows = np.arange(lh.shape[0], dtype=np.int64)
    got = {}
    for dev, mesh in (("cpu", X.make_mesh(shards, device="cpu", share=True)),
                      ("cuda", X.make_mesh(shards, device="cuda"))):
        assert dev == "cpu" or not mesh.one_device()
        got[dev] = [t.cpu().numpy() for t in X.exchange_join_pairs(
            _t(lh).to(dev), _t(rows).to(dev), _t(rh).to(dev),
            _t(rows).to(dev), mesh)]
    for a, b in zip(got["cpu"], got["cuda"]):
        assert np.array_equal(a, b)
    rng = np.random.default_rng(11)
    ss = {"ss_item_sk": rng.integers(1, 250, 4001).astype(np.int64),
          "ss_sold_date_sk": rng.integers(1, 430, 4001).astype(np.int64),
          "ss_ext_sales_price": rng.integers(1, 9999, 4001).astype(np.int64)}
    item = {"i_item_sk": np.arange(1, 201, dtype=np.int64),
            "i_manufact_id": rng.integers(1, 10, 200).astype(np.int64),
            "i_brand_id": rng.integers(1000, 1020, 200).astype(np.int64)}
    date_dim = {"d_date_sk": np.arange(1, 401, dtype=np.int64),
                "d_moy": rng.integers(1, 13, 400).astype(np.int64),
                "d_year": 1998 + (np.arange(400, dtype=np.int64) // 100)}
    a = D.run_distributed_q3(D.make_mesh(shards, device="cpu", share=True),
                             ss, date_dim, item, manufact_id=3, moy=11)
    b = D.run_distributed_q3(D.make_mesh(shards, device="cuda"), ss,
                             date_dim, item, manufact_id=3, moy=11)
    for k in ("d_year", "item_index", "count"):
        assert np.array_equal(a[k], b[k]), k
    assert np.allclose(a["sum_agg"], b["sum_agg"], rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# the meshed resident session
# ---------------------------------------------------------------------------


def _mesh_tables():
    """A fact table and two small dimensions, from a fixed seed."""
    import pyarrow as pa
    rng = np.random.default_rng(31)
    n = 20000
    return {
        "sales": pa.table({
            "s_item": pa.array(rng.integers(1, 90, n), pa.int64()),
            "s_date": pa.array(rng.integers(1, 300, n), pa.int64()),
            "s_qty": pa.array(rng.integers(1, 50, n), pa.int64()),
            "s_price": pa.array([None if x % 17 == 0 else float(x) / 7
                                 for x in rng.integers(1, 9000, n)],
                                pa.float64())}),
        "items": pa.table({
            "i_item": pa.array(np.arange(1, 81), pa.int64()),
            "i_cat": pa.array([f"cat{k % 7}" for k in range(80)])}),
        "dates": pa.table({
            "d_date": pa.array(np.arange(1, 301), pa.int64()),
            "d_year": pa.array(1998 + np.arange(300) // 100, pa.int64())}),
    }


MESH_SQL = [
    """select d_year, i_cat, sum(s_qty) qty, count(*) cnt, avg(s_price) p,
              min(s_price) lo
       from sales, items, dates
       where s_item = i_item and s_date = d_date and s_qty > 5
       group by d_year, i_cat order by d_year, i_cat""",
    """select s_item, s_qty, i_cat from sales, items
       where s_item = i_item and s_qty > 47 order by s_item, s_qty, i_cat""",
]


def _mesh_rows(session, tables):
    for name, t in tables.items():
        session.create_temp_view(name, t)
    return [session.sql(q).collect() for q in MESH_SQL]


def _rows_equal(a, b) -> bool:
    """Exact kinds bit for bit, doubles within rel 1e-5 (a double sum's
    order on the card is not fixed), row order exact."""
    import math

    def same(x, y):
        if isinstance(x, float) and isinstance(y, float):
            return math.isclose(x, y, rel_tol=1e-5, abs_tol=1e-12)
        return x == y

    return len(a) == len(b) and all(
        len(ra) == len(rb) and all(same(x, y) for x, y in zip(ra, rb))
        for ra, rb in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("limit", [20000, 64])
def test_meshed_session_sharing_the_card_equals_unmeshed(cuda, limit):
    """Mesh 2 with both shards on this card (inside the sharing seam, on
    a host of any number of cards), the fact row-sharded (and at 64 bytes
    everything, so the join takes the exchange), gives the unmeshed rows;
    a third sight replays as one CUDA graph."""
    from nds_tpu_torch.engine import sharded as SH
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.parallel import exchange as X
    tables = _mesh_tables()
    want = _mesh_rows(Session({"replay": "off"}, device="cuda"), tables)
    with X.sharing_devices():
        s = Session({"mesh_shape": 2, "broadcast_bytes": limit,
                     "replay": "force"}, device="cuda")
    assert s.mesh.one_device() and s.mesh.devices[0] == torch.device(
        "cuda", torch.cuda.current_device())
    SH.COUNTS["exchange_joins"] = 0
    got = _mesh_rows(s, tables)
    assert all(_rows_equal(g, w) for g, w in zip(got, want))
    assert s.catalog["sales"].spec == "row"
    assert (SH.COUNTS["exchange_joins"] > 0) == (limit == 64)
    for tier in ("record", "replayed"):
        assert _rows_equal(s.sql(MESH_SQL[0]).collect(), want[0])
        assert s.last_tier == tier, s.replay_reason(MESH_SQL[0])


@pytest.mark.gpu
def test_meshed_session_across_distinct_cards(cuda):
    """Mesh 2 on two cards (no sharing): the unmeshed rows, and replay
    refused with its reason."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: a distinct-card mesh puts "
                    "each shard on a card of its own")
    from nds_tpu_torch.engine.session import Session
    tables = _mesh_tables()
    want = _mesh_rows(Session({"replay": "off"}, device="cuda"), tables)
    s = Session({"mesh_shape": 2, "broadcast_bytes": 64, "replay": "force"},
                device="cuda")
    assert not s.mesh.one_device()
    got = _mesh_rows(s, tables)
    assert all(_rows_equal(g, w) for g, w in zip(got, want))
    for _ in range(2):
        assert _rows_equal(s.sql(MESH_SQL[0]).collect(), want[0])
    assert s.last_tier.startswith("blacklisted: meshed over distinct")


@pytest.mark.gpu
def test_raw_wire_stream_on_cuda_equals_cpu(cuda, monkeypatch):
    """Under ``NDS_TPU_ENCODED=0`` a streamed statement uploads its
    int64 columns at 8 bytes a row: K4 runs its int64 lane with the
    ``"id"`` decode on the card, and the rows are the CPU's, captured and
    replayed."""
    from nds_tpu_torch.engine import stream as S
    monkeypatch.setenv("NDS_TPU_ENCODED", "0")
    S._PIPELINE_CACHE.clear()
    lanes = []
    real = K.chunk_scan

    def scan(flat, n_dev, spec, bound=None):
        if flat[spec.cols[0][0]].device.type == "cuda" and \
                not torch.cuda.is_current_stream_capturing():
            lanes.extend((flat[c[0]].dtype, c[2]) for c in spec.cols)
        return real(flat, n_dev, spec, bound)

    monkeypatch.setattr(K, "chunk_scan", scan)
    want = _stream_session(device="cpu").sql(STREAM_QS[1]).collect()
    s = _stream_session()
    for graph in ("captured", "replayed"):
        rows, launches, events = _streamed(s, STREAM_QS[1])
        assert rows == want and rows
        assert [e.graph for e in events] == [graph]
        assert launches["chunk_scan"] > 0
    assert (torch.int64, "id") in lanes


@pytest.mark.gpu
def test_validate_cuda_against_cpu_outputs(cuda, tmp_path):
    """Power Runs of four statements at SF0.01 on cuda and on cpu write
    outputs that ``python -m nds_tpu_torch.validate`` passes, every
    summary ``Pass``."""
    import argparse
    import glob
    import json
    import subprocess
    import sys

    from nds_tpu_torch import datagen
    from nds_tpu_torch.queries import generate_query_streams
    raw = str(tmp_path / "raw")
    datagen.generate_data(argparse.Namespace(
        data_dir=raw, update=None, type="local", scale="0.01", parallel=2,
        range=None, overwrite_output=True, rngseed=None))
    generate_query_streams(str(tmp_path), streams=1, rngseed=19620718,
                           scale=0.01)
    stream = str(tmp_path / "query_0.sql")
    subset = "query3,query7,query78,query96"
    for dev in ("cuda", "cpu"):
        res = subprocess.run(
            [sys.executable, "-m", "nds_tpu_torch.power", raw, stream,
             str(tmp_path / f"{dev}.csv"), "--input_format", "raw",
             "--device", dev, "--output_prefix", str(tmp_path / dev),
             "--json_summary_folder", str(tmp_path / f"{dev}_json"),
             "--sub_queries", subset],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-2000:]
    res = subprocess.run(
        [sys.executable, "-m", "nds_tpu_torch.validate",
         str(tmp_path / "cpu"), str(tmp_path / "cuda"), stream,
         "--json_summary_folder", str(tmp_path / "cuda_json"),
         "--sub_queries", subset],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:]
    statuses = []
    for fn in glob.glob(str(tmp_path / "cuda_json" / "*.json")):
        with open(fn) as f:
            statuses.append(json.load(f)["queryValidationStatus"])
    assert statuses == [["Pass"]] * 4


# ------------------------------------------------- parameterized plans


@pytest.mark.gpu
def test_param_bound_pipeline_captures_once_and_replays(cuda):
    """K=4 parameter vectors of each bindable harness template: one
    pipeline, one capture and 3 replays, the rows those of a fresh
    recording of each vector (``NDS_TPU_PARAM_BIND=0``)."""
    from nds_tpu_torch.tools import param_audit_diff as D
    tables = D.toy_tables(np.random.default_rng(20260117))
    fresh = D.fresh_recording(tables, "cuda")
    arm = D.run_bind_arm("base", {}, False, tables, "cuda")
    for t in D.TEMPLATES:
        got = arm["templates"][t["name"]]
        assert got["rows"] == fresh[t["name"]], t["name"]
        if t["bindable"]:
            assert got["graphs"] == ["captured"] + ["replayed"] * 3
            assert (got["n_keys"], got["misses"], got["hits"]) == (1, 1, 3)
        else:
            assert got["graphs"] == ["captured"] * 4


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["c > {}", "c = {}",
                                   "c between {} and {}",
                                   "c not between {} and {}"])
def test_k4_bound_words_match_plain(cuda, shape):
    """K4 over one execution's bound words against its plain version over
    the same bound entries, on a FOR-encoded decimal column."""
    from nds_tpu_torch.analysis.param_audit import conjunct_bind_slots
    from nds_tpu_torch.engine import exprs as X
    from nds_tpu_torch.engine.column import Encoding
    from nds_tpu_torch.sql import parser as PP
    rng = np.random.default_rng(7)
    n = 40_000
    codes = rng.integers(0, 30_000, n).astype(np.int32)
    valid = rng.random(n) > 0.05
    meta = {"name": "l.c", "kind": "dec(7,2)", "enc": Encoding("for", -9000),
            "dict_values": None, "data_slot": 0, "valid_slot": 1}

    def conj(vals):
        return PP.parse("select 1 from l where "
                        + shape.format(*vals)).body.where
    vectors = [("12.34", "99.99"), ("0.00", "0.00"), ("150.05", "3.00"),
               ("46116860184273879.00", "1.00")]
    k = shape.count("{}")
    build = conj(vectors[0][:k])
    slots = conjunct_bind_slots(build, True, False)
    spec, kept = X.lower_scan_spec(
        [build], [meta], lambda c: True,
        {id(nd): i for i, (_p, nd, _t) in enumerate(slots)})
    assert kept == [] and spec.binds
    words0, lay = K.packed_scan_spec(spec)
    flat_cpu = (_t(codes), _t(valid))
    flat = tuple(x.to(cuda) for x in flat_cpu)
    n_live = n - 17
    for vals in vectors:
        values = [nd.value for (_p, nd, _t)
                  in conjunct_bind_slots(conj(vals[:k]), True, False)]
        entries = K.bind_scan_entries(spec, values)
        full = words0.copy()
        full[:lay.off_cols] = K.bind_scan_words(spec, entries)
        words = torch.as_tensor(full).to(cuda)
        l0 = K.LAUNCHES["chunk_scan"]
        m, _h = K.chunk_scan(flat, torch.tensor(n_live, device=cuda), spec,
                             K.ScanBinding(entries, words))
        assert K.LAUNCHES["chunk_scan"] == l0 + 1
        want, _ = K.chunk_scan_plain(flat_cpu, torch.tensor(n_live), spec,
                                     entries)
        assert torch.equal(m.cpu(), want), vals


# ------------------------------------------------- the static cost model


@pytest.fixture(scope="module")
def perf_evidence():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    from nds_tpu_torch.tools import perf_audit_diff as PD
    return PD.collect("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arm", ["base", "sharded", "encoded-off"])
def test_launch_band_and_bytes_hold_on_the_card(perf_evidence, arm):
    """``tools.perf_audit_diff``'s arm on the card: every sight (captured,
    replayed, eager drive) uploads the closed form's bytes, the sharded
    arm's collectives move the exchange's, and each scan's K4/K5
    launches lie in the static band, the arm's total nonzero."""
    from nds_tpu_torch.tools import perf_audit_diff as PD
    (got,) = [c for c in perf_evidence if c[0] == arm]
    name, reports, evidence, counted = got
    assert counted
    ok, lines, rec = PD.compare(name, reports, evidence, counted)
    assert ok, "\n".join(lines)
    assert rec["launches"] > 0
    assert rec["band"][0] <= rec["launches"] <= rec["band"][1]
    for runs in evidence.values():
        graphs = {g for s in ("cold", "warm") for g in runs[s]["graphs"]}
        assert graphs <= {"captured", "replayed"}, graphs


@pytest.mark.gpu
def test_launch_band_drift_is_rejected(perf_evidence):
    from nds_tpu_torch.tools import perf_audit_diff as PD
    ok, lines, _recs = PD.check(perf_evidence, inject=True)
    assert not ok
    assert any("K4/K5 launches outside the band" in ln for ln in lines)


@pytest.mark.gpu
def test_rollup_avg_of_a_decimal_equals_cpu(cuda):
    """The ROLLUP path's AVG descale divides through ``prim.true_div``
    (hazard H6): the card's doubles equal the CPU's bit for bit."""
    import pyarrow as pa
    from decimal import Decimal

    from nds_tpu_torch.engine.session import Session
    rng = np.random.default_rng(11)
    n = 5000
    tbl = pa.table({
        "g": pa.array(rng.integers(0, 7, n), pa.int64()),
        "h": pa.array(rng.integers(0, 3, n), pa.int64()),
        "p": pa.array([Decimal(int(c)) / 100 for c in
                       rng.integers(1, 10 ** 6, n)], pa.decimal128(7, 2)),
    })
    sql = ("select g, h, avg(p) a from t group by rollup(g, h) "
           "order by g, h")
    out = {}
    for dev in ("cpu", "cuda"):
        s = Session(conf={"replay": "off"}, device=dev)
        s.create_temp_view("t", tbl)
        out[dev] = s.sql(sql).collect()
    assert out["cuda"] == out["cpu"] and out["cpu"]


@pytest.mark.gpu
def test_replay_ab_on_cuda_times_the_replay_after_the_stream(replay_session,
                                                             monkeypatch):
    """``tools.replay_ab`` on two statements on the card: each captures
    one graph and replays the eager rows; every timed stage waits on the
    card's stream before its clock stops, so a replay's wall covers its
    work (the stream is idle when the clock stops)."""
    from nds_tpu_torch.tools import replay_ab as RA
    s = replay_session
    waits = []
    run = RA.timed_run(s)

    def checked(stage, sql):
        res, secs = run(stage, sql)
        waits.append((stage, torch.cuda.current_stream().query()))
        return res, secs

    for sql in ("select grp, count(*) c, sum(v) s from f, dim "
                "where d = sk group by grp order by grp",
                "select g, min(x) lo, max(x) hi from f, dim where d = sk "
                "group by g order by g"):
        row, runs = RA.measure(s, sql, reps=3, run=checked)
        RA.reset(s)
        assert row["compiled"] and row["segmented"] == 0, row
        assert 0 < row["replay_s"] and 0 < row["eager_s"]
        assert row["speedup"] == round(row["eager_s"] / row["replay_s"], 2)
        eager = [r for st, r, _s in runs if st == "seen"][0]
        assert all(r == eager for st, r, _s in runs
                   if st in ("record", "replay_first", "replay"))
    assert waits and all(idle for _st, idle in waits)
    assert not s._replay_cache and s._pool is None
    agg = RA.aggregate([{"query": "a", **row}], "cuda", "toy")
    assert agg["n_replayed"] == 1 and agg["backend"] == "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["device-put", "sync-retry"])
def test_fault_diff_entries_recover_on_cuda(cuda, entry):
    """fault_diff's upload and fetch entries on the card: rows bit for bit
    against the fault-free cuda run, the injection fired, one recovery
    event; K4 launched."""
    from nds_tpu_torch.tools import fault_diff as FD
    K.reset_launches()
    outcomes = {}
    failures = FD.run_diff(verbose=False, device="cuda", only={entry},
                           outcomes=outcomes)
    assert not failures, failures
    assert outcomes == {entry: "recovered"}
    assert K.LAUNCHES["chunk_scan"] > 0
