# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The port's CUDA kernels against their plain PyTorch versions on a card:
K1-K3 (grouped aggregation), K4 ``chunk_scan`` and K5 ``join_probe``. Every
test here is ``gpu``-marked and skips without a CUDA device. The module
imports neither jax nor the reference package, so it also runs where only
the port's requirements are installed::

    python -m pytest tests/test_torch_gpu.py -m gpu

The input builders double as the cases of ``tests/test_torch_scan.py``,
which holds the plain versions against the reference on the CPU."""

import numpy as np
import pytest
import torch

from nds_tpu_torch.engine import kernels as K

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
    raise KeyError(name)


_SCAN_CASES = ["all_survivors", "zero_survivors", "tile_boundary_rows",
               "dict_code_out_of_range", "validity_and_hash",
               "rich_predicates", "float_lane_nan_and_signed_zero",
               "narrow_codes_sign_extend"]



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
