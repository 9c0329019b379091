# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The torch port's relational operators against ``nds_tpu.engine.ops`` on
the same inputs (made with numpy from a seed): hashing bit for bit, a
stable lexsort with ties, grouping, joins, the sync counters, and the
clip/fill/drop index rules."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nds_tpu.engine import ops as RO
from nds_tpu.engine.column import Column as RCol
from nds_tpu_torch.engine import ops as PO
from nds_tpu_torch.engine import prim
from nds_tpu_torch.engine.column import Column as PCol

torch.set_num_threads(1)   # tiny tensors: spare the other workers' cores


def _pair(kind, data, valid=None, dict_values=None):
    """The same column in both engines."""
    r = RCol(kind, jnp.asarray(data),
             None if valid is None else jnp.asarray(valid), dict_values)
    p = PCol(kind, torch.from_numpy(np.ascontiguousarray(data)),
             None if valid is None else torch.from_numpy(valid), dict_values)
    return r, p


@pytest.mark.parametrize("null_safe", [False, True])
@pytest.mark.parametrize("salt", [0, 1])
def test_key_hash_bit_for_bit(null_safe, salt):
    rng = np.random.default_rng(1 + salt + 2 * null_safe)
    n = 512
    a = rng.integers(-(1 << 62), 1 << 62, size=n).astype(np.int64)
    b = rng.integers(-1000, 1000, size=n).astype(np.int32)
    f = rng.normal(scale=1e6, size=n)
    f[:5] = [np.nan, np.inf, -np.inf, -0.0, 1e300]
    va = rng.random(n) > 0.1
    excl = rng.random(n) > 0.9
    ref = RO._key_hash_impl(
        (jnp.asarray(a), jnp.asarray(b), jnp.asarray(f)),
        (jnp.asarray(va), None, None), salt, null_safe, 400,
        jnp.asarray(excl))
    got = PO._key_hash_impl(
        (torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(f)),
        (torch.from_numpy(va), None, None), salt, null_safe, 400,
        torch.from_numpy(excl))
    assert np.array_equal(np.asarray(ref).view(np.int64), got.numpy())


def test_unsigned_order_matches_uint64_sort():
    rng = np.random.default_rng(5)
    h = rng.integers(0, np.iinfo(np.uint64).max, size=1000,
                     dtype=np.uint64)
    h[:4] = [0, 1 << 63, (1 << 64) - 1, 7]
    ref = np.argsort(h, kind="stable")
    got = prim.argsort_stable(PO.unsigned_order(torch.from_numpy(
        h.view(np.int64)))).numpy()
    assert np.array_equal(ref, got)


def test_lexsort_is_stable_with_ties_nulls_and_pads():
    rng = np.random.default_rng(9)
    n = 256
    k1 = rng.integers(0, 4, size=n).astype(np.int64)      # many ties
    k2 = rng.normal(size=n)
    k2[::17] = np.nan
    v2 = rng.random(n) > 0.2
    codes = rng.integers(0, 5, size=n).astype(np.int32)
    d = np.asarray(["e", "b", "d", "a", "c"], dtype=object)
    cols = [_pair("i64", k1), _pair("f64", k2, v2), _pair("str", codes, None,
                                                          d)]
    for desc, nl, nv in [([False, True, False], [False, True, False], None),
                         ([True, False, True], [True, False, False], 200)]:
        ref = RO.lexsort_indices([c[0] for c in cols], desc, nl, n_valid=nv)
        got = PO.lexsort_indices([c[1] for c in cols], desc, nl, n_valid=nv)
        assert np.array_equal(np.asarray(ref), got.numpy())
    # all keys tied: stable means identity order
    tied = _pair("i64", np.zeros(n, dtype=np.int64))
    assert np.array_equal(PO.lexsort_indices([tied[1]]).numpy(),
                          np.arange(n))


@pytest.mark.parametrize("pack", [False, True])
def test_group_ids_match(monkeypatch, pack):
    if pack:
        monkeypatch.setenv("NDS_TPU_GROUP_PACK_MIN", "1")   # the reference
        monkeypatch.setattr(PO, "GROUP_PACK_MIN", 1)         # the port
    rng = np.random.default_rng(21)
    n = 300
    a = rng.integers(0, 7, size=n).astype(np.int64)
    va = rng.random(n) > 0.2
    b = rng.integers(0, 3, size=n).astype(np.int32)
    d = np.asarray(["x", "y", "z"], dtype=object)
    cols = [_pair("i64", a, va), _pair("str", b, None, d)]
    rg, rn, rrep, rcap = RO.group_ids([c[0] for c in cols], n_valid=250)
    pg, pn, prep, pcap = PO.group_ids([c[1] for c in cols], n_valid=250)
    assert (rn, rcap) == (pn, pcap)
    assert np.array_equal(np.asarray(rg), pg.numpy())
    assert np.array_equal(np.asarray(rrep), prep.numpy())


@pytest.mark.parametrize("how", ["inner", "left", "right", "full"])
def test_join_indices_match(how):
    rng = np.random.default_rng(33)
    nl, nr = 200, 120
    lk = rng.integers(0, 60, size=nl).astype(np.int64)
    rk = rng.integers(0, 60, size=nr).astype(np.int64)
    lv = rng.random(nl) > 0.1
    L, R = _pair("i64", lk, lv), _pair("i64", rk)
    ref = RO.join_indices([L[0]], [R[0]], how, n_left=180, n_right=100)
    got = PO.join_indices([L[1]], [R[1]], how, n_left=180, n_right=100)
    n_ref = RO.count_int(ref[2])
    assert n_ref == PO.count_int(got[2])
    assert np.array_equal(np.asarray(ref[0])[:n_ref], got[0].numpy()[:n_ref])
    assert np.array_equal(np.asarray(ref[1])[:n_ref], got[1].numpy()[:n_ref])
    for i in (3, 5):
        if ref[i] is None:
            assert got[i] is None
        else:
            k = ref[i + 1]
            assert k == got[i + 1]
            assert np.array_equal(np.asarray(ref[i])[:k], got[i].numpy()[:k])


def test_semi_join_and_pk_gather_match():
    rng = np.random.default_rng(44)
    fk = rng.integers(-5, 80, size=300).astype(np.int64)
    fv = rng.random(300) > 0.1
    dk = rng.permutation(70).astype(np.int64) + 3
    F, D = _pair("i64", fk, fv), _pair("i64", dk)
    for neg in (False, True):
        ref = RO.semi_join_mask([F[0]], [D[0]], negate=neg, n_left=290,
                                n_right=60)
        got = PO.semi_join_mask([F[1]], [D[1]], negate=neg, n_left=290,
                                n_right=60)
        assert np.array_equal(np.asarray(ref), got.numpy())
    rr, rm = RO.pk_gather_join(F[0], D[0], 290, 60)
    pr, pm = PO.pk_gather_join(F[1], D[1], 290, 60)
    assert np.array_equal(np.asarray(rm), pm.numpy())
    m = np.asarray(rm)
    assert np.array_equal(np.asarray(rr)[m], pr.numpy()[m])


def test_index_rules_clip_fill_drop():
    a = torch.tensor([10, 20, 30], dtype=torch.int64)
    idx = torch.tensor([-4, -1, 0, 2, 3, 9])
    ja, ji = jnp.asarray([10, 20, 30]), jnp.asarray([-4, -1, 0, 2, 3, 9])
    assert prim.take_clip(a, idx).tolist() == \
        np.asarray(jnp.take(ja, ji, mode="clip")).tolist()
    assert prim.take_fill(a, idx, 7).tolist() == \
        np.asarray(jnp.take(ja, ji, mode="fill", fill_value=7)).tolist()
    assert prim.take(a, idx).tolist() == np.asarray(jnp.take(ja, ji)).tolist()
    assert prim.wrap_clamp(a, idx).tolist() == np.asarray(ja[ji]).tolist()
    tgt = torch.zeros(3, dtype=torch.int64)
    assert prim.scatter_set(tgt, idx, 1).tolist() == np.asarray(
        jnp.zeros(3, dtype=jnp.int64).at[ji].set(1, mode="drop")).tolist()
    assert prim.scatter_add(tgt, idx, 1).tolist() == np.asarray(
        jnp.zeros(3, dtype=jnp.int64).at[ji].add(1, mode="drop")).tolist()
    g = torch.tensor([0, 3, -1, 1, 2])
    assert prim.segment_sum(torch.ones(5, dtype=torch.int64), g,
                            3).tolist() == [1, 1, 1]
    assert prim.nonzero_sized(torch.tensor([0, 1, 1, 0, 1]).bool(), 2,
                              9).tolist() == [1, 2]
    assert prim.nonzero_sized(torch.tensor([0, 1, 0]).bool(), 4,
                              9).tolist() == [1, 9, 9, 9]
    x = torch.tensor([1e30, -1e30, float("nan"), 2.7, -2.7],
                     dtype=torch.float64)
    assert prim.f64_to_i64(x).tolist() == np.asarray(
        jnp.asarray([1e30, -1e30, np.nan, 2.7, -2.7]).astype(
            jnp.int64)).tolist()


def test_aggregates_match_reference_off_arm(monkeypatch):
    monkeypatch.setenv("NDS_TPU_PALLAS", "off")
    rng = np.random.default_rng(55)
    n, G = 400, 16
    gids = rng.integers(0, G + 2, size=n).astype(np.int64)   # pads >= G
    valid = rng.random(n) > 0.2
    dec = rng.integers(-10 ** 9, 10 ** 9, size=n).astype(np.int64)
    dbl = rng.normal(size=n)
    for kind, data in (("dec(7,2)", dec), ("f64", dbl), ("i64", dec)):
        r, p = _pair(kind, np.where(valid, data, 0), valid)
        rg, pg = jnp.asarray(gids), torch.from_numpy(gids)
        for fn in ("agg_sum", "agg_avg", "agg_count", "agg_min"):
            rc = getattr(RO, fn)(r, rg, G)
            pc = getattr(PO, fn)(p, pg, G)
            rv = np.asarray(rc.valid_mask())
            assert rc.kind == pc.kind, (kind, fn)
            assert np.array_equal(rv, pc.valid_mask().numpy()), (kind, fn)
            if pc.data.dtype.is_floating_point:
                np.testing.assert_allclose(pc.data.numpy()[rv],
                                           np.asarray(rc.data)[rv],
                                           rtol=1e-12)
            else:
                assert np.array_equal(pc.data.numpy()[rv],
                                      np.asarray(rc.data)[rv]), (kind, fn)


def test_host_reads_are_counted_and_counts_batch():
    before = PO.sync_count()
    c1 = PO.DeviceCount(torch.tensor(3), 10)
    c2 = PO.DeviceCount(torch.tensor(5), 10)
    assert PO.count_bound(c1) == 10
    assert c1.to_int() == 3 and c2.to_int() == 5      # one batched transfer
    assert PO.sync_count() - before == 1
    assert PO.host_sync(torch.tensor(7)) == 7
    assert PO.sync_count() - before == 2
    with pytest.raises(TypeError):
        bool(PO.DeviceCount(torch.tensor(1), 2))
    PO.resolve_counts()


def test_bucket_len_matches_reference():
    for n in (0, 1, 16, 17, 1000, 1 << 20, (1 << 20) + 1):
        assert PO.bucket_len(n) == RO.bucket_len(n)


@pytest.mark.parametrize("scale", [1, 2, 4])
def test_true_div_decodes_decimals_as_the_reference(scale):
    """The decimal-to-double decode (``prim.true_div`` by 10^scale) gives
    the reference's quotient bit for bit, the one IEEE division rounds."""
    codes = np.arange(-300_000, 300_000, 7, dtype=np.int64)
    got = prim.true_div(torch.from_numpy(codes).to(torch.float64),
                        10.0 ** scale)
    want = np.asarray(jnp.asarray(codes, dtype=jnp.float64) / 10.0 ** scale)
    np.testing.assert_array_equal(got.numpy().view(np.int64),
                                  want.view(np.int64))


def test_true_div_fills_each_divisor_once():
    """A decode divides by the divisor kept for its (value, dtype,
    device), filled at the first call: the later calls make no new one and
    give the same quotient."""
    x = torch.arange(-50, 50, dtype=torch.float64)
    first = prim.true_div(x, 1000.0)
    kept = prim._DIVISORS[(1000.0, torch.float64, x.device)]
    assert kept.dim() == 0 and kept.item() == 1000.0
    again = prim.true_div(x * 3, 1000.0)
    assert torch.equal(first, x / kept)
    assert prim._DIVISORS[(1000.0, torch.float64, x.device)] is kept
    assert torch.equal(again, (x * 3) / kept)
    f32 = prim.true_div(x.to(torch.float32), 1000.0)
    assert f32.dtype == torch.float32
    assert prim._DIVISORS[(1000.0, torch.float32, x.device)] is not kept
