# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The port's exchange and distributed q3 (``nds_tpu_torch.parallel``)
against the reference's (``nds_tpu.parallel``) on the CPU: the cases of
``tests/test_distributed.py`` (q3 at 8,000 and 8,001 fact rows,
``broadcast_join_agg``, the repartition join with 50 % and 95 % dead rows
and with skewed keys that force the capacity retry), plus the hash
exchange's bucketing and the filter-exchange-aggregate step. The same
numpy inputs, made from fixed seeds, go through the reference on the
tests' virtual JAX mesh and through the port on a mesh whose shards share
the CPU, at 2, 4 and 8 shards. Exact kinds match bit for bit (the join's
pair arrays whole, pad slots included), doubles within ``rel_tol=1e-5``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nds_tpu.parallel import exchange as RX
from nds_tpu.parallel import make_mesh as ref_mesh
from nds_tpu.parallel.distributed import (
    broadcast_join_agg as ref_bja, dim_probe_map as ref_dpm,
    replicate as ref_replicate, run_distributed_q3 as ref_q3,
    shard_fact_columns as ref_sfc)
from nds_tpu_torch.engine import ops as E
from nds_tpu_torch.listener import Manager
from nds_tpu_torch.parallel import distributed as D
from nds_tpu_torch.parallel import exchange as X

from tests.test_distributed import _q3_data, _q3_reference

torch.set_num_threads(1)

SHARDS = (2, 4, 8)


@pytest.fixture(autouse=True)
def _virtual_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the reference's virtual 8-device mesh")


def _mesh(n):
    return X.make_mesh(n, device="cpu", share=True)


def _close(a, b):
    return all(math.isclose(x, y, rel_tol=1e-5, abs_tol=0.0)
               for x, y in zip(np.asarray(a, float), np.asarray(b, float)))


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("n_fact", [8_000, 8_001])  # even and uneven shards
def test_q3_matches_reference(shards, n_fact):
    store_sales, date_dim, item = _q3_data(np.random.default_rng(11),
                                           n_fact=n_fact)
    want = ref_q3(ref_mesh(shards), store_sales, date_dim, item,
                  manufact_id=3, moy=11)
    syncs = E.sync_count()
    got = D.run_distributed_q3(_mesh(shards), store_sales, date_dim, item,
                               manufact_id=3, moy=11)
    assert E.sync_count() - syncs == 1          # the result's one read
    for k in ("d_year", "i_brand_id", "item_index", "count"):
        assert np.array_equal(got[k], np.asarray(want[k])), k
    assert _close(got["sum_agg"], want["sum_agg"])
    ref = _q3_reference(store_sales, date_dim, item, 3, 11)
    assert {(int(y), int(i)) for y, i in zip(got["d_year"],
                                             got["item_index"])} == set(ref)


@pytest.mark.parametrize("shards", SHARDS)
def test_broadcast_join_agg_matches_reference(shards):
    rng = np.random.default_rng(12)
    n = 4096
    fact_key = rng.integers(1, 100, n).astype(np.int64)
    weights = rng.integers(1, 5, n).astype(np.int64)
    dim_key = np.arange(1, 101, dtype=np.int64)[::-1].copy()
    codes = (dim_key % 7).astype(np.int64)

    rm = ref_mesh(shards)
    fact, alive = ref_sfc(rm, {"k": jnp.asarray(fact_key),
                               "w": jnp.asarray(weights)}, n)
    dks, dorder = ref_dpm(ref_replicate(rm, jnp.asarray(dim_key)))
    rs, rc = ref_bja(rm, fact, alive, dks, dorder,
                     ref_replicate(rm, jnp.asarray(codes)), 7,
                     weight_name="w", fact_key_name="k")

    m = _mesh(shards)
    pf, palive = D.shard_fact_columns(m, {"k": fact_key, "w": weights}, n)
    pks, porder = D.dim_probe_map(D.replicate(m, dim_key))
    ps, pc = D.broadcast_join_agg(m, pf, palive, pks, porder,
                                  D.replicate(m, codes), 7,
                                  weight_name="w", fact_key_name="k")
    assert np.array_equal(pc.numpy(), np.asarray(rc))
    assert int(pc.sum()) == n                   # every key matches
    assert _close(ps.numpy(), np.asarray(rs))


def _dead_row_hashes(frac, n=4096):
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 200, n)
    dead = rng.random(n) < frac
    row_ids = np.arange(n, dtype=np.uint64)
    # _key_hash_impl's layout: bits 0-1 side tag, bit 2 set on a real
    # hash, the row id from bit 3 on a dead one
    lh = np.where(dead, (row_ids << 3) | 2,
                  (keys.astype(np.uint64) << 3) | 4)
    rh = np.where(dead, (row_ids << 3) | 1,
                  (keys.astype(np.uint64) << 3) | 4)
    return keys, dead, lh, rh


def _both_joins(shards, lh, rh):
    n = lh.shape[0]
    rows = np.arange(n, dtype=np.int64)
    want = RX.exchange_join_pairs(jnp.asarray(lh), jnp.asarray(rows),
                                  jnp.asarray(rh), jnp.asarray(rows),
                                  ref_mesh(shards))
    got = X.exchange_join_pairs(torch.from_numpy(lh.view(np.int64)),
                                torch.from_numpy(rows),
                                torch.from_numpy(rh.view(np.int64)),
                                torch.from_numpy(rows), _mesh(shards))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    return [g.numpy() for g in got]


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("frac", [0.5, 0.95])
def test_exchange_join_dead_rows(shards, frac):
    keys, dead, lh, rh = _dead_row_hashes(frac)
    li, ri, live = _both_joins(shards, lh, rh)
    expect = sum(int(c) * int(c) for c in np.bincount(keys[~dead]))
    assert int(live.sum()) == expect
    li, ri = li[live], ri[live]
    assert not dead[li].any() and not dead[ri].any()
    assert (keys[li] == keys[ri]).all()


class _Retries:
    def __init__(self):
        self.seen = []

    def notify(self, where, reason, fatal):
        self.seen.append(where)


@pytest.mark.parametrize("shards", SHARDS)
def test_exchange_join_overflow_retry(shards):
    rng = np.random.default_rng(9)
    n = 1024
    # skewed keys: most rows share one key, so one destination bucket
    # overflows any capacity sized for the uniform case
    keys = np.where(rng.random(n) < 0.8, 7, rng.integers(0, 50, n))
    lh = (keys.astype(np.uint64) << 3) | 4
    listener = _Retries()
    Manager.register(listener)
    try:
        syncs = E.sync_count()
        _li, _ri, live = _both_joins(shards, lh, lh)
        reads = E.sync_count() - syncs
    finally:
        Manager.unregister(listener)
    assert int(live.sum()) == sum(int(c) * int(c) for c in np.bincount(keys))
    # one counted read of the counters a try, and every retry reported
    assert listener.seen and \
        set(listener.seen) == {"exchange join capacity retry"}
    assert reads == len(listener.seen) + 1


@pytest.mark.parametrize("shards", SHARDS)
def test_hash_dest_and_bucketize_match_reference(shards):
    rng = np.random.default_rng(21)
    keys = rng.integers(-(1 << 62), 1 << 62, 3000).astype(np.int64)
    keys[:5] = [0, -1, 7, 1 << 40, -(1 << 63)]
    for n_parts in (shards, 3, 5):
        want = RX.hash_partition_dest(jnp.asarray(keys.view(np.uint64)),
                                      n_parts)
        got = X.hash_partition_dest(torch.from_numpy(keys), n_parts)
        assert np.array_equal(np.asarray(want), got.numpy())
    dest = X.hash_partition_dest(torch.from_numpy(keys), shards)
    vals = np.arange(3000, dtype=np.int64) * 3
    cap = 3000 // shards // 2 + 1                 # some buckets overflow
    wb, wv, wo = RX.bucketize(jnp.asarray(dest.numpy().astype(np.int32)),
                              {"v": jnp.asarray(vals)}, shards, cap)
    gb, gv, go = X.bucketize(dest, {"v": torch.from_numpy(vals)}, shards,
                             cap)
    assert np.array_equal(np.asarray(wb["v"]), gb["v"].numpy())
    assert np.array_equal(np.asarray(wv), gv.numpy())
    assert int(wo) == int(go) > 0


@pytest.mark.parametrize("shards", SHARDS)
def test_filter_exchange_aggregate_matches_reference(shards):
    rng = np.random.default_rng(5)
    n, G = 4096, 64
    gk = rng.integers(0, G, n).astype(np.int32)
    qty = rng.integers(1, 100, n).astype(np.int64)
    sold = rng.integers(0, 365, n).astype(np.int32)
    cap = 2 * n // (shards * shards) + 16
    want = RX.sharded_filter_agg_step(ref_mesh(shards), G, cap)(
        jnp.asarray(gk), jnp.asarray(qty), jnp.asarray(sold),
        jnp.int32(30), jnp.int32(200))
    got = X.sharded_filter_agg_step(_mesh(shards), G, cap)(
        torch.from_numpy(gk), torch.from_numpy(qty), torch.from_numpy(sold),
        30, 200)
    assert np.array_equal(np.asarray(want[0]), got[0].gather().numpy())
    assert np.array_equal(np.asarray(want[1]), got[1].numpy())
    assert int(want[2]) == int(got[2])
    keep = (sold >= 30) & (sold <= 200)
    assert int(got[2]) == int(qty[keep].sum())
    assert int(got[1].sum()) == n


def test_collectives_are_counted():
    m = _mesh(4)
    parts = [torch.arange(8, dtype=torch.int64) for _ in range(4)]
    with X.collective_trace() as ct:
        total = X.psum_counted(parts, m)
        whole = X.all_gather_counted(parts, m)
    assert ct.counts == {"a2a": 0, "psum": 1, "all_gather": 1,
                         "bytes": 128}
    assert len(total) == 4 and int(total[0][1]) == 4
    assert whole[3].shape == (32,)
    assert X.collective_ops(ct.counts) == 2 and X.collective_ops(None) == 0


def test_mesh_needs_devices_or_sharing():
    with pytest.raises(ValueError, match="share=True"):
        X.make_mesh(2, device="cpu")
    m = X.make_mesh(3, device="cpu", share=True)
    assert m.size == 3 and m.one_device()
    assert X.stream_mesh(2, "cpu") is None
    assert X.stream_mesh(2, "cpu", share=True) is \
        X.stream_mesh(2, "cpu", share=True)
    parts = D.replicate(m, np.arange(3))
    assert X.mesh_of(parts) is None
    fact, _alive = D.shard_fact_columns(m, {"a": np.arange(7)}, 7)
    assert X.mesh_of(parts, fact["a"]) is m
    assert fact["a"].shape == (9,)
    assert fact["a"].gather().tolist() == [0, 1, 2, 3, 4, 5, 6, 0, 0]
