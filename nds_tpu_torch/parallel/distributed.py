# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Distributed query execution over a mesh of shards.

The NDS flagship query shape over a :class:`~.exchange.Mesh`: scan a
row-sharded fact table, broadcast-join replicated dimension tables, and
merge the shards' partial aggregates with ``psum`` (a Spark stage with a
broadcast hash join feeding a partial/final hash aggregate).

Layout:

- **fact columns**: padded to a multiple of the shard count and split
  contiguously (:class:`~.exchange.Sharded`, ``spec="row"``); pad rows
  carry ``alive=False`` and are masked at the filter.
- **dimension columns**: replicated (``spec="rep"``): dimensions are tiny
  next to facts, so a broadcast join wins over a repartition join.
- **join**: each shard probes its fact rows against the replicated,
  sorted dimension keys (two ``searchsorted``\\ s and a gather); no
  collective.
- **aggregate**: a per-shard grouped sum into the dense group-id space
  (``prim.segment_sum``, an ``index_add_``), then ``psum`` over the
  shards.

Inputs of :func:`run_distributed_q3` are host arrays; its one device-to-
host read goes through the engine's sync choke point.
"""

from __future__ import annotations

import numpy as np
import torch

from nds_tpu_torch.engine import prim
from nds_tpu_torch.parallel.exchange import (Mesh, Sharded, make_mesh,
                                             psum_counted)

__all__ = ["make_mesh", "shard_fact_columns", "replicate", "dim_probe_map",
           "broadcast_join_agg", "run_distributed_q3"]

I64 = torch.int64
F64 = torch.float64


def _host_array(x) -> np.ndarray:
    """A host (numpy) input as an array; a tensor argument must already
    lie on the CPU (a device tensor would need a host read here)."""
    if torch.is_tensor(x):
        if x.device.type != "cpu":
            raise ValueError("expected a host array, got a tensor on "
                             f"{x.device}")
        return x.numpy()
    return np.asarray(x)


def _pad_to(arr: torch.Tensor, n: int, fill=0) -> torch.Tensor:
    k = n - int(arr.shape[0])
    if k == 0:
        return arr
    return torch.cat([arr, torch.full((k,), fill, dtype=arr.dtype,
                                      device=arr.device)])


def shard_fact_columns(mesh: Mesh, cols: dict, nrows: int):
    """Pad each 1-D column to a multiple of the shard count and split it
    row-wise over the mesh. Returns ``(sharded_cols, alive)``: alive marks
    the real rows."""
    S = mesh.size
    n_pad = (nrows + S - 1) // S * S
    step = n_pad // S

    def split(arr):
        return Sharded([arr[s * step:(s + 1) * step].to(d)
                        for s, d in enumerate(mesh.devices)], mesh)

    out = {name: split(_pad_to(torch.as_tensor(arr), n_pad))
           for name, arr in cols.items()}
    alive = split(_pad_to(torch.ones(nrows, dtype=torch.bool), n_pad,
                          False))
    return out, alive


def replicate(mesh: Mesh, arr) -> Sharded:
    """A whole copy of ``arr`` on every shard."""
    t = torch.as_tensor(arr)
    return Sharded([t.to(d) for d in mesh.devices], mesh, "rep")


def dim_probe_map(dim_key):
    """Sorted build side of a broadcast join: ``(sorted_keys, order)``, so
    a probe is two searchsorteds and a gather (per copy of a replicated
    key column)."""
    if isinstance(dim_key, Sharded):
        got = [dim_probe_map(p) for p in dim_key.parts]
        return (Sharded([g[0] for g in got], dim_key.mesh, dim_key.spec),
                Sharded([g[1] for g in got], dim_key.mesh, dim_key.spec))
    dim_key = torch.as_tensor(dim_key)
    order = prim.argsort_stable(dim_key)
    return dim_key[order], order


def _rep_parts(mesh: Mesh, x) -> list:
    return x.parts if isinstance(x, Sharded) else replicate(mesh, x).parts


def _probe(keys_sorted, order, fk):
    """(match flag, dimension row) of each fact key against one sorted
    dimension key column."""
    lo = prim.searchsorted(keys_sorted, fk)
    hi = prim.searchsorted(keys_sorted, fk, right=True)
    idx = order[lo.clamp(0, keys_sorted.shape[0] - 1)]
    return (hi - lo) > 0, idx


def _weighted(live, w):
    return torch.where(live, w, torch.zeros((), dtype=w.dtype,
                                            device=w.device)).to(F64)


def broadcast_join_agg(mesh: Mesh, fact, alive, dim_keys_sorted, dim_order,
                       dim_payload_codes, num_groups: int,
                       weight_name: str, fact_key_name: str):
    """Filter (the alive mask), broadcast-join the fact key against the
    dimension, group by the joined dimension's payload code, ``psum`` the
    shards' partial aggregates.

    Inner-join semantics: fact rows whose key misses the dimension drop
    out, one dimension match a key (FK -> PK). Returns ``(sums f64[G],
    counts i64[G])`` on the first shard's device."""
    dks = _rep_parts(mesh, dim_keys_sorted)
    dord = _rep_parts(mesh, dim_order)
    dcodes = _rep_parts(mesh, dim_payload_codes)
    sums, counts = [], []
    for s in range(mesh.size):
        fk = fact[fact_key_name].parts[s]
        w = fact[weight_name].parts[s]
        matched, didx = _probe(dks[s], dord[s], fk)
        gid = dcodes[s][didx]
        live = alive.parts[s] & matched
        gid_safe = torch.where(live, gid, torch.zeros((), dtype=gid.dtype,
                                                      device=gid.device))
        sums.append(prim.segment_sum(_weighted(live, w), gid_safe,
                                     num_groups))
        counts.append(prim.segment_sum(live.to(I64), gid_safe, num_groups))
    return psum_counted(sums, mesh)[0], psum_counted(counts, mesh)[0]


def run_distributed_q3(mesh: Mesh, store_sales, date_dim, item,
                       manufact_id: int = 128, moy: int = 11):
    """TPC-DS q3 over the mesh:

        select d_year, i_brand_id, i_brand, sum(ss_ext_sales_price)
        from date_dim, store_sales, item
        where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
          and i_manufact_id = [M] and d_moy = [MOY]
        group by d_year, i_brand_id, i_brand

    ``store_sales``, ``date_dim`` and ``item`` are dicts of host int arrays
    (decoded columns). The group is (item row, year slot): dense and
    static, filtered after the reduce. Returns host arrays (year,
    brand_id, item index, sum, count) of the matched groups."""
    from nds_tpu_torch.engine.ops import timed_read
    item = {k: _host_array(v) for k, v in item.items()}
    date_dim = {k: _host_array(v) for k, v in date_dim.items()}
    n_items = int(item["i_item_sk"].shape[0])

    def rep(arr):
        return replicate(mesh, torch.as_tensor(arr)).parts

    iks, iorder = dim_probe_map(torch.as_tensor(item["i_item_sk"]))
    dks, dorder = dim_probe_map(torch.as_tensor(date_dim["d_date_sk"]))
    # the dimension predicates fold into the payload: a fact row joins a
    # kept dimension row or contributes nothing
    ikeep = rep(item["i_manufact_id"] == manufact_id)
    dkeep = rep(date_dim["d_moy"] == moy)
    d_year = date_dim["d_year"]
    year_lo = int(d_year.min())
    n_years = int(d_year.max()) - year_lo + 1
    num_groups = n_items * n_years
    dyear = rep(d_year)
    iks, iorder, dks, dorder = (rep(x) for x in (iks, iorder, dks, dorder))

    nrows = int(_host_array(store_sales["ss_item_sk"]).shape[0])
    fact, alive = shard_fact_columns(mesh, {
        k: torch.as_tensor(_host_array(store_sales[k]))
        for k in ("ss_item_sk", "ss_sold_date_sk", "ss_ext_sales_price")},
        nrows)

    sums, counts = [], []
    for s in range(mesh.size):
        ihit, iidx = _probe(iks[s], iorder[s], fact["ss_item_sk"].parts[s])
        dhit, didx = _probe(dks[s], dorder[s],
                            fact["ss_sold_date_sk"].parts[s])
        live = alive.parts[s] & ihit & ikeep[s][iidx] & dhit & dkeep[s][didx]
        gid = iidx * n_years + (dyear[s][didx] - year_lo)
        gid_safe = torch.where(live, gid, torch.zeros((), dtype=gid.dtype,
                                                      device=gid.device))
        sums.append(prim.segment_sum(
            _weighted(live, fact["ss_ext_sales_price"].parts[s]), gid_safe,
            num_groups))
        counts.append(prim.segment_sum(live.to(I64), gid_safe, num_groups))
    sums = psum_counted(sums, mesh)[0]
    counts = psum_counted(counts, mesh)[0]
    sums, counts = timed_read(
        "q3_result", lambda: (sums.cpu().numpy(), counts.cpu().numpy()))
    hit = np.nonzero(counts > 0)[0]
    item_idx = hit // n_years
    return {
        "d_year": hit % n_years + year_lo,
        "i_brand_id": item["i_brand_id"][item_idx],
        "item_index": item_idx,
        "sum_agg": sums[hit],
        "count": counts[hit],
    }
