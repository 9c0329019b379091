# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Tables laid over a mesh: the placement of the meshed resident session.

A session with ``mesh_shape`` S > 1 places every table it registers over
an :class:`~nds_tpu_torch.parallel.exchange.Mesh` of S shards
(:func:`place`). The placement rule:

* a table of at most ``broadcast_bytes`` (the session's conf, else
  ``NDS_TPU_BROADCAST_BYTES``, default 128 MiB) is **replicated**: spec
  ``rep``, a copy on every shard's device (the same tensors when shards
  share a device);
* a larger table is **row-sharded**: spec ``row``, its physical rows split
  evenly and contiguously, shard ``g`` holding rows ``[g * plen / S,
  (g + 1) * plen / S)`` (a bucketed length is a power of two of at least
  16, so a mesh of at most 16 shards divides it).

Row-local operators keep a row-sharded table sharded and run shard by
shard, each under ``ops.device_scope(shard device)``:

* WHERE conjuncts, each shard compacting its own rows (:func:`per_shard`);
* the projection of a SELECT without aggregates, windows or subqueries;
* the probe of a row-sharded side against a replicated (or whole) one:
  the primary-key gather join (:func:`pk_gather_join`) and the inner hash
  join (:func:`probe_join`); the result stays row-sharded;
* the inner join of two row-sharded sides, which takes the repartition
  join (``ops._exchange_inner_join``) and leaves its result on the first
  shard's device.

Every other operator (grouped aggregation, sort, window, distinct, set
operations, outer, semi and anti joins, LIMIT, scalar subqueries, the
result fetch) reads the table's ``columns``, which gathers the shards to
the first shard's device in shard order (:func:`gather`; an all-gather
when the mesh spans processes), and runs unchanged on the whole table.
Shard order is row order, and every shard-local operator keeps its rows in
order, so a meshed statement gives the unmeshed session's rows in the
unmeshed order.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from nds_tpu_torch.engine import ops as E
from nds_tpu_torch.engine import prim
from nds_tpu_torch.engine.table import DeviceTable
from nds_tpu_torch.parallel import exchange as X

# what meshed statements did in this process: repartition joins engaged,
# row-sharded tables gathered to the first shard's device, and sides whose
# shards handed over just the repartition join's matched rows
COUNTS = {"exchange_joins": 0, "gathers": 0, "fetches": 0}


class ShardedTable(DeviceTable):
    """A table over a mesh: ``parts[i]``, a DeviceTable, on
    ``mesh.devices[i]`` (this process's shards), ``spec`` ``"row"`` or
    ``"rep"``. Its ``columns``, ``nrows`` and ``plen`` are the whole
    table's: a replicated table's first copy, a row-sharded table's
    gather (made once per object)."""

    def __init__(self, parts, mesh: X.Mesh, spec: str = "row"):
        if len(parts) != len(mesh.devices):
            raise ValueError(f"{len(parts)} parts for a mesh of "
                             f"{len(mesh.devices)} local shards")
        self.parts, self.mesh, self.spec = list(parts), mesh, spec
        self._whole = None

    def whole(self) -> DeviceTable:
        if self._whole is None:
            self._whole = self.parts[0] if self.spec == "rep" \
                else gather(self)
        return self._whole

    @property
    def columns(self):
        return self.whole().columns

    @property
    def nrows(self):
        return self.whole().nrows

    @property
    def plen(self) -> int:
        return self.whole().plen

    @property
    def column_names(self):
        return self.parts[0].column_names

    @property
    def nbytes(self) -> int:
        return table_bytes(self)

    def __contains__(self, name: str) -> bool:
        return name in self.parts[0].columns

    def select(self, names) -> "ShardedTable":
        return ShardedTable([p.select(names) for p in self.parts],
                            self.mesh, self.spec)

    def __repr__(self):
        return (f"ShardedTable[{self.spec} x{len(self.parts)} of "
                f"{self.mesh.size}]({', '.join(self.column_names)})")


def is_row(t) -> bool:
    """A row-sharded table (over more than one shard)."""
    return isinstance(t, ShardedTable) and t.spec == "row" \
        and t.mesh.size > 1


def column_meta(t: DeviceTable, name: str):
    """A column whose kind and dictionary may be read (a sharded table's
    first part's: no gather)."""
    return t.parts[0][name] if isinstance(t, ShardedTable) else t[name]


def table_bytes(t: DeviceTable) -> int:
    """Device bytes of a table (this process's share of a row-sharded
    one; one copy of a replicated one)."""
    if isinstance(t, ShardedTable):
        parts = t.parts[:1] if t.spec == "rep" else t.parts
        return sum(table_bytes(p) for p in parts)
    return sum(c.data.nbytes + (0 if c.valid is None else c.valid.nbytes)
               for c in t.columns.values())


def tensor_to(x, dev):
    return None if x is None else x.to(dev, non_blocking=True)


def table_to(t: DeviceTable, dev) -> DeviceTable:
    """The table with its columns on ``dev`` (itself when they are
    there). A lazy row count resolves first when the table moves."""
    dev = torch.device(dev)
    if all(c.data.device == dev for c in t.columns.values()):
        return t
    cols = {n: replace(c, data=tensor_to(c.data, dev),
                       valid=tensor_to(c.valid, dev))
            for n, c in t.columns.items()}
    return DeviceTable(cols, E.count_int(t.nrows), plen=t.plen)


def shard_copy(t: DeviceTable, i: int, mesh: X.Mesh) -> DeviceTable:
    """What shard ``i`` of a row-sharded partner reads of ``t``: its copy
    of a replicated table, else the whole table on the shard's device."""
    if isinstance(t, ShardedTable):
        if t.spec == "rep":
            return t.parts[i]
        t = t.whole()
    return table_to(t, mesh.devices[i])


def per_shard(t: ShardedTable, fn) -> ShardedTable:
    """``fn(i, part)`` on every local shard under its device scope: the
    row-sharded table of the results."""
    parts = []
    for i, (p, dev) in enumerate(zip(t.parts, t.mesh.devices)):
        with E.device_scope(dev):
            parts.append(fn(i, p))
    return ShardedTable(parts, t.mesh, "row")


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def place(table: DeviceTable, mesh: X.Mesh, limit: int) -> ShardedTable:
    """The placement rule: replicated at or under ``limit`` bytes, else
    row-sharded."""
    if isinstance(table, ShardedTable):
        table = table.whole()
    if table_bytes(table) <= limit:
        return ShardedTable([table_to(table, d) for d in mesh.devices],
                            mesh, "rep")
    return split(table, mesh)


def split(table: DeviceTable, mesh: X.Mesh) -> ShardedTable:
    """Row-shard a whole table: its physical rows in ``mesh.size`` even,
    contiguous parts (padded first when the length does not divide),
    this process's parts on their shards' devices."""
    n = E.count_int(table.nrows)
    S = mesh.size
    step = -(-max(table.plen, 1) // S)
    if step * S != table.plen:
        dev = next(iter(table.columns.values())).data.device \
            if table.columns else E.device()
        table = E.gather_table_rows(table, torch.arange(step * S,
                                                        device=dev), n)
    parts = []
    for g, dev in enumerate(mesh.devices, mesh.first):
        lo = g * step
        cols = {name: replace(
            c, data=tensor_to(c.data[lo:lo + step], dev),
            valid=None if c.valid is None
            else tensor_to(c.valid[lo:lo + step], dev))
            for name, c in table.columns.items()}
        parts.append(DeviceTable(cols, max(0, min(step, n - lo)),
                                 plen=step))
    return ShardedTable(parts, mesh, "row")


# ---------------------------------------------------------------------------
# gathers
# ---------------------------------------------------------------------------


def gather(t: ShardedTable) -> DeviceTable:
    """The whole of a row-sharded table on the first shard's device, its
    rows in shard order (every process's, in rank order, on a mesh that
    spans processes). Counted as one all-gather."""
    mesh = t.mesh
    dev = mesh.devices[0]
    COUNTS["gathers"] += 1
    X._note_collective("all_gather", 1, table_bytes(t.parts[0]))
    parts = [table_to(p, dev) for p in t.parts]
    with E.device_scope(dev):
        local = _concat_in_order(parts)
        if mesh.world == 1:
            return local
        return _all_gather_table(local, mesh)


def _concat_in_order(parts) -> DeviceTable:
    """Parts concatenated in order: their physical rows as they stand when
    the live rows already form a prefix (a freshly split table), else
    compacted (``ops.concat_tables``)."""
    ns = [p.nrows for p in parts]
    if all(isinstance(n, int) for n in ns):
        live = [i for i, n in enumerate(ns) if n]
        last = live[-1] if live else 0
        if all(ns[i] == parts[i].plen for i in range(last)):
            plen = sum(p.plen for p in parts)
            cols = {name: E.concat_columns([p[name] for p in parts])
                    for name in parts[0].column_names}
            return DeviceTable(cols, sum(ns), plen=plen)
    return E.concat_tables(parts)


def _all_gather_table(local: DeviceTable, mesh: X.Mesh) -> DeviceTable:
    """Every process's live rows of ``local`` in rank order, on every
    process (validity always travels as a mask, so that every process
    issues the same collectives)."""
    n = E.count_int(local.nrows)
    rows = X.gather_rows([torch.ones(n, dtype=torch.bool,
                                     device=mesh.devices[0])], mesh)
    total = int(rows.shape[0])
    cols = {name: replace(c, data=X.gather_rows([c.data[:n]], mesh),
                          valid=X.gather_rows([c.valid_mask()[:n]], mesh))
            for name, c in local.columns.items()}
    raw = DeviceTable(cols, total, plen=total)
    return E.take_padded(raw, E.compact_indices(rows, total), total)


def shard_offsets(t: ShardedTable) -> list:
    """The physical row offset of every shard's first row of a row-sharded
    table, in global shard order, and the whole physical length last (on
    a mesh that spans processes the lengths meet in one small
    all-gather, read on the host)."""
    mesh = t.mesh
    plens = [p.plen for p in t.parts]
    if mesh.world > 1:
        got = X.gather_rows([torch.tensor(plens, dtype=E.I64,
                                          device=mesh.devices[0])], mesh)
        plens = E.timed_read("mesh_plens", lambda: got.tolist())
    offs = [0]
    for n in plens:
        offs.append(offs[-1] + int(n))
    return offs


def physical(t: ShardedTable) -> DeviceTable:
    """A row-sharded table's physical rows (pads included) concatenated in
    shard order on the first shard's device (every process's on a mesh
    that spans processes): row ``r`` is physical row ``r`` of
    :func:`shard_offsets`. Counted as one all-gather."""
    mesh = t.mesh
    dev = mesh.devices[0]
    X._note_collective("all_gather", 1, table_bytes(t.parts[0]))
    cols = {}
    for name in t.column_names:
        local = E.concat_columns([table_to(p, dev)[name] for p in t.parts])
        if mesh.world > 1:
            local = replace(local, data=X.gather_rows([local.data], mesh),
                            valid=X.gather_rows([local.valid_mask()], mesh))
        cols[name] = local
    total = int(next(iter(cols.values())).data.shape[0]) if cols else 0
    return DeviceTable(cols, total, plen=total)


def fetch_rows(t: ShardedTable, idx: torch.Tensor, offs: list,
               counts: list) -> DeviceTable:
    """The rows of a row-sharded table at the physical row ids ``idx``
    (on the first shard's device, every process holding the same), which
    run shard by shard: the first ``counts[0]`` lie on global shard 0,
    the next ``counts[1]`` on shard 1, and so on (``offs`` from
    :func:`shard_offsets`). Each local shard gathers its own rows on its
    device and hands over only those; they are assembled in ``idx`` order
    on the first shard's device (every process's, in rank order, on a
    mesh that spans processes). Counted as one all-gather of a shard's
    share of the rows."""
    mesh = t.mesh
    dev = mesh.devices[0]
    COUNTS["fetches"] += 1
    starts = [0]
    for c in counts:
        starts.append(starts[-1] + c)
    parts = []
    for i, (part, d) in enumerate(zip(t.parts, mesh.devices)):
        g = mesh.first + i
        lo, c = starts[g], counts[g]
        with E.device_scope(d):
            loc = (idx[lo:lo + c] - offs[g]).to(d, non_blocking=True)
            parts.append(table_to(E.gather_table_rows(part, loc, c), dev))
    X._note_collective("all_gather", 1,
                       sum(table_bytes(p) for p in parts) // len(parts))
    with E.device_scope(dev):
        local = _concat_in_order(parts)
        if mesh.world == 1:
            return local
        return _all_gather_table(local, mesh)


def rows_at(t: ShardedTable, idx: torch.Tensor, offs: list, counts: list,
            cap: int, ascending: bool = False) -> DeviceTable:
    """The rows of a row-sharded table at the physical row ids ``idx`` (on
    the first shard's device, every process holding the same; ``counts[g]``
    of them on global shard ``g``, ``offs`` from :func:`shard_offsets`),
    in ``idx`` order, padded to ``cap`` physical rows. It moves the fewer
    rows: with fewer ids than the table has physical rows each shard
    hands over just its rows at the ids (:func:`fetch_rows`; ids not
    ``ascending`` are sorted by shard first and put back after), else the
    whole table gathers (:func:`physical`) and the ids index it there."""
    n = int(idx.shape[0])
    slot = torch.arange(cap, device=idx.device)
    if n >= offs[-1]:
        src, at = physical(t), prim.take_clip(idx, slot)
    elif ascending:
        src, at = fetch_rows(t, idx, offs, counts), slot
    else:
        perm = torch.argsort(idx, stable=True)
        src = fetch_rows(t, prim.take_clip(idx, perm), offs, counts)
        at = torch.zeros(cap, dtype=E.I64, device=idx.device).scatter_(
            0, perm, slot[:n])
    return E.take_padded(src, at, n)


# ---------------------------------------------------------------------------
# joins of a row-sharded side
# ---------------------------------------------------------------------------


def pk_gather_join(fact: ShardedTable, dim: DeviceTable, fk_names,
                   dk_names, d_excl=None):
    """The primary-key gather join of a row-sharded fact side, shard by
    shard against the dimension's copy on the shard's device, each shard
    compacted to its matched rows: the row-sharded joined table, or None
    when the keys cannot pack (decided by the dimension alone, so by the
    first shard for every shard)."""
    mesh = fact.mesh
    out = []
    for i, (part, dev) in enumerate(zip(fact.parts, mesh.devices)):
        with E.device_scope(dev):
            d = shard_copy(dim, i, mesh)
            got = E.pk_gather_join_multi(
                [part[n] for n in fk_names], [d[n] for n in dk_names],
                part.nrows, d.nrows, d_excl=tensor_to(d_excl, dev))
            if got is None:
                return None
            r_idx, matched = got
            cols = dict(part.columns)
            cols.update(E.gather_table_rows(d, r_idx, part.nrows).columns)
            out.append(E.compact_table(
                DeviceTable(cols, part.nrows, plen=part.plen), matched))
    return ShardedTable(out, mesh, "row")


def probe_join(left: ShardedTable, right: DeviceTable, left_on, right_on,
               r_excl=None, residual_fn=None) -> ShardedTable:
    """Inner hash join of a row-sharded left side with a replicated (or
    whole) right side, shard by shard against the right side's copy on
    the shard's device; the result stays row-sharded, each shard's pairs
    in the unmeshed join's order (left row, then right row)."""
    mesh = left.mesh

    def one(i, part):
        dev = mesh.devices[i]
        return E.join_tables(part, shard_copy(right, i, mesh), left_on,
                             right_on, "inner", r_excl=tensor_to(r_excl, dev),
                             residual_fn=residual_fn)

    return per_shard(left, one)
