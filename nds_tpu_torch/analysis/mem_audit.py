# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The survivor-bound proof the streamed pipeline sizes its accumulators
from (the runtime pieces of the reference's static memory model), and the
capacity/cardinality model the execution auditor prices bare streamed
scans with (:class:`MemModel`, :func:`statement_needed_names`).

For a streamed join graph, :func:`stream_graph_fanout` proves a
survivor-multiplicity exponent ``k`` from schema primary keys: every join
batch with no PK-unique side may fan out, clamped at run time by the
stream-bounds pair bucket (probe bucket x fanout, device overflow flag past
it). The survivors of the whole graph are then bounded by
:func:`structural_row_bound` = ``bucket(rows) x fanout^k``. A graph whose
bound does not fit the device-memory capacity model is split grace-style
by join-key hash (:func:`choose_partitions`, :func:`partition_row_bound`,
:func:`stream_partition_keys`).

The settings come from the calling statement (``ops.setting``): capacity
``hbm_bytes`` (default: the card's own memory on cuda, the reference's
16 GiB on the CPU so both engines choose the same partitions), partitions,
skew and fanout.

:class:`MemAuditor` walks every statement with the same model and proves a
per-statement peak device-memory byte bound: schema widths through the
planner's column pruning (narrow encoded widths for streamed scans),
cardinalities through joins (a PK-unique side keeps the fact side's rows,
any other batch is bounded by the enforced pair bucket), the streamed
accumulators, partitions, shards and the prefetch ring. The lint gate's
``hbm-capacity`` findings and ``--mem-report`` read it, and the static
cost model (:mod:`perf_audit`) takes its row bounds and partition plans.
"""

from __future__ import annotations

import math
import os
import sys
from dataclasses import dataclass

import numpy as np

from nds_tpu_torch.analysis import Finding
from nds_tpu_torch.analysis.exec_audit import _conjuncts_of
from nds_tpu_torch.analysis.plan_audit import _single_row_query
from nds_tpu_torch.engine.settings import CHUNK_ROWS, bucket_len, setting
from nds_tpu_torch.queries import (TEMPLATE_DIR, instantiate_template,
                                   list_templates, load_template)
from nds_tpu_torch.schema import (COMPOSITE_PRIMARY_KEYS, PRIMARY_KEYS,
                                  decimal_precision_scale, get_schemas,
                                  is_decimal, is_string)
from nds_tpu_torch.sql import ast as A
from nds_tpu_torch.sql.parser import ParseError, parse

# capacity model on the CPU: the reference's default (one 16 GiB chip), so
# the CPU tests choose the reference's partition counts
DEFAULT_HBM_BYTES = 16 << 30


def hbm_capacity_bytes() -> int:
    """Device-memory capacity of the calling statement: the ``hbm_bytes``
    setting, else the card's total memory on cuda, else
    :data:`DEFAULT_HBM_BYTES` (also where the engine is not loaded: no
    statement runs there)."""
    got = setting("hbm_bytes")
    if got is not None:
        return int(got)
    ops = sys.modules.get("nds_tpu_torch.engine.ops")
    dev = ops.device() if ops is not None else None
    if dev is not None and dev.type == "cuda":
        import torch
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return DEFAULT_HBM_BYTES


# ---------------------------------------------------------------------------
# AST helpers (the port's copies of the reference's exec_audit helpers)
# ---------------------------------------------------------------------------

_SUBQUERY = (A.ScalarSubquery, A.InSubquery, A.Exists, A.QuantifiedCompare)


def _children(e):
    """Direct expression children of an AST expression node."""
    if not hasattr(e, "__dataclass_fields__"):
        return
    for f in vars(e).values():
        if isinstance(f, A.Expr):
            yield f
        elif isinstance(f, (list, tuple)):
            for x in f:
                if isinstance(x, A.Expr):
                    yield x
                elif isinstance(x, tuple):
                    for y in x:
                        if isinstance(y, A.Expr):
                            yield y


def _has_subquery(e) -> bool:
    if isinstance(e, _SUBQUERY):
        return True
    return any(_has_subquery(c) for c in _children(e))


def _column_refs(e):
    out = []

    def walk(node):
        if isinstance(node, A.ColumnRef):
            out.append(node)
            return
        if isinstance(node, _SUBQUERY):
            return                     # a subquery's refs are its own scope
        for c in _children(node):
            walk(c)
    walk(e)
    return out


# ---------------------------------------------------------------------------
# shared survivor-bound core
# ---------------------------------------------------------------------------


def _owns_key(colset, ref: A.ColumnRef) -> str | None:
    """Bare column name when a part whose lowercase ``alias.col`` key set
    is ``colset`` provides ``ref`` — mirroring the planner's qualified /
    suffix-match resolution over its internal column names."""
    name = ref.name.lower()
    if ref.table:
        return name if f"{ref.table.lower()}.{name}" in colset else None
    for c in colset:
        if c == name or c.endswith("." + name):
            return name
    return None


def _equi_sides(c, part_cols):
    """``(li, ri, lkey, rkey)`` when the conjunct is an equi edge between
    two distinct parts: a plain ``col = col`` (bare key names returned),
    or an expression-equi conjunct whose sides each live wholly in one
    part (keys None — an expression can never cover a primary key)."""
    if not (isinstance(c, A.BinaryOp) and c.op == "="):
        return None
    if isinstance(c.left, A.ColumnRef) and isinstance(c.right, A.ColumnRef):
        li = ri = None
        lk = rk = None
        for i, cols in enumerate(part_cols):
            if li is None:
                got = _owns_key(cols, c.left)
                if got:
                    li, lk = i, got
            if ri is None:
                got = _owns_key(cols, c.right)
                if got:
                    ri, rk = i, got
        if li is not None and ri is not None and li != ri:
            return li, ri, lk, rk
        return None

    def side_owner(e):
        refs = _column_refs(e)
        if not refs:
            return None
        owner = None
        for r in refs:
            cands = [i for i, cols in enumerate(part_cols)
                     if _owns_key(cols, r)]
            if len(cands) != 1:
                return None
            if owner is None:
                owner = cands[0]
            elif owner != cands[0]:
                return None
        return owner

    li, ri = side_owner(c.left), side_owner(c.right)
    if li is not None and ri is not None and li != ri:
        return li, ri, None, None
    return None


def _table_pk(src: str | None):
    if not src:
        return None
    pk = COMPOSITE_PRIMARY_KEYS.get(src)
    if pk is None and src in PRIMARY_KEYS:
        pk = (PRIMARY_KEYS[src],)
    return pk


def _batch_unique_side(part_cols, sources, keep, a, b, batch) -> bool:
    """True when one side of the (a, b) edge batch is unique on its join
    keys: a pristine base-table scan whose bare key-name set covers its
    declared (composite) primary key. When the batch touches the streamed
    slot (``keep``), only the OTHER side counts."""
    cands = [s for s in (a, b) if s != keep] if keep in (a, b) else [a, b]
    for side in cands:
        pk = _table_pk(sources[side])
        if pk is None:
            continue
        keys = set()
        for (li, ri, lk, rk) in batch:
            k = lk if li == side else (rk if ri == side else None)
            if k is not None:
                keys.add(k)
        if keys >= set(pk):
            return True
    return False


def _edge_batches(part_cols, conjuncts) -> dict:
    batches: dict = {}
    for c in conjuncts:
        if _has_subquery(c):
            continue
        e = _equi_sides(c, part_cols)
        if e is None:
            continue
        li, ri, _lk, _rk = e
        batches.setdefault(tuple(sorted((li, ri))), []).append(e)
    return batches


def stream_graph_fanout(part_cols, sources, keep, conjuncts):
    """Conservative survivor-multiplicity exponent ``k`` of a streamed
    join graph, or None when the multiplicity is unprovable.

    ``part_cols`` is the per-part set of lowercase ``alias.col`` column
    keys, ``sources`` the per-part pristine catalog table name (None for
    derived relations), ``keep`` the streamed part's index, ``conjuncts``
    the join predicates + WHERE conjuncts. Each join batch with no unique
    (PK-covered) side adds one to ``k``; subquery conjuncts are filters
    and never grow rows. None when some part is not connected to the
    streamed slot by equi edges (a cartesian layout)."""
    n = len(part_cols)
    batches = _edge_batches(part_cols, conjuncts)
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for (a, b) in batches:
        parent[find(a)] = find(b)
    if n and any(find(i) != find(keep) for i in range(n)):
        return None
    k = 0
    for (a, b), batch in batches.items():
        if not _batch_unique_side(part_cols, sources, keep, a, b, batch):
            k += 1
    return k


def structural_row_bound(rows: int, k: int, fanout: int) -> int:
    """``bucket_len(rows) x fanout^k`` — the structural term of the
    survivor proof."""
    return bucket_len(max(int(rows), 1)) * (int(fanout) ** int(k))


# ---------------------------------------------------------------------------
# partitioned (grace-style) fan-out accumulation: the per-partition proof
# ---------------------------------------------------------------------------

# partition-count search ceiling: past 256 partitions the per-chunk
# dispatch fan-out dominates any accumulator saving
_MAX_PARTITIONS = 256


def _pow2_at_least(n: int) -> int:
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def forced_partitions() -> int | None:
    """The ``stream_partitions`` setting: pins the partition count of
    every partitionable streamed graph (rounded up to a power of two,
    clamped to :data:`_MAX_PARTITIONS`; <= 1 disables). None = the proof
    chooses (:func:`choose_partitions`)."""
    got = setting("stream_partitions")
    return None if got is None else min(_pow2_at_least(int(got)),
                                        _MAX_PARTITIONS)


def stream_skew_factor() -> int:
    """The ``stream_skew`` setting: the hash-skew safety factor of the
    per-partition bound (one partition may hold up to ``skew x`` its even
    share before the enforced overflow flag fires)."""
    return max(int(setting("stream_skew")), 1)


def stream_shards() -> int:
    """The ``stream_shards`` setting: the shard count of a streamed
    pipeline (rounded up to a power of two, clamped to
    :data:`_MAX_PARTITIONS` like the partition count, so the two routing
    windows take at most 8 + 8 of the hash's 32 bits; <= 1 disables). The
    runtime also needs that many local devices, or shards that share them
    (``parallel.exchange.stream_mesh``), and builds unsharded otherwise."""
    got = setting("stream_shards")
    return 1 if got is None else min(_pow2_at_least(int(got)),
                                     _MAX_PARTITIONS)


def shard_row_bound(rows: int, n_shards: int, n_partitions: int, k: int,
                    fanout: int, skew: int | None = None) -> int:
    """Per-shard survivor-row bound of a sharded streamed graph: the
    structural bound of one shard's skew-factored row share, ``rows /
    shards x skew`` through the fan-out exponent. With partitions the
    partition share re-shares over the shards, each level keeping its own
    skew allowance. The runtime enforces it with per-shard overflow flags
    (overflow => eager rerun), as :func:`partition_row_bound`."""
    if skew is None:
        skew = stream_skew_factor()
    share = max(int(rows), 1)
    if n_partitions > 1:
        share = min(share, -(-share // int(n_partitions)) * int(skew))
    if n_shards > 1:
        share = min(share, -(-share // int(n_shards)) * int(skew))
    return structural_row_bound(share, k, fanout)


def partition_row_bound(rows: int, n_partitions: int, k: int, fanout: int,
                        skew: int | None = None) -> int:
    """Per-partition survivor-row bound of a hash-partitioned streamed
    graph: the structural bound of one partition's skew-factored row
    share (enforced at run time by a per-partition overflow flag)."""
    if skew is None:
        skew = stream_skew_factor()
    rows = max(int(rows), 1)
    share = min(rows, -(-rows // max(int(n_partitions), 1)) * int(skew))
    return structural_row_bound(share, k, fanout)


def choose_partitions(rows: int, k: int, fanout: int, row_bytes: int,
                      capacity_bytes: int, forced: int | None = None,
                      skew: int | None = None):
    """``(n_partitions, per_partition_row_bound)`` for one streamed graph:
    ``forced`` pins the count; otherwise the smallest power of two whose
    skew-factored per-partition bound fits ``capacity_bytes``. ``(1,
    None)``: unpartitioned (the whole bound fits, or no count up to
    :data:`_MAX_PARTITIONS` admits it)."""
    row_bytes = max(int(row_bytes), 1)
    if forced is not None:
        p = _pow2_at_least(forced)
        if p <= 1:
            return 1, None
        return p, partition_row_bound(rows, p, k, fanout, skew)
    if structural_row_bound(rows, k, fanout) * row_bytes <= capacity_bytes:
        return 1, None
    p = 2
    while p <= _MAX_PARTITIONS:
        bound = partition_row_bound(rows, p, k, fanout, skew)
        if bound * row_bytes <= capacity_bytes:
            return p, bound
        p <<= 1
    return 1, None


def stream_partition_keys(part_cols, sources, keep, conjuncts):
    """Bare chunk-side column names the partition hash keys on, or None
    when the streamed graph is not partitionable (no plain-column equi
    edge incident to the streamed slot). Prefers a fan-out batch (no
    PK-unique side) so rows that co-fan-out land in one partition.
    Deterministic: batches walk in sorted part order, keys return
    sorted."""
    batches = _edge_batches(part_cols, conjuncts)
    best = None
    for (a, b) in sorted(batches):
        if keep not in (a, b):
            continue
        batch = batches[(a, b)]
        keys = sorted({(lk if li == keep else rk)
                       for (li, ri, lk, rk) in batch
                       if (lk if li == keep else rk) is not None})
        if not keys:
            continue
        fan_out = not _batch_unique_side(part_cols, sources, keep,
                                         a, b, batch)
        if best is None or (fan_out and not best[0]):
            best = (fan_out, tuple(keys))
    return best[1] if best else None


# ---------------------------------------------------------------------------
# the static capacity / cardinality model (the execution auditor's)
# ---------------------------------------------------------------------------

# Conservative SF10 row-count upper bounds (TPC-DS spec scaling, rounded
# UP — the audit must never under-bound a cardinality): the static stand-in
# for the arrow row counts a live session knows exactly
DEFAULT_ROW_BOUNDS = {
    "call_center": 30,
    "catalog_page": 12_100,
    "catalog_returns": 1_500_000,
    "catalog_sales": 14_500_000,
    "customer": 500_000,
    "customer_address": 250_000,
    "customer_demographics": 1_920_800,
    "date_dim": 73_049,
    "household_demographics": 7_200,
    "income_band": 20,
    "inventory": 133_200_000,
    "item": 102_000,
    "promotion": 500,
    "reason": 45,
    "ship_mode": 20,
    "store": 102,
    "store_returns": 2_900_000,
    "store_sales": 28_900_000,
    "time_dim": 86_400,
    "warehouse": 10,
    "web_page": 200,
    "web_returns": 800_000,
    "web_sales": 7_300_000,
    "web_site": 42,
}

# spec-fixed value-domain upper bounds (TPC-DS: quantities are 1..100,
# inventory levels 0..1000): int64 columns a FOR encoding provably narrows
# to int16 offsets at any scale factor
SPEC_INT_DOMAINS = {
    "ss_quantity": 100, "cs_quantity": 100, "ws_quantity": 100,
    "sr_return_quantity": 100, "cr_return_quantity": 100,
    "wr_return_quantity": 100, "inv_quantity_on_hand": 1000,
}

# int64 sequence columns whose value domain is bounded by their table's
# row bound at the audited scale (ticket numbers are assigned per sale)
ROW_BOUND_DOMAINS = {
    "ss_ticket_number": "store_sales",
    "sr_ticket_number": "store_returns",
}


def _pow2_ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length() if n > 2 else 2


def _bucket(n: int) -> int:
    """The engine's bucket rule (``settings.bucket_len``): the audit's row
    bounds round exactly like the engine's physical buckets."""
    return bucket_len(int(n))


def type_width(t: str) -> int:
    """Device bytes per row of one column of canonical type ``t``,
    validity byte included (int32/date -> int32, decimals -> scaled int64,
    strings -> int32 dictionary codes)."""
    if is_string(t):
        return 4 + 1
    if is_decimal(t):
        return 8 + 1
    if t in ("int32", "date"):
        return 4 + 1
    return 8 + 1                       # int64 / double / unknown


def encoded_type_width(col: str, t: str, row_bounds: dict) -> int:
    """Static streamed-chunk bytes per row of one column under encoded
    execution (validity byte included): what is provable without data —
    a decimal's precision bounds its scaled int64 (p <= 9 fits an int32 FOR
    code), and the spec / row-bound domains above prove int16/int32 for the
    quantity and ticket-number columns. Everything else keeps its plain
    width."""
    if is_decimal(t):
        p, _s = decimal_precision_scale(t)
        if p <= 9:
            return 4 + 1
        return 8 + 1
    w = type_width(t)
    dom = SPEC_INT_DOMAINS.get(col)
    if dom is None and col in ROW_BOUND_DOMAINS:
        dom = row_bounds.get(ROW_BOUND_DOMAINS[col])
    if dom is not None:
        if dom < (1 << 15):
            return min(w, 2 + 1)
        if dom < (1 << 31):
            return min(w, 4 + 1)
    return w


def _deep_children(e):
    """Every AST expression nested in ``e``, reached through arbitrary
    dataclass / list / tuple containers (it descends into non-Expr
    dataclasses such as WindowSpec, whose partition/order expressions the
    pruning model must see)."""

    def rec(v):
        if isinstance(v, A.Expr):
            yield v
        elif isinstance(v, (list, tuple)):
            for x in v:
                yield from rec(x)
        elif hasattr(v, "__dataclass_fields__"):
            for f in vars(v).values():
                yield from rec(f)

    if hasattr(e, "__dataclass_fields__"):
        for f in vars(e).values():
            yield from rec(f)


def statement_needed_names(stmt, catalog_cols: dict | None = None) \
        -> set | None:
    """Bare lowercase column names the statement references anywhere (the
    mirror of the planner's projection pushdown), or None when pruning is
    unsafe. ``SELECT *`` resolves scoped, like the planner: a star over a
    derived table needs nothing new, a star over a catalog table adds its
    full column set, and only a star over an unresolvable name disables
    pruning. ``catalog_cols`` maps table -> column names (default: the
    TPC-DS schema)."""
    if catalog_cols is None:
        catalog_cols = {t: [f.name for f in fields]
                        for t, fields in get_schemas(True).items()}
    names: set = set()
    disabled = [False]

    def add_table(name):
        cols = catalog_cols.get(name)
        if cols is None:
            disabled[0] = True
        else:
            names.update(c.lower() for c in cols)

    def rel_entries(f, out):
        """(alias, catalog name | None-for-derived) per FROM leaf."""
        if isinstance(f, A.TableRef):
            out.append(((f.alias or f.name).lower(), f.name.lower()))
        elif isinstance(f, A.SubqueryRef):
            out.append((f.alias.lower(), None))
        elif isinstance(f, A.Join):
            rel_entries(f.left, out)
            rel_entries(f.right, out)
        elif isinstance(f, A.Query):
            rel_entries(getattr(f.body, "from_", None), out)

    def walk_expr(e, ctes, rels):
        if isinstance(e, A.Star):
            qual = e.table and e.table.lower()
            if qual is None:
                for _alias, src in rels:
                    if src is not None and src not in ctes:
                        add_table(src)
                if not rels:
                    disabled[0] = True
            else:
                hit = [src for alias, src in rels
                       if alias == qual or src == qual]
                if hit and hit[0] is not None and hit[0] not in ctes:
                    add_table(hit[0])
                elif (hit and (hit[0] is None or hit[0] in ctes)) \
                        or qual in ctes:
                    pass               # star over a derived relation
                elif qual in catalog_cols:
                    add_table(qual)
                else:
                    disabled[0] = True
            return
        if isinstance(e, A.ColumnRef):
            names.add(e.name.lower())
            return
        if isinstance(e, _SUBQUERY):
            walk_query(e.query, ctes)
            if isinstance(e, (A.InSubquery, A.QuantifiedCompare)):
                walk_expr(e.expr, ctes, rels)
            return
        for c in _deep_children(e):
            walk_expr(c, ctes, rels)

    def walk_from(f, ctes, rels):
        if isinstance(f, A.SubqueryRef):
            walk_query(f.query, ctes)
        elif isinstance(f, A.Join):
            walk_from(f.left, ctes, rels)
            walk_from(f.right, ctes, rels)
            if f.condition is not None:
                walk_expr(f.condition, ctes, rels)
        elif isinstance(f, A.Query):
            walk_from(getattr(f.body, "from_", None), ctes, rels)

    def walk_sel(sel, ctes):
        rels = []
        rel_entries(sel.from_, rels)
        walk_from(sel.from_, ctes, rels)
        for item in sel.items:
            walk_expr(item.expr, ctes, rels)
        if sel.where is not None:
            walk_expr(sel.where, ctes, rels)
        if sel.group_by is not None:
            for e in sel.group_by.exprs:
                walk_expr(e, ctes, rels)
        if sel.having is not None:
            walk_expr(sel.having, ctes, rels)

    def walk_body(b, ctes):
        if isinstance(b, A.SetOp):
            walk_body(b.left, ctes)
            walk_body(b.right, ctes)
        elif isinstance(b, A.Query):
            walk_query(b, ctes)
        else:
            walk_sel(b, ctes)

    def walk_query(q, ctes):
        ctes = set(ctes)
        for cname, cq in q.ctes:
            walk_query(cq, ctes)
            ctes.add(cname.lower())
        walk_body(q.body, ctes)
        for ent in q.order_by:
            walk_expr(ent[0], ctes, [])

    if isinstance(stmt, A.Query):
        walk_query(stmt, set())
    elif isinstance(stmt, (A.InsertInto, A.CreateTempView)):
        walk_query(stmt.query, set())
    elif isinstance(stmt, A.DeleteFrom) and stmt.where is not None:
        walk_expr(stmt.where, set(), [])
    return None if disabled[0] else names


class MemModel:
    """Capacity + cardinality model the execution auditor prices bare
    streamed scans against.

    ``row_bounds`` maps catalog table -> row upper bound (default: the
    conservative SF10 table); ``capacity_bytes`` is the device-memory
    budget (default :func:`hbm_capacity_bytes`: the ``hbm_bytes`` setting,
    else the card's own memory on cuda, else the reference's 16 GiB);
    ``fanout``/``chunk_rows``/``acc_ceiling`` and the partition, skew,
    shard, prefetch and encoding knobs are the streamed path's settings as
    the calling statement (or, outside one, their defaults) gives them,
    read at construction time."""

    def __init__(self, row_bounds=None, capacity_bytes=None, fanout=None,
                 chunk_rows=None, acc_ceiling="setting", catalog=None):
        from nds_tpu_torch.io.columnar import encoded_enabled
        self.row_bounds = dict(DEFAULT_ROW_BOUNDS if row_bounds is None
                               else row_bounds)
        self.capacity_bytes = (hbm_capacity_bytes() if capacity_bytes is None
                               else int(capacity_bytes))
        self.fanout = _pow2_ceil(int(setting("stream_fanout"))
                                 if fanout is None else int(fanout))
        self.chunk_rows = int(CHUNK_ROWS if chunk_rows is None
                              else chunk_rows)
        if acc_ceiling == "setting":
            got = setting("stream_acc_rows")
            acc_ceiling = int(got) if got else None
        self.acc_ceiling = acc_ceiling
        self.partitions = forced_partitions()      # None = proof-chosen
        self.skew = stream_skew_factor()
        self.shards = stream_shards()
        # the prefetch ring's chunks beyond the in-flight pair, priced
        # into every streamed peak and off the admitting capacity
        self.prefetch_depth = max(int(setting("prefetch_depth")), 0)
        if catalog is None:
            catalog = {
                t: {f.name.lower(): type_width(f.type) for f in fields}
                for t, fields in get_schemas(use_decimal=True).items()}
        self.widths = catalog              # table -> {col -> bytes/row}
        self.encoded = encoded_enabled()
        if self.encoded:
            self.enc_widths = {
                t: {c: encoded_type_width(c, f.type, self.row_bounds)
                    for c, f in ((f.name.lower(), f) for f in fields)}
                for t, fields in get_schemas(use_decimal=True).items()}
        else:
            self.enc_widths = {}

    def table_rows(self, name: str) -> int | None:
        return self.row_bounds.get(name)

    def pruned_width(self, table: str, needed: set | None,
                     encoded: bool = False) -> int:
        """Bytes per row of ``table`` after the planner's column pruning
        (``needed`` = names the statement references; None disables
        pruning; an empty intersection keeps every column, like the
        planner). ``encoded`` prices the streamed-chunk representation."""
        cols = (self.enc_widths if encoded and self.encoded
                else self.widths).get(table, {})
        if not cols:
            return 9                       # unknown table: one wide column
        if needed is not None:
            kept = {c: w for c, w in cols.items() if c in needed}
            if kept and len(kept) < len(cols):
                cols = kept
        return sum(cols.values())

    def chunk_cap(self) -> int:
        return _bucket(self.chunk_rows)

    def acc_row_bound(self, stream_rows: int, k: int) -> int:
        """Proven survivor-row bound of one streamed graph: the tighter of
        the per-chunk-bucket sum and the structural
        ``bucket_len(rows) x fanout^k`` bound."""
        mult = self.fanout ** k
        n_chunks = max(1, math.ceil(stream_rows / self.chunk_rows))
        base = n_chunks * self.chunk_cap() * mult
        return min(base, structural_row_bound(stream_rows, k, self.fanout))

    def partition_bound(self, stream_rows: int, k: int,
                        n_partitions: int) -> int:
        """Per-partition accumulator row bound: the tighter of the
        per-chunk-bucket sum and the skew-factored structural share."""
        mult = self.fanout ** k
        n_chunks = max(1, math.ceil(stream_rows / self.chunk_rows))
        base = n_chunks * self.chunk_cap() * mult
        return min(base, partition_row_bound(stream_rows, n_partitions, k,
                                             self.fanout, self.skew))

    def ring_bytes(self, chunk_row_width: int) -> int:
        """Extra live bytes of the prefetch ring: ``depth`` more padded
        chunks beyond the in-flight pair."""
        return self.prefetch_depth * self.chunk_cap() \
            * max(int(chunk_row_width), 0)

    def admit_capacity(self, chunk_row_width: int) -> int:
        """The capacity less the prefetch ring's live set."""
        return max(self.capacity_bytes - self.ring_bytes(chunk_row_width),
                   1)

    def bare_scan_fits(self, table: str | None, needed: set | None) -> bool:
        """Can a bare streamed scan of ``table`` (no filter, no join: the
        accumulator keeps every row) be proven to fit? True when the proven
        accumulator bound fits the capacity net of the ring AND the
        ``stream_acc_rows`` ceiling (when set) admits the table's rows."""
        rows = self.row_bounds.get(table or "")
        if rows is None:
            return False
        if self.acc_ceiling is not None and rows > self.acc_ceiling:
            return False                   # hard ceiling: overflow certain
        bound = self.acc_row_bound(rows, 0)
        w = self.pruned_width(table, needed, encoded=True)
        return bound * w <= self.admit_capacity(w)



# ---------------------------------------------------------------------------
# report types
# ---------------------------------------------------------------------------


@dataclass
class ScanBound:
    """The proven memory fate of one streamed scan (a table above the
    device-memory threshold)."""

    alias: str
    table: str
    rows: int                  # streamed table row bound
    fanout_k: int | None       # survivor-multiplicity exponent; None =
    #                            unprovable (subquery / cartesian: the
    #                            executor falls back eager there)
    acc_rows: int | None       # proven accumulator row bound (provable)
    acc_bytes: int | None      # acc_rows x streamed-graph row width
    chunk_bytes: int = 0       # one padded chunk's bytes (x2 in flight)
    partitions: int = 1        # grace-style partition count (1 = whole)
    part_rows: int | None = None   # per-partition accumulator row bound
    part_bytes: int | None = None  # part_rows x streamed-graph row width
    shards: int = 1            # mesh shard count (``stream_shards``)
    shard_rows: int | None = None  # per-shard survivor-row bound across
    #                                partitions (rows/shards x skew through
    #                                the fan-out — what StreamEvent's
    #                                shard_rows evidence is checked against)
    shard_bytes: int | None = None  # per-(partition, shard) accumulator
    #                                 unit bound x row width — the
    #                                 allocation unit a sharded pipeline's
    #                                 per-shard overflow flags enforce
    ring_bytes: int = 0        # prefetch-ring live set (depth x one
    #                            padded chunk) priced into the streamed
    #                            peak and off the admitting capacity
    #                            (``prefetch_depth``; 0 = ring off)

    @property
    def provable(self) -> bool:
        return self.fanout_k is not None


@dataclass
class MemReport:
    """Peak-HBM byte bound of one template statement."""

    file: str
    query: str
    mode: str                  # "streamed" | "device" | "unknown"
    peak_bytes: int = 0
    out_rows: int = 0          # statement output row bound
    scans: tuple = ()          # ScanBounds, FROM order
    detail: str = ""

    def to_dict(self) -> dict:
        return {
            "file": self.file, "query": self.query, "mode": self.mode,
            "peak_bytes": int(self.peak_bytes),
            "out_rows": int(self.out_rows),
            "scans": [{"alias": s.alias, "table": s.table,
                       "rows": int(s.rows), "fanout_k": s.fanout_k,
                       "acc_rows": None if s.acc_rows is None
                       else int(s.acc_rows),
                       "acc_bytes": None if s.acc_bytes is None
                       else int(s.acc_bytes),
                       "chunk_bytes": int(s.chunk_bytes),
                       "partitions": int(s.partitions),
                       "part_rows": None if s.part_rows is None
                       else int(s.part_rows),
                       "part_bytes": None if s.part_bytes is None
                       else int(s.part_bytes),
                       "shards": int(s.shards),
                       "shard_rows": None if s.shard_rows is None
                       else int(s.shard_rows),
                       "shard_bytes": None if s.shard_bytes is None
                       else int(s.shard_bytes),
                       "ring_bytes": int(s.ring_bytes),
                       "provable": s.provable} for s in self.scans],
            "detail": self.detail,
        }


class _MRel:
    """One relation in the walk: row bound + per-column widths and value
    domains, addressable by every alias the relation answers for (a
    materialized outer join keeps both sides' aliases, exactly like the
    planner's merged alias-qualified columns)."""

    __slots__ = ("cols", "widths", "dom", "rows", "source", "chunked",
                 "single_row", "plain_widths")

    def __init__(self, alias, widths: dict, rows: int, dom: dict | None =
                 None, source=None, chunked=False, single_row=False):
        a = alias.lower()
        self.widths = {a: dict(widths)}
        self.cols = {a: set(widths)}
        self.dom = {a: dict(dom or {c: rows for c in widths})}
        self.rows = int(rows)
        self.source = source
        self.chunked = chunked
        self.single_row = single_row
        # encoded execution: a chunked rel's ``widths`` price the narrow
        # streamed representation; ``plain_widths`` keeps the unencoded
        # widths for the paths that materialize the table whole (a
        # non-kept chunked part binds device-resident, unencoded)
        self.plain_widths = None

    @property
    def alias(self) -> str:
        return next(iter(self.cols))

    @property
    def width(self) -> int:
        return sum(w for cols in self.widths.values()
                   for w in cols.values())

    @property
    def plain_width(self) -> int:
        """Unencoded width (equals ``width`` for unencoded rels) — the
        byte size the runtime's whole-table materialization pays, and the
        keep-choice tiebreak (the executor picks by arrow nbytes)."""
        if self.plain_widths is None:
            return self.width
        return sum(self.plain_widths.values())

    def use_plain_widths(self) -> None:
        """Re-price this rel at its unencoded widths (non-kept chunked
        parts materialize whole through the plain device path)."""
        if self.plain_widths is not None:
            self.widths = {self.alias: dict(self.plain_widths)}
            self.plain_widths = None

    def colset(self) -> set:
        return {f"{a}.{c}" for a, cols in self.cols.items() for c in cols}

    def owns(self, ref: A.ColumnRef) -> str | None:
        name = ref.name.lower()
        if ref.table:
            t = ref.table.lower()
            cols = self.cols.get(t)
            return name if cols is not None and name in cols else None
        for cols in self.cols.values():
            if name in cols:
                return name
        return None

    def col_width(self, ref) -> int:
        name = ref.name.lower()
        aliases = [ref.table.lower()] if ref.table else list(self.cols)
        for a in aliases:
            w = self.widths.get(a, {}).get(name)
            if w is not None:
                return w
        return 9

    def col_domain(self, ref) -> int:
        name = ref.name.lower()
        aliases = [ref.table.lower()] if ref.table else list(self.cols)
        for a in aliases:
            d = self.dom.get(a, {}).get(name)
            if d is not None:
                return d
        return self.rows

    def merged_with(self, other: "_MRel", rows: int) -> "_MRel":
        out = _MRel(self.alias, {}, rows)
        out.cols = {**self.cols, **other.cols}
        out.widths = {**self.widths, **other.widths}
        out.dom = {**self.dom, **other.dom}
        out.rows = int(rows)
        return out


class _MemCost:
    """Accumulator for one statement walk: running peak-byte sum (a
    conservative everything-live-at-once over-approximation) plus the
    streamed-scan bounds discovered along the way."""

    def __init__(self):
        self.peak = 0
        self.scans: list = []


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------


class MemAuditor:
    """Host-only abstract interpreter computing peak device-memory byte
    bounds.

    ``streamed`` names the tables bound as ChunkedTables (the same binding
    model :mod:`exec_audit` uses); ``model`` carries capacities and
    cardinalities. The walk mirrors ``Planner._flatten_from`` →
    ``_join_parts`` → downstream aggregation, tracking (row bound,
    per-column width, per-column domain) per relation."""

    DEFAULT_STREAMED = ("catalog_sales", "inventory", "store_sales",
                        "web_sales")

    def __init__(self, streamed=None, model: MemModel | None = None,
                 base_tables=None):
        self.model = model or MemModel()
        self.streamed = set(self.DEFAULT_STREAMED if streamed is None
                            else streamed)
        self.base_tables = set(self.model.widths if base_tables is None
                               else base_tables)
        self.needed: set | None = None

    # -- entry point --------------------------------------------------------

    def audit_sql(self, sql: str, file: str = "<sql>",
                  query: str = "<sql>") -> MemReport:
        try:
            stmt = parse(sql)
        except ParseError as e:
            return MemReport(file, query, "unknown", detail=str(e))
        self.needed = statement_needed_names(stmt)
        cost = _MemCost()
        env = self._base_env()
        out_rows = 0
        try:
            if isinstance(stmt, A.Query):
                out_rows = self._audit_query(stmt, env, cost).rows
            elif isinstance(stmt, (A.InsertInto, A.CreateTempView)):
                out_rows = self._audit_query(stmt.query, env, cost).rows
            elif isinstance(stmt, A.DeleteFrom):
                name = stmt.table.lower()
                rows = self.model.table_rows(name) or 1
                cost.peak += rows * self.model.pruned_width(name, None)
            else:
                return MemReport(file, query, "unknown",
                                 detail=f"unmodeled statement "
                                        f"{type(stmt).__name__}")
        except RecursionError:
            return MemReport(file, query, "unknown",
                             detail="recursion limit")
        mode = "streamed" if cost.scans else "device"
        return MemReport(file, query, mode, peak_bytes=cost.peak,
                         out_rows=out_rows, scans=tuple(cost.scans))

    def _base_env(self) -> dict:
        env = {}
        for name, widths in self.model.widths.items():
            rows = self.model.table_rows(name) or 1
            env[name] = (widths, rows, name in self.base_tables)
        return env

    # -- query / set-expression walk ---------------------------------------

    def _audit_query(self, q: A.Query, env: dict, cost: _MemCost) -> _MRel:
        env = dict(env)
        for cname, cq in q.ctes:
            out = self._audit_query(cq, env, cost)
            widths = {c: w for cols in out.widths.values()
                      for c, w in cols.items()}
            # a CTE result is a device table whatever it scanned; it may
            # shadow a chunked catalog name (the planner resolves CTEs
            # first, so the statement does not stream the shadowed table)
            env[cname.lower()] = (widths, out.rows, False)
        out = self._audit_body(q.body, env, cost)
        # ORDER BY: the device lexsort holds one index vector alongside
        # the input — 8 B per row, already dominated by the conservative
        # sum; LIMIT clamps the output rows exactly
        if q.limit is not None:
            out.rows = min(out.rows, max(int(q.limit), 0))
        return out

    def _audit_body(self, body, env: dict, cost: _MemCost) -> _MRel:
        if isinstance(body, A.SetOp):
            left = self._audit_body(body.left, env, cost)
            right = self._audit_body(body.right, env, cost)
            rows = left.rows + right.rows
            # the concatenated buffer is a fresh allocation alongside the
            # branches (UNION's distinct grouping reuses it in place)
            cost.peak += _bucket(max(rows, 1)) * max(left.width,
                                                     right.width, 1)
            if body.op in ("intersect", "except"):
                rows = left.rows         # both are subsets of the left
            elif body.op == "union":
                # distinct union: also bounded by the output columns'
                # value-domain product (same rule as SELECT DISTINCT)
                doms = [d for cols in left.dom.values()
                        for d in cols.values()]
                if doms:
                    dom = 1
                    for v in doms:
                        dom = min(dom * max(v, 1), max(rows, 1))
                    rows = min(rows, max(dom, 1))
            out = _MRel(left.alias, {}, rows)
            out.cols, out.widths, out.dom = left.cols, left.widths, left.dom
            out.rows = rows
            return out
        if isinstance(body, A.Query):
            return self._audit_query(body, env, cost)
        return self._audit_select(body, env, cost)

    # -- SELECT -------------------------------------------------------------

    def _audit_select(self, sel: A.Select, env: dict,
                      cost: _MemCost) -> _MRel:
        where = _conjuncts_of(sel.where)
        parts, preds = self._flatten_from(sel.from_, env, cost, where)
        if parts:
            joined = self._audit_graph(parts, list(preds) + list(where),
                                       env, cost)
        else:
            joined = _MRel("_dual", {}, 1, single_row=True)
        for item in sel.items:
            self._walk_subqueries(item.expr, env, cost)
        if sel.having is not None:
            self._walk_subqueries(sel.having, env, cost)
        if not parts:
            # with a FROM graph the WHERE conjuncts were handed to
            # _audit_graph, which walks their subqueries exactly once
            for c in where:
                self._walk_subqueries(c, env, cost)

        rows = joined.rows
        if sel.group_by is not None:
            gb = sel.group_by
            # group output <= product of the key value domains (a base
            # column's domain is at most its table's rows), clamped at
            # input rows; grouping sets replay the aggregation per set
            dom = 1
            for e in gb.exprs:
                d = joined.col_domain(e) if isinstance(e, A.ColumnRef) \
                    else rows
                dom = min(dom * max(d, 1), max(rows, 1))
            n_sets = max(len(gb.sets), 1) if gb.kind != "plain" else 1
            rows = min(rows, max(dom, 1)) * n_sets
        elif self._has_aggregate_items(sel):
            rows = 1                       # keyless aggregate: one row

    # -- projection: output widths/domains ----------------------------------

        widths, dom = {}, {}
        for i, item in enumerate(sel.items):
            e = item.expr
            if isinstance(e, A.Star):
                qual = e.table and e.table.lower()
                for a, cols in joined.widths.items():
                    if qual is None or a == qual:
                        widths.update(cols)
                        dom.update(joined.dom.get(a, {}))
                continue
            if item.alias:
                name = item.alias.lower()
            elif isinstance(e, A.ColumnRef):
                name = e.name.lower()
            else:
                name = f"_c{i}"
            if isinstance(e, A.ColumnRef):
                widths[name] = joined.col_width(e)
                dom[name] = joined.col_domain(e)
            else:
                widths[name] = 9
                dom[name] = rows
        out = _MRel("_out", widths, rows, dom=dom)
        if sel.distinct and dom:
            d = 1
            for v in dom.values():
                d = min(d * max(v, 1), max(rows, 1))
            out.rows = rows = min(rows, max(d, 1))
        # the projected output is a fresh materialization
        cost.peak += _bucket(max(rows, 1)) * max(out.width, 1)
        return out

    def _has_aggregate_items(self, sel: A.Select) -> bool:
        from nds_tpu_torch.sql.parser import AGG_FUNCS

        def has_agg(e) -> bool:
            if isinstance(e, A.FuncCall) and e.name.lower() in AGG_FUNCS:
                return True
            return any(has_agg(c) for c in _children(e))

        return any(has_agg(i.expr) for i in sel.items
                   if not isinstance(i.expr, A.Star))

    # -- FROM flattening (mirror of Planner._flatten_from) ------------------

    def _flatten_from(self, node, env: dict, cost: _MemCost, where=None,
                      top: bool = True):
        if node is None:
            return [], []
        if isinstance(node, A.TableRef):
            name = node.name.lower()
            alias = (node.alias or node.name).lower()
            widths, rows, is_base = env.get(name, ({}, 1, False))
            widths = self._prune(widths)
            chunked = is_base and name in self.streamed
            enc_widths = None
            if chunked and self.model.encoded:
                # streamed scans upload (and accumulate) the narrow
                # encoded representation — the width the proof prices
                enc_cols = self.model.enc_widths.get(name, {})
                enc_widths = {c: enc_cols.get(c, w)
                              for c, w in widths.items()}
            rel = _MRel(alias, enc_widths if enc_widths is not None
                        else widths, rows,
                        source=name if is_base else None, chunked=chunked)
            if enc_widths is not None:
                rel.plain_widths = dict(widths)
            if is_base and not chunked:
                # a device-resident base scan uploads its pruned columns
                cost.peak += _bucket(rows) * rel.width
            return [rel], []
        if isinstance(node, A.SubqueryRef):
            out = self._audit_query(node.query, env, cost)
            rel = _MRel(node.alias,
                        {c: w for cols in out.widths.values()
                         for c, w in cols.items()}, out.rows,
                        single_row=_single_row_query(node.query))
            return [rel], []
        if isinstance(node, A.Join):
            if node.kind in ("cross", "inner"):
                lp, lj = self._flatten_from(node.left, env, cost, where,
                                            top=False)
                rp, rj = self._flatten_from(node.right, env, cost, where,
                                            top=False)
                return lp + rp, lj + rj + _conjuncts_of(node.condition)
            lp, lj = self._flatten_from(node.left, env, cost, top=False)
            got = self._deferred_left(node, lp, lj, env, cost, where, top)
            if got is not None:
                return got
            # outer/semi/anti join: each side materializes whole first
            left = self._audit_graph(lp, lj, env, cost)
            rp, rj = self._flatten_from(node.right, env, cost)
            return self._finish_outer(node, left, rp, rj, env, cost)
        if isinstance(node, A.Query):        # parenthesized join tree
            return self._flatten_from(getattr(node.body, "from_", None),
                                      env, cost, where)
        return [], []

    def _finish_outer(self, node, left, rp, rj, env, cost):
        right = self._audit_graph(rp, rj, env, cost)
        rows = self._binary_join_rows(node, left, right)
        merged = left.merged_with(right, rows)
        cost.peak += _bucket(max(rows, 1)) * merged.width
        return [merged], []

    def _deferred_left(self, node, lp, lj, env, cost, where, top=True):
        """Mirror of the planner's multi-pass LEFT-join deferral (and of
        ``exec_audit._deferred_left``): an eligible join's sides flow
        into the enclosing streamed graph with the ON conjuncts as plain
        edges — the bound rules (PK-unique side => multiplicity 1) then
        price the join exactly like an inner PK batch, and the outer
        extras stay bounded by the preserved side's rows (every preserved
        row appears exactly once, matched or null-extended)."""
        if node.kind != "left" or node.condition is None:
            return None
        conjs = _conjuncts_of(node.condition)
        if not conjs or any(_has_subquery(c) for c in conjs):
            return None

        def plain_pairs(rel):
            out = []
            for c in conjs:
                if not (isinstance(c, A.BinaryOp) and c.op == "=" and
                        isinstance(c.left, A.ColumnRef) and
                        isinstance(c.right, A.ColumnRef)):
                    return None
                rk = rel.owns(c.left)
                lref = c.right
                if rk is None:
                    rk = rel.owns(c.right)
                    lref = c.left
                if rk is None or not any(p.owns(lref) for p in lp):
                    return None
                out.append((lref, rk))
            return out

        l_chunk = any(p.chunked for p in lp)
        if l_chunk:
            # (b1): preserved chunk side — one pristine right scan whose
            # ON keys are exactly its declared (composite) primary key
            rp, rj = self._flatten_from(node.right, env, cost, top=False)
            eligible = len(rp) == 1 and not rj and rp[0].source and \
                not rp[0].chunked
            if eligible:
                pairs = plain_pairs(rp[0])
                pk = _table_pk(rp[0].source)
                eligible = pairs is not None and pk is not None and \
                    {rk for (_l, rk) in pairs} == set(pk)
            if eligible:
                return lp + rp, lj + conjs
            left = self._audit_graph(lp, lj, env, cost)
            return self._finish_outer(node, left, rp, rj, env, cost)
        # (b2): null-introducing chunk side — single build part on the
        # left, single chunked scan on the right, the join being the
        # SELECT's whole FROM, and no remaining WHERE conjunct beyond
        # those the planner consumes below the join (build-side only)
        if len(lp) != 1 or lp[0].chunked:
            return None
        rp, rj = self._flatten_from(node.right, env, cost, top=False)
        eligible = top and len(rp) == 1 and not rj and rp[0].chunked and \
            plain_pairs(rp[0]) is not None
        if eligible:
            for c in (where or []):
                if _has_subquery(c):
                    eligible = False
                    break
                refs = _column_refs(c)
                # conjuncts fully on the build side are consumed below
                # the join by the planner (lw) and do not block
                if refs and all(lp[0].owns(r) for r in refs):
                    continue
                eligible = False
                break
        if eligible:
            lp[0].single_row = False
            return rp + lp, lj + conjs
        left = self._audit_graph(lp, lj, env, cost)
        return self._finish_outer(node, left, rp, rj, env, cost)

    def _prune(self, widths: dict) -> dict:
        if self.needed is None:
            return dict(widths)
        kept = {c: w for c, w in widths.items() if c in self.needed}
        return kept if kept and len(kept) < len(widths) else dict(widths)

    def _binary_join_rows(self, node: A.Join, left: _MRel,
                          right: _MRel) -> int:
        """Row bound of one materialized (outer/semi/anti) binary join.
        Semi/anti never grow the left side; a LEFT join against a side
        whose ON keys cover its declared primary key is 1:1 (matches +
        extras <= left rows); everything else is bounded by the pair
        bucket plus the null-extended extras."""
        if node.kind in ("semi", "anti"):
            return left.rows
        conjuncts = _conjuncts_of(node.condition)
        part_cols = [left.colset(), right.colset()]
        sources = [left.source, right.source]
        unique = {}
        for side, other in ((1, 0), (0, 1)):
            pk = _table_pk(sources[side])
            keys = set()
            for c in conjuncts:
                e = _equi_sides(c, part_cols)
                if e is None:
                    continue
                li, ri, lk, rk = e
                k = lk if li == side else (rk if ri == side else None)
                if k is not None:
                    keys.add(k)
            unique[side] = pk is not None and keys >= set(pk)
        pairs = left.rows if unique.get(1) else (
            right.rows if unique.get(0) and node.kind != "left"
            else _bucket(max(left.rows, 1)) * self.model.fanout)
        if node.kind == "left":
            return pairs + left.rows
        if node.kind == "right":
            return pairs + right.rows
        if node.kind == "full":
            return pairs + left.rows + right.rows
        return pairs

    # -- join-graph bounds (mirror of Planner._join_parts) ------------------

    def _audit_graph(self, parts, conjuncts, env, cost: _MemCost) -> _MRel:
        if not parts:
            return _MRel("_dual", {}, 1, single_row=True)
        if len(parts) == 1 and not any(p.chunked for p in parts):
            for c in conjuncts:
                self._walk_subqueries(c, env, cost)
            return parts[0]
        part_cols = [p.colset() for p in parts]
        sources = [p.source for p in parts]
        batches: dict = {}
        for c in conjuncts:
            if _has_subquery(c):
                # multi-pass streaming: the subquery pre-plans into a
                # device residual and the conjunct filters joined rows —
                # it neither grows rows nor breaks the proof
                self._walk_subqueries(c, env, cost)
                continue
            e = _equi_sides(c, part_cols)
            if e is not None:
                li, ri, _lk, _rk = e
                batches.setdefault(tuple(sorted((li, ri))), []).append(e)

        parent = list(range(len(parts)))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for (a, b) in batches:
            parent[find(a)] = find(b)

        # per-component row bound: the largest member, times the enforced
        # fanout bucket for every batch with no unique side; components
        # multiply (cartesian layout is an exact product)
        comp_rows: dict = {}
        for i, p in enumerate(parts):
            r = find(i)
            base = 1 if p.single_row else max(p.rows, 1)
            comp_rows[r] = max(comp_rows.get(r, 1), base)
        chunked_idx = [i for i, p in enumerate(parts) if p.chunked]
        # keep-choice mirrors the executor (largest by UNENCODED bytes:
        # the runtime picks by arrow nbytes); non-kept chunked parts bind
        # whole through the plain device path, so they re-price plain
        keep = max(chunked_idx, key=lambda i: parts[i].rows *
                   max(parts[i].plain_width, 1)) if chunked_idx else None
        for i in chunked_idx:
            if i != keep:
                parts[i].use_plain_widths()
        for (a, b), batch in batches.items():
            if not _batch_unique_side(part_cols, sources,
                                      keep if keep is not None else -1,
                                      a, b, batch):
                r = find(a)
                comp_rows[r] = _bucket(comp_rows[r]) * self.model.fanout
        joined_rows = 1
        for r in comp_rows.values():
            joined_rows *= r

        merged = parts[0]
        for p in parts[1:]:
            merged = merged.merged_with(p, joined_rows)
        merged.rows = joined_rows

        if keep is None:
            # device-resident graph: the joined result materializes whole
            cost.peak += _bucket(max(joined_rows, 1)) * merged.width
            return merged

        # streamed graph: non-kept chunked parts bind whole (one
        # streaming axis per graph) — charge their resident bytes
        for i in chunked_idx:
            if i != keep:
                cost.peak += _bucket(parts[i].rows) * parts[i].width
        kept = parts[keep]
        k = stream_graph_fanout(part_cols, sources, keep, conjuncts)
        chunk_bytes = self.model.chunk_cap() * kept.width
        # async ingest: the bounded prefetch ring holds up to ``depth``
        # MORE prepared chunks beyond the in-flight pair — priced into
        # the peak below and off the capacity every admission decision
        # here compares against (lockstep with engine/stream.py)
        ring_bytes = self.model.ring_bytes(kept.width)
        admit_cap = self.model.admit_capacity(kept.width)
        n_parts, part_rows, part_bytes = 1, None, None
        if k is not None:
            acc_rows = self.model.acc_row_bound(kept.rows, k)
            if self.model.acc_ceiling is not None:
                acc_rows = min(acc_rows, self.model.acc_ceiling)
            acc_bytes = acc_rows * merged.width
            survivors = min(joined_rows, acc_rows)
            # grace-style partition decomposition: when the whole-graph
            # bound is past capacity (or ``stream_partitions`` pins a
            # count), a graph with plain equi keys on the streamed slot
            # is proven per partition instead — the rule the executor
            # mirrors at pipeline build (engine/stream.py)
            forced = self.model.partitions
            if (acc_bytes > admit_cap
                    or (forced is not None and forced > 1)):
                keys = stream_partition_keys(part_cols, sources, keep,
                                             conjuncts)
                if keys:
                    p, _ = choose_partitions(
                        kept.rows, k, self.model.fanout,
                        max(merged.width, 1), admit_cap,
                        forced=forced, skew=self.model.skew)
                    if p > 1:
                        n_parts = p
                        part_rows = self.model.partition_bound(
                            kept.rows, k, p)
                        if self.model.acc_ceiling is not None:
                            part_rows = min(part_rows,
                                            self.model.acc_ceiling)
                        part_bytes = part_rows * merged.width
        else:
            # eager loop: survivors concatenate up to the graph bound
            acc_rows = acc_bytes = None
            survivors = joined_rows
        # mesh-sharded execution (``stream_shards``): the per-shard
        # survivor bound is the share rule applied over the mesh —
        # rows/shards x skew through the fan-out — and the allocation
        # unit is the (partition, shard) composition. The eager loop
        # never shards, so unprovable scans keep shards=1.
        n_shards, srows, sbytes = 1, None, None
        if k is not None and self.model.shards > 1:
            n_shards = self.model.shards
            srows = min(acc_rows,
                        shard_row_bound(kept.rows, n_shards, 1, k,
                                        self.model.fanout, self.model.skew))
            unit = min(part_rows if part_rows is not None else acc_rows,
                       shard_row_bound(kept.rows, n_shards, n_parts, k,
                                       self.model.fanout, self.model.skew))
            if self.model.acc_ceiling is not None:
                srows = min(srows, self.model.acc_ceiling)
                unit = min(unit, self.model.acc_ceiling)
            sbytes = unit * merged.width
        sb = ScanBound(kept.alias, kept.source or "?", kept.rows, k,
                       acc_rows, acc_bytes, chunk_bytes,
                       partitions=n_parts, part_rows=part_rows,
                       part_bytes=part_bytes, shards=n_shards,
                       shard_rows=srows, shard_bytes=sbytes,
                       ring_bytes=ring_bytes)
        cost.scans.append(sb)
        # working set: two chunks in flight + the prefetch ring's live
        # set (depth more prepared chunks) + the survivor accumulator(s)
        # (partitioned: every partition's proof-sized accumulator is live
        # until the single materializing sync; eager: the concatenated
        # survivor union)
        if part_bytes is not None:
            held = n_parts * part_bytes
        elif acc_bytes is not None:
            held = acc_bytes
        else:
            held = _bucket(max(survivors, 1)) * merged.width
        cost.peak += 2 * chunk_bytes + ring_bytes + held
        merged.rows = survivors
        return merged

    # -- subqueries inside expressions --------------------------------------

    def _walk_subqueries(self, e, env: dict, cost: _MemCost) -> None:
        def walk(node):
            if isinstance(node, (A.InSubquery, A.ScalarSubquery, A.Exists,
                                 A.QuantifiedCompare)):
                self._audit_query(node.query, env, cost)
                return
            for c in _children(node):
                walk(c)

        walk(e)


# ---------------------------------------------------------------------------
# corpus driver + lint-gate findings
# ---------------------------------------------------------------------------

# pinned instantiation seed shared with exec_audit: bounds must not depend
# on sampled parameter values
_AUDIT_SEED = 20260803


def audit_mem_template_text(text: str, file: str,
                            auditor: MemAuditor | None = None) -> list:
    auditor = auditor or MemAuditor()
    sql = instantiate_template(text, np.random.default_rng(_AUDIT_SEED))
    stmts = [s for s in sql.split(";") if s.strip()]
    base = os.path.basename(file)
    out = []
    for i, stmt in enumerate(stmts):
        qname = base[:-4] if base.endswith(".tpl") else base
        if len(stmts) > 1:
            qname = f"{qname}_part{i + 1}"
        out.append(auditor.audit_sql(stmt, file=base, query=qname))
    return out


def audit_mem_corpus(template_dir: str | None = None, streamed=None,
                     model: MemModel | None = None) -> list:
    """MemReports for every template in templates.lst order."""
    template_dir = template_dir or TEMPLATE_DIR
    auditor = MemAuditor(streamed=streamed, model=model)
    reports: list = []
    for name in list_templates(template_dir):
        reports.extend(audit_mem_template_text(
            load_template(name, template_dir), name, auditor))
    return reports


def reports_to_findings(reports, capacity_bytes: int | None = None) -> list:
    """``hbm-capacity`` findings: a device-resident statement whose peak
    bound exceeds the capacity cannot be admitted at the audited scale,
    and a streamed statement whose proven accumulator bound exceeds it
    would be sized past the card's memory. A partitioned scan is gated on
    its per-partition bound (the unit the executor allocates and the
    per-partition overflow flag enforces), a sharded one on its
    (partition, shard) unit. Eager-loop scans (unprovable multiplicity)
    are reported in ``--mem-report`` but not gated: the eager loop's
    working set is per chunk. The capacity is
    :func:`hbm_capacity_bytes`: the ``hbm_bytes`` setting, else the
    card's memory on cuda, else 16 GiB."""
    cap = hbm_capacity_bytes() if capacity_bytes is None else capacity_bytes
    findings = []
    for r in reports:
        if r.mode == "device" and r.peak_bytes > cap:
            findings.append(Finding(
                r.file, r.query, "hbm-capacity", "error",
                f"device-resident peak bound {r.peak_bytes:,} B exceeds "
                f"the device-memory capacity {cap:,} B (hbm_bytes)"))
        for s in r.scans:
            if not s.provable:
                continue
            if s.shards > 1 and s.shard_bytes is not None:
                # sharded pipeline: the allocation unit is one
                # (partition, shard) accumulator — the bound the per-shard
                # overflow flags enforce
                if s.shard_bytes > cap:
                    findings.append(Finding(
                        r.file, r.query, "hbm-capacity", "error",
                        f"streamed scan {s.table!r} per-shard accumulator "
                        f"bound {s.shard_bytes:,} B ({s.shards} shards x "
                        f"{s.partitions} partitions) exceeds the "
                        f"device-memory capacity {cap:,} B"))
                continue
            if s.partitions > 1 and s.part_bytes is not None:
                if s.part_bytes > cap:
                    findings.append(Finding(
                        r.file, r.query, "hbm-capacity", "error",
                        f"streamed scan {s.table!r} per-partition "
                        f"accumulator bound {s.part_bytes:,} B "
                        f"({s.part_rows:,} rows x {s.partitions} "
                        f"partitions) exceeds the device-memory "
                        f"capacity {cap:,} B"))
            elif s.acc_bytes is not None and s.acc_bytes > cap:
                findings.append(Finding(
                    r.file, r.query, "hbm-capacity", "error",
                    f"streamed scan {s.table!r} accumulator bound "
                    f"{s.acc_bytes:,} B ({s.acc_rows:,} rows) exceeds the "
                    f"device-memory capacity {cap:,} B"))
    return findings


def mem_audit_findings(template_dir: str | None = None) -> list:
    """The lint pass entry point (``nds_tpu_torch.tools.lint``)."""
    return reports_to_findings(audit_mem_corpus(template_dir))


def _human(n) -> str:
    if n is None:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return str(n)


def format_mem_report(reports) -> str:
    """The per-statement bound table (``nds_tpu_torch.tools.lint
    --mem-report``)."""
    cap = hbm_capacity_bytes()
    depth = max(int(setting("prefetch_depth")), 0)
    lines = ["# mem-audit: per-statement peak device-memory byte bounds",
             f"# capacity model: {_human(cap)} (hbm_bytes); "
             f"prefetch ring depth {depth} (prefetch_depth) — "
             "ring live set (depth x chunk bytes) priced into every "
             "streamed peak and off the admitting capacity",
             f"{'template':<18} {'mode':<9} {'peak':>9}  accumulators"]
    worst = 0
    for r in reports:
        worst = max(worst, r.peak_bytes)
        bits = []
        for s in r.scans:
            ring = f" + ring {_human(s.ring_bytes)}" if s.ring_bytes \
                else ""
            if s.provable and s.shards > 1:
                bits.append(f"{s.table}: S={s.shards}"
                            + (f" x P={s.partitions}"
                               if s.partitions > 1 else "")
                            + f" x {_human(s.shard_bytes)}/shard "
                            f"({s.shard_rows:,} rows/shard, "
                            f"k={s.fanout_k}){ring}")
            elif s.provable and s.partitions > 1:
                bits.append(f"{s.table}: P={s.partitions} x "
                            f"{_human(s.part_bytes)}/part "
                            f"({s.part_rows:,} rows/part, "
                            f"k={s.fanout_k}){ring}")
            elif s.provable:
                bits.append(f"{s.table}: {_human(s.acc_bytes)} "
                            f"({s.acc_rows:,} rows, k={s.fanout_k})"
                            f"{ring}")
            else:
                bits.append(f"{s.table}: unprovable (eager loop){ring}")
        lines.append(f"{r.query:<18} {r.mode:<9} "
                     f"{_human(r.peak_bytes):>9}  " + "; ".join(bits))
    lines.append(f"# {len(reports)} statements — worst peak bound "
                 f"{_human(worst)} vs capacity {_human(cap)}")
    return "\n".join(lines)
