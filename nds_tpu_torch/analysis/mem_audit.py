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
"""

from __future__ import annotations

import math

import torch

from nds_tpu_torch.schema import (COMPOSITE_PRIMARY_KEYS, PRIMARY_KEYS,
                                  decimal_precision_scale, get_schemas,
                                  is_decimal, is_string)
from nds_tpu_torch.sql import ast as A

# capacity model on the CPU: the reference's default (one 16 GiB chip), so
# the CPU tests choose the reference's partition counts
DEFAULT_HBM_BYTES = 16 << 30


def hbm_capacity_bytes() -> int:
    """Device-memory capacity of the calling statement: the ``hbm_bytes``
    setting, else the card's total memory on cuda, else
    :data:`DEFAULT_HBM_BYTES`."""
    from nds_tpu_torch.engine import ops as E
    got = E.setting("hbm_bytes")
    if got is not None:
        return int(got)
    dev = E.device()
    if dev.type == "cuda":
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
    from nds_tpu_torch.engine.ops import bucket_len
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
    from nds_tpu_torch.engine import ops as E
    got = E.setting("stream_partitions")
    return None if got is None else min(_pow2_at_least(int(got)),
                                        _MAX_PARTITIONS)


def stream_skew_factor() -> int:
    """The ``stream_skew`` setting: the hash-skew safety factor of the
    per-partition bound (one partition may hold up to ``skew x`` its even
    share before the enforced overflow flag fires)."""
    from nds_tpu_torch.engine import ops as E
    return max(int(E.setting("stream_skew")), 1)


def stream_shards() -> int:
    """The ``stream_shards`` setting: the shard count of a streamed
    pipeline (rounded up to a power of two, clamped to
    :data:`_MAX_PARTITIONS` like the partition count, so the two routing
    windows take at most 8 + 8 of the hash's 32 bits; <= 1 disables). The
    runtime also needs that many local devices, or shards that share them
    (``parallel.exchange.stream_mesh``), and builds unsharded otherwise."""
    from nds_tpu_torch.engine import ops as E
    got = E.setting("stream_shards")
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
    """``ops.bucket_len`` without a device: the audit's row bounds round
    exactly like the engine's physical buckets."""
    from nds_tpu_torch.engine.ops import bucket_len
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
        from nds_tpu_torch.engine import ops as E
        from nds_tpu_torch.engine.prefetch import prefetch_depth
        from nds_tpu_torch.engine.table import CHUNK_ROWS
        from nds_tpu_torch.io.columnar import encoded_enabled
        self.row_bounds = dict(DEFAULT_ROW_BOUNDS if row_bounds is None
                               else row_bounds)
        self.capacity_bytes = (hbm_capacity_bytes() if capacity_bytes is None
                               else int(capacity_bytes))
        self.fanout = _pow2_ceil(int(E.setting("stream_fanout"))
                                 if fanout is None else int(fanout))
        self.chunk_rows = int(CHUNK_ROWS if chunk_rows is None
                              else chunk_rows)
        if acc_ceiling == "setting":
            got = E.setting("stream_acc_rows")
            acc_ceiling = int(got) if got else None
        self.acc_ceiling = acc_ceiling
        self.partitions = forced_partitions()      # None = proof-chosen
        self.skew = stream_skew_factor()
        self.shards = stream_shards()
        # the prefetch ring's chunks beyond the in-flight pair, priced
        # into every streamed peak and off the admitting capacity
        self.prefetch_depth = max(prefetch_depth(), 0)
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
