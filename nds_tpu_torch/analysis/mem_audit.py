# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The survivor-bound proof the streamed pipeline sizes its accumulators
from (the runtime pieces of the reference's static memory model).

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

import torch

from nds_tpu_torch.schema import COMPOSITE_PRIMARY_KEYS, PRIMARY_KEYS
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
