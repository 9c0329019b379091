# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Planner/executor: lowers parsed SQL onto the columnar engine.

Table-at-a-time interpretation with the optimizations that matter for the
TPC-DS shape: single-table predicate pushdown before joins, equi-join graph
extraction from WHERE conjuncts (comma joins never cartesian unless truly
unconnected), sort-based grouping, decorrelation of equality-correlated
EXISTS/IN/scalar subqueries into (semi/left) joins, grouping-set expansion,
and shared window-sort contexts.

Columns are internally named ``alias.column``; unqualified references resolve
by unique suffix match, mirroring SQL scoping.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from nds_tpu_torch.engine import exprs as X
from nds_tpu_torch.engine import ops as E
from nds_tpu_torch.engine import prim
from nds_tpu_torch.engine import sharded as SH
from nds_tpu_torch.engine.column import Column
from nds_tpu_torch.engine.table import DeviceTable
from nds_tpu_torch.engine.window import WindowContext
from nds_tpu_torch.obs import trace as _obs
from nds_tpu_torch.sql import ast as A
from nds_tpu_torch.sql.parser import expr_key


class ExecError(ValueError):
    pass


# Defer pushed-down filters into the join hash (no compaction sync) up to
# this physical size; above it, compaction pays for itself by shrinking the
# join's sort/probe width.
DEFER_FILTER_MAX_ROWS = 1 << 21


@dataclass
class EvalCtx:
    """Expression evaluation context."""
    table: DeviceTable
    agg_values: dict = field(default_factory=dict)      # expr_key -> Column
    group_values: dict = field(default_factory=dict)    # expr_key -> Column
    grouping_flags: dict = field(default_factory=dict)  # expr_key -> 0/1 (per set)
    select_aliases: dict = field(default_factory=dict)  # alias -> Column
    window_values: dict = field(default_factory=dict)   # expr_key -> Column
    post_agg: bool = False


class _StreamedScan:
    """A streamed (bigger than device memory) base-table scan inside a join
    graph: the host-resident
    ChunkedTable plus its FROM alias. :func:`Planner._stream_join_parts`
    binds its device chunks one at a time."""

    def __init__(self, chunked, alias: str):
        self.chunked = chunked
        self.alias = alias

    @property
    def nbytes(self) -> int:
        return self.chunked.nbytes

    @property
    def column_names(self):
        return [f"{self.alias.lower()}.{n.split('.')[-1].lower()}"
                for n in self.chunked.column_names]

    def device_chunks(self, planner):
        # the device is read here, on the calling thread: the chunks are
        # produced on the prefetch worker, which has no device of its own
        chunks = self.chunked.device_chunks(E.device())
        return (planner._alias_table(c, self.alias) for c in chunks)

    def bind_whole(self, planner):
        return planner._alias_table(self.chunked.materialize(E.device()),
                                    self.alias)


class _OuterProbe:
    """A deferred LEFT join whose PRESERVED side holds the >HBM chunked
    scan (q40/q78/q80/q93: ``fact left join returns on returns-PK``).
    The join rides INTO the streamed graph: every chunk applies the
    sync-free PK gather against the whole probe table inside the per-chunk
    program (``Planner._apply_outer``), so nothing materializes
    whole and the per-chunk unmatched rows — which distribute over the
    preserved side's chunks — null-extend in place."""

    def __init__(self, table: DeviceTable, condition, conjuncts, src):
        self.table = table          # alias-qualified device table
        self.condition = condition  # the original ON expression (AST)
        self.conjuncts = list(conjuncts)
        self.src = src              # pristine catalog name (PK provenance)

    @property
    def column_names(self):
        return self.table.column_names


class _OuterBuild:
    """A deferred LEFT join whose NULL-INTRODUCING side holds the chunked
    scan (q5: ``returns left join sales on sales-PK``). Each chunk emits
    its matched pairs through an inner bound-bucket join and registers the
    matched-build-row mask (``ops.stream_outer_matched``); the pipeline
    ORs the masks into an on-device unmatched-key accumulator and the
    outer extras — build rows no chunk matched — are emitted ONCE at
    materialize time, null-extended to the joined schema."""

    def __init__(self, table: DeviceTable, condition, conjuncts, src):
        self.table = table
        self.condition = condition
        self.conjuncts = list(conjuncts)
        self.src = src

    @property
    def column_names(self):
        return self.table.column_names


def outer_extras_table(build: DeviceTable, idx, n_extras,
                       template: DeviceTable) -> DeviceTable:
    """The outer-extras rows of a deferred outer-build join: unmatched
    build rows gathered by ``idx``, null-extended to the joined output
    schema of ``template`` (columns the build side does not provide come
    back NULL, exactly like the extras arm of a materialized left join)."""
    cols = {}
    cap = int(idx.shape[0])
    for n in template.column_names:
        t = template[n]
        if n in build.columns:
            cols[n] = build[n].take(idx)
        else:
            dev = idx.device
            data = torch.zeros((cap,) + tuple(t.data.shape[1:]),
                               dtype=t.data.dtype, device=dev)
            cols[n] = Column(t.kind, data,
                             torch.zeros(cap, dtype=torch.bool, device=dev),
                             t.dict_values, t.enc)
    return DeviceTable(cols, n_extras, plen=cap)


def _table_bytes(t) -> int:
    """Resident byte size of a catalog table (device columns, a meshed
    table's share or a host-resident ChunkedTable) — the scanBytes term
    of the per-query roofline accounting."""
    if hasattr(t, "nbytes"):               # ChunkedTable, ShardedTable
        return int(t.nbytes)
    return sum(c.data.nbytes + (0 if c.valid is None else c.valid.nbytes)
               for c in t.columns.values())


class Planner:
    def __init__(self, catalog: dict, base_tables: set | None = None):
        self.catalog = catalog          # name -> (DeviceTable with plain col names)
        # names the session loaded as pristine base-table scans; only these
        # carry schema guarantees (PK uniqueness for gather joins)
        self.base_tables = base_tables if base_tables is not None else set()
        self.cte_stack: list[dict] = []
        self._synth_keys = 0             # synthetic join-key name counter
        # bare column names the current statement references anywhere
        # (projection pushdown); None = pruning disabled (SELECT * present
        # or not yet computed)
        self._needed_names: set | None = None
        # roofline accounting: catalog tables this statement actually bound,
        # with their resident byte sizes (per-query scanBytes in summaries)
        self.scanned: dict[str, int] = {}
        # per-statement registry of planned subquery residuals
        # (device-resident inner results keyed by the subquery's
        # structural expr_key): a repeated subquery is planned once, and
        # the streamed pipeline's per-chunk program consumes each as an
        # ordinary device table instead of re-planning it per chunk
        self._subquery_residuals: dict = {}
        # while a pipeline records, the residual keys the record phase
        # touched (registry hits included) — the pipeline's operand list
        self._residuals_touched: list | None = None

    # ------------------------------------------------------------------ query

    def _collect_needed_names(self, node) -> set | None:
        """Bare (unqualified, lowercased) column names referenced anywhere in
        the statement, or None when pruning is unsafe. Over-approximates
        across subqueries — pruning only ever drops columns NO expression in
        the whole statement mentions, and a miss fails loudly at name
        resolution, never silently.

        SELECT * is resolved SCOPED instead of disabling pruning globally
        (q21-class queries wrap a narrow aggregate in ``select * from (...)``
        — without scoping, every base scan under the subquery drags all of
        its columns through the join). A star over a derived table needs
        nothing (the inner projection is explicit and its refs are walked);
        a star over a catalog table adds that table's full column set; only
        a star over an unresolvable name disables pruning."""
        names: set = set()
        star = False
        # names that resolve to derived tables (CTEs) anywhere in the
        # statement, with their projected OUTPUT names (None when not
        # statically derivable): a star over a CTE needs the CTE's output
        # columns even though nothing references them (q47-class
        # ``select * from v2`` where v2 projects aliased columns)
        cte_outputs: dict = {}

        def output_names(body):
            if isinstance(body, A.Select):
                return self._projected_names(body.items)
            left = getattr(body, "left", None)
            return output_names(left) if left is not None else None

        def collect_ctes(x):
            if isinstance(x, A.Query):
                for cname, cq in x.ctes:
                    cte_outputs[cname.lower()] = output_names(cq.body)
            if hasattr(x, "__dataclass_fields__"):
                for f in vars(x).values():
                    collect_any(f, collect_ctes)

        def collect_any(f, fn):
            if isinstance(f, (list, tuple)):
                for y in f:
                    collect_any(y, fn)
            elif hasattr(f, "__dataclass_fields__"):
                fn(f)
        collect_ctes(node)

        def from_leaves(f, out):
            if f is None:
                return
            if isinstance(f, A.TableRef):
                out.append(f)
            elif isinstance(f, A.Join):
                from_leaves(f.left, out)
                from_leaves(f.right, out)
            # SubqueryRef leaves contribute nothing: their projections are
            # explicit and walked on their own

        def resolve_star(sel: A.Select, qualifier):
            """Add the base columns a star could expand to; returns False
            when any leaf is unresolvable (disable pruning)."""
            leaves: list = []
            from_leaves(sel.from_, leaves)
            for leaf in leaves:
                alias = (leaf.alias or leaf.name).lower()
                if qualifier and qualifier.lower() != alias:
                    continue
                name_l = leaf.name.lower()
                t = self.catalog.get(name_l) or self.catalog.get(leaf.name)
                if t is not None:
                    names.update(n.split(".")[-1].lower()
                                 for n in t.column_names)
                elif name_l in cte_outputs:
                    outs = cte_outputs[name_l]
                    if outs is None:
                        return False          # CTE outputs not derivable
                    names.update(outs)
                else:
                    return False              # unknown leaf: stay safe
            return True

        def walk(x, sel=None):
            nonlocal star
            if star or x is None:
                return
            if isinstance(x, A.Star):
                if sel is None or not resolve_star(sel, x.table):
                    star = True
                return
            if isinstance(x, A.ColumnRef):
                names.add(x.name.lower())
            here = x if isinstance(x, A.Select) else sel
            if hasattr(x, "__dataclass_fields__"):
                for f in vars(x).values():
                    walk_any(f, here)

        def walk_any(f, sel):
            if isinstance(f, (list, tuple)):
                for y in f:
                    walk_any(y, sel)
            elif hasattr(f, "__dataclass_fields__"):
                walk(f, sel)
        walk(node)
        return None if star else names

    def query(self, q: A.Query) -> DeviceTable:
        """Execute a full query; returns a DeviceTable whose column names are
        the output names in order."""
        top_level = self._needed_names is None and not self.cte_stack
        if top_level:
            self._needed_names = self._collect_needed_names(q)
        scope = {}
        self.cte_stack.append(scope)
        # the statement-level plan/execute span (this engine plans as it
        # executes): one per top-level statement, CTE recursion rides
        # inside it.
        plan_span = _obs.span("plan") if top_level else _obs.NULL_SPAN
        try:
            with plan_span:
                for name, cq in q.ctes:
                    scope[name.lower()] = self.query(cq)
                out = self.set_expr(q.body)
                if q.order_by:
                    out = self._apply_order_by(out, q.order_by, q.body)
                if q.limit is not None:
                    out = E.limit_table(out, q.limit)
                return out
        finally:
            self.cte_stack.pop()
            # a reused Planner must not prune the next statement's scans
            # with this statement's column set
            if top_level:
                self._needed_names = None

    def _apply_order_by(self, out: DeviceTable, order_by,
                        body=None) -> DeviceTable:
        names = out.column_names
        keys, desc, nl = [], [], []
        ctx = EvalCtx(out)
        # output aliases are directly addressable in ORDER BY
        for n in names:
            ctx.select_aliases[n.lower()] = out[n]
        # ORDER BY may repeat a select-item expression verbatim (e.g.
        # ``order by count(distinct x)``); resolve those positionally instead
        # of re-evaluating an aggregate over the output
        item_keys = {}
        if body is not None and isinstance(body, A.Select) and \
                not any(isinstance(it.expr, A.Star) for it in body.items):
            # (a Star item expands to several output columns, breaking the
            # positional item -> output-name correspondence)
            for i, it in enumerate(body.items):
                if i < len(names):
                    item_keys.setdefault(expr_key(it.expr), names[i])
        for e, d, last in order_by:
            if isinstance(e, A.Literal) and isinstance(e.value, int):
                col = out[names[e.value - 1]]
            elif expr_key(e) in item_keys:
                col = out[item_keys[expr_key(e)]]
            else:
                col = self.eval_expr(e, ctx)
            keys.append(col)
            desc.append(d)
            nl.append(last)
        order = E.lexsort_indices(keys, desc, nl, n_valid=out.nrows)
        return out.take(order, nrows=out.nrows)

    def set_expr(self, body) -> DeviceTable:
        if isinstance(body, A.Query):
            return self.query(body)
        if isinstance(body, A.Select):
            return self.select(body)
        if isinstance(body, A.SetOp):
            left = self.set_expr(body.left)
            right = self.set_expr(body.right)
            if len(left.column_names) != len(right.column_names):
                raise ExecError("set operands have different arity")
            # align by position onto left's names
            right = DeviceTable(
                {ln: right[rn] for ln, rn in zip(left.column_names, right.column_names)},
                right.nrows)
            # unify each positional pair onto one physical kind (a dec(7,2)
            # column and a literal 0 have different representations; blind
            # concatenation would corrupt values)
            lu, ru = {}, {}
            for name in left.column_names:
                (lc, rc), _ = X.unify_columns([left[name], right[name]])
                lu[name], ru[name] = lc, rc
            left = DeviceTable(lu, left.nrows)
            right = DeviceTable(ru, right.nrows)
            if body.op == "union_all":
                return E.concat_tables([left, right])
            if body.op == "union":
                return self._distinct(E.concat_tables([left, right]))
            # intersect / except: null-safe membership of distinct left rows
            ldist = self._distinct(left)
            lkeys = [ldist[n] for n in ldist.column_names]
            rkeys = [right[n] for n in ldist.column_names]
            mask = E.semi_join_mask(lkeys, rkeys, negate=(body.op == "except"),
                                    null_safe=True, n_left=ldist.nrows,
                                    n_right=right.nrows)
            return E.compact_table(ldist, mask)
        raise ExecError(f"unsupported set expression {type(body).__name__}")

    def _distinct(self, t: DeviceTable) -> DeviceTable:
        if E.count_bound(t.nrows) == 0:
            return t
        gids, ng, rep, cap = E.group_ids([t[n] for n in t.column_names],
                                         n_valid=t.nrows)
        return t.take(rep, nrows=ng)

    # ------------------------------------------------------------------ FROM

    def _lookup_table(self, name: str) -> DeviceTable:
        for scope in reversed(self.cte_stack):
            if name.lower() in scope:
                return scope[name.lower()]
        key = name.lower() if name.lower() in self.catalog else name
        if key in self.catalog:
            t = self.catalog[key]
            if key not in self.scanned:
                self.scanned[key] = _table_bytes(t)
            return t
        raise ExecError(f"unknown table {name!r}")

    def _alias_table(self, t: DeviceTable, alias: str) -> DeviceTable:
        if isinstance(t, SH.ShardedTable):
            return SH.ShardedTable([self._alias_table(p, alias)
                                    for p in t.parts], t.mesh, t.spec)
        cols = {}
        for n, c in t.columns.items():
            base = n.split(".")[-1]
            cols[f"{alias.lower()}.{base.lower()}"] = c
        return DeviceTable(cols, t.nrows)

    def plan_from(self, from_) -> DeviceTable:
        """Returns a DeviceTable with alias-qualified columns. Comma-joined
        table lists are returned un-joined as a list for the join-graph
        optimizer in select()."""
        if from_ is None:
            # SELECT without FROM: single virtual row
            return DeviceTable({}, 1, plen=E.bucket_len(1))
        parts, join_preds, sources = self._flatten_from(from_)
        return self._join_parts(parts, join_preds, [], sources)

    def _flatten_from(self, from_, where=None, top=True):
        """Flatten a FROM tree into (leaf tables, explicit-join predicates,
        per-leaf catalog source names). Cross/comma joins AND structured
        INNER joins flatten into the list — an inner ON predicate is
        semantically a WHERE conjunct, and flattening lets the join-graph
        orderer see every equi edge at once (q72's item-only explosion
        disappears once the week_seq WHERE edge joins the same slot pair).
        Outer joins keep their structure, but WHERE conjuncts owned entirely
        by the null-preserving side are consumed from ``where`` (a mutable
        list) and pushed below the join. ``sources[i]`` names the catalog
        table a leaf scans (None for subqueries/materialized joins) — the
        provenance the PK gather-join optimization keys on. ``top`` is
        True only for the SELECT's whole FROM node: the outer-BUILD
        deferral (mechanism b2) is sound only there — a parent join
        around it would filter/extend rows the materialize-time extras
        cannot see."""
        if isinstance(from_, A.TableRef):
            alias = from_.alias or from_.name
            name_l = from_.name.lower()
            # a CTE or temp view shadowing a catalog name is NOT the base
            # table — its rows carry no schema uniqueness guarantees
            in_cte = any(name_l in scope for scope in self.cte_stack)
            is_base = not in_cte and name_l in self.base_tables
            raw = self._lookup_table(from_.name)
            from nds_tpu_torch.engine.table import ChunkedTable
            if isinstance(raw, ChunkedTable):
                # streamed scan: stays host-resident; _join_parts binds
                # device chunks one at a time. Projection pushdown prunes
                # the arrow columns, so only referenced bytes ever upload.
                if self._needed_names is not None:
                    keep = [n for n in raw.column_names
                            if n.lower() in self._needed_names]
                    if keep and len(keep) < len(raw.column_names):
                        raw = raw.select(keep)
                part = _StreamedScan(raw, alias)
                return [part], [], [name_l if is_base else None]
            t = self._alias_table(raw, alias)
            if self._needed_names is not None:
                # projection pushdown: drop scan columns nothing in the
                # statement references (fact tables are 20+ columns wide,
                # queries touch a handful)
                keep = {n for n in t.column_names
                        if n.split(".")[-1] in self._needed_names}
                if keep and len(keep) < len(t.column_names):
                    t = t.select([n for n in t.column_names if n in keep])
            return [t], [], [name_l if is_base else None]
        if isinstance(from_, A.SubqueryRef):
            t = self.query(from_.query)
            return [self._alias_table(t, from_.alias)], [], [None]
        if isinstance(from_, A.Join):
            if from_.kind in ("cross", "inner"):
                lp, lj, ls = self._flatten_from(from_.left, where,
                                                top=False)
                rp, rj, rs = self._flatten_from(from_.right, where,
                                                top=False)
                cond = [h for c in self._split_conjuncts(from_.condition)
                        for h in self._hoist_or_conjuncts(c)]
                return lp + rp, lj + rj + cond, ls + rs
            # outer join: materialize it, pushing WHERE conjuncts owned by
            # the null-preserving side below the join first (for LEFT, a
            # predicate over left columns only commutes with the join) —
            # UNLESS one side binds a >HBM chunked scan and the join fits
            # one of the multi-pass streamed shapes, in which case the
            # join defers INTO the streamed graph (_OuterProbe /
            # _OuterBuild) instead of materializing the chunked side whole
            lp, lj, ls = self._flatten_from(
                from_.left, where if from_.kind == "left" else None,
                top=False)
            conjs = ([h for c in self._split_conjuncts(from_.condition)
                      for h in self._hoist_or_conjuncts(c)]
                     if from_.condition is not None else [])
            l_chunk = any(isinstance(p, _StreamedScan) for p in lp)
            if from_.kind == "left" and l_chunk and conjs:
                # mechanism (b1): chunked scan on the PRESERVED side.
                # Leave WHERE alone — left-side filters push down inside
                # the streamed graph; conjuncts over probe columns apply
                # after the per-chunk gather (_join_parts_outer).
                rp, rj, rs = self._flatten_from(from_.right, top=False)
                if self._probe_eligible(conjs, lp, rp, rj, rs):
                    return (lp + [_OuterProbe(rp[0], from_.condition,
                                              conjs, rs[0])],
                            lj, ls + [rs[0]])
                # ineligible after flattening: today's materialize path,
                # reusing the already-flattened right side
                lw = self._consume_pushable(where, lp)
                left = self._join_parts(lp, lj, lw, ls)
                right = self._join_parts(rp, rj, [], rs)
                right_src = rs[0] if len(rs) == 1 else None
                joined = self._binary_join(left, right, from_.kind,
                                           from_.condition,
                                           right_src=right_src)
                return [joined], [], [None]
            lw = self._consume_pushable(where, lp) \
                if from_.kind == "left" else []
            left = self._join_parts(lp, lj, lw, ls)
            rp, rj, rs = self._flatten_from(
                from_.right, where if from_.kind == "right" else None,
                top=False)
            if from_.kind == "left" and top and conjs and \
                    self._build_eligible(conjs, lp, rp, rj, where):
                # mechanism (b2): chunked scan on the NULL-INTRODUCING
                # side — the materialized left side becomes the BUILD
                # operand of the streamed graph; extras emit at
                # materialize time from the unmatched-key accumulator
                build_src = ls[0] if len(ls) == 1 else None
                return ([rp[0], _OuterBuild(left, from_.condition, conjs,
                                            build_src)],
                        [], [rs[0], None])
            rw = self._consume_pushable(where, rp) \
                if from_.kind == "right" else []
            right = self._join_parts(rp, rj, rw, rs)
            # single-leaf scan provenance survives filtering (uniqueness is
            # key-set property, not row-set) — _binary_join uses it to turn
            # LEFT joins on a declared (composite) PK into gathers
            right_src = rs[0] if len(rs) == 1 else None
            joined = self._binary_join(left, right, from_.kind,
                                       from_.condition, right_src=right_src)
            return [joined], [], [None]
        raise ExecError(f"unsupported FROM clause {type(from_).__name__}")

    def _probe_eligible(self, conjs, lp, rp, rj, rs) -> bool:
        """Mechanism (b1) shape test: the right side must be one pristine
        device scan whose ON keys are exactly its declared (composite)
        primary key, every ON conjunct a plain cross-side equi pair — the
        shape the per-chunk gather serves with zero steady-state syncs
        (composite keys must be numeric to pack, mirroring
        ``_pk_gather_plan``). Mirrored by ``exec_audit._deferred_left``."""
        from nds_tpu_torch.schema import COMPOSITE_PRIMARY_KEYS, PRIMARY_KEYS
        if len(rp) != 1 or rj or not rs or rs[0] is None or \
                not isinstance(rp[0], DeviceTable):
            return False
        lcols = set()
        for p in lp:
            lcols |= set(p.column_names)
        rcols = set(rp[0].column_names)
        rkeys = []
        for c in conjs:
            if self._has_subquery(c):
                return False
            pair = self._equi_pair(c, lcols, rcols)
            if pair is None:
                return False
            rkeys.append(pair[1])
        pk = COMPOSITE_PRIMARY_KEYS.get(rs[0])
        if pk is None and rs[0] in PRIMARY_KEYS:
            pk = (PRIMARY_KEYS[rs[0]],)
        if pk is None or {k.split(".")[-1] for k in rkeys} != set(pk):
            return False
        if len(pk) > 1 and any(
                rp[0][k].kind in ("str", "f64") or
                rp[0][k].kind.startswith("dec") for k in rkeys):
            return False                 # composite pack is int-only
        return True

    def _build_eligible(self, conjs, lp, rp, rj, where) -> bool:
        """Mechanism (b2) shape test: single chunked scan on the right,
        single device part on the left (the build side), plain equi ON,
        and NO remaining WHERE conjunct at all — post-join structure
        (including a ref-less ``1 = 0``) would need the extras (emitted
        only at materialize) to flow through it. The caller additionally
        requires the join to be the SELECT's whole FROM (``top``): a
        parent join would wrap the deferral the same way. Mirrored by
        ``exec_audit._deferred_left``."""
        if len(rp) != 1 or rj or not isinstance(rp[0], _StreamedScan):
            return False
        if len(lp) != 1 or any(isinstance(p, (_StreamedScan, _OuterProbe,
                                              _OuterBuild)) for p in lp):
            return False
        if where:
            return False
        lcols = set(lp[0].column_names)
        rcols = set(rp[0].column_names)
        for c in conjs:
            if self._has_subquery(c) or \
                    self._equi_pair(c, lcols, rcols) is None:
                return False
        return True

    def _refs_touch(self, e, cols) -> bool:
        """True when any column reference of ``e`` resolves in ``cols``.
        Subquery-bearing expressions always touch (their inner scopes are
        not walked, so the conservative answer keeps them post-join —
        WHERE semantics make post-join evaluation always correct)."""
        if self._has_subquery(e):
            return True
        return any(self._resolve_name(r, cols) is not None
                   for r in self._column_refs(e))

    def _consume_pushable(self, where, parts):
        """Remove and return the conjuncts of ``where`` (in place) whose
        every column reference resolves within ``parts`` and which carry no
        subquery — the set safe to evaluate below an outer join on the
        null-preserving side."""
        if not where:
            return []
        cols = set()
        for p in parts:
            cols |= set(p.column_names)
        taken = []
        for c in list(where):
            if self._has_subquery(c):
                continue
            if self._refs_resolve_in(c, cols):
                taken.append(c)
                where.remove(c)
        return taken

    def _refs_resolve_in(self, e, cols) -> bool:
        """True when the expression references at least one column and every
        column it references resolves within ``cols``."""
        refs = []
        ok = True

        def walk(node):
            nonlocal ok
            if isinstance(node, A.ColumnRef):
                refs.append(node)
                if self._resolve_name(node, cols) is None:
                    ok = False
            for ch in self._child_exprs(node):
                walk(ch)
        walk(e)
        return ok and bool(refs)

    # -------------------------------------------------------- join machinery

    def _split_conjuncts(self, e):
        if isinstance(e, A.BinaryOp) and e.op == "and":
            return self._split_conjuncts(e.left) + self._split_conjuncts(e.right)
        return [e] if e is not None else []

    def _split_disjuncts(self, e):
        if isinstance(e, A.BinaryOp) and e.op == "or":
            return self._split_disjuncts(e.left) + self._split_disjuncts(e.right)
        return [e]

    @staticmethod
    def _fold_bool(op: str, exprs):
        out = exprs[0]
        for e in exprs[1:]:
            out = A.BinaryOp(op, out, e)
        return out

    def _hoist_or_conjuncts(self, e):
        """Factor conjuncts common to every disjunct out of an OR:
        ``(A and X) or (A and Y)`` → ``[A, (X or Y)]``. The TPC-DS corpus
        (q13/q48/q85) hides its equi-join keys this way; without hoisting the
        join planner would fall back to a cartesian against the 1.9M-row
        customer_demographics dimension."""
        if not (isinstance(e, A.BinaryOp) and e.op == "or"):
            return [e]
        conj_lists = [self._split_conjuncts(d) for d in self._split_disjuncts(e)]
        common = [c for c in conj_lists[0]
                  if all(any(c == d for d in dl) for dl in conj_lists[1:])]
        if not common:
            return [e]
        rests = []
        for dl in conj_lists:
            rest = [c for c in dl if not any(c == cm for cm in common)]
            if not rest:
                # one disjunct is exactly the common set: OR degenerates
                return common
            rests.append(self._fold_bool("and", rest))
        return common + [self._fold_bool("or", rests)]

    @staticmethod
    def _child_exprs(node):
        """Direct A.Expr children of an AST node (the shared recursion step
        of every expression walker: dataclass fields that are expressions,
        lists of expressions, or lists of tuples containing expressions)."""
        if not hasattr(node, "__dataclass_fields__"):
            return
        for f in vars(node).values():
            if isinstance(f, A.Expr):
                yield f
            elif isinstance(f, list):
                for x in f:
                    if isinstance(x, A.Expr):
                        yield x
                    elif isinstance(x, tuple):
                        for y in x:
                            if isinstance(y, A.Expr):
                                yield y

    def _expr_tables(self, e, available: set) -> set:
        """Set of alias-qualified table names an expression references."""
        out = set()

        def walk(node):
            if isinstance(node, A.ColumnRef):
                key = self._resolve_name(node, available)
                if key is not None:
                    out.add(key.split(".")[0])
            for c in self._child_exprs(node):
                walk(c)
        walk(e)
        return out

    def _resolve_name(self, ref: A.ColumnRef, colnames) -> str | None:
        name = ref.name.lower()
        if ref.table:
            key = f"{ref.table.lower()}.{name}"
            return key if key in colnames else None
        matches = [c for c in colnames if c.split(".")[-1] == name]
        if len(matches) == 1:
            return matches[0]
        if len(matches) > 1:
            # ambiguous unqualified ref: SQL would error; the corpus relies on
            # it only when all candidates are join-equal, pick the first
            return matches[0]
        return None

    def _binary_join(self, left: DeviceTable, right: DeviceTable, kind: str,
                     condition, right_src: str | None = None) -> DeviceTable:
        conjuncts = [h for c in self._split_conjuncts(condition)
                     for h in self._hoist_or_conjuncts(c)]
        lcols, rcols = set(left.column_names), set(right.column_names)
        equi, lkeys, rkeys, residual = [], [], [], []
        all_plain = True
        for c in conjuncts:
            pair = self._equi_pair(c, lcols, rcols)
            if pair:
                equi.append(pair)
                lkeys.append(left[pair[0]])
                rkeys.append(right[pair[1]])
                continue
            keypair = self._equi_key_cols(c, left, right)
            if keypair:
                # expression equi-key (e.g. cast(col as date) = d_date):
                # evaluate each side against its input as a synthetic key
                all_plain = False
                lkeys.append(keypair[0])
                rkeys.append(keypair[1])
                continue
            residual.append(c)
        if kind in ("semi", "anti"):
            if not lkeys:
                raise ExecError("semi/anti join requires equi condition")
            if residual:
                # a left row matches only if some equi-matching right row also
                # satisfies the residual conjuncts
                l_idx, r_idx, n_pairs, _, _, _, _ = E.join_indices(
                    lkeys, rkeys, "inner",
                    n_left=left.nrows, n_right=right.nrows)
                pairs = DeviceTable(
                    {**E.gather_table_rows(left, l_idx, n_pairs).columns,
                     **E.gather_table_rows(right, r_idx, n_pairs).columns},
                    n_pairs)
                ok = self._conjunct_mask(pairs, residual)
                ok = ok & E.live_mask(pairs.plen, pairs.nrows)
                safe = torch.where(ok, l_idx, left.plen)
                matched = prim.scatter_set(torch.zeros(
                    left.plen, dtype=torch.bool, device=l_idx.device),
                    safe, True)
            else:
                matched = E.semi_join_mask(lkeys, rkeys, n_left=left.nrows,
                                           n_right=right.nrows)
            mask = ~matched if kind == "anti" else matched
            return E.compact_table(left, mask)
        if not lkeys:
            # pure cartesian with optional residual filter
            out = self._cartesian(left, right)
            if residual:
                out = self._filter_conjuncts(out, residual)
            if kind != "inner":
                raise ExecError("non-equi outer joins unsupported")
            return out
        if not residual and all_plain:
            l_on = [l for l, _ in equi]
            r_on = [r for _, r in equi]
            if kind == "left" and right_src:
                # LEFT join on the right side's declared (composite) PK:
                # at most one match per probe row, so gather right columns
                # onto the left's unchanged physical rows and null-extend
                # misses — no pair machinery, no syncs (q78-class
                # sales x returns joins). Uniqueness is a schema fact.
                from nds_tpu_torch.schema import (COMPOSITE_PRIMARY_KEYS,
                                            PRIMARY_KEYS)
                pk = COMPOSITE_PRIMARY_KEYS.get(right_src)
                if pk is None and right_src in PRIMARY_KEYS:
                    pk = (PRIMARY_KEYS[right_src],)
                bare = {r.split(".")[-1] for r in r_on}
                if pk is not None and bare == set(pk):
                    got = E.pk_gather_join_multi(
                        [left[n] for n in l_on], [right[n] for n in r_on],
                        left.nrows, right.nrows)
                    if got is not None:
                        r_idx, matched = got
                        cols = dict(left.columns)
                        rg = E.gather_table_rows(right, r_idx, left.nrows)
                        for n, c in rg.columns.items():
                            cols[n] = Column(c.kind, c.data,
                                             c.valid_mask() & matched,
                                             c.dict_values, c.enc)
                        return DeviceTable(cols, left.nrows, plen=left.plen)
            return E.join_tables(left, right, l_on, r_on, kind)
        # join with residual and/or expression keys: match pairs on the key
        # columns, filter by the residual conjuncts, then rebuild outer rows
        l_idx, r_idx, n_pairs, _, _, _, _ = E.join_indices(
            lkeys, rkeys, "inner", n_left=left.nrows, n_right=right.nrows)
        pairs = DeviceTable(
            {**E.gather_table_rows(left, l_idx, n_pairs).columns,
             **E.gather_table_rows(right, r_idx, n_pairs).columns}, n_pairs)
        keep_mask = self._conjunct_mask(pairs, residual)
        keep_mask = keep_mask & E.live_mask(pairs.plen, pairs.nrows)
        matched = E.compact_table(pairs, keep_mask)
        if kind == "inner":
            return matched
        out_parts = [matched]
        miss = miss_r = None
        if kind in ("left", "full"):
            safe_l = torch.where(keep_mask, l_idx, left.plen)
            lmask = prim.scatter_set(torch.zeros(
                left.plen, dtype=torch.bool, device=l_idx.device),
                safe_l, True)
            miss = ~lmask & E.live_mask(left.plen, left.nrows)
            nd_lx = E.DeviceCount(miss.sum(), E.count_bound(left.nrows))
        if kind in ("right", "full"):
            safe_r = torch.where(keep_mask, r_idx, right.plen)
            rmask = prim.scatter_set(torch.zeros(
                right.plen, dtype=torch.bool, device=r_idx.device),
                safe_r, True)
            miss_r = ~rmask & E.live_mask(right.plen, right.nrows)
            nd_rx = E.DeviceCount(miss_r.sum(),
                                  E.count_bound(right.nrows))
        # both extra counts resolve in one batched transfer (one sync)
        if miss is not None:
            n_lx = nd_lx.to_int()
            if n_lx:
                lx = E.compact_indices(miss, n_lx)
                cols = {n: c.take(lx) for n, c in left.columns.items()}
                cols.update({n: E._null_column_like(c, int(lx.shape[0]))
                             for n, c in right.columns.items()})
                out_parts.append(DeviceTable(cols, n_lx))
        if miss_r is not None:
            n_rx = nd_rx.to_int()
            if n_rx:
                rx = E.compact_indices(miss_r, n_rx)
                cols = {n: E._null_column_like(c, int(rx.shape[0]))
                        for n, c in left.columns.items()}
                cols.update({n: c.take(rx) for n, c in right.columns.items()})
                out_parts.append(DeviceTable(cols, n_rx))
        return E.concat_tables(out_parts) if len(out_parts) > 1 else out_parts[0]

    def _pk_gather_plan(self, tables, sources, a, b, es):
        """Eligibility of the (a, b) edge batch for a PK gather join.

        Requires the edge batch's dimension-side key set to be exactly the
        declared primary key — single-column (any surrogate kind) or
        composite (integer kinds; packed into one probe key) — of a still-
        pristine base-table scan (``sources`` survives deferred filters and
        earlier gather joins, which never change a slot's physical rows).
        Uniqueness is a schema fact, so no runtime check or sync is needed.
        Returns ``(fact_slot, dim_slot, [fact_keys], [dim_keys])`` or
        None."""
        from nds_tpu_torch.schema import COMPOSITE_PRIMARY_KEYS, PRIMARY_KEYS
        pairs = [((lk, rk) if sl == a else (rk, lk)) for (sl, sr, lk, rk)
                 in es]
        for fact_slot, dim_slot, idx in ((a, b, 1), (b, a, 0)):
            src = sources[dim_slot]
            if not src:
                continue
            dks = [p[idx] for p in pairs]
            fks = [p[1 - idx] for p in pairs]
            bare = {d.split(".")[-1] for d in dks}
            if len(es) == 1 and bare == {PRIMARY_KEYS.get(src)}:
                pass                           # single-column PK
            elif bare == set(COMPOSITE_PRIMARY_KEYS.get(src, ())):
                pass                           # composite PK (full cover)
            else:
                continue
            ok = True
            for fk, dk in zip(fks, dks):
                fkc = SH.column_meta(tables[fact_slot], fk)
                dkc = SH.column_meta(tables[dim_slot], dk)
                if fkc.kind == "f64" or dkc.kind == "f64":
                    ok = False                 # surrogate keys only
                if (fkc.kind == "str") != (dkc.kind == "str"):
                    ok = False
                if len(es) > 1 and (fkc.kind == "str" or dkc.kind == "str"):
                    ok = False                 # composite pack is int-only
            if ok:
                return fact_slot, dim_slot, fks, dks
        return None

    def _equi_pair(self, c, lcols, rcols):
        if isinstance(c, A.BinaryOp) and c.op == "=" and \
                isinstance(c.left, A.ColumnRef) and isinstance(c.right, A.ColumnRef):
            lk = self._resolve_name(c.left, lcols)
            rk = self._resolve_name(c.right, rcols)
            if lk and rk:
                return (lk, rk)
            lk2 = self._resolve_name(c.right, lcols)
            rk2 = self._resolve_name(c.left, rcols)
            if lk2 and rk2:
                return (lk2, rk2)
        return None

    def _has_subquery(self, e) -> bool:
        found = False

        def walk(node):
            nonlocal found
            if isinstance(node, (A.ScalarSubquery, A.InSubquery, A.Exists)):
                found = True
                return
            if getattr(node, "query", None) is not None and \
                    isinstance(getattr(node, "query"), A.Query):
                found = True
                return
            for c in self._child_exprs(node):
                walk(c)
        walk(e)
        return found

    def _column_refs(self, e):
        out = []

        def walk(node):
            if isinstance(node, A.ColumnRef):
                out.append(node)
            for c in self._child_exprs(node):
                walk(c)
        walk(e)
        return out

    def _synthetic_edge(self, c, parts, part_cols):
        """Edge for an ``expr = expr`` conjunct whose sides each reference
        exactly one (distinct) part: materialize both expressions as
        synthetic key columns on their parts and return the edge tuple.
        The flattened-join twin of :func:`_equi_key_cols`."""
        def side_owner(e):
            refs = self._column_refs(e)
            if not refs:
                return None
            owner = None
            for r in refs:
                cands = [i for i, pc in enumerate(part_cols)
                         if self._resolve_name(r, pc) is not None]
                if len(cands) != 1:
                    return None
                if owner is None:
                    owner = cands[0]
                elif owner != cands[0]:
                    return None
            return owner

        lo_, ro_ = side_owner(c.left), side_owner(c.right)
        if lo_ is None or ro_ is None or lo_ == ro_:
            return None
        try:
            lcol = self.eval_expr(c.left, EvalCtx(parts[lo_]))
            rcol = self.eval_expr(c.right, EvalCtx(parts[ro_]))
        except Exception:
            return None                   # stays residual, as before
        n = self._synth_keys
        self._synth_keys += 1
        ln, rn = f"__jk{n}_l", f"__jk{n}_r"
        parts[lo_] = DeviceTable({**parts[lo_].columns, ln: lcol},
                                 parts[lo_].nrows, plen=parts[lo_].plen)
        part_cols[lo_].add(ln)
        parts[ro_] = DeviceTable({**parts[ro_].columns, rn: rcol},
                                 parts[ro_].nrows, plen=parts[ro_].plen)
        part_cols[ro_].add(rn)
        return (lo_, ro_, ln, rn)

    def _equi_key_cols(self, c, left: DeviceTable, right: DeviceTable):
        """(left key Column, right key Column) for an ``expr = expr`` conjunct
        whose sides each reference exactly one join input (e.g.
        ``cast(purc_purchase_date as date) = d_date``); None otherwise."""
        if not (isinstance(c, A.BinaryOp) and c.op == "="):
            return None
        lcols, rcols = set(left.column_names), set(right.column_names)
        for a, b, ltab, rtab in ((c.left, c.right, left, right),
                                 (c.right, c.left, left, right)):
            arefs = self._column_refs(a)
            brefs = self._column_refs(b)
            if not arefs or not brefs:
                continue
            if all(self._resolve_name(r, lcols) for r in arefs) and \
                    all(self._resolve_name(r, rcols) for r in brefs):
                return (self.eval_expr(a, EvalCtx(ltab)),
                        self.eval_expr(b, EvalCtx(rtab)))
        return None

    def _cartesian(self, left: DeviceTable, right: DeviceTable) -> DeviceTable:
        pl, pr = left.plen, right.plen
        # the physical expansion is pl x pr either way; host counts lay out
        # the live prefix (both sides resolve in one batched transfer)
        nl, nr = E.count_int(left.nrows), E.count_int(right.nrows)
        total = nl * nr
        if pl == 0 or pr == 0 or total == 0:
            cols = {n: E._null_column_like(c, E.bucket_len(0))
                    for t in (left, right) for n, c in t.columns.items()}
            return DeviceTable(cols, 0)
        dev = E.device()
        li = torch.arange(pl, device=dev).repeat_interleave(pr)
        ri = torch.arange(pr, device=dev).repeat(pl)
        live = (li < nl) & (ri < nr)
        # logical count is known on host: compact to bucket with no sync
        idx = prim.nonzero_sized(live, E.bucket_len(total), pl * pr)
        li = prim.take_fill(li, idx, pl)
        ri = prim.take_fill(ri, idx, pr)
        return DeviceTable(
            {**E.gather_table_rows(left, li, total).columns,
             **E.gather_table_rows(right, ri, total).columns}, total)

    def _conjunct_mask_eager(self, table: DeviceTable, conjuncts) -> torch.Tensor:
        ctx = EvalCtx(table)
        mask = torch.ones(table.plen, dtype=torch.bool, device=E.device())
        for c in conjuncts:
            col = self.eval_expr(c, ctx)
            mask = mask & col.data.to(torch.bool) & col.valid_mask()
        return mask

    def _conjunct_mask(self, table: DeviceTable, conjuncts) -> torch.Tensor:
        """Predicate mask over a plain table: every conjunct evaluated
        directly (torch runs eagerly; there is no fused program to build)."""
        return self._conjunct_mask_eager(table, conjuncts)

    def _has_window(self, e) -> bool:
        found = False

        def walk(node):
            nonlocal found
            if isinstance(node, A.WindowFunc):
                found = True
                return
            for c in self._child_exprs(node):
                walk(c)
        walk(e)
        return found

    def _filter_conjuncts(self, table: DeviceTable, conjuncts) -> DeviceTable:
        if not conjuncts:
            return table
        return E.compact_table(table, self._conjunct_mask(table, conjuncts))

    def _stream_join_parts(self, parts, join_preds, where_conjuncts,
                           sources):
        """Streamed execution of a join graph containing streamed scans: bind
        the largest streamed part's device chunks one at a time and run
        the join graph per chunk (pushed-down filters and joins shrink the
        chunk before anything is kept), keeping the survivor union.
        Downstream aggregation runs on the union, which is correct because
        joins and filters distribute over row-wise union. Other streamed
        parts materialize whole (one streaming axis per graph).

        Default path: the chunk pipeline (engine/stream.py) — one recorded
        per-chunk program replayed over every padded chunk with prefetch,
        on-device survivor accumulation and a single materializing sync.
        The per-chunk eager loop below is the automatic fallback for
        graphs that are not chunk-invariant and the ``stream_exec =
        "eager"`` setting."""
        streamed = [i for i, p in enumerate(parts)
                    if isinstance(p, _StreamedScan)]
        keep = max(streamed, key=lambda i: parts[i].nbytes)
        parts = list(parts)
        for i in streamed:
            if i != keep:
                parts[i] = parts[i].bind_whole(self)
        # the span opens exactly where the StreamEvent sync window opens,
        # so its sync delta equals the event's
        with _obs.span("stream", table=parts[keep].alias):
            syncs0 = E.sync_count()
            reason = None
            if str(E.setting("stream_exec")).lower() != "eager":
                from nds_tpu_torch.engine.stream import stream_execute
                got, reason = stream_execute(self, parts, keep, join_preds,
                                             where_conjuncts, list(sources))
                if got is not None:
                    return got
            else:
                reason = "stream_exec=eager"
            outs = []
            n_chunks = 0
            h2d = 0
            # a bound-bucket overflow discards a COMPLETED pipeline run: the
            # rerun gets its own span name, apart from ordinary eager
            # fallbacks (which never drove the pipeline at all)
            eager_span = "stream.overflow-rerun" \
                if reason == "bound-bucket overflow" else "stream.eager"
            builds = [p for p in parts if isinstance(p, _OuterBuild)]
            bitmaps = None
            # the eager loop pulls its chunks through the same bounded
            # prefetch ring the pipeline uses (engine/prefetch): the arrow
            # slice + device conversion of chunk k+1 runs on the worker
            # while chunk k's join graph executes here; depth 0 is the
            # inline loop, bit for bit. The ring closes in the finally so
            # a mid-loop planner exception never leaks the worker thread.
            from nds_tpu_torch.engine.prefetch import chunk_ring
            ring = chunk_ring(parts[keep].device_chunks(self),
                              name="nds-prefetch-eager")
            with _obs.span(eager_span,
                           reason=reason or "replay-nested"):
                try:
                    while True:
                        chunk = ring.next_chunk()
                        if chunk is None:
                            break
                        n_chunks += 1
                        # actual prefetch bytes of this scan (buffer
                        # metadata, no sync): the eager loop uploads
                        # unencoded chunks
                        h2d += sum(
                            c.data.nbytes
                            + (0 if c.valid is None else c.valid.nbytes)
                            for c in chunk.columns.values())
                        sub = list(parts)
                        sub[keep] = chunk
                        with E.outer_match_collector() as omc:
                            out = self._join_parts(sub, join_preds,
                                                   where_conjuncts,
                                                   list(sources))
                        if builds:
                            # OR each chunk's matched-build-row masks:
                            # the outer extras (unmatched across EVERY
                            # chunk) append once, after the loop
                            bitmaps = list(omc.masks) if bitmaps is None \
                                else [a | b for a, b in zip(bitmaps,
                                                            omc.masks)]
                        if E.count_bound(out.nrows) or not outs:
                            outs.append(out)
                    stall_ms = ring.stall_ms()
                finally:
                    ring.close()
                result = E.concat_tables(outs) if len(outs) > 1 else outs[0]
                if builds and bitmaps is not None:
                    result = self._append_outer_extras(result, builds,
                                                       bitmaps)
            if reason is not None:
                # recorded AFTER the loop: the event's syncs charge the whole
                # eager path (failed record attempt + per-chunk loop). reason
                # None = replay-nested fallback, accounted by the outer pass.
                from nds_tpu_torch.listener import record_stream_event
                record_stream_event(parts[keep].alias, n_chunks,
                                    E.sync_count() - syncs0, "eager", reason,
                                    bytes_h2d=h2d,
                                    prefetch_stall_ms=stall_ms)
                _obs.annotate(path="eager", chunks=n_chunks, reason=reason,
                              bytesH2d=h2d, prefetchStallMs=stall_ms)
            return result

    def _append_outer_extras(self, result, builds, bitmaps):
        """Eager-loop twin of the pipeline's materialize-time extras:
        null-extended unmatched build rows of every deferred outer-build
        join, appended once after the chunk union."""
        parts = [result]
        for w, bm in zip(builds, bitmaps):
            miss = ~bm & E.live_mask(w.table.plen, w.table.nrows)
            n_miss = E.host_sync(miss.sum())
            if not n_miss:
                continue
            idx = E.compact_indices(miss, n_miss)
            parts.append(outer_extras_table(w.table, idx, n_miss, result))
        return E.concat_tables(parts) if len(parts) > 1 else result

    def _join_parts_outer(self, parts, join_preds, where_conjuncts,
                          sources, outer_idx):
        """One multi-pass outer-join step: runs per chunk inside the
        streamed pipeline (the chunk slot is a bound DeviceTable here) and
        per chunk on the eager loop. Joins the parts connected to the
        chunk side by outer-free conjuncts first, applies each deferred
        LEFT join, then joins any leftover parts/conjuncts that needed
        the probe columns (q93: ``reason`` joins the returns side of the
        gather). WHERE semantics make the post split always correct —
        deferring a conjunct past the outer join only delays a filter."""
        wrappers = [parts[i] for i in outer_idx]
        inner = [p for i, p in enumerate(parts) if i not in outer_idx]
        inner_src = [s for i, s in enumerate(sources) if i not in outer_idx]
        outer_cols = set()
        for w in wrappers:
            outer_cols |= set(w.column_names)
        conjuncts = list(join_preds) + list(where_conjuncts)
        post = [c for c in conjuncts if self._refs_touch(c, outer_cols)]
        pre = [c for c in conjuncts if not any(c is x for x in post)]
        # union-find the inner parts along pre-conjunct ownership; the
        # components providing the wrappers' ON columns join BEFORE the
        # deferred joins, everything else after
        groups = list(range(len(inner)))

        def find(i):
            while groups[i] != i:
                groups[i] = groups[groups[i]]
                i = groups[i]
            return i

        part_colsets = [set(p.column_names) for p in inner]

        def owners_of(e):
            return [i for i, cs in enumerate(part_colsets)
                    if self._refs_touch(e, cs)]

        for c in pre:
            own = owners_of(c)
            for o in own[1:]:
                groups[find(own[0])] = find(o)
        anchors = set()
        for w in wrappers:
            for c in w.conjuncts:
                for o in owners_of(c):
                    anchors.add(find(o))
        if not anchors and inner:
            anchors = {find(0)}
        pre_idx = [i for i in range(len(inner)) if find(i) in anchors]
        post_idx = [i for i in range(len(inner)) if find(i) not in anchors]
        pre_set = set(pre_idx)
        pre_here = [c for c in pre
                    if set(owners_of(c)) <= pre_set]
        leftover = [c for c in conjuncts
                    if not any(c is x for x in pre_here)]
        out = self._join_parts(
            [inner[i] for i in pre_idx],
            [c for c in join_preds if any(c is x for x in pre_here)],
            [c for c in where_conjuncts if any(c is x for x in pre_here)],
            [inner_src[i] for i in pre_idx])
        for w in wrappers:
            out = self._apply_outer(out, w)
        if post_idx or leftover:
            out = self._join_parts(
                [out] + [inner[i] for i in post_idx], [], leftover,
                [None] + [inner_src[i] for i in post_idx])
        return out

    def _apply_outer(self, left: DeviceTable, w) -> DeviceTable:
        """Apply one deferred LEFT join to a (per-chunk) joined table."""
        if isinstance(w, _OuterProbe):
            # preserved chunk side: PK gather against the whole probe
            # table — sync-free, keeps the chunk's physical rows, misses
            # null-extend in place (_binary_join's gather arm)
            return self._binary_join(left, w.table, "left", w.condition,
                                     right_src=w.src)
        # _OuterBuild: build ⟕ chunk — emit THIS dispatch's matched pairs
        # through an inner bound-bucket join and register the matched
        # build rows; the unmatched build rows (the outer extras) emit
        # ONCE at materialize time from the OR of every dispatch's mask
        build = w.table
        lcols = set(left.column_names)
        bcols = set(build.column_names)
        lkeys, bkeys = [], []
        for c in w.conjuncts:
            pair = self._equi_pair(c, lcols, bcols)
            if pair is None:
                raise ExecError("outer-build join requires plain equi keys")
            lkeys.append(left[pair[0]])
            bkeys.append(build[pair[1]])
        # probe FROM the chunk side: the pair bucket stays chunk-sized
        l_idx, r_idx, n_pairs, _, _, _, _ = E.join_indices(
            lkeys, bkeys, "inner", n_left=left.nrows, n_right=build.nrows)
        matched = prim.scatter_set(torch.zeros(
            build.plen, dtype=torch.bool, device=r_idx.device), r_idx, True)
        E.stream_outer_matched(matched)
        cols = dict(E.gather_table_rows(build, r_idx, n_pairs).columns)
        for n, c in E.gather_table_rows(left, l_idx, n_pairs).columns.items():
            # chunk-side columns must be NULLABLE in the output template:
            # the extras rows null-extend them at materialize time
            cols.setdefault(n, Column(c.kind, c.data, c.valid_mask(),
                                      c.dict_values, c.enc))
        return DeviceTable(cols, n_pairs)

    def _join_parts(self, parts, join_preds, where_conjuncts, sources=None):
        """Join-graph execution: push single-table predicates down, then join
        parts connected by equi edges, deferring unconnected parts
        (cartesian only as a last resort). ``sources`` carries each part's
        catalog table name (None otherwise) so single-key joins against a
        declared dimension primary key run as exact merge-probe gathers
        with a deferred miss-mask — no host sync, no pair expansion — the
        star-join shape that dominates the TPC-DS corpus."""
        if sources is None:
            sources = [None] * len(parts)
        if any(isinstance(p, _StreamedScan) for p in parts):
            return self._stream_join_parts(parts, join_preds,
                                           where_conjuncts, sources)
        outer_idx = [i for i, p in enumerate(parts)
                     if isinstance(p, (_OuterProbe, _OuterBuild))]
        if outer_idx:
            return self._join_parts_outer(parts, join_preds, where_conjuncts,
                                          sources, outer_idx)
        sources = list(sources)
        conjuncts = list(join_preds) + list(where_conjuncts)
        # split into single-table filters / equi edges / complex residual
        all_cols = set()
        for p in parts:
            all_cols |= set(p.column_names)
        filters_per_part = [[] for _ in parts]
        edges = []      # (li, ri, lcol, rcol)
        residual = []
        part_cols = [set(p.column_names) for p in parts]

        def owner(colkey):
            for i, pc in enumerate(part_cols):
                if colkey in pc:
                    return i
            return None

        for c in conjuncts:
            if self._has_subquery(c):
                # a correlated subquery may reference columns of OTHER parts
                # (q32: cs_item_sk = i_item_sk inside the scalar subquery);
                # only the fully joined row has every correlation column in
                # scope, so never push these down
                residual.append(c)
                continue
            tables = self._expr_tables(c, all_cols)
            owners = set()
            for p_i, pc in enumerate(part_cols):
                for t in tables:
                    if any(cc.startswith(t + ".") for cc in pc):
                        owners.add(p_i)
            if len(owners) == 1:
                filters_per_part[owners.pop()].append(c)
                continue
            pair = None
            if isinstance(c, A.BinaryOp) and c.op == "=" and \
                    isinstance(c.left, A.ColumnRef) and isinstance(c.right, A.ColumnRef):
                lk = self._resolve_name(c.left, all_cols)
                rk = self._resolve_name(c.right, all_cols)
                if lk and rk:
                    li, ri = owner(lk), owner(rk)
                    if li is not None and ri is not None and li != ri:
                        pair = (li, ri, lk, rk)
            if pair is None and isinstance(c, A.BinaryOp) and c.op == "=" \
                    and len(owners) == 2:
                # expression equi edge (``cast(a.x as date) = b.d + 1``):
                # when each side's references live wholly in one part,
                # materialize synthetic key columns and join on those —
                # without this a flattened inner join whose only equi
                # condition is an expression degrades to a cartesian
                pair = self._synthetic_edge(c, parts, part_cols)
            if pair:
                edges.append(pair)
            else:
                residual.append(c)

        # deferred filter materialization: keep each part's pushed-down
        # predicate as a boolean mask and fold it into its first equi-join
        # (filtered rows hash as unmatchable), skipping one compaction sync
        # and a full-width gather per filtered part. Big parts compact
        # up front instead so join sorts don't run at raw-table width.
        masks = []
        tables = list(parts)
        for i, (p, f) in enumerate(zip(parts, filters_per_part)):
            if not f:
                masks.append(None)
            elif SH.is_row(p):
                # a row-sharded part filters and compacts shard by shard
                # (it never carries a deferred mask)
                tables[i] = SH.per_shard(
                    p, lambda _i, t, f=f: self._filter_conjuncts(t, f))
                masks.append(None)
            elif p.plen > DEFER_FILTER_MAX_ROWS:
                tables[i] = self._filter_conjuncts(p, f)
                masks.append(None)
            else:
                masks.append(~self._conjunct_mask(p, f))

        # iteratively merge parts along equi edges
        groups = list(range(len(parts)))  # part index -> current table slot

        def slot(i):
            while groups[i] != i:
                i = groups[i]
            return i

        pending = list(edges)
        while pending:
            # gather every edge connecting the same two slots in one join
            by_slots = {}
            for (li, ri, lk, rk) in pending:
                sl, sr = slot(li), slot(ri)
                if sl == sr:
                    continue
                by_slots.setdefault(tuple(sorted((sl, sr))), []).append((sl, sr, lk, rk))
            if not by_slots:
                break
            # order heuristic: take PK gather edges first — they never
            # pair-expand, and their miss-masks shrink every later hash
            # join's candidate set (q72-class fact x fact joins explode
            # when run before the dimension predicates mask the facts)
            (a, b), es, gather = next(
                ((pair, pes, plan) for pair, pes in by_slots.items()
                 if (plan := self._pk_gather_plan(
                     tables, sources, pair[0], pair[1], pes)) is not None),
                (*next(iter(by_slots.items())), None))
            got = None
            if gather is not None:
                fact_slot, dim_slot, fk_names, dk_names = gather
                fact_t, dim_t = tables[fact_slot], tables[dim_slot]
                if SH.is_row(fact_t):
                    got = SH.pk_gather_join(fact_t, dim_t, fk_names,
                                            dk_names, d_excl=masks[dim_slot])
                else:
                    got = E.pk_gather_join_multi(
                        [fact_t[n] for n in fk_names],
                        [dim_t[n] for n in dk_names],
                        fact_t.nrows, dim_t.nrows,
                        f_excl=masks[fact_slot], d_excl=masks[dim_slot])
            if isinstance(got, SH.ShardedTable):
                # a row-sharded fact side joined shard by shard, each
                # shard compacted to its matches
                tables[a] = got
                masks[a] = masks[b] = None
                sources[a] = sources[fact_slot]
            elif got is not None:
                r_idx, matched = got
                cols = dict(fact_t.columns)
                cols.update(E.gather_table_rows(
                    dim_t, r_idx, fact_t.nrows).columns)
                tables[a] = DeviceTable(cols, fact_t.nrows, plen=fact_t.plen)
                masks[a] = ~matched          # accumulates misses + old masks
                masks[b] = None
                sources[a] = sources[fact_slot]   # fact physical survives
            else:
                l_on = [lk if sl == a else rk for (sl, sr, lk, rk) in es]
                r_on = [rk if sl == a else lk for (sl, sr, lk, rk) in es]
                # residual conjuncts fully in scope of this pair evaluate
                # INSIDE the join (per chunk when it exceeds the pair
                # budget): the q72-class expansion is filtered before it is
                # ever materialized whole
                pair_cols = set(tables[a].column_names) | \
                    set(tables[b].column_names)
                res_here = [c for c in residual
                            if not self._has_subquery(c) and
                            self._refs_resolve_in(c, pair_cols)]
                residual = [c for c in residual if c not in res_here]
                res_fn = (lambda t, rh=res_here: self._conjunct_mask(t, rh)) \
                    if res_here else None
                tables[a] = E.join_tables(tables[a], tables[b], l_on, r_on,
                                          "inner",
                                          l_excl=masks[a], r_excl=masks[b],
                                          residual_fn=res_fn)
                masks[a] = masks[b] = None   # consumed by the join
                sources[a] = None            # physical rows are pair-expanded
            groups[b] = a
            pending = [e for e in pending if slot(e[0]) != slot(e[1])]
        # cartesian any remaining disconnected slots (materialize any
        # still-deferred mask first)
        live = sorted({slot(i) for i in range(len(parts))})
        for s in live:
            if masks[s] is not None:
                tables[s] = E.compact_table(tables[s], ~masks[s])
                masks[s] = None
        out = tables[live[0]]
        for s in live[1:]:
            out = self._cartesian(out, tables[s])
        # residual predicates apply on the fully joined result (shard by
        # shard on a row-sharded one, unless a subquery needs it whole)
        if SH.is_row(out) and residual and \
                not any(self._has_subquery(c) for c in residual):
            out = SH.per_shard(
                out, lambda _i, t: self._filter_conjuncts(t, residual))
        else:
            out = self._filter_conjuncts(out, residual)
        # synthetic join keys must not leak into SELECT * expansion
        if any(n.startswith("__jk") for n in out.column_names):
            out = out.select([n for n in out.column_names
                              if not n.startswith("__jk")])
        return out

    # ---------------------------------------------------------------- SELECT

    def select(self, sel: A.Select) -> DeviceTable:
        where_conjuncts = [h for c in self._split_conjuncts(sel.where)
                           for h in self._hoist_or_conjuncts(c)]
        # _flatten_from consumes conjuncts it pushes below outer joins
        parts, join_preds, sources = (([], [], []) if sel.from_ is None
                                      else self._flatten_from(sel.from_,
                                                              where_conjuncts))
        if sel.from_ is None:
            table = DeviceTable({}, 1, plen=E.bucket_len(1))
            table = self._filter_conjuncts(table, where_conjuncts)
        else:
            table = self._join_parts(parts, join_preds, where_conjuncts,
                                     sources)

        agg_calls = {}
        self._collect_aggs(
            [it.expr for it in sel.items] + ([sel.having] if sel.having else []),
            agg_calls)
        has_group = sel.group_by is not None
        if has_group or agg_calls:
            out, _ = self._aggregate(sel, table, agg_calls)
        elif SH.is_row(table) and not any(
                self._has_window(it.expr) or self._has_subquery(it.expr)
                for it in sel.items if not isinstance(it.expr, A.Star)):
            # a plain projection of a row-sharded table: shard by shard
            out = SH.per_shard(
                table, lambda _i, t: self._project(sel, EvalCtx(t)))
        else:
            ctx = EvalCtx(table)
            self._eval_windows(sel, ctx)
            out = self._project(sel, ctx)
        if sel.distinct:
            out = self._distinct(out)
        return out

    @staticmethod
    def _item_name(item, i: int) -> str:
        """Output name of one non-star SELECT item BEFORE collision
        renaming. Single source of truth for _project and the pruning
        side's _projected_names — they must never disagree, or projection
        pruning drops a column the star over a CTE still needs."""
        name = item.alias
        if name is None:
            if isinstance(item.expr, A.ColumnRef):
                name = item.expr.name.lower()
            elif isinstance(item.expr, A.FuncCall):
                name = f"{item.expr.name}_{i}"
            else:
                name = f"col{i}"
        return name.lower()

    @classmethod
    def _projected_names(cls, items):
        """The exact output names :meth:`_project` will emit for a SELECT
        list — including the duplicate-name ``_{i}`` suffixing — or None
        when not statically derivable (a star expansion depends on the
        input table, so callers must disable pruning)."""
        outs: list = []
        for i, item in enumerate(items):
            if isinstance(item.expr, A.Star):
                return None
            name = cls._item_name(item, i)
            if name in outs:
                name = f"{name}_{i}"
            outs.append(name)
        return outs

    def _project(self, sel: A.Select, ctx: EvalCtx) -> DeviceTable:
        cols = {}
        for i, item in enumerate(sel.items):
            if isinstance(item.expr, A.Star):
                for n, c in ctx.table.columns.items():
                    if item.expr.table and not n.startswith(item.expr.table.lower() + "."):
                        continue
                    base = n.split(".")[-1]
                    cols[base if base not in cols else n] = c
                continue
            name = self._item_name(item, i)
            if name in cols:
                name = f"{name}_{i}"
            col = self.eval_expr(item.expr, ctx)
            if len(col) != ctx.table.plen:
                raise ExecError(f"projection arity mismatch for {name}")
            cols[name] = col
            ctx.select_aliases[name] = col
        return DeviceTable(cols, ctx.table.nrows, plen=ctx.table.plen)

    # ------------------------------------------------------------ aggregation

    def _collect_aggs(self, exprs, out: dict):
        from nds_tpu_torch.sql.parser import AGG_FUNCS

        def walk(e, in_window=False):
            if isinstance(e, A.WindowFunc):
                # the window func itself is not a group agg, but its args can be
                for a in e.func.args:
                    walk(a)
                for p in e.spec.partition_by:
                    walk(p)
                for (oe, _, _) in e.spec.order_by:
                    walk(oe)
                return
            if isinstance(e, A.FuncCall) and e.name in AGG_FUNCS:
                out[expr_key(e)] = e
                return  # no nested aggs
            for c in self._child_exprs(e):
                walk(c)
        for e in exprs:
            if e is not None:
                walk(e)

    def _aggregate(self, sel: A.Select, table: DeviceTable, agg_calls: dict):
        group_by = sel.group_by or A.GroupingSets("plain", [[]], [])
        base_ctx = EvalCtx(table)
        group_exprs = group_by.exprs
        key_cols = [self.eval_expr(e, base_ctx) for e in group_exprs]
        key_names = [expr_key(e) for e in group_exprs]

        set_tables = self._rollup_fast(sel, group_by, agg_calls, base_ctx,
                                       key_cols, key_names, table)
        if set_tables is not None:
            pass
        elif not group_exprs and group_by.kind == "plain" and \
                not any(c.distinct or c.name == "approx_count_distinct"
                        for c in agg_calls.values()):
            # GLOBAL aggregate: the output row count is statically 1 and
            # SQL's empty-input semantics already live in the aggregates'
            # device-side validity (a zero-contribution group yields
            # count 0 and NULL sum/min/max) — so the input count is never
            # resolved on host. q9-class queries pay one sync per scalar
            # subquery through the generic arm; this path pays none.
            ng, cap = 1, E.bucket_len(1)
            gids = torch.where(E.live_mask(table.plen, table.nrows),
                               0, cap).to(torch.int64)
            agg_vals = {akey: self._compute_agg(call, base_ctx, gids,
                                                cap, [])
                        for akey, call in agg_calls.items()}
            set_tables = [self._finish_set(sel, set(), key_names, key_cols,
                                           {}, agg_vals, ng, cap)]
        else:
            set_tables = []
            for gset in group_by.sets:
                gset_keys = [expr_key(e) for e in gset]
                active = [key_cols[i] for i, k in enumerate(key_names)
                          if k in gset_keys]
                if active:
                    # group_ids' ngroups resolve DRAINS every pending lazy
                    # count — including the input count — so the empty-
                    # input test rides the same transfer (ng == 0 iff no
                    # live input rows): ONE sync per grouping set, not two
                    gids, ng, rep, cap = E.group_ids(active,
                                                     n_valid=table.nrows)
                    if ng == 0:
                        # keyed set over empty input contributes no rows
                        continue
                else:
                    # keyless set: inside rollup/cube/grouping-sets an
                    # empty input contributes no row; a PLAIN keyless
                    # aggregate (only distinct aggs reach this arm) still
                    # yields one row over empty input. A sibling keyed
                    # set usually resolved the input count already,
                    # making this test free.
                    if E.count_int(table.nrows) == 0 and \
                            (group_by.kind != "plain" or group_exprs):
                        continue
                    # global aggregate: live rows in group 0, pads in a
                    # dropped trailing slot
                    ng, cap = 1, E.bucket_len(1)
                    gids = torch.where(E.live_mask(table.plen, table.nrows),
                                       0, cap).to(torch.int64)
                    rep = torch.zeros(cap, dtype=torch.int64,
                                      device=E.device())
                group_cols = {
                    k: key_cols[i].take(rep)
                    for i, k in enumerate(key_names) if k in gset_keys}
                # aggregates (segment capacity = cap keeps shapes canonical;
                # pad contributions land past ng or are dropped)
                agg_vals = {akey: self._compute_agg(call, base_ctx, gids,
                                                    cap, active)
                            for akey, call in agg_calls.items()}
                set_tables.append(self._finish_set(
                    sel, set(gset_keys), key_names, key_cols, group_cols,
                    agg_vals, ng, cap))
        if not set_tables:
            # grouped query over empty input -> empty result with right
            # names. Keep the physical floor bucket (plen >= 16, nrows = 0):
            # a zero-length physical table would break the padded-prefix
            # invariant every downstream consumer (joins, sorts) relies on.
            cap0 = E.bucket_len(0)
            post = EvalCtx(DeviceTable({}, 0, plen=cap0), post_agg=True)
            pad_idx = torch.full((cap0,), base_ctx.table.plen,
                                 dtype=torch.int64, device=E.device())
            for kname, kcol in zip(key_names, key_cols):
                post.group_values[kname] = (
                    kcol.take(pad_idx) if len(kcol)
                    else E._null_column_like(kcol, cap0))
                post.grouping_flags[kname] = 0
            gids0 = torch.full((base_ctx.table.plen,), cap0,
                               dtype=torch.int64, device=E.device())
            for akey, call in agg_calls.items():
                post.agg_values[akey] = self._compute_agg(
                    call, base_ctx, gids0, cap0, [])
            self._eval_windows(sel, post)
            out = self._project(sel, post)
            return out, post
        if len(set_tables) == 1:
            return set_tables[0]
        tables = [t for t, _ in set_tables]
        return E.concat_tables(tables), set_tables[0][1]

    def _finish_set(self, sel: A.Select, gset_keys: set, key_names, key_cols,
                    group_cols: dict, agg_vals: dict, ng: int, cap: int):
        """Build one grouping set's output: post-agg context (active keys
        from ``group_cols``, inactive keys as typed nulls, grouping flags),
        HAVING, windows, projection."""
        post = EvalCtx(DeviceTable({}, ng, plen=cap), post_agg=True)
        for kname, kcol in zip(key_names, key_cols):
            if kname in gset_keys:
                post.group_values[kname] = group_cols[kname]
                post.grouping_flags[kname] = 0
            else:
                dev = kcol.data.device
                if kcol.kind == "str":
                    null = Column("str", torch.zeros(cap, dtype=torch.int32,
                                                     device=dev),
                                  torch.zeros(cap, dtype=torch.bool,
                                              device=dev),
                                  kcol.dict_values)
                else:
                    null = Column(kcol.kind,
                                  torch.zeros(cap, dtype=kcol.data.dtype,
                                              device=dev),
                                  torch.zeros(cap, dtype=torch.bool,
                                              device=dev),
                                  kcol.dict_values, kcol.enc)
                post.group_values[kname] = null
                post.grouping_flags[kname] = 1
        post.agg_values.update(agg_vals)
        post.table = DeviceTable({}, ng, plen=cap)
        # HAVING before projection
        if sel.having is not None:
            mask_col = self.eval_expr(sel.having, post)
            post = self._mask_ctx(
                post, mask_col.data.to(torch.bool) & mask_col.valid_mask())
        self._eval_windows(sel, post)
        out = self._project(sel, post)
        return out, post

    _ROLLUP_REAGG = {"sum", "count", "avg", "min", "max"}

    def _rollup_fast(self, sel, group_by, agg_calls, base_ctx, key_cols,
                     key_names, table):
        """Hierarchical ROLLUP: grouping sets are prefixes of one another
        (finest first), so each coarser level re-aggregates the PREVIOUS
        level's partial aggregates (thousands of groups) instead of
        re-grouping the base table (millions of rows) — the rollup twin of
        partial/final aggregation. Engages when every aggregate is
        algebraically decomposable (sum/count/avg/min/max, no DISTINCT);
        returns None to fall back to the per-set generic path."""
        if group_by.kind != "rollup" or E.count_int(table.nrows) == 0:
            return None
        if not agg_calls or not all(
                c.name in self._ROLLUP_REAGG and not c.distinct
                for c in agg_calls.values()):
            return None
        expected = [[expr_key(e) for e in s] for s in group_by.sets]
        if any(ks != key_names[:len(ks)] for ks in expected) or \
                not expected or not expected[0]:
            return None
        set_tables = []
        prev = None          # (level key Columns, partials, ng, cap)
        for gkeys in expected:
            k = len(gkeys)
            if prev is None:
                gids, ng, rep, cap = E.group_ids(key_cols[:k],
                                                 n_valid=table.nrows)
                lvl_keys = [c.take(rep) for c in key_cols[:k]]
                partials = {akey: self._agg_partials(call, base_ctx, gids,
                                                     cap)
                            for akey, call in agg_calls.items()}
            else:
                p_keys, p_partials, p_ng, p_cap = prev
                if k:
                    gids, ng, rep, cap = E.group_ids(p_keys[:k], n_valid=p_ng)
                    lvl_keys = [c.take(rep) for c in p_keys[:k]]
                else:
                    ng, cap = 1, E.bucket_len(1)
                    gids = torch.where(E.live_mask(p_cap, p_ng), 0,
                                       cap).to(torch.int64)
                    lvl_keys = []
                partials = {akey: self._reagg_partials(p, gids, cap)
                            for akey, p in p_partials.items()}
            agg_vals = {akey: self._finalize_partial(call, partials[akey])
                        for akey, call in agg_calls.items()}
            group_cols = dict(zip(gkeys, lvl_keys))
            set_tables.append(self._finish_set(
                sel, set(gkeys), key_names, key_cols, group_cols, agg_vals,
                ng, cap))
            prev = (lvl_keys, partials, ng, cap)
        return set_tables

    def _agg_partials(self, call: A.FuncCall, base_ctx: EvalCtx, gids, cap):
        """Decomposed (re-aggregatable) components of one aggregate at the
        finest rollup level."""
        arg = self.eval_expr(call.args[0], base_ctx) if call.args else None
        n = call.name
        if n == "count":
            return {"count": self._as_plain_count(
                E.agg_count(arg, gids, cap))}
        if n == "sum":
            return {"sum": E.agg_sum(arg, gids, cap)}
        if n == "avg":
            return {"sum": E.agg_sum(arg, gids, cap),
                    "count": self._as_plain_count(
                        E.agg_count(arg, gids, cap))}
        return {n: E.agg_min(arg, gids, cap, is_max=(n == "max"))}

    @staticmethod
    def _as_plain_count(col: Column) -> Column:
        # COUNT is never NULL: empty slots are zero, not invalid
        return Column(col.kind, col.data, None)

    def _reagg_partials(self, partials: dict, gids, cap):
        out = {}
        for part, col in partials.items():
            if part == "count":
                s = E.agg_sum(col, gids, cap)
                out[part] = Column(col.kind, s.data, None)
            elif part == "sum":
                out[part] = E.agg_sum(col, gids, cap)
            else:                                    # "min" / "max"
                out[part] = E.agg_min(col, gids, cap,
                                      is_max=(part == "max"))
        return out

    def _finalize_partial(self, call: A.FuncCall, partials: dict) -> Column:
        n = call.name
        if n in ("count", "sum", "min", "max"):
            return partials[n]
        # avg = sum / count with the decimal descale agg_avg applies
        s, c = partials["sum"], partials["count"]
        data = s.data.to(torch.float64)
        if s.scale:
            # one IEEE division on every device (H6), as agg_avg descales
            data = prim.true_div(data, 10.0 ** s.scale)
        cnt = c.data.to(torch.float64)
        out = torch.where(cnt > 0, data / cnt.clamp(min=1.0), 0.0)
        return Column("f64", out, c.data > 0)

    def _mask_ctx(self, ctx: EvalCtx, mask) -> EvalCtx:
        """Compact an aggregation context by a boolean mask (HAVING).

        LAZY (DESIGN.md item 1): HAVING can only shrink, so the input's
        bound is a valid capacity — live rows gather to the prefix of the
        bound-sized bucket and the exact count rides as a DeviceCount,
        resolved batched by whatever downstream consumer truly needs it
        (ORDER BY/LIMIT, collect). No sync here."""
        m = mask & E.live_mask(ctx.table.plen, ctx.table.nrows)
        bound = E.count_bound(ctx.table.nrows)
        n = E.DeviceCount(m.sum(), bound)
        idx = E.compact_indices(m, bound)
        new = EvalCtx(DeviceTable(
            {nm: c.take(idx) for nm, c in ctx.table.columns.items()}, n,
            plen=int(idx.shape[0])), post_agg=True)
        new.group_values = {k: c.take(idx) for k, c in ctx.group_values.items()}
        new.agg_values = {k: c.take(idx) for k, c in ctx.agg_values.items()}
        new.grouping_flags = dict(ctx.grouping_flags)
        new.window_values = {k: c.take(idx) for k, c in ctx.window_values.items()}
        return new

    def _compute_agg(self, call: A.FuncCall, base_ctx: EvalCtx, gids, ng, key_cols):
        name = call.name
        if name == "count" and call.star:
            return E.agg_count(None, gids, ng)
        arg = self.eval_expr(call.args[0], base_ctx) if call.args else None
        if call.distinct:
            # only the distinct re-grouping needs the exact host count
            # (memoized by the generic arm's resolve when it ran; the
            # sync-free global arm never reaches here with distinct)
            n_base = E.count_int(base_ctx.table.nrows)
            if name == "count":
                return self._count_distinct(arg, gids, ng, n_base)
            if name in ("sum", "avg"):
                return self._sum_avg_distinct(name, arg, gids, ng, n_base)
            # min/max distinct == plain
        if name == "count":
            return E.agg_count(arg, gids, ng)
        if name == "sum":
            return E.agg_sum(arg, gids, ng)
        if name == "avg":
            return E.agg_avg(arg, gids, ng)
        if name == "min":
            return E.agg_min(arg, gids, ng, is_max=False)
        if name == "max":
            return E.agg_min(arg, gids, ng, is_max=True)
        if name in ("stddev_samp", "stddev"):
            return E.agg_stddev_samp(arg, gids, ng)
        if name in ("var_samp", "variance"):
            sd = E.agg_stddev_samp(arg, gids, ng)
            return Column("f64", sd.data * sd.data, sd.valid)
        if name == "approx_count_distinct":
            return self._count_distinct(arg, gids, ng,
                                        E.count_int(base_ctx.table.nrows))
        raise ExecError(f"unsupported aggregate {name}")

    def _count_distinct(self, arg: Column, gids, ng, n_base: int):
        # empty-input fallback: gids comes from the zero-length path, but the
        # padded arg still has plen >= 16, so test the base row count
        if n_base == 0 or gids.shape[0] == 0:
            return Column("i64", torch.zeros(ng, dtype=torch.int64,
                                             device=gids.device))
        gid_col = Column("i64", gids)
        inner_gids, inner_ng, inner_rep, inner_cap = E.group_ids(
            [gid_col, arg], n_valid=n_base)
        # inner_rep pad slots are out of range: route them to the dropped
        # segment instead of letting a clipped gather pollute a real group
        outer_at_rep = prim.take_fill(gids, inner_rep, ng)
        valid_at_rep = prim.take_fill(arg.valid_mask(), inner_rep,
                                      False).to(torch.int64)
        out = prim.segment_sum(valid_at_rep, outer_at_rep, ng)
        return Column("i64", out)

    def _sum_avg_distinct(self, name, arg: Column, gids, ng, n_base: int):
        if n_base == 0 or gids.shape[0] == 0:
            return Column("f64" if name == "avg" else arg.kind,
                          torch.zeros(ng, dtype=torch.float64
                                      if name == "avg" else torch.int64,
                                      device=gids.device))
        gid_col = Column("i64", gids)
        inner_gids, inner_ng, inner_rep, inner_cap = E.group_ids(
            [gid_col, arg], n_valid=n_base)
        outer_at_rep = prim.take_fill(gids, inner_rep, ng)
        rep_arg = arg.take(inner_rep)
        if name == "sum":
            return E.agg_sum(rep_arg, outer_at_rep, ng)
        return E.agg_avg(rep_arg, outer_at_rep, ng)

    # --------------------------------------------------------------- windows

    def _eval_windows(self, sel: A.Select, ctx: EvalCtx):
        """Evaluate every window function in the select list, sharing one
        WindowContext per (partition, order) spec."""
        wins = []

        def walk(e):
            if isinstance(e, A.WindowFunc):
                wins.append(e)
                return
            for c in self._child_exprs(e):
                walk(c)
        for it in sel.items:
            walk(it.expr)
        if sel.having is not None:
            walk(sel.having)
        if not wins:
            return
        contexts = {}
        for w in wins:
            skey = (tuple(expr_key(p) for p in w.spec.partition_by),
                    tuple((expr_key(e), d, nl) for e, d, nl in w.spec.order_by))
            if skey not in contexts:
                pcols = [self.eval_expr(p, ctx) for p in w.spec.partition_by]
                ocols = [self.eval_expr(e, ctx) for e, _, _ in w.spec.order_by]
                desc = [d for _, d, _ in w.spec.order_by]
                nl = [n for _, _, n in w.spec.order_by]
                contexts[skey] = WindowContext(pcols, ocols, desc, nl,
                                               n_valid=ctx.table.nrows)
            wc = contexts[skey]
            fname = w.func.name
            if fname == "row_number":
                col = wc.row_number()
            elif fname == "rank":
                col = wc.rank()
            elif fname == "dense_rank":
                col = wc.dense_rank()
            elif fname in ("sum", "avg", "min", "max", "count"):
                arg = (self.eval_expr(w.func.args[0], ctx) if w.func.args
                       else Column("i64", torch.ones(
                           ctx.table.plen, dtype=torch.int64,
                           device=E.device())))
                frame = w.spec.frame
                if frame is None and w.spec.order_by:
                    # SQL default with ORDER BY: RANGE UNBOUNDED PRECEDING ..
                    # CURRENT ROW (a running, not whole-partition, aggregate)
                    frame = "range_unbounded_preceding"
                if frame is not None and w.spec.order_by:
                    col = wc.running_agg(arg, fname,
                                         rows_frame=frame.startswith("rows"))
                else:
                    col = wc.partition_agg(arg, fname)
            else:
                raise ExecError(f"unsupported window function {fname}")
            ctx.window_values[expr_key(w)] = col

    # ----------------------------------------------------------- expressions

    def eval_expr(self, e, ctx: EvalCtx) -> Column:
        if E.stream_bounds_on():
            # the chunk-derived hazard reads check the table (ops)
            E.note_eval_table(ctx.table)
        n = ctx.table.plen     # new columns are built at physical length
        k = expr_key(e)
        if ctx.window_values and k in ctx.window_values:
            return ctx.window_values[k]
        if ctx.post_agg:
            if k in ctx.agg_values:
                return ctx.agg_values[k]
            hit = self._lookup_group(e, ctx)
            if hit is not None:
                return hit

        if isinstance(e, A.Literal):
            # audited-bindable slots read the pipeline's device scalars
            # (one build, many parameter vectors); everything else bakes
            bound = X.bound_literal(e, n)
            if bound is not None:
                return bound
            return X.literal(e.value, n)
        if isinstance(e, A.DateLiteral):
            days = X.parse_date_literal(e.text)
            return Column("date", torch.full((n,), days, dtype=torch.int32,
                                             device=E.device()))
        if isinstance(e, A.ColumnRef):
            return self._eval_column_ref(e, ctx)
        if isinstance(e, A.UnaryOp):
            if e.op == "not":
                return X.logical_not(self.eval_expr(e.operand, ctx))
            return X.negate(self.eval_expr(e.operand, ctx))
        if isinstance(e, A.BinaryOp):
            return self._eval_binary(e, ctx)
        if isinstance(e, A.Between):
            v = self.eval_expr(e.expr, ctx)
            lo = self.eval_expr(e.low, ctx)
            hi = self.eval_expr(e.high, ctx)
            v1, lo = self._coerce_pair(v, lo)
            v2, hi = self._coerce_pair(v, hi)
            res = X.logical_and(X.compare(">=", v1, lo), X.compare("<=", v2, hi))
            return X.logical_not(res) if e.negated else res
        if isinstance(e, A.InList):
            return self._eval_in_list(e, ctx)
        if isinstance(e, A.InSubquery):
            return self._eval_in_subquery(e, ctx)
        if isinstance(e, A.Exists):
            return self._eval_exists(e, ctx)
        if isinstance(e, A.ScalarSubquery):
            return self._eval_scalar_subquery(e, ctx)
        if isinstance(e, A.QuantifiedCompare):
            return self._eval_quantified(e, ctx)
        if isinstance(e, A.Like):
            col = self.eval_expr(e.expr, ctx)
            return X.fn_like(col, e.pattern, e.negated)
        if isinstance(e, A.IsNull):
            return X.is_null(self.eval_expr(e.expr, ctx), e.negated)
        if isinstance(e, A.Case):
            return self._eval_case(e, ctx)
        if isinstance(e, A.Cast):
            return X.cast(self.eval_expr(e.expr, ctx), e.target)
        if isinstance(e, A.FuncCall):
            return self._eval_func(e, ctx)
        if isinstance(e, A.WindowFunc):
            raise ExecError("window function outside select list")
        raise ExecError(f"unsupported expression {type(e).__name__}")

    def _lookup_group(self, e, ctx: EvalCtx):
        """Match an expression against the grouped key columns, tolerating
        qualified/unqualified column-ref mismatches."""
        k = expr_key(e)
        if k in ctx.group_values:
            return ctx.group_values[k]
        if isinstance(e, A.ColumnRef):
            suffix = f".{e.name.lower()}"
            hits = [v for gk, v in ctx.group_values.items()
                    if gk.startswith("col:") and gk.endswith(suffix)]
            if len(hits) == 1:
                return hits[0]
            if e.table:  # qualified ref vs unqualified group key
                alt = f"col:.{e.name.lower()}"
                if alt in ctx.group_values:
                    return ctx.group_values[alt]
        return None

    def _lookup_grouping_flag(self, e, ctx: EvalCtx):
        k = expr_key(e)
        if k in ctx.grouping_flags:
            return ctx.grouping_flags[k]
        if isinstance(e, A.ColumnRef):
            suffix = f".{e.name.lower()}"
            hits = [v for gk, v in ctx.grouping_flags.items()
                    if gk.startswith("col:") and gk.endswith(suffix)]
            if len(hits) == 1:
                return hits[0]
        raise ExecError(f"grouping() argument is not a grouping column")

    def _eval_column_ref(self, e: A.ColumnRef, ctx: EvalCtx) -> Column:
        key = self._resolve_name(e, set(ctx.table.column_names))
        if key is not None:
            return ctx.table[key]
        if not e.table and e.name.lower() in ctx.select_aliases:
            return ctx.select_aliases[e.name.lower()]
        if ctx.post_agg:
            hit = self._lookup_group(e, ctx)
            if hit is not None:
                return hit
        # ORDER BY over projected output: a qualified ref (dt.d_year) still
        # addresses the bare output column name
        if e.table and e.name.lower() in ctx.select_aliases:
            return ctx.select_aliases[e.name.lower()]
        raise ExecError(f"cannot resolve column "
                        f"{(e.table + '.') if e.table else ''}{e.name}")

    def _coerce_pair(self, a: Column, b: Column):
        """Type coercions the corpus relies on: string literal vs date."""
        if a.kind == "date" and b.kind == "str":
            return a, X.cast(b, "date")
        if b.kind == "date" and a.kind == "str":
            return X.cast(a, "date"), b
        return a, b

    def _eval_binary(self, e: A.BinaryOp, ctx: EvalCtx) -> Column:
        if e.op == "and":
            return X.logical_and(self.eval_expr(e.left, ctx),
                                 self.eval_expr(e.right, ctx))
        if e.op == "or":
            return X.logical_or(self.eval_expr(e.left, ctx),
                                self.eval_expr(e.right, ctx))
        # interval date arithmetic
        if isinstance(e.right, A.IntervalLiteral):
            base = self.eval_expr(e.left, ctx)
            return self._add_interval(base, e.right, negate=(e.op == "-"))
        if isinstance(e.left, A.IntervalLiteral):
            base = self.eval_expr(e.right, ctx)
            return self._add_interval(base, e.left, negate=False)
        a = self.eval_expr(e.left, ctx)
        b = self.eval_expr(e.right, ctx)
        if e.op == "||":
            return X.fn_concat([a, b])
        a, b = self._coerce_pair(a, b)
        if e.op in ("=", "<>", "<", "<=", ">", ">="):
            return X.compare(e.op, a, b)
        return X.arith(e.op, a, b)

    def _add_interval(self, base: Column, iv: A.IntervalLiteral, negate: bool) -> Column:
        amt = -iv.amount if negate else iv.amount
        if base.kind == "str":
            base = X.cast(base, "date")
        base = E.plain_col(base)
        if iv.unit == "day":
            return Column("date", (base.data + amt).to(base.data.dtype),
                          base.valid)
        # month/year arithmetic via numpy calendar math on host (a whole-
        # column fetch through the counted host-read choke point)
        def fetch():
            days = E.to_host(base.data)
            months = amt * (12 if iv.unit == "year" else 1)
            d64 = _EPOCH64 + days.astype("timedelta64[D]")
            m = d64.astype("datetime64[M]")
            dom = (d64 - m.astype("datetime64[D]")).astype(int)
            shifted_m = m + np.timedelta64(months, "M")
            next_m = shifted_m + np.timedelta64(1, "M")
            last_dom = ((next_m.astype("datetime64[D]")
                         - np.timedelta64(1, "D"))
                        - shifted_m.astype("datetime64[D]")).astype(int)
            new_dom = np.minimum(dom, last_dom)
            out = (shifted_m.astype("datetime64[D]")
                   - _EPOCH64).astype(int) + new_dom
            return out.astype(np.int32)

        out = E.timed_read("month_arith", fetch)
        return Column("date", E.upload(out, base.data.device), base.valid)

    def _eval_in_list(self, e: A.InList, ctx: EvalCtx) -> Column:
        col = self.eval_expr(e.expr, ctx)
        values = []
        for item in e.items:
            if not isinstance(item, A.Literal):
                # general fallback: OR of equalities
                res = None
                for it in e.items:
                    cmp = X.compare("=", col, self.eval_expr(it, ctx))
                    res = cmp if res is None else X.logical_or(res, cmp)
                return X.logical_not(res) if e.negated else res
            values.append(item.value)
        has_null = any(v is None for v in values)
        values = [v for v in values if v is not None]
        if e.negated and has_null:
            # ANSI: NOT IN with a NULL in the list is never true
            return Column("bool", torch.zeros(len(col), dtype=torch.bool,
                                              device=col.data.device))
        col = E.plain_col(col)
        if col.kind == "str":
            res = X.fn_in_strings(col, [str(v) for v in values])
        elif col.kind == "f64":
            data = torch.isin(col.data, E.upload(
                [float(v) for v in values], col.data.device, torch.float64))
            res = Column("bool", data, col.valid)
        else:
            from decimal import Decimal
            scale = col.scale
            nums = []
            for v in values:
                if not isinstance(v, Decimal):
                    if not isinstance(v, (int, float)):
                        raise ExecError(f"bad IN-list literal {v!r}")
                    v = Decimal(str(v))
                scaled = v.scaleb(scale)
                # a literal that is fractional at this column's scale can
                # never match an int/decimal column — drop it, don't round
                if scaled == scaled.to_integral_value():
                    nums.append(int(scaled))
            if not nums:
                res = Column("bool", torch.zeros(
                    len(col), dtype=torch.bool, device=col.data.device),
                    col.valid)
            else:
                data = torch.isin(col.data.to(torch.int64), E.upload(
                    nums, col.data.device, torch.int64))
                res = Column("bool", data, col.valid)
        return X.logical_not(res) if e.negated else res

    def _eval_case(self, e: A.Case, ctx: EvalCtx) -> Column:
        n = ctx.table.plen
        branches = []
        if e.operand is not None:
            op = self.eval_expr(e.operand, ctx)
            for cond, res in e.branches:
                c = X.compare("=", op, self.eval_expr(cond, ctx))
                branches.append((c, self.eval_expr(res, ctx)))
        else:
            for cond, res in e.branches:
                branches.append((self.eval_expr(cond, ctx),
                                 self.eval_expr(res, ctx)))
        else_col = (self.eval_expr(e.else_, ctx) if e.else_ is not None
                    else X.literal(None, n))
        return X.case_when(branches, else_col)

    def _eval_func(self, e: A.FuncCall, ctx: EvalCtx) -> Column:
        name = e.name
        n = ctx.table.plen
        if name == "grouping":
            flag = self._lookup_grouping_flag(e.args[0], ctx)
            return Column("i64", torch.full((n,), flag, dtype=torch.int64,
                                            device=E.device()))
        if name in ("substr", "substring"):
            col = self.eval_expr(e.args[0], ctx)
            start = self._const_int(e.args[1])
            length = self._const_int(e.args[2]) if len(e.args) > 2 else None
            return X.fn_substr(col, start, length)
        if name == "coalesce":
            return X.coalesce([self.eval_expr(a, ctx) for a in e.args])
        if name == "nullif":
            a = self.eval_expr(e.args[0], ctx)
            b = self.eval_expr(e.args[1], ctx)
            eq = X.compare("=", a, b)
            new_valid = a.valid_mask() & ~(eq.data.to(torch.bool) & eq.valid_mask())
            return Column(a.kind, a.data, new_valid, a.dict_values, a.enc)
        if name in ("abs",):
            return X.fn_abs(self.eval_expr(e.args[0], ctx))
        if name == "round":
            col = self.eval_expr(e.args[0], ctx)
            digits = self._const_int(e.args[1]) if len(e.args) > 1 else 0
            return X.fn_round(col, digits)
        if name == "floor":
            return X.fn_floor(self.eval_expr(e.args[0], ctx))
        if name in ("ceil", "ceiling"):
            return X.fn_ceil(self.eval_expr(e.args[0], ctx))
        if name == "sqrt":
            return X.fn_sqrt(self.eval_expr(e.args[0], ctx))
        if name in ("upper", "ucase"):
            return X.fn_upper(self.eval_expr(e.args[0], ctx))
        if name in ("lower", "lcase"):
            return X.fn_lower(self.eval_expr(e.args[0], ctx))
        if name == "trim":
            return X.fn_trim(self.eval_expr(e.args[0], ctx))
        if name in ("length", "char_length", "character_length"):
            return X.fn_length(self.eval_expr(e.args[0], ctx))
        if name == "concat":
            return X.fn_concat([self.eval_expr(a, ctx) for a in e.args])
        if name in ("year", "month", "day", "dayofmonth"):
            col = self.eval_expr(e.args[0], ctx)
            return self._date_part(col, "day" if name == "dayofmonth" else name)
        if name in ("d_date", ):
            pass
        raise ExecError(f"unsupported function {name}")

    def _date_part(self, col: Column, part: str) -> Column:
        col = E.plain_col(col)
        def fetch():
            # host calendar math on the whole column (a counted fetch)
            days = E.to_host(col.data)
            d64 = _EPOCH64 + days.astype("timedelta64[D]")
            y = d64.astype("datetime64[Y]").astype(int) + 1970
            if part == "year":
                out = y
            else:
                m_idx = d64.astype("datetime64[M]").astype(int)
                month = m_idx % 12 + 1
                if part == "month":
                    out = month
                else:
                    dom = (d64 - d64.astype("datetime64[M]")
                           .astype("datetime64[D]")).astype(int) + 1
                    out = dom
            return out.astype(np.int64)

        return Column("i64", E.upload(E.timed_read("date_part", fetch),
                                      col.data.device), col.valid)

    def _const_int(self, e) -> int:
        if isinstance(e, A.Literal) and isinstance(e.value, int):
            return e.value
        if isinstance(e, A.UnaryOp) and e.op == "-":
            return -self._const_int(e.operand)
        raise ExecError("expected integer literal argument")

    # -------------------------------------------------------- subquery plans

    def _select_output_cols(self, from_) -> set:
        """Alias-qualified column names a FROM clause exposes, without
        executing it (for correlation analysis)."""
        out = set()
        if isinstance(from_, A.TableRef):
            alias = (from_.alias or from_.name).lower()
            try:
                cols = self._lookup_table(from_.name).column_names
            except ExecError:
                # the per-chunk planner of the streamed pipeline has an
                # EMPTY catalog; its correlation analysis must still
                # resolve subquery scopes exactly like the record phase
                # did, so the pipeline seeds a NAMES-ONLY snapshot of the
                # record-time catalog
                nc = getattr(self, "name_catalog", None)
                cols = (nc or {}).get(from_.name.lower())
                if cols is None:
                    return out
            for c in cols:
                out.add(f"{alias}.{c.split('.')[-1].lower()}")
        elif isinstance(from_, A.SubqueryRef):
            body = from_.query.body
            names = self._query_output_names(from_.query)
            for nm in names:
                out.add(f"{from_.alias.lower()}.{nm}")
        elif isinstance(from_, A.Join):
            out |= self._select_output_cols(from_.left)
            out |= self._select_output_cols(from_.right)
        return out

    def _query_output_names(self, q: A.Query) -> list:
        body = q.body
        while isinstance(body, A.SetOp):
            body = body.left
        if isinstance(body, A.Query):
            return self._query_output_names(body)
        names = []
        for i, it in enumerate(body.items):
            if isinstance(it.expr, A.Star):
                cols = self._select_output_cols(body.from_)
                names.extend(sorted({c.split(".")[-1] for c in cols}))
            elif it.alias:
                names.append(it.alias.lower())
            elif isinstance(it.expr, A.ColumnRef):
                names.append(it.expr.name.lower())
            else:
                names.append(f"col{i}")
        return names

    # -------------------------------------------- subquery residuals

    def _residual_key(self, payload) -> str:
        return payload[0] + "|" + "|".join(
            expr_key(x) if x is not None else "-" for x in payload[1:])

    def _plan_residual(self, payload):
        """Plan one subquery residual with the real planner/catalog."""
        if payload[0] == "query":
            return self.query(payload[1])
        # ("exists_inner", from_, where): correlated EXISTS with a
        # non-equality residual (q16/q94) — the inner join graph,
        # stripped of its correlation conjuncts, materialized whole
        _tag, from_, where = payload
        parts, preds, srcs = self._flatten_from(from_)
        return self._join_parts(parts, preds,
                                self._split_conjuncts(where), srcs)

    def _residual_table(self, payload) -> DeviceTable:
        """The device-resident residual of one chunk-invariant subquery,
        planned at most once per statement. Inside a streamed record phase
        the inner plan runs under ``ops.suspend_stream_record()`` — its
        host reads must never interleave with the outer recording, and
        freed of the stream-bounds guard it may sync (once) or stream
        through its own pipeline. Inside the per-chunk replay the registry
        is pre-seeded from the pipeline's operands; a miss there means the
        pipeline cannot serve the statement (StreamSyncError => eager
        fallback)."""
        key = self._residual_key(payload)
        hit = self._subquery_residuals.get(key)
        if hit is None:
            if E.stream_bounds_on():
                if E.replay_mode() == "replay":
                    raise E.StreamSyncError(
                        f"unplanned subquery residual {key[:80]}")
                with E.suspend_stream_record():
                    rt = E.resolve_table(self._plan_residual(payload))
            else:
                # outside a pipeline the residual stays LAZY (a q9-class
                # projection subquery must keep its no-sync broadcast
                # arm); the registry dedupes repeated subqueries and
                # caches across eager chunks
                rt = self._plan_residual(payload)
            hit = (payload, rt)
            self._subquery_residuals[key] = hit
        if self._residuals_touched is not None and \
                E.stream_bounds_on() and E.replay_mode() == "record" and \
                all(k != key for (k, _p, _t) in self._residuals_touched):
            self._residuals_touched.append((key, hit[0], hit[1]))
        return hit[1]

    def _find_correlation(self, q: A.Query, ctx: EvalCtx):
        """Detect equality correlation between a subquery and the outer row.

        Returns (corr_pairs, stripped_query) where corr_pairs is a list of
        (outer ColumnRef, inner Expr); or None if uncorrelated."""
        if not isinstance(q.body, A.Select) or q.ctes:
            return None
        sel = q.body
        if sel.from_ is None:
            return None
        inner_cols = self._select_output_cols(sel.from_)
        outer_cols = set(ctx.table.column_names)
        # hoist common conjuncts out of ORs first: q41's correlation equality
        # appears as (i_manufact = i1.i_manufact and X) or (i_manufact =
        # i1.i_manufact and Y)
        conjs = [h for c in self._split_conjuncts(sel.where)
                 for h in self._hoist_or_conjuncts(c)]
        corr, keep, residual = [], [], []
        for c in conjs:
            pair = None
            if isinstance(c, A.BinaryOp) and c.op == "=" and \
                    isinstance(c.left, A.ColumnRef) and isinstance(c.right, A.ColumnRef):
                l_in = self._resolve_name(c.left, inner_cols)
                r_in = self._resolve_name(c.right, inner_cols)
                l_out = self._resolve_name(c.left, outer_cols)
                r_out = self._resolve_name(c.right, outer_cols)
                if l_in is None and l_out is not None and r_in is not None:
                    pair = (c.left, c.right)
                elif r_in is None and r_out is not None and l_in is not None:
                    pair = (c.right, c.left)
            if pair:
                corr.append(pair)
            elif all(self._resolve_name(r, inner_cols)
                     for r in self._column_refs(c)):
                keep.append(c)
            else:
                # references both scopes without being an equality (e.g.
                # q16's cs1.cs_warehouse_sk <> cs2.cs_warehouse_sk)
                residual.append(c)
        if not corr:
            return None
        new_where = None
        for c in keep:
            new_where = c if new_where is None else A.BinaryOp("and", new_where, c)
        stripped = A.Query(
            A.Select(sel.items, sel.from_, new_where, sel.group_by, sel.having,
                     sel.distinct),
            [], None, [])
        return corr, stripped, residual

    def _eval_exists(self, e: A.Exists, ctx: EvalCtx) -> Column:
        n = ctx.table.plen
        found = self._find_correlation(e.query, ctx)
        if found is None:
            t = self._residual_table(("query", e.query))
            val = E.count_int(t.nrows) > 0
            res = Column("bool", torch.full((n,), val, dtype=torch.bool,
                                            device=E.device()))
            return X.logical_not(res) if e.negated else res
        corr, stripped, residual = found
        sel = stripped.body
        if residual:
            # non-equality correlated conjuncts (q16/q94: cs1.x <> cs2.x):
            # match pairs on the equality keys, then evaluate the residual on
            # the joined pair table
            if sel.group_by or sel.having:
                raise ExecError("correlated EXISTS with residual predicate "
                                "and grouping unsupported")
            inner_t = self._residual_table(("exists_inner", sel.from_,
                                            sel.where))
            lkeys = [self.eval_expr(outer, ctx) for outer, _ in corr]
            rkeys = [self.eval_expr(inner, EvalCtx(inner_t))
                     for _, inner in corr]
            l_idx, r_idx, n_pairs, _, _, _, _ = E.join_indices(
                lkeys, rkeys, "inner",
                n_left=ctx.table.nrows, n_right=inner_t.nrows)
            pair_cols = dict(E.gather_table_rows(
                inner_t, r_idx, n_pairs).columns)
            outer_g = E.gather_table_rows(ctx.table, l_idx, n_pairs).columns
            for nm, c in outer_g.items():
                pair_cols.setdefault(nm, c)
            pairs = DeviceTable(pair_cols, n_pairs)
            ok = self._conjunct_mask(pairs, residual)
            ok = ok & E.live_mask(pairs.plen, pairs.nrows)
            safe = torch.where(ok, l_idx, n)
            matched = prim.scatter_set(torch.zeros(
                n, dtype=torch.bool, device=l_idx.device), safe, True)
            return Column("bool", ~matched if e.negated else matched)
        inner_items = [A.SelectItem(inner, f"_ck{i}")
                       for i, (_, inner) in enumerate(corr)]
        sub = A.Query(A.Select(inner_items, sel.from_, sel.where, sel.group_by,
                               sel.having, True), [], None, [])
        rt = self._residual_table(("query", sub))
        lkeys = [self.eval_expr(outer, ctx) for outer, _ in corr]
        rkeys = [rt[c] for c in rt.column_names]
        mask = E.semi_join_mask(lkeys, rkeys, negate=e.negated,
                                n_left=ctx.table.nrows, n_right=rt.nrows)
        return Column("bool", mask)

    def _eval_in_subquery(self, e: A.InSubquery, ctx: EvalCtx) -> Column:
        found = self._find_correlation(e.query, ctx)
        if found is None:
            rt = self._residual_table(("query", e.query))
            rcol = rt[rt.column_names[0]]
            lcol = self.eval_expr(e.expr, ctx)
            lcol2, rcol2 = self._coerce_pair(lcol, rcol)
            mask = E.semi_join_mask([lcol2], [rcol2], negate=e.negated,
                                    n_left=ctx.table.nrows, n_right=rt.nrows)
            if e.negated:
                # ANSI NOT IN: any NULL on the right makes the predicate
                # NULL (never true); a NULL lhs is NULL too
                if rcol2.null_count(rt.nrows) > 0:
                    return Column("bool", torch.zeros(
                        len(lcol2), dtype=torch.bool,
                        device=lcol2.data.device))
                return Column("bool", mask & lcol2.valid_mask())
            return Column("bool", mask)
        corr, stripped, residual = found
        if residual:
            raise ExecError("correlated subquery with non-equality correlation unsupported here")
        sel = stripped.body
        items = [sel.items[0]] + [A.SelectItem(inner, f"_ck{i}")
                                  for i, (_, inner) in enumerate(corr)]
        sub = A.Query(A.Select(items, sel.from_, sel.where, sel.group_by,
                               sel.having, True), [], None, [])
        rt = self._residual_table(("query", sub))
        rcols = [rt[c] for c in rt.column_names]
        lcols = [self.eval_expr(e.expr, ctx)] + \
            [self.eval_expr(outer, ctx) for outer, _ in corr]
        lcols2 = []
        for lc, rc in zip(lcols, rcols):
            lc2, _ = self._coerce_pair(lc, rc)
            lcols2.append(lc2)
        mask = E.semi_join_mask(lcols2, rcols, n_left=ctx.table.nrows,
                                n_right=rt.nrows)
        if not e.negated:
            return Column("bool", mask)
        # ANSI NOT IN per correlation group: a NULL lhs, or any NULL value in
        # the row's matching group, makes the predicate NULL (never true)
        keep = ~mask & lcols2[0].valid_mask() & \
            E.live_mask(ctx.table.plen, ctx.table.nrows)
        val_col = rcols[0]
        n_nulls = val_col.null_count(rt.nrows)
        if n_nulls > 0:
            nullm = ~val_col.valid_mask() & E.live_mask(rt.plen, rt.nrows)
            null_rows = E.compact_indices(nullm, n_nulls)
            null_keys = [c.take(null_rows) for c in rcols[1:]]
            group_has_null = E.semi_join_mask(
                lcols2[1:], null_keys, n_left=ctx.table.nrows, n_right=n_nulls)
            keep = keep & ~group_has_null
        return Column("bool", keep)

    def _eval_scalar_subquery(self, e: A.ScalarSubquery, ctx: EvalCtx) -> Column:
        n = ctx.table.plen
        found = self._find_correlation(e.query, ctx)
        if found is None:
            rt = self._residual_table(("query", e.query))
            col = rt[rt.column_names[0]]
            if isinstance(rt.nrows, E.DeviceCount):
                # LAZY scalar: broadcast row 0 with device-side validity
                # (empty subquery -> NULL via nd >= 1); the "more than one
                # row" error check rides the next batched resolution
                # instead of spending a sync here (q58-class queries pay
                # one per scalar subquery otherwise)
                nd = rt.nrows.dev
                ok = nd >= 1
                if col.valid is not None:
                    ok = ok & col.valid[0]
                data = col.data[0].expand(n)
                valid = ok.expand(n)

                def check(v):
                    if v > 1:
                        raise ExecError(
                            "scalar subquery returned more than one row")

                E.defer_check(rt.nrows, check)
                return Column(col.kind, data, valid, col.dict_values,
                              col.enc)
            n_rt = E.count_int(rt.nrows)     # host semantics: exact count
            if n_rt == 0:
                return X.literal(None, n)
            if n_rt != 1:
                raise ExecError("scalar subquery returned more than one row")
            data = col.data[0].expand(n)
            valid = None
            if col.valid is not None:
                valid = col.valid[0].expand(n)
            return Column(col.kind, data, valid, col.dict_values, col.enc)
        corr, stripped, residual = found
        if residual:
            raise ExecError("correlated subquery with non-equality correlation unsupported here")
        sel = stripped.body
        # grouped-by-correlation-keys aggregate, left-joined back to the outer
        items = [sel.items[0]] + [A.SelectItem(inner, f"_ck{i}")
                                  for i, (_, inner) in enumerate(corr)]
        gexprs = (sel.group_by.exprs if sel.group_by else []) + \
            [inner for _, inner in corr]
        sub = A.Query(A.Select(items, sel.from_, sel.where,
                               A.GroupingSets("plain", [gexprs], gexprs),
                               sel.having, False), [], None, [])
        rt = self._residual_table(("query", sub))
        val_col = rt[rt.column_names[0]]
        rkeys = [rt[c] for c in rt.column_names[1:1 + len(corr)]]
        lkeys = [self.eval_expr(outer, ctx) for outer, _ in corr]
        lkeys = [self._coerce_pair(lc, rc)[0] for lc, rc in zip(lkeys, rkeys)]
        l_idx, r_idx, n_pairs, _, _, _, _ = E.join_indices(
            lkeys, rkeys, "inner", n_left=ctx.table.nrows, n_right=rt.nrows)
        # the subquery was grouped by its correlation keys, so each outer row
        # may match at most once; more than one match means the original
        # subquery was not scalar per outer row
        hits = prim.scatter_add(torch.zeros(n, dtype=torch.int32,
                                            device=l_idx.device), l_idx, 1)
        # pad pairs drop out of the scatter, so max(hits) alone detects a
        # non-scalar subquery; one counted, batch-draining host read
        if E.stream_bounds_on():
            E.stream_overflow(hits.max() > 1)
        elif E.DeviceCount(hits.max(), n).to_int() > 1:
            raise ExecError("correlated scalar subquery returned more than one "
                            "row per outer row")
        dev = l_idx.device
        data = torch.zeros(n, dtype=val_col.data.dtype, device=dev)
        valid = torch.zeros(n, dtype=torch.bool, device=dev)
        data = prim.scatter_set(data, l_idx, prim.take(val_col.data, r_idx))
        valid = prim.scatter_set(valid, l_idx,
                                 prim.take(val_col.valid_mask(), r_idx))
        return Column(val_col.kind, data, valid, val_col.dict_values,
                      val_col.enc)

    def _eval_quantified(self, e: A.QuantifiedCompare, ctx: EvalCtx) -> Column:
        n = ctx.table.plen
        if e.op == "=" and e.quantifier == "any":
            return self._eval_in_subquery(A.InSubquery(e.expr, e.query, False), ctx)
        if e.op == "<>" and e.quantifier == "all":
            return self._eval_in_subquery(A.InSubquery(e.expr, e.query, True), ctx)
        rt = self._residual_table(("query", e.query))
        col = rt[rt.column_names[0]]
        lhs = self.eval_expr(e.expr, ctx)
        if E.count_int(rt.nrows) == 0:
            val = e.quantifier == "all"
            return Column("bool", torch.full((n,), val, dtype=torch.bool,
                                             device=E.device()))
        # live rows reduce into segment 0; pads go to the dropped segment
        gids = torch.where(E.live_mask(rt.plen, rt.nrows), 0,
                           1).to(torch.int64)

        def broadcast(red):
            return Column(red.kind, red.data[0].expand(n),
                          None if red.valid is None
                          else red.valid[0].expand(n),
                          red.dict_values, red.enc)

        if e.op in ("=", "<>"):
            # = ALL: every value equals lhs  <=>  min = lhs AND max = lhs
            # <> ANY: some value differs     <=>  NOT (= ALL)
            mn = broadcast(E.agg_min(col, gids, 1))
            mx = broadcast(E.agg_min(col, gids, 1, is_max=True))
            all_eq = X.logical_and(X.compare("=", lhs, mn),
                                   X.compare("=", lhs, mx))
            return all_eq if e.op == "=" else X.logical_not(all_eq)
        use_max = (e.op in (">", ">=")) == (e.quantifier == "all") or \
                  (e.op in ("<", "<=") and e.quantifier == "any")
        scalar = broadcast(E.agg_min(col, gids, 1, is_max=use_max))
        return X.compare(e.op, lhs, scalar)


_EPOCH64 = np.datetime64("1970-01-01", "D")
