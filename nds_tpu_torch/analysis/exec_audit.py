# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Static execution auditor: the control path of every statement, proved
on the host before the data path runs (the port's copy of the reference's
``analysis/exec_audit.py``).

An abstract interpreter over the planner's decomposition that answers, for
every template, with no device in the loop:

1. **Which path will it take?** ``compiled-stream`` (the chunk pipeline of
   :mod:`nds_tpu_torch.engine.stream`), ``eager-fallback`` (the per-chunk
   loop) or ``device-resident`` (no streamed scan), with reason codes
   mirroring the executor's routing:

   * ``subquery-residual`` — retired from the shipped corpus by multi-pass
     streaming (subquery conjuncts pre-plan into device-resident residuals
     that ride the per-chunk program); kept for foreign corpora;
   * ``chunk-dependent-host-read`` — the streamed graph has unconnected
     components (a cartesian laid out from host row counts);
   * ``outer-join-extras`` — the chunked scan sits on a side of an outer
     join the multi-pass deferral cannot serve (eligible LEFT joins defer
     as ``outer-gather`` / ``outer-build`` and classify compiled);
   * ``accumulator-overflow`` — a bare streamed scan whose accumulator the
     memory model (:class:`mem_audit.MemModel`) cannot prove fits;
   * ``non-invariant-graph`` — a shape outside the modeled forms;
   * ``parse-error`` — the statement did not parse.

2. **How many host syncs can it cost?** A conservative static bound walked
   against the engine's sync-effect model: ``sync_bound`` for the
   statement (None when a scan takes the eager loop, whose cost is
   O(chunks), reported as ``per_chunk``), and per compiled scan the
   steady-state ``gate_bound`` (the pipeline's one materializing sync, its
   SELECT's post-aggregation syncs, the outer-join materializations it
   feeds and one output resolution), gated at :data:`SYNC_BUDGET`.
   One-time record costs are ``first_sight`` and are not gated.

The partition pass, encoded execution, the prefetch ring, fault retries
and trace instrumentation charge nothing: none of them reads the device,
so no bound here moves with them. The sharded pipeline's collective budget
(:data:`COLLECTIVE_CHUNK_BUDGET`, :data:`COLLECTIVE_FINAL_BUDGET`) and the
K4/K5 launch prediction ride each scan verdict.

:class:`analysis.param_audit.ParamAuditor` stands on this classification:
a literal binds only into a compiled streamed scan.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from nds_tpu_torch.analysis import Finding
from nds_tpu_torch.analysis.plan_audit import _single_row_query, type_class
from nds_tpu_torch.queries import (TEMPLATE_DIR, instantiate_template,
                                   list_templates, load_template)
from nds_tpu_torch.schema import (COMPOSITE_PRIMARY_KEYS, PRIMARY_KEYS,
                                  get_schemas)
from nds_tpu_torch.sql import ast as A
from nds_tpu_torch.sql.parser import ParseError, expr_key, parse

# the streamed-path host-sync budget every compiled scan must prove (the
# port's streamed tests hold the runtime to it)
SYNC_BUDGET = 6

# static COLLECTIVE budget of the sharded streamed pipeline
# (NDS_TPU_STREAM_SHARDS > 1, engine/stream.py): per chunk, the only
# collectives are the hash-exchange pass's all-to-alls — at most one per
# uploaded buffer (data + validity per kept column) plus the partition-id
# and validity planes, so <= 2 x scan columns + 2; the widest streamed
# fact (catalog_sales, 34 columns) bounds the corpus at 70. At the single
# materializing sync, ONE cross-shard reduce runs: an all-gather of the
# per-shard counts, a psum of the overflow flags, a psum of the partition
# histogram, and one psum-OR per deferred outer-build bitmap — a fixed
# handful, gated at 8 (+1 per outer build is still far below). The
# per-chunk program itself must contain ZERO collectives (every shard
# works its own rows; builds ride replicated). The runtime counts its
# collectives (StreamEvent.collectives).
COLLECTIVE_CHUNK_BUDGET = 72
COLLECTIVE_FINAL_BUDGET = 8

# >HBM binding model: the catalog tables bound as host-resident
# ChunkedTables at the audited scale (SF10 with NDS_TPU_STREAM_BYTES=1.5e9
# streams exactly these four; session.read_columnar_view decides at load
# from arrow.nbytes, which the audit cannot see — this set is the static
# stand-in and is parameterizable per ExecAuditor).
DEFAULT_STREAMED = ("catalog_sales", "inventory", "store_sales", "web_sales")
# (the corpus: 96 compiled-stream / 7 device-resident / 0 eager-fallback
# — multi-pass streaming retired the subquery-residual and
# outer-join-extras fallbacks; held against the reference's auditor by
# tests/test_torch_param_audit.py)

# descending resident-size rank of the streamable facts: when a graph binds
# several chunked scans the planner streams the LARGEST (by nbytes) and
# binds the others whole; the audit mirrors that choice by SF row weight
_SIZE_RANK = {"store_sales": 4, "catalog_sales": 3, "web_sales": 2,
              "inventory": 1}

CLASS_COMPILED = "compiled-stream"
CLASS_EAGER = "eager-fallback"
CLASS_DEVICE = "device-resident"
CLASS_UNKNOWN = "unknown"

R_SUBQUERY = "subquery-residual"
R_OUTER = "outer-join-extras"
R_CHUNK_READ = "chunk-dependent-host-read"
R_OVERFLOW = "accumulator-overflow"
R_NON_INVARIANT = "non-invariant-graph"
R_PARSE = "parse-error"


@dataclass
class ScanVerdict:
    """The audited fate of one >HBM streamed scan (one join graph binding a
    chunked table)."""

    alias: str                 # FROM alias of the chunked scan
    table: str                 # catalog table name
    compiled: bool             # True = the chunk pipeline serves it
    reasons: tuple = ()        # eager-fallback reason codes (empty if compiled)
    gate_bound: int = 0        # steady-state local sync bound (gated <= 6)
    per_chunk: int = 0         # eager loop: syncs charged PER CHUNK
    first_sight: int = 0       # one-time record/compile extras (not gated)
    mechanisms: tuple = ()     # multi-pass conversions serving this scan
    #                            ("streamed-subquery", "outer-gather",
    #                             "outer-build", "recorded-scalar")
    shards: int = 1            # modeled mesh shard count
    #                            (NDS_TPU_STREAM_SHARDS; 1 = single-device)
    a2a_chunk: int = 0         # collective budget, per chunk: upper bound
    #                            on the exchange pass's all-to-alls (0 =
    #                            no exchange can run — unsharded, or no
    #                            hashable equi keys)
    coll_final: int = 0        # collective budget at the materializing
    #                            sync: the one cross-shard reduce's ops
    kernel_scan_chunk: int = 0  # K4 scan-pass launches per chunk
    #                            (EXACT: 1 iff the shared eligibility
    #                            rule lowers >=1 chunk-local conjunct)
    kernel_stages: int = 0     # fused stages per scan launch (EXACT:
    #                            eligible conjuncts + the routing-hash
    #                            stage) == kernel_fused_stages
    kernel_probe_chunk: int = 0  # UPPER bound on fused join-probe
    #                            launches per chunk-program dispatch
    #                            (the graph's hash batches; the probe
    #                            may decline per batch — f64 keys,
    #                            oversized dimension)


@dataclass
class ExecReport:
    """Classification + sync bound of one template statement."""

    file: str
    query: str
    classification: str
    reasons: tuple = ()
    sync_bound: int | None = None   # statement bound; None = O(chunks)
    per_chunk: int = 0              # eager per-chunk charge (0 if bounded)
    first_sight: int = 0
    scans: tuple = ()               # ScanVerdicts, FROM order
    detail: str = ""

    def to_dict(self) -> dict:
        return {
            "file": self.file, "query": self.query,
            "classification": self.classification,
            "reasons": list(self.reasons),
            "sync_bound": self.sync_bound, "per_chunk": self.per_chunk,
            "first_sight": self.first_sight,
            "scans": [{"alias": s.alias, "table": s.table,
                       "compiled": s.compiled, "reasons": list(s.reasons),
                       "gate_bound": s.gate_bound,
                       "per_chunk": s.per_chunk,
                       "first_sight": s.first_sight,
                       "mechanisms": list(s.mechanisms),
                       "shards": s.shards,
                       "a2a_chunk": s.a2a_chunk,
                       "coll_final": s.coll_final,
                       "kernel_scan_chunk": s.kernel_scan_chunk,
                       "kernel_stages": s.kernel_stages,
                       "kernel_probe_chunk": s.kernel_probe_chunk}
                      for s in self.scans],
            "detail": self.detail,
        }


class _Rel:
    """One relation in a join graph. ``cols`` maps each FROM alias the
    relation answers for to its bare (lowercase) column names — a
    materialized outer join keeps BOTH sides' aliases addressable, exactly
    like the planner's alias-qualified merged columns."""

    __slots__ = ("cols", "classes", "source", "chunked", "single_row",
                 "outer_mech")

    def __init__(self, alias, columns, classes=None, source=None,
                 chunked=False, single_row=False):
        self.cols = {alias.lower(): {c.lower() for c in columns}}
        self.classes = classes or {}
        self.source = source          # pristine base-table name, else None
        self.chunked = chunked
        self.single_row = single_row
        # multi-pass streaming marker: "outer-gather" (deferred probe) /
        # "outer-build" (unmatched-key accumulator) when this rel entered
        # the graph through a deferred LEFT join
        self.outer_mech = None

    @property
    def alias(self) -> str:
        return next(iter(self.cols))

    def owns(self, ref: A.ColumnRef) -> str | None:
        """The bare column name when this relation provides ``ref``."""
        name = ref.name.lower()
        if ref.table:
            t = ref.table.lower()
            cols = self.cols.get(t)
            return name if cols is not None and name in cols else None
        for cols in self.cols.values():
            if name in cols:
                return name
        return None

    def merged_with(self, other: "_Rel") -> "_Rel":
        out = _Rel(self.alias, ())
        out.cols = {**self.cols, **other.cols}
        out.classes = {**self.classes, **other.classes}
        return out


class _Cost:
    """Accumulator for the statement walk: statement-fixed sync bound,
    eager per-chunk charge, one-time extras, and the streamed-scan
    verdicts whose gate bounds grow as downstream costs apply."""

    def __init__(self):
        self.fixed = 0
        self.per_chunk = 0
        self.first_sight = 0
        self.scans: list = []
        self.needed = None               # statement pruning set (mem model)


def _children(e):
    """Direct expression children of an AST expression node (dataclass
    fields that are expressions, or lists/tuples containing them)."""
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
    if isinstance(e, (A.ScalarSubquery, A.InSubquery, A.Exists,
                      A.QuantifiedCompare)):
        return True
    return any(_has_subquery(c) for c in _children(e))


def _subquery_nodes(e) -> list:
    """Top-level subquery nodes of one expression (no descent into a
    found subquery's own body): the residuals the streamed pipeline
    pre-plans for this conjunct, one resolve each."""
    if isinstance(e, (A.ScalarSubquery, A.InSubquery, A.Exists,
                      A.QuantifiedCompare)):
        return [e]
    out = []
    for c in _children(e):
        out.extend(_subquery_nodes(c))
    return out


def _column_refs(e):
    out = []

    def walk(node):
        if isinstance(node, A.ColumnRef):
            out.append(node)
            return
        if isinstance(node, (A.ScalarSubquery, A.InSubquery, A.Exists,
                             A.QuantifiedCompare)):
            return                     # a subquery's refs are its own scope
        for c in _children(node):
            walk(c)
    walk(e)
    return out


def _split_conjuncts(e):
    if isinstance(e, A.BinaryOp) and e.op == "and":
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e] if e is not None else []


def _split_disjuncts(e):
    if isinstance(e, A.BinaryOp) and e.op == "or":
        return _split_disjuncts(e.left) + _split_disjuncts(e.right)
    return [e]


def _fold_bool(op, exprs):
    out = exprs[0]
    for e in exprs[1:]:
        out = A.BinaryOp(op, out, e)
    return out


def _hoist_or_conjuncts(e):
    """Mirror of ``Planner._hoist_or_conjuncts`` (q13/q48/q85: equi keys
    hidden under an OR of conjunctions), compared by ``expr_key`` so the
    audit factors exactly what the planner factors."""
    if not (isinstance(e, A.BinaryOp) and e.op == "or"):
        return [e]
    conj_lists = [_split_conjuncts(d) for d in _split_disjuncts(e)]
    keys = [{expr_key(c) for c in dl} for dl in conj_lists]
    common = [c for c in conj_lists[0]
              if all(expr_key(c) in ks for ks in keys[1:])]
    if not common:
        return [e]
    common_keys = {expr_key(c) for c in common}
    rests = []
    for dl in conj_lists:
        rest = [c for c in dl if expr_key(c) not in common_keys]
        if not rest:
            return common
        rests.append(_fold_bool("and", rest))
    return common + [_fold_bool("or", rests)]


def _conjuncts_of(e):
    return [h for c in _split_conjuncts(e) for h in _hoist_or_conjuncts(c)]


class ExecAuditor:
    """Host-only abstract interpreter over the planner's decomposition.

    ``catalog`` maps table name -> {bare column -> type class}; default is
    the full TPC-DS schema. ``streamed`` names the tables bound as >HBM
    ChunkedTables (the binding model); ``base_tables`` carry schema
    guarantees (PK uniqueness for gather joins) — default: every catalog
    table, matching a session that loads them as base scans."""

    def __init__(self, catalog: dict | None = None,
                 streamed=None, base_tables=None, mem_model=None):
        if catalog is None:
            catalog = {
                t: {f.name.lower(): type_class(f.type) for f in fields}
                for t, fields in get_schemas(use_decimal=True).items()}
        self.catalog = catalog
        self.streamed = set(DEFAULT_STREAMED if streamed is None
                            else streamed)
        self.base_tables = set(catalog if base_tables is None
                               else base_tables)
        if mem_model is None:
            # lazy: mem_audit imports this module's AST helpers at top
            from nds_tpu_torch.analysis.mem_audit import MemModel
            mem_model = MemModel()
        self.mem = mem_model

    # -- entry points -------------------------------------------------------

    def audit_sql(self, sql: str, file: str = "<sql>",
                  query: str = "<sql>") -> ExecReport:
        """Classify one SQL statement and bound its host syncs."""
        try:
            stmt = parse(sql)
        except ParseError as e:
            return ExecReport(file, query, CLASS_UNKNOWN, (R_PARSE,),
                              detail=str(e))
        cost = _Cost()
        # the statement's referenced-column set (planner projection
        # pushdown mirror): the accumulator-fit test below prices only
        # the columns a bare streamed scan would actually upload
        from nds_tpu_torch.analysis.mem_audit import statement_needed_names
        cost.needed = statement_needed_names(
            stmt, {t: list(cols) for t, cols in self.catalog.items()})
        env = {name: (set(cols), name in self.base_tables)
               for name, cols in self.catalog.items()}
        try:
            if isinstance(stmt, A.Query):
                self._audit_query(stmt, env, None, cost)
            elif isinstance(stmt, (A.InsertInto, A.CreateTempView)):
                self._audit_query(stmt.query, env, None, cost)
            elif isinstance(stmt, A.DeleteFrom):
                return ExecReport(file, query, CLASS_DEVICE,
                                  sync_bound=1,
                                  detail="DML: device-resident delete")
            else:
                return ExecReport(file, query, CLASS_UNKNOWN,
                                  (R_NON_INVARIANT,),
                                  detail=f"unmodeled statement "
                                         f"{type(stmt).__name__}")
        except RecursionError:                      # pathological nesting
            return ExecReport(file, query, CLASS_UNKNOWN,
                              (R_NON_INVARIANT,), detail="recursion limit")
        # the one output resolution every statement pays (collect() /
        # ORDER BY+LIMIT shaping; batched with any still-lazy counts)
        cost.fixed += 1
        for s in cost.scans:
            if s.compiled:
                s.gate_bound += 1
        if not cost.scans:
            classification = CLASS_DEVICE
        elif all(s.compiled for s in cost.scans):
            classification = CLASS_COMPILED
        else:
            classification = CLASS_EAGER
        reasons = []
        for s in cost.scans:
            for r in s.reasons:
                if r not in reasons:
                    reasons.append(r)
        return ExecReport(
            file, query, classification, tuple(reasons),
            sync_bound=cost.fixed if cost.per_chunk == 0 else None,
            per_chunk=cost.per_chunk, first_sight=cost.first_sight,
            scans=tuple(cost.scans))

    # -- query / set-expression walk ---------------------------------------

    def _audit_query(self, q: A.Query, env: dict, outer, cost: _Cost):
        """Walk one query expression; returns its output column names."""
        env = dict(env)
        for cname, cq in q.ctes:
            out = self._audit_query(cq, env, outer, cost)
            # a CTE result is a device table whatever it scanned; it may
            # SHADOW a chunked catalog name (the planner resolves CTEs
            # first, so the statement does not stream the shadowed table)
            env[cname.lower()] = (set(out), False)
        return self._audit_body(q.body, env, outer, cost)
        # ORDER BY / LIMIT: lexsort is device-side and LIMIT's count
        # resolution batches into the output read — no extra charge

    def _audit_body(self, body, env: dict, outer, cost: _Cost):
        if isinstance(body, A.SetOp):
            left = self._audit_body(body.left, env, outer, cost)
            self._audit_body(body.right, env, outer, cost)
            if body.op == "union_all":
                # concat_tables resolves every branch's lazy count in one
                # batched transfer
                cost.fixed += 1
            elif body.op == "union":
                cost.fixed += 2          # concat resolve + distinct grouping
            else:
                # intersect/except: distinct grouping + null-safe semi
                # probe (generic multi-key path sizes candidate pairs)
                cost.fixed += 2
            return left
        if isinstance(body, A.Query):
            return self._audit_query(body, env, outer, cost)
        return self._audit_select(body, env, outer, cost)

    # -- SELECT -------------------------------------------------------------

    def _audit_select(self, sel: A.Select, env: dict, outer,
                      cost: _Cost) -> list:
        where = _conjuncts_of(sel.where)
        local_scans: list = []
        parts, preds = self._flatten_from(sel.from_, env, outer, where,
                                          cost, local_scans)
        scope = (parts, env, outer)
        if parts or where:
            self._audit_graph(parts, preds, where, scope, cost,
                              local_scans, outer_ctx=False)
        # subqueries outside the WHERE (scalar subqueries in the
        # projection — the q9 shape — and in HAVING/GROUP BY) execute
        # during this statement: their plans charge the walk too
        for item in sel.items:
            self._audit_expr_subqueries(item.expr, scope, cost)
        if sel.having is not None:
            self._audit_expr_subqueries(sel.having, scope, cost)
        # post-FROM sync charges (ops.py sync-effect model):
        post = 0
        if sel.group_by is not None:
            post += 1                    # group_ids' batched count resolve
            if len(sel.group_by.exprs) > 1:
                post += 1                # packed-plan key-range probe
        # keyless aggregates (no GROUP BY) ride device validity: no charge
        if sel.distinct:
            post += 1                    # distinct = one more grouping
        cost.fixed += post
        for s in local_scans:
            if s.compiled:
                s.gate_bound += post
        return self._projected_names(sel, parts)

    def _projected_names(self, sel: A.Select, parts) -> list:
        out = []
        for i, item in enumerate(sel.items):
            if isinstance(item.expr, A.Star):
                qual = item.expr.table and item.expr.table.lower()
                for p in parts:
                    for alias, cols in p.cols.items():
                        if qual is None or alias == qual:
                            out.extend(sorted(cols))
                continue
            if item.alias:
                out.append(item.alias.lower())
            elif isinstance(item.expr, A.ColumnRef):
                out.append(item.expr.name.lower())
            else:
                out.append(f"_c{i}")
        return out

    # -- FROM flattening (mirror of Planner._flatten_from) ------------------

    def _flatten_from(self, node, env: dict, outer, where: list,
                      cost: _Cost, local_scans: list, top: bool = True):
        if node is None:
            return [], []
        if isinstance(node, A.TableRef):
            name = node.name.lower()
            alias = (node.alias or node.name).lower()
            cols, is_base = env.get(name, (set(), False))
            chunked = is_base and name in self.streamed
            classes = self.catalog.get(name, {}) if is_base else {}
            rel = _Rel(alias, cols, classes,
                       source=name if is_base else None, chunked=chunked)
            return [rel], []
        if isinstance(node, A.SubqueryRef):
            out = self._audit_query(node.query, env, outer, cost)
            return [_Rel(node.alias, out,
                         single_row=_single_row_query(node.query))], []
        if isinstance(node, A.Join):
            if node.kind in ("cross", "inner"):
                lp, lj = self._flatten_from(node.left, env, outer, where,
                                            cost, local_scans, top=False)
                rp, rj = self._flatten_from(node.right, env, outer, where,
                                            cost, local_scans, top=False)
                return lp + rp, lj + rj + _conjuncts_of(node.condition)
            # outer/semi/anti join: each side is its own join graph,
            # materialized whole before the join — WHERE conjuncts owned
            # by the null-preserving side push below it first. A LEFT
            # join with a chunked side may instead DEFER into the
            # streamed graph (multi-pass mechanisms b1/b2, mirroring
            # Planner._flatten_from): the sides' rels then join the
            # enclosing graph with the ON conjuncts as ordinary edges.
            lp, lj = self._flatten_from(node.left, env, outer, where,
                                        cost, local_scans, top=False)
            deferred = self._deferred_left(node, lp, lj, env, outer,
                                           where, cost, local_scans, top)
            if deferred is not None:
                return deferred
            lw = self._consume_pushable(where, lp) \
                if node.kind == "left" else []
            self._audit_graph(lp, lj, lw, (lp, env, outer), cost,
                              local_scans, outer_ctx=True)
            rp, rj = self._flatten_from(node.right, env, outer, where,
                                        cost, local_scans, top=False)
            return self._finish_outer(node, lp, rp, rj, env, outer, where,
                                      cost, local_scans)
        if isinstance(node, A.Query):        # parenthesized join tree
            return self._flatten_from(getattr(node.body, "from_", None),
                                      env, outer, where, cost, local_scans)
        return [], []

    def _finish_outer(self, node, lp, rp, rj, env, outer, where, cost,
                      local_scans):
        """The materialize-both-sides completion of one outer/semi/anti
        join (the right side already flattened; the left side already
        audited)."""
        rw = self._consume_pushable(where, rp) \
            if node.kind == "right" else []
        self._audit_graph(rp, rj, rw, (rp, env, outer), cost,
                          local_scans, outer_ctx=True)
        join_cost = self._binary_join_cost(node, lp, rp, cost)
        # every streamed scan flattened so far in this SELECT feeds (or
        # conservatively precedes) this materialized join: its result
        # rides through the join's syncs on the way to the output
        for s in local_scans:
            if s.compiled:
                s.gate_bound += join_cost
        sides = lp + rp
        if not sides:
            return [], []
        merged = sides[0]
        for p in sides[1:]:
            merged = merged.merged_with(p)
        merged.single_row = False
        merged.chunked = False
        merged.source = None
        return [merged], []

    def _deferred_left(self, node, lp, lj, env, outer, where, cost,
                       local_scans, top):
        """Mirror of the planner's multi-pass LEFT-join deferral
        (``Planner._flatten_from`` mechanisms b1/b2): returns the merged
        ``(parts, preds)`` when the join defers into the streamed graph,
        the completed materialize-path result when a side had to be
        flattened to decide (no double audit), or None when the
        pre-checks already exclude deferral (caller runs today's path).
        ``top`` mirrors the planner's whole-FROM requirement for the
        outer-build deferral."""
        if node.kind != "left" or node.condition is None:
            return None
        conjs = _conjuncts_of(node.condition)
        if not conjs or any(_has_subquery(c) for c in conjs):
            return None

        def plain_pairs(rel):
            """(left key, right key) bare names per conjunct when every
            conjunct is a plain cross-side equi pair against ``rel``."""
            out = []
            for c in conjs:
                if not (isinstance(c, A.BinaryOp) and c.op == "=" and
                        isinstance(c.left, A.ColumnRef) and
                        isinstance(c.right, A.ColumnRef)):
                    return None
                rk = rel.owns(c.left)
                lk_ref = c.right
                if rk is None:
                    rk = rel.owns(c.right)
                    lk_ref = c.left
                if rk is None:
                    return None
                if not any(p.owns(lk_ref) for p in lp):
                    return None
                out.append((lk_ref, rk))
            return out

        l_chunk = any(p.chunked for p in lp)
        if l_chunk:
            # mechanism (b1): preserved chunk side — right must be one
            # pristine scan whose ON keys are exactly its (composite) PK
            rp, rj = self._flatten_from(node.right, env, outer, where,
                                        cost, local_scans, top=False)
            eligible = len(rp) == 1 and not rj and rp[0].source and \
                not rp[0].chunked
            if eligible:
                pairs = plain_pairs(rp[0])
                pk = COMPOSITE_PRIMARY_KEYS.get(rp[0].source)
                if pk is None and rp[0].source in PRIMARY_KEYS:
                    pk = (PRIMARY_KEYS[rp[0].source],)
                eligible = pairs is not None and pk is not None and \
                    {rk for (_lr, rk) in pairs} == set(pk)
                if eligible and len(pk) > 1 and any(
                        rp[0].classes.get(k) != "num" for k in pk):
                    eligible = False     # composite pack is int-only
            if eligible:
                rp[0].outer_mech = "outer-gather"
                return lp + rp, lj + conjs
            # ineligible after flattening: the planner's materialize
            # path, reusing the flattened right side
            lw = self._consume_pushable(where, lp)
            self._audit_graph(lp, lj, lw, (lp, env, outer), cost,
                              local_scans, outer_ctx=True)
            return self._finish_outer(node, lp, rp, rj, env, outer,
                                      where, cost, local_scans)
        # mechanism (b2): null-introducing chunk side — single device
        # part on the left (the build side, materialized first with its
        # pushed WHERE conjuncts), single chunked scan on the right, the
        # join being the SELECT's whole FROM, and no remaining WHERE
        # conjunct at all (post-join structure would need the extras,
        # emitted only at materialize, to flow through it)
        if len(lp) != 1 or lp[0].chunked:
            return None
        lw = self._consume_pushable(where, lp)
        rp, rj = self._flatten_from(node.right, env, outer, where, cost,
                                    local_scans, top=False)
        eligible = top and len(rp) == 1 and not rj and rp[0].chunked \
            and not (where or [])
        if eligible:
            pairs = plain_pairs(rp[0])
            eligible = pairs is not None
        if eligible:
            lp[0].outer_mech = "outer-build"
            lp[0].single_row = False
            return rp + lp, lj + conjs
        # fall back: audit the build side as its own (device) graph and
        # finish with the materialize path
        self._audit_graph(lp, lj, lw, (lp, env, outer), cost,
                          local_scans, outer_ctx=True)
        return self._finish_outer(node, lp, rp, rj, env, outer, where,
                                  cost, local_scans)

    def _binary_join_cost(self, node: A.Join, lp, rp, cost: _Cost) -> int:
        """Sync charge of one materialized (outer/semi/anti) binary join.

        LEFT joins whose ON keys cover the right side's declared
        (composite) primary key run as exact merge-probe gathers — no pair
        sizing, no extras resolution, zero steady-state syncs (the
        dimension span plan is identity-cached; first sight pays one
        fused range read). Everything else pays the hash probe's
        candidate-total sync plus one batched extras resolution."""
        conjuncts = _conjuncts_of(node.condition)
        if node.kind == "left" and len(rp) == 1 and rp[0].source:
            src = rp[0].source
            pk = COMPOSITE_PRIMARY_KEYS.get(src)
            if pk is None and src in PRIMARY_KEYS:
                pk = (PRIMARY_KEYS[src],)
            if pk is not None:
                rkeys = set()
                for c in conjuncts:
                    if isinstance(c, A.BinaryOp) and c.op == "=" and \
                            isinstance(c.left, A.ColumnRef) and \
                            isinstance(c.right, A.ColumnRef):
                        for ref in (c.left, c.right):
                            got = rp[0].owns(ref)
                            if got:
                                rkeys.add(got)
                if rkeys == set(pk):
                    cost.first_sight += 1        # dim span/range plan
                    return 0
        if node.kind in ("semi", "anti"):
            # single integer-comparable key takes the sort-probe (0);
            # charge the generic candidate-sizing sync conservatively
            charge = 1
        else:
            charge = 2                   # probe total + batched extras
        cost.fixed += charge
        return charge

    def _consume_pushable(self, where: list, parts) -> list:
        """Mirror of ``Planner._consume_pushable``: remove (in place) and
        return the subquery-free conjuncts whose every column reference
        resolves within ``parts``."""
        taken = []
        for c in list(where):
            if _has_subquery(c):
                continue
            refs = _column_refs(c)
            if refs and all(any(p.owns(r) for p in parts) for r in refs):
                taken.append(c)
                where.remove(c)
        return taken

    # -- join-graph audit (mirror of Planner._join_parts routing) -----------

    def _owners(self, c, parts) -> set:
        """Indexes of the graph parts a conjunct references (refs that
        resolve only in outer scopes — correlation — own nothing here,
        matching ``Planner._expr_tables`` over the parts' columns)."""
        owners = set()
        for ref in _column_refs(c):
            for i, p in enumerate(parts):
                if p.owns(ref):
                    owners.add(i)
                    break                # planner takes the first match
        return owners

    def _equi_edge(self, c, parts):
        """(li, ri) when the conjunct is an equi edge the planner would
        join on: a plain ``col = col`` across two parts, or an
        expression-equi conjunct whose sides each live wholly in one
        distinct part (``Planner._synthetic_edge``)."""
        if not (isinstance(c, A.BinaryOp) and c.op == "="):
            return None
        if isinstance(c.left, A.ColumnRef) and \
                isinstance(c.right, A.ColumnRef):
            li = ri = None
            for i, p in enumerate(parts):
                if li is None and p.owns(c.left):
                    li = i
                if ri is None and p.owns(c.right):
                    ri = i
            if li is not None and ri is not None and li != ri:
                return li, ri, c
            return None

        def side_owner(e):
            refs = _column_refs(e)
            if not refs:
                return None
            owner = None
            for r in refs:
                cands = [i for i, p in enumerate(parts) if p.owns(r)]
                if len(cands) != 1:
                    return None
                if owner is None:
                    owner = cands[0]
                elif owner != cands[0]:
                    return None
            return owner

        li, ri = side_owner(c.left), side_owner(c.right)
        if li is not None and ri is not None and li != ri:
            return li, ri, c
        return None

    def _pk_batch(self, parts, a, b, edge_conjs):
        """Dim-side part index when the (a, b) edge batch qualifies for the
        PK gather join (``Planner._pk_gather_plan``): the dimension side's
        bare key-name set is exactly its declared primary key, on a
        pristine base-table scan; composite keys must be numeric to pack."""
        for fact, dim in ((a, b), (b, a)):
            src = parts[dim].source
            if not src:
                continue
            pk = COMPOSITE_PRIMARY_KEYS.get(src)
            if pk is None and src in PRIMARY_KEYS:
                pk = (PRIMARY_KEYS[src],)
            if pk is None:
                continue
            dks = set()
            for (li, ri, c) in edge_conjs:
                side = c.right if ri == dim else c.left
                if not isinstance(side, A.ColumnRef):
                    dks = None
                    break
                got = parts[dim].owns(side)
                if got is None:
                    dks = None
                    break
                dks.add(got)
            if dks != set(pk):
                continue
            if len(pk) > 1 and any(parts[dim].classes.get(k) != "num"
                                   for k in pk):
                continue
            return dim
        return None

    def _audit_graph(self, parts, preds, where, scope, cost: _Cost,
                     local_scans: list, outer_ctx: bool) -> list:
        """Audit one ``_join_parts`` invocation; returns the ScanVerdicts
        it created (appended to ``cost.scans`` and ``local_scans``)."""
        conjuncts = list(preds) + list(where)
        filters = [[] for _ in parts]
        edges = []                       # (li, ri, conjunct)
        residual = []
        subq = []
        subq_cost = _Cost()
        for c in conjuncts:
            if _has_subquery(c):
                subq.append(c)
                self._audit_expr_subqueries(c, scope, subq_cost)
                continue
            owners = self._owners(c, parts)
            if len(owners) == 1:
                filters[owners.pop()].append(c)
                continue
            edge = self._equi_edge(c, parts)
            if edge:
                edges.append(edge)
            else:
                residual.append(c)

        # union-find over parts: components joined by equi edges; the
        # planner cartesians the leftover slots
        parent = list(range(len(parts)))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        batches: dict = {}               # sorted part pair -> [edges]
        for (li, ri, c) in edges:
            batches.setdefault(tuple(sorted((li, ri))), []).append(
                (li, ri, c))
        for (a, b) in batches:
            parent[find(a)] = find(b)
        ncomp = len({find(i) for i in range(len(parts))}) if parts else 0
        n_cart = max(ncomp - 1, 0)
        pk_dims = []
        hash_batches = 0
        for (a, b), ec in batches.items():
            dim = self._pk_batch(parts, a, b, ec)
            if dim is not None and not parts[dim].chunked:
                # chunked dim side is masked by the executor (its key
                # ranges would bake chunk data into the program): that
                # batch takes the hash arm
                pk_dims.append(dim)
            else:
                hash_batches += 1

        chunked_idx = [i for i, p in enumerate(parts) if p.chunked]
        if not chunked_idx:
            # device-resident graph: hash probes sync for their candidate
            # totals; PK gathers ride identity-cached host plans (first
            # sight builds them); cartesians resolve both counts batched
            cost.fixed += hash_batches + n_cart + subq_cost.fixed
            cost.per_chunk += subq_cost.per_chunk
            cost.first_sight += len(pk_dims) + subq_cost.first_sight
            cost.scans.extend(subq_cost.scans)
            return []

        # streamed graph: mirror stream_execute's eligibility
        keep = max(chunked_idx,
                   key=lambda i: (_SIZE_RANK.get(parts[i].source, 0), -i))
        reasons = []
        mechanisms = []
        if subq:
            # multi-pass streaming, mechanism (a): subquery conjuncts
            # pre-plan their inner tables into device-resident RESIDUALS
            # (recorded/driven as ordinary operands), so they no
            # longer break the chunk-invariant trace — the conjunct
            # reduces to a device-side membership/compare mask per chunk
            mechanisms.append("streamed-subquery")
            if any(isinstance(nq, A.InSubquery) and nq.negated
                   for c in subq for nq in _subquery_nodes(c)):
                # ANSI NOT IN consults the residual's null count: a
                # recorded scalar with a device-side staleness guard
                # (mechanism c)
                mechanisms.append("recorded-scalar")
        for p in parts:
            if p.outer_mech and p.outer_mech not in mechanisms:
                mechanisms.append(p.outer_mech)
        if ncomp > 1:
            reasons.append(R_CHUNK_READ)
        incident = any(keep in (li, ri) for (li, ri, _c) in edges) or \
            bool(filters[keep]) or \
            any(keep in self._owners(c, parts) for c in residual + subq)
        if not incident:
            if outer_ctx:
                reasons.append(R_OUTER)
            elif not self.mem.bare_scan_fits(parts[keep].source,
                                             cost.needed):
                # the survivor accumulator keeps every chunk row and the
                # memory proof cannot admit it — overflow rerun at scale.
                # A bare scan whose proven bound FITS streams compiled:
                # the runtime sizes the accumulator from the same proof.
                reasons.append(R_OVERFLOW)
        compiled = not reasons

        verdicts = []
        if compiled:
            # pipeline steady state: ONE materializing sync (count +
            # overflow flag + outer-extras counts in the same transfer);
            # the upfront part-count resolve batches counts the statement
            # owed anyway. Record-phase dimension plan reads ride the
            # replay log: first-sight only. Each subquery residual is
            # re-planned per execution — its table resolves once (the
            # inner plan's own costs are subq_cost).
            n_resid = sum(len(_subquery_nodes(c)) for c in subq)
            shards, a2a_chunk, coll_final = self._collective_budget(
                parts, keep, conjuncts, cost)
            k_scan, k_stages, k_probe = self._kernel_budget(
                parts, keep, filters[keep], conjuncts, mechanisms,
                hash_batches, len(subq), cost)
            v = ScanVerdict(parts[keep].alias, parts[keep].source or "?",
                            True, (), gate_bound=1,
                            first_sight=len(pk_dims) + 1,
                            mechanisms=tuple(mechanisms),
                            shards=shards, a2a_chunk=a2a_chunk,
                            coll_final=coll_final,
                            kernel_scan_chunk=k_scan,
                            kernel_stages=k_stages,
                            kernel_probe_chunk=k_probe)
            cost.fixed += 1 + subq_cost.fixed + n_resid
            cost.first_sight += v.first_sight + subq_cost.first_sight
        else:
            # eager chunk loop: every chunk re-plans the graph — each
            # hash batch pays its probe sync and each cartesian its
            # layout resolve PER CHUNK; subquery predicates re-evaluate
            # per chunk too. One final batched resolve concatenates the
            # surviving chunks.
            per_chunk = hash_batches + n_cart + \
                subq_cost.fixed + subq_cost.per_chunk
            v = ScanVerdict(parts[keep].alias, parts[keep].source or "?",
                            False, tuple(reasons), per_chunk=per_chunk,
                            first_sight=len(pk_dims),
                            mechanisms=tuple(mechanisms))
            cost.fixed += 1
            cost.per_chunk += per_chunk
            cost.first_sight += len(pk_dims) + subq_cost.first_sight
        cost.scans.extend(subq_cost.scans)
        cost.scans.append(v)
        local_scans.append(v)
        verdicts.append(v)
        # further chunked parts bind whole (one streaming axis per graph)
        for i in chunked_idx:
            if i != keep:
                w = ScanVerdict(parts[i].alias, parts[i].source or "?",
                                compiled, v.reasons,
                                gate_bound=v.gate_bound,
                                per_chunk=v.per_chunk,
                                mechanisms=v.mechanisms)
                cost.scans.append(w)
                local_scans.append(w)
                verdicts.append(w)
        return verdicts

    def _kernel_budget(self, parts, keep, chunk_filters, conjuncts,
                       mechanisms, hash_batches, n_subq, cost):
        """``(kernel_scan_chunk, kernel_stages, kernel_probe_chunk)`` of
        one compiled streamed scan: the static prediction of the K4 scan
        pass and the K5 probes (every kernel pass is device-only and moves
        no sync bound).

        The scan-pass prediction is exact by construction: eligibility is
        the one shared rule (``analysis/kernel_spec.eligible_conjunct``)
        the runtime lowering applies to the same chunk-local conjuncts,
        and the hash stage mirrors the executor's partition trigger
        (forced count + hashable equi keys surviving the column pruning).
        The port lowers a K4 spec on every device (the reference only
        under an explicit Pallas mode), so the prediction is always live.
        Outer-join graphs keep every conjunct in the graph (the executor
        never splits their pre/post conjuncts), mirrored here."""
        # probe bound: every bound-bucket join in the per-chunk program
        # may take the fused probe — the plain hash batches, plus one
        # per deferred outer-BUILD (its matched-pair inner join probes
        # per dispatch) and one per subquery conjunct (a residual pair
        # probe, the q16-class EXISTS shape)
        n_builds = sum(1 for p in parts if p.outer_mech == "outer-build")
        probe = hash_batches + n_builds + n_subq
        if any(m in ("outer-gather", "outer-build") for m in mechanisms):
            return 0, 0, probe
        from nds_tpu_torch.analysis.kernel_spec import count_eligible
        rel = parts[keep]

        def class_of(ref):
            bare = rel.owns(ref)
            return None if bare is None else rel.classes.get(bare)

        n = count_eligible(chunk_filters, class_of)
        if n == 0:
            return 0, 0, probe
        # hash stage: the executor attaches key slots when the pipeline
        # partitions (forced count + stream_partition_keys surviving
        # projection pruning) — same rule shape as _collective_budget
        from nds_tpu_torch.analysis.mem_audit import (forced_partitions,
                                                      stream_partition_keys)
        hash_stage = 0
        forced = forced_partitions()
        if forced is not None and forced > 1:
            part_cols = [{c for cols in p.cols.values() for c in cols}
                         for p in parts]
            sources = [p.source for p in parts]
            keys = stream_partition_keys(part_cols, sources, keep,
                                         conjuncts)
            if keys and (cost.needed is None
                         or all(k in cost.needed for k in keys)):
                hash_stage = 1
        return 1, n + hash_stage, probe

    def _collective_budget(self, parts, keep, conjuncts, cost):
        """``(shards, a2a_chunk, coll_final)`` of one compiled streamed
        scan — the static collective budget of the sharded pipeline
        (``NDS_TPU_STREAM_SHARDS``; all zeros when unsharded).

        ``a2a_chunk`` is an UPPER bound on the per-chunk exchange pass's
        all-to-alls: the pass MAY run only when the graph has hashable
        equi keys on the streamed slot (``stream_partition_keys`` — the
        same predicate the executor's partition/exchange trigger uses),
        and it exchanges at most every uploaded buffer (data + validity
        per pruned column) plus the partition-id and validity planes.
        ``coll_final`` bounds the one cross-shard materialize reduce:
        count all-gather + overflow psum + histogram psum + one psum-OR
        per deferred outer-build bitmap. The per-chunk program itself is
        collective-free by construction; the runtime counts every
        explicit collective it issues (``StreamEvent.collectives``), which
        stays within ``a2a_chunk x chunks + coll_final``."""
        from nds_tpu_torch.analysis.mem_audit import (stream_partition_keys,
                                                      stream_shards)
        shards = stream_shards()
        if shards <= 1:
            return 1, 0, 0
        part_cols = [{c for cols in p.cols.values() for c in cols}
                     for p in parts]
        sources = [p.source for p in parts]
        keys = stream_partition_keys(part_cols, sources, keep, conjuncts)
        source = parts[keep].source or ""
        cols = self.catalog.get(source, {})
        n_cols = len(cols) or 1
        if cost.needed is not None and cols:
            kept = {c for c in cols if c in cost.needed}
            if kept and len(kept) < len(cols):
                n_cols = len(kept)
        a2a_chunk = (2 * n_cols + 2) if keys else 0
        n_builds = sum(1 for p in parts if p.outer_mech == "outer-build")
        return shards, a2a_chunk, 3 + n_builds

    # -- subqueries inside expressions --------------------------------------

    def _audit_expr_subqueries(self, e, scope, cost: _Cost) -> None:
        """Charge every subquery nested in one expression: the subquery's
        own plan cost plus its membership-probe cost. Single-key integer
        IN/NOT IN takes the sort probe (sync-free, DESIGN.md item 2);
        generic quantified compares pay the candidate-sizing sync.
        Scalar subqueries defer their one-row check into the batched
        resolution (0)."""
        parts, env, outer = scope

        def walk(node):
            if isinstance(node, A.InSubquery):
                self._audit_query(node.query, env, scope, cost)
                if not isinstance(node.expr, A.ColumnRef):
                    cost.fixed += 1
                walk_children(node.expr)
                return
            if isinstance(node, A.ScalarSubquery):
                self._audit_query(node.query, env, scope, cost)
                return
            if isinstance(node, (A.Exists, A.QuantifiedCompare)):
                self._audit_query(node.query, env, scope, cost)
                cost.fixed += 1
                if isinstance(node, A.QuantifiedCompare):
                    walk_children(node.expr)
                return
            walk_children(node)

        def walk_children(node):
            for c in _children(node):
                walk(c)

        walk(e)


# ---------------------------------------------------------------------------
# corpus driver + lint-gate findings
# ---------------------------------------------------------------------------

# pinned instantiation seed, shared with plan_audit: classifications must
# not depend on sampled parameter values, and a fixed seed keeps the gate
# and the report deterministic either way
_AUDIT_SEED = 20260803


def audit_exec_template_text(text: str, file: str,
                             auditor: ExecAuditor | None = None) -> list:
    """Instantiate one template (pinned seed) and audit each statement;
    returns ExecReports."""
    auditor = auditor or ExecAuditor()
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


def audit_exec_corpus(template_dir: str | None = None,
                      streamed=None) -> list:
    """ExecReports for every template in templates.lst order."""
    template_dir = template_dir or TEMPLATE_DIR
    auditor = ExecAuditor(streamed=streamed)
    reports: list = []
    for name in list_templates(template_dir):
        reports.extend(audit_exec_template_text(
            load_template(name, template_dir), name, auditor))
    return reports


def reports_to_findings(reports) -> list:
    """Lint-gate findings from exec reports: a streamable (compiled) scan
    whose steady-state gate bound exceeds the budget is an error — the
    compiled pipeline would hold >6 syncs per execution, which is exactly
    the regression the streamed-path budget forbids. Classifications
    themselves are a report, not findings."""
    findings = []
    for r in reports:
        for s in r.scans:
            if s.compiled and s.gate_bound > SYNC_BUDGET:
                findings.append(Finding(
                    r.file, r.query, "stream-sync-budget", "error",
                    f"streamed scan {s.table!r} has a static sync bound of "
                    f"{s.gate_bound} (> {SYNC_BUDGET}): the compiled "
                    "pipeline would exceed the streamed-path budget every "
                    "execution"))
            if s.compiled and s.shards > 1 and (
                    s.a2a_chunk > COLLECTIVE_CHUNK_BUDGET
                    or s.coll_final > COLLECTIVE_FINAL_BUDGET
                    + sum(1 for m in s.mechanisms if m == "outer-build")):
                findings.append(Finding(
                    r.file, r.query, "collective-budget", "error",
                    f"streamed scan {s.table!r} has a static collective "
                    f"budget of {s.a2a_chunk}/chunk + {s.coll_final} at "
                    f"materialize (> {COLLECTIVE_CHUNK_BUDGET}/"
                    f"{COLLECTIVE_FINAL_BUDGET}): the sharded pipeline "
                    "would pay more than one exchange per chunk or more "
                    "than the single cross-shard reduce"))
    return findings


def exec_audit_findings(template_dir: str | None = None) -> list:
    """Findings of the whole corpus (the reference's lint pass)."""
    return reports_to_findings(audit_exec_corpus(template_dir))


def format_stream_report(reports) -> str:
    """The per-template classification table (the reference's
    ``--stream-report``): the worklist for widening streamability."""
    lines = ["# exec-audit: per-template execution-path classification",
             f"# binding model: chunked = {', '.join(DEFAULT_STREAMED)}",
             f"{'template':<18} {'class':<16} {'bound':>6}  detail"]
    counts: dict = {}
    for r in reports:
        counts[r.classification] = counts.get(r.classification, 0) + 1
        if r.sync_bound is not None:
            bound = str(r.sync_bound)
        else:
            bound = f"~{r.per_chunk}/ch"
        bits = []
        for s in r.scans:
            if s.compiled:
                mech = f" [{','.join(s.mechanisms)}]" if s.mechanisms \
                    else ""
                shard = f" S={s.shards} coll<={s.a2a_chunk}/ch+" \
                    f"{s.coll_final}" if s.shards > 1 else ""
                bits.append(f"{s.table}: compiled{mech} "
                            f"gate={s.gate_bound}"
                            f"(+{s.first_sight} first-sight){shard}")
            else:
                bits.append(f"{s.table}: eager [{','.join(s.reasons)}] "
                            f"{s.per_chunk}/chunk")
        if not bits and r.reasons:
            bits.append(",".join(r.reasons))
        lines.append(f"{r.query:<18} {r.classification:<16} {bound:>6}  "
                     + "; ".join(bits))
    summary = ", ".join(f"{k}: {v}" for k, v in sorted(counts.items()))
    lines.append(f"# {len(reports)} statements — {summary}")
    return "\n".join(lines)
