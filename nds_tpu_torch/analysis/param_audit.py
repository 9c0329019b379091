# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Parameterization auditor: literal-bindability proofs over the corpus
(the port's copy of the reference's ``analysis/param_audit.py``).

NDS Throughput streams run the same 99 templates with other literal
values. A literal that can ride as a runtime operand of the one captured
per-chunk program lets K parameter vectors of a template share one
pipeline build and one capture instead of K. This module says which
literals can.

A literal occurrence is **BINDABLE** when binding it leaves every part of
the cached pipeline invariant to its value: it lives in a WHERE conjunct
owned solely by the streamed alias (so its evaluation is device work over
chunk columns, recorded under stream bounds, and no recorded host read can
embed it); chunk shapes and codecs are fixed by the ``ChunkedTable``
before any predicate runs (the FOR-encoded compare rebases the plain side
with a saturating clamp, exact for any operand in the safe domain); the
partition/shard plan is structural; and the conjunct holds no subquery, so
no residual key embeds it. In the port a bound literal reaches the program
two ways (engine/stream.py): written into the K4 spec's entry words when
its conjunct lowers to the scan kernel, else as a static device scalar the
graph reads.

Everything else is **FOLD-REQUIRED**, with a reason:

``shape-affecting``
    LIMIT row counts and IN-list members (the in-list evaluation reads the
    member values on the host).
``codec-threshold``
    string literals (their one-value dictionary is built on the host).
    Also the domain provenance tag of a bindable slot whose partner column
    carries a known integer interval.
``partition-count-dependent``
    literals inside join ON conjuncts.
``residual-key``
    the conjunct contains a subquery.
``date-parse-at-plan``
    DATE/INTERVAL literals, parsed to host ints at plan time.
``replayed-host-read``
    a numeric comparand in a conjunct not owned solely by the streamed
    alias (dimension-side evaluation may fold into recorded host reads).
``non-comparand``
    a literal that is not one whole side of a compare/BETWEEN reachable
    through AND/OR/NOT only.
``non-streamed-statement``
    the statement (or this scan) does not run through the compiled chunk
    pipeline.

:func:`conjunct_bind_slots` is the ONE rule the auditor and the runtime
(``engine/stream._param_slots``) share; :func:`skeleton_conjunct_key` is
the pipeline-cache key of a bound conjunct; ``NDS_TPU_PARAM_BIND=0`` bakes
every literal. ``python -m nds_tpu_torch.tools.param_audit_diff`` holds
the rule against the engine (one build serving K vectors bit for bit,
fold-required slots changing the key, ``--inject-drift`` failing both
ways).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from nds_tpu_torch.analysis import Finding
from nds_tpu_torch.analysis.exec_audit import (CLASS_COMPILED,
                                               DEFAULT_STREAMED, ExecAuditor,
                                               _conjuncts_of, _has_subquery)
from nds_tpu_torch.queries import (TEMPLATE_DIR, instantiate_template,
                                   list_templates, load_template)
from nds_tpu_torch.sql import ast as A
from nds_tpu_torch.sql.parser import ParseError, Parser, expr_key

# the shared corpus-instantiation seed (the reference's auditors use it)
_AUDIT_SEED = 20260117

# integer columns with a provable value interval beyond mem_audit's spec
# and row-bound domains (the reference's num_audit tables): the
# FOR-encodable partners a slot's ``codec-threshold`` provenance names
NUM_INT_DOMAINS = {
    "cd_dep_count": 100,
    "cd_dep_employed_count": 100,
    "cd_dep_college_count": 100,
    "c_birth_year": 10_000,
    "c_birth_month": 100,
    "c_birth_day": 100,
}
NUM_FK_DOMAINS = {
    "cs_call_center_sk": "call_center",
    "cr_call_center_sk": "call_center",
}

VERDICT_BINDABLE = "bindable"
R_SHAPE = "shape-affecting"
R_CODEC = "codec-threshold"
R_PARTITION = "partition-count-dependent"
R_RESIDUAL = "residual-key"
R_DATE = "date-parse-at-plan"
R_REPLAYED = "replayed-host-read"
R_NON_COMPARAND = "non-comparand"
R_NON_STREAMED = "non-streamed-statement"

REASONS = (R_SHAPE, R_CODEC, R_PARTITION, R_RESIDUAL, R_DATE, R_REPLAYED,
           R_NON_COMPARAND, R_NON_STREAMED)

# proven-safe int magnitude for a bound operand: the encoded-compare
# rebase subtracts a host base before the saturating clamp, so one
# sign-bit of margin keeps |lit - base| inside int64 for every codec
# base the FOR encoder can emit (num_audit's rebase proof).
SAFE_INT_ABS = 1 << 62

_COMPARE_OPS = frozenset(("=", "<>", "<", "<=", ">", ">="))


# ---------------------------------------------------------------------------
# the shared bindability rule (static auditor AND engine/stream.py)
# ---------------------------------------------------------------------------


def literal_typetag(value) -> str | None:
    """Operand type tag of a bindable literal value, or None when the
    value class can never bind (str/bool/None/date — host-folded).
    Decimal tags pin the EXACT scale: a scale change re-plans decimal
    alignment, so it must produce a different skeleton."""
    if value is None or isinstance(value, bool):
        return None
    if isinstance(value, int):
        return "i64"
    if isinstance(value, float):
        return "f64"
    if type(value).__name__ == "Decimal":
        s = max(0, -value.as_tuple().exponent)
        return f"dec:{s}"
    return None


def safe_domain(typetag: str) -> tuple:
    """Closed proven-safe value domain ``(lo, hi)`` for one type tag, in
    LITERAL units (unscaled decimals).  f64 slots admit any finite value
    (comparisons never leave f64), signalled as ``(None, None)``."""
    if typetag == "i64":
        return (-SAFE_INT_ABS, SAFE_INT_ABS)
    if typetag == "f64":
        return (None, None)
    s = int(typetag.split(":")[1])
    lim = SAFE_INT_ABS // (10 ** s)
    return (-lim, lim)


def domain_contains(typetag: str, value) -> bool:
    lo, hi = safe_domain(typetag)
    if lo is None:
        try:
            v = float(value)
        except (TypeError, ValueError):
            return False
        return v == v and v not in (float("inf"), float("-inf"))
    return lo <= value <= hi


def slot_param_value(value, typetag: str):
    """The host value a bound slot passes as its operand: ints stay
    ints, floats floats, decimals pre-scale to their pinned-scale int
    (exactly what ``exprs.literal`` bakes)."""
    if typetag == "i64":
        return int(value)
    if typetag == "f64":
        return float(value)
    s = int(typetag.split(":")[1])
    return int(value.scaleb(s))


def _comparand_literals(conj, drift: bool = False):
    """Yield ``(path, literal_node, partner_expr)`` for every literal in a
    direct-comparand position of one WHERE conjunct: one whole side of a
    compare BinaryOp or a BETWEEN bound, reachable from the conjunct root
    through AND/OR/NOT only.  ``path`` is the dataclass-field DFS path —
    slot identity inside the skeleton (two statements sharing a skeleton
    share conjunct tree shape, so the path addresses the same node in
    both).  ``drift=True`` is the deliberate misclassification for the
    differential self-test: IN-list members are yielded as if they were
    comparands (they are ``shape-affecting``: ``_eval_in_list`` bakes
    them into a host-built device array)."""
    out = []

    def walk(e, path):
        if isinstance(e, A.BinaryOp) and e.op in ("and", "or"):
            walk(e.left, path + ("left",))
            walk(e.right, path + ("right",))
            return
        if isinstance(e, A.UnaryOp) and e.op == "not":
            walk(e.operand, path + ("operand",))
            return
        if isinstance(e, A.BinaryOp) and e.op in _COMPARE_OPS:
            if isinstance(e.left, A.Literal):
                out.append((path + ("left",), e.left, e.right))
            if isinstance(e.right, A.Literal):
                out.append((path + ("right",), e.right, e.left))
            return
        if isinstance(e, A.Between):
            if isinstance(e.low, A.Literal):
                out.append((path + ("low",), e.low, e.expr))
            if isinstance(e.high, A.Literal):
                out.append((path + ("high",), e.high, e.expr))
            return
        if drift and isinstance(e, A.InList):
            for i, item in enumerate(e.items):
                if isinstance(item, A.Literal):
                    out.append((path + (("items", i),), item, e.expr))

    walk(conj, ())
    return out


def conjunct_bind_slots(conj, owned: bool, has_subquery: bool,
                        drift: bool = False) -> list:
    """THE shared bindability rule over one WHERE conjunct: the list of
    ``(path, literal_node, typetag)`` slots that are safe to hoist into
    runtime operands.  ``owned`` — the caller's verdict that the conjunct
    references ONLY the streamed alias (static: catalog resolution;
    runtime: the planner's ``_expr_tables`` ownership, the same test
    ``_build_pipeline`` pushes conjuncts down by).  Non-owned or
    subquery-bearing conjuncts bind nothing; neither do string / date /
    bool / None literals or non-comparand positions."""
    if has_subquery or not owned:
        return []
    slots = []
    for path, lit, _partner in _comparand_literals(conj, drift=drift):
        tag = literal_typetag(lit.value)
        if tag is None:
            continue
        if not domain_contains(tag, lit.value):
            continue                     # outside the proven safe domain
        slots.append((path, lit, tag))
    return slots


def skeleton_conjunct_key(conj, slots) -> str:
    """``expr_key`` of the conjunct with every bindable slot's VALUE
    replaced by a typed placeholder — the canonical template-skeleton key
    member.  The AST nodes are plain mutable dataclasses, so the swap is
    a temporary in-place edit restored under ``finally``.  Placeholders
    are impossible literal collisions: a ``?p:<tag>`` STRING literal in a
    real statement would sit in a slot-free conjunct, and the slot
    signature tuple rides the cache key next to these strings."""
    saved = [(lit, lit.value) for (_p, lit, _t) in slots]
    try:
        for (_p, lit, tag) in slots:
            lit.value = f"?p:{tag}"
        return expr_key(conj)
    finally:
        for lit, v in saved:
            lit.value = v


def drift_active() -> bool:
    """NDS_TPU_PARAM_DRIFT=1: the deliberate shared-rule misclassification
    (IN-list members treated as bindable comparands) both halves consume,
    so ``nds_tpu_torch.tools.param_audit_diff --inject-drift`` proves the
    harness would catch a real drift.  Never set outside the self-tests."""
    return os.environ.get("NDS_TPU_PARAM_DRIFT") == "1"


# ---------------------------------------------------------------------------
# static corpus auditor
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamSlot:
    """One audited-bindable parameter slot of a statement."""

    conjunct: int           # index into the block's WHERE conjunct list
    path: tuple             # dataclass-field DFS path to the Literal
    typetag: str            # "i64" | "f64" | "dec:<scale>"
    column: str             # partner expression key (provenance)
    domain: tuple           # proven safe (lo, hi); (None, None) = finite f64
    provenance: str = ""    # "codec-threshold" when the partner column
    #                         carries a num_audit interval (FOR-encodable)
    value: object = None    # the audit-seed instantiation's literal value
    span: tuple | None = None  # (start, end) of its token in the SQL text

    def to_dict(self) -> dict:
        return {"conjunct": self.conjunct, "path": list(self.path),
                "typetag": self.typetag, "column": self.column,
                "domain": [None if d is None else int(d)
                           for d in self.domain],
                "provenance": self.provenance,
                "value": repr(self.value)}


@dataclass
class ParamReport:
    """Bindability classification of one template statement: the
    parameter signature (bindable slots + proven safe value domains) and
    the fold-required census by reason."""

    file: str
    query: str
    classification: str
    n_literals: int = 0
    slots: tuple = ()                    # ParamSlots
    folds: dict = field(default_factory=dict)   # reason -> count

    @property
    def n_bindable(self) -> int:
        return len(self.slots)

    def signature(self) -> str:
        """The per-template parameter signature: ordered bindable slots
        with their type tags (the plan-bank key shape)."""
        return ", ".join(f"{s.column}:{s.typetag}" for s in self.slots)

    def to_dict(self) -> dict:
        return {"file": self.file, "query": self.query,
                "classification": self.classification,
                "n_literals": self.n_literals,
                "slots": [s.to_dict() for s in self.slots],
                "folds": dict(sorted(self.folds.items())),
                "signature": self.signature()}


class _Census:
    """Accumulator for one statement's walk."""

    def __init__(self, spans=None):
        self.slots: list = []
        self.folds: dict = {}
        self.n = 0
        self.spans = spans or {}

    def fold(self, reason: str, k: int = 1) -> None:
        if k:
            self.n += k
            self.folds[reason] = self.folds.get(reason, 0) + k


def _iter_literals(e):
    """Every Literal/DateLiteral/IntervalLiteral node under ``e``,
    WITHOUT descending into subqueries (their blocks are walked as
    statements of their own)."""
    if isinstance(e, (A.Literal, A.DateLiteral, A.IntervalLiteral)):
        yield e
        return
    if isinstance(e, (A.InSubquery, A.Exists, A.ScalarSubquery,
                      A.QuantifiedCompare)):
        for f in ("expr",):
            sub = getattr(e, f, None)
            if sub is not None:
                yield from _iter_literals(sub)
        return
    if not hasattr(e, "__dataclass_fields__"):
        return
    for f in e.__dataclass_fields__:
        v = getattr(e, f)
        if isinstance(v, (list, tuple)):
            for item in v:
                if hasattr(item, "__dataclass_fields__"):
                    yield from _iter_literals(item)
        elif hasattr(v, "__dataclass_fields__"):
            yield from _iter_literals(v)


def _classify_literal(lit, in_list: bool) -> str:
    """Fold reason of one non-bindable literal inside an owned streamed
    conjunct (shared precedence with the runtime's skip rules)."""
    if isinstance(lit, (A.DateLiteral, A.IntervalLiteral)):
        return R_DATE
    if in_list:
        return R_SHAPE
    if isinstance(lit.value, str):
        return R_CODEC
    return R_NON_COMPARAND


def _in_list_literals(conj) -> set:
    ids = set()

    def walk(e):
        if isinstance(e, A.InList):
            for item in e.items:
                if isinstance(item, A.Literal):
                    ids.add(id(item))
        if isinstance(e, (A.InSubquery, A.Exists, A.ScalarSubquery,
                          A.QuantifiedCompare)):
            return
        if hasattr(e, "__dataclass_fields__"):
            for f in e.__dataclass_fields__:
                v = getattr(e, f)
                if isinstance(v, (list, tuple)):
                    for it in v:
                        if hasattr(it, "__dataclass_fields__"):
                            walk(it)
                elif hasattr(v, "__dataclass_fields__"):
                    walk(v)

    walk(conj)
    return ids


class ParamAuditor:
    """Host-only bindability interpreter over the planner decomposition.

    Composes :class:`ExecAuditor` for statement classification (a slot
    can only bind into a COMPILED chunk pipeline) and mirrors the
    planner's ownership resolution (``_expr_tables``) over the catalog —
    the same single-ownership test ``_build_pipeline`` pushes conjuncts
    down by.  ``drift=True`` routes the shared rule's deliberate
    misclassification (the differential self-test)."""

    def __init__(self, catalog: dict | None = None, streamed=None,
                 base_tables=None, drift: bool = False):
        self._exec = ExecAuditor(catalog=catalog, streamed=streamed,
                                 base_tables=base_tables)
        self.catalog = self._exec.catalog
        self.streamed = set(DEFAULT_STREAMED if streamed is None
                            else streamed)
        self.drift = drift

    # -- entry point --------------------------------------------------------

    def audit_sql(self, sql: str, file: str = "<sql>",
                  query: str = "<sql>") -> ParamReport:
        rep = self._exec.audit_sql(sql, file, query)
        try:
            stmt, spans = _parse_with_spans(sql)
        except ParseError:
            return ParamReport(file, query, rep.classification)
        census = _Census(spans)
        compiled = {s.alias for s in rep.scans if s.compiled}
        q = stmt.query if isinstance(stmt, (A.InsertInto,
                                            A.CreateTempView)) else stmt
        if isinstance(q, A.Query):
            try:
                self._walk_query(q, set(), compiled, census)
            except RecursionError:
                pass
        return ParamReport(file, query, rep.classification,
                           n_literals=census.n,
                           slots=tuple(census.slots),
                           folds=census.folds)

    # -- statement walk -----------------------------------------------------

    def _walk_query(self, q: A.Query, cte_names: set, compiled: set,
                    census: _Census) -> None:
        cte_names = set(cte_names)
        for cname, cq in q.ctes:
            self._walk_query(cq, cte_names, compiled, census)
            cte_names.add(cname.lower())
        self._walk_body(q.body, cte_names, compiled, census)
        if q.limit is not None:
            census.fold(R_SHAPE)         # LIMIT sizes the output shaping
        for e, _d, _nl in q.order_by:
            census.fold(R_NON_COMPARAND, _count_literals(e))

    def _walk_body(self, body, cte_names, compiled, census) -> None:
        if isinstance(body, A.SetOp):
            self._walk_body(body.left, cte_names, compiled, census)
            self._walk_body(body.right, cte_names, compiled, census)
            return
        if isinstance(body, A.Query):
            self._walk_query(body, cte_names, compiled, census)
            return
        if isinstance(body, A.Select):
            self._walk_select(body, cte_names, compiled, census)

    def _flatten_rels(self, node, cte_names, compiled, census,
                      rels: list) -> None:
        """FROM flattening for ownership: ``rels`` collects
        ``(alias, qualified-col set | None, streamed-compiled)``.  ON
        conjunct literals census as partition-count-dependent (equi-key
        structure routes the grace partition/shard plan)."""
        if node is None:
            return
        if isinstance(node, A.TableRef):
            name = node.name.lower()
            alias = (node.alias or node.name).lower()
            if name in cte_names or name not in self.catalog:
                rels.append((alias, None, False))
                return
            cols = {f"{alias}.{c}" for c in self.catalog[name]}
            rels.append((alias, cols,
                         name in self.streamed and alias in compiled))
            return
        if isinstance(node, A.SubqueryRef):
            self._walk_query(node.query, cte_names, compiled, census)
            rels.append((node.alias.lower(), None, False))
            return
        if isinstance(node, A.Join):
            self._flatten_rels(node.left, cte_names, compiled, census,
                               rels)
            self._flatten_rels(node.right, cte_names, compiled, census,
                               rels)
            for c in _conjuncts_of(node.condition):
                if _has_subquery(c):
                    census.fold(R_RESIDUAL, _count_literals(c))
                else:
                    census.fold(R_PARTITION, _count_literals(c))
            return
        if isinstance(node, A.Query):    # parenthesized join tree
            self._flatten_rels(getattr(node.body, "from_", None),
                               cte_names, compiled, census, rels)

    def _ref_owners(self, ref: A.ColumnRef, rels) -> set:
        """Aliases that can answer for ``ref`` — the static mirror of the
        planner's ``_resolve_name`` suffix match.  Unknown-column rels
        (CTEs, subqueries) own every unqualified name conservatively."""
        name = ref.name.lower()
        if ref.table:
            t = ref.table.lower()
            return {a for (a, _cols, _s) in rels if a == t}
        owners = set()
        for (a, cols, _s) in rels:
            if cols is None or any(c.split(".")[-1] == name for c in cols):
                owners.add(a)
        return owners

    def _conjunct_refs(self, e, out: list) -> None:
        if isinstance(e, A.ColumnRef):
            out.append(e)
        if isinstance(e, (A.InSubquery, A.Exists, A.ScalarSubquery,
                          A.QuantifiedCompare)):
            return
        if hasattr(e, "__dataclass_fields__"):
            for f in e.__dataclass_fields__:
                v = getattr(e, f)
                if isinstance(v, (list, tuple)):
                    for it in v:
                        if hasattr(it, "__dataclass_fields__"):
                            self._conjunct_refs(it, out)
                elif hasattr(v, "__dataclass_fields__"):
                    self._conjunct_refs(v, out)

    def _walk_select(self, sel: A.Select, cte_names, compiled,
                     census) -> None:
        rels: list = []
        self._flatten_rels(sel.from_, cte_names, compiled, census, rels)
        streamed_aliases = {a for (a, _c, s) in rels if s}
        for ci, conj in enumerate(_conjuncts_of(sel.where)):
            self._walk_conjunct(ci, conj, rels, streamed_aliases,
                                cte_names, compiled, census)
        # non-conjunct positions: projections, grouping, HAVING — their
        # subquery blocks still walk (the q9 scalar-subquery shape)
        for item in sel.items:
            self._census_other(item.expr, cte_names, compiled, census)
        if sel.group_by is not None:
            for e in sel.group_by.exprs:
                self._census_other(e, cte_names, compiled, census)
        if sel.having is not None:
            self._census_other(sel.having, cte_names, compiled, census)

    def _census_other(self, e, cte_names, compiled, census) -> None:
        census.fold(R_NON_COMPARAND, _count_literals(e))
        for sub in _subqueries_of(e):
            self._walk_query(sub, cte_names, compiled, census)

    def _walk_conjunct(self, ci, conj, rels, streamed_aliases,
                       cte_names, compiled, census) -> None:
        lits = list(_iter_literals(conj))
        if _has_subquery(conj):
            census.fold(R_RESIDUAL, len(lits))
            for sub in _subqueries_of(conj):
                self._walk_query(sub, cte_names, compiled, census)
            return
        if not streamed_aliases:
            census.fold(R_NON_STREAMED, len(lits))
            return
        refs: list = []
        self._conjunct_refs(conj, refs)
        owners = set()
        for r in refs:
            owners |= self._ref_owners(r, rels)
        owned = bool(refs) and owners and owners <= streamed_aliases
        if not owned:
            for lit in lits:
                if isinstance(lit, (A.DateLiteral, A.IntervalLiteral)):
                    census.fold(R_DATE)
                elif isinstance(lit.value, str):
                    census.fold(R_CODEC)
                else:
                    census.fold(R_REPLAYED)
            return
        slots = conjunct_bind_slots(conj, owned=True, has_subquery=False,
                                    drift=self.drift)
        bound_ids = {id(lit) for (_p, lit, _t) in slots}
        in_list = _in_list_literals(conj)
        keep_alias = next(iter(streamed_aliases))
        for path, lit, tag in slots:
            census.n += 1
            partner = self._slot_partner(conj, path)
            prov = R_CODEC if self._for_encodable(partner, rels) else ""
            census.slots.append(ParamSlot(
                conjunct=ci, path=path, typetag=tag,
                column=partner or keep_alias, domain=safe_domain(tag),
                provenance=prov, value=lit.value,
                span=census.spans.get(id(lit))))
        for lit in lits:
            if id(lit) in bound_ids:
                continue
            census.fold(_classify_literal(lit, id(lit) in in_list))

    def _slot_partner(self, conj, path) -> str:
        """Readable partner-column key of one slot (provenance only)."""
        for p, _lit, partner in _comparand_literals(conj, drift=True):
            if p == path:
                if isinstance(partner, A.ColumnRef):
                    return (f"{partner.table.lower()}.{partner.name.lower()}"
                            if partner.table else partner.name.lower())
                try:
                    return expr_key(partner)
                except Exception:
                    return "<expr>"
        return "<expr>"

    def _for_encodable(self, partner: str, rels) -> bool:
        """True when the slot's partner column carries a known num_audit
        interval — the FOR-encodable case whose in-trace rebase the
        saturating-clamp proof covers (domain provenance tag)."""
        if not partner or "." not in partner:
            return False
        bare = partner.split(".")[-1]
        from nds_tpu_torch.analysis.mem_audit import SPEC_INT_DOMAINS
        return (bare in SPEC_INT_DOMAINS or bare in NUM_INT_DOMAINS
                or bare in NUM_FK_DOMAINS or bare.endswith("_sk"))


class _SpanParser(Parser):
    """The parser, noting where each numeric Literal's token lies."""

    def __init__(self, sql: str):
        super().__init__(sql)
        self.spans: dict = {}

    def parse_primary(self):
        t = self.peek()
        node = super().parse_primary()
        if t.kind == "number" and isinstance(node, A.Literal):
            self.spans[id(node)] = (t.pos, t.pos + len(t.value))
        return node


def _parse_with_spans(sql: str):
    """``parse(sql)`` and ``{id(numeric Literal): (start, end)}``."""
    p = _SpanParser(sql)
    stmt = p.parse_statement()
    p.accept_op(";")
    if p.peek().kind != "eof":
        raise ParseError("trailing input", p.peek())
    return stmt, p.spans


def format_slot_value(value, typetag: str) -> str:
    """A slot value as SQL text of the same type tag: an integer, a
    decimal with exactly the tag's scale, or a float with an exponent."""
    from decimal import Decimal
    if typetag == "i64":
        return str(int(value))
    if typetag == "f64":
        return f"{float(value)!r}e0" if "e" not in repr(float(value)) \
            else repr(float(value))
    scale = int(typetag.split(":")[1])
    return str(Decimal(value).quantize(Decimal(1).scaleb(-scale)))


def substitute_slots(sql: str, slots, values) -> str:
    """``sql`` with each bindable slot's literal (a :class:`ParamSlot` with
    its ``span``) replaced by its value in ``values``: the same statement
    over another parameter vector."""
    out, last = [], 0
    for s, v in sorted(zip(slots, values), key=lambda sv: sv[0].span[0]):
        a, b = s.span
        out.append(sql[last:a])
        out.append(format_slot_value(v, s.typetag))
        last = b
    out.append(sql[last:])
    return "".join(out)


def skeleton_text(sql: str, slots) -> str:
    """``sql`` with every bindable slot replaced by ``?<typetag>``: two
    instantiations of a template share a streamed pipeline only if their
    skeleton texts are equal."""
    out, last = [], 0
    for s in sorted(slots, key=lambda s: s.span[0]):
        out.append(sql[last:s.span[0]])
        out.append(f"?{s.typetag}")
        last = s.span[1]
    out.append(sql[last:])
    return "".join(out)


def _count_literals(e) -> int:
    return sum(1 for _ in _iter_literals(e))


def _subqueries_of(e) -> list:
    out = []

    def walk(node):
        if isinstance(node, (A.InSubquery, A.Exists, A.ScalarSubquery,
                             A.QuantifiedCompare)):
            out.append(node.query)
            return
        if not hasattr(node, "__dataclass_fields__"):
            return
        for f in node.__dataclass_fields__:
            v = getattr(node, f)
            if isinstance(v, (list, tuple)):
                for it in v:
                    if hasattr(it, "__dataclass_fields__"):
                        walk(it)
            elif hasattr(v, "__dataclass_fields__"):
                walk(v)

    walk(e)
    return out


# ---------------------------------------------------------------------------
# corpus drivers
# ---------------------------------------------------------------------------


def audit_param_template_text(text: str, file: str,
                              auditor: ParamAuditor | None = None) -> list:
    """Instantiate one template (pinned seed, shared with the other
    auditors) and classify each statement; returns ParamReports."""
    import numpy as np
    auditor = auditor or ParamAuditor()
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


def audit_param_corpus(template_dir: str | None = None,
                       streamed=None, drift: bool = False) -> list:
    """ParamReports for every template in templates.lst order."""
    template_dir = template_dir or TEMPLATE_DIR
    auditor = ParamAuditor(streamed=streamed, drift=drift)
    reports: list = []
    for name in list_templates(template_dir):
        reports.extend(audit_param_template_text(
            load_template(name, template_dir), name, auditor))
    return reports


def reports_to_findings(reports) -> list:
    """Lint-gate findings.  The signatures themselves are a report
    (``--param-report``), not findings; the gate catches the two ways
    the bindability model can contradict itself:

    * ``param-unproven-bind`` — a bindable slot on a statement that is
      not classified compiled-stream: there is no cached per-chunk
      program its operand could patch, so the proof is vacuous (model
      drift between the param and exec decompositions);
    * ``param-domain-escape`` — the audit-seed instantiation's own
      literal value sits outside the slot's proven safe domain: the
      domain arithmetic stopped covering the corpus the other passes
      audit.
    """
    findings = []
    for r in reports:
        for s in r.slots:
            if r.classification != CLASS_COMPILED:
                findings.append(Finding(
                    r.file, r.query, "param-unproven-bind", "error",
                    f"bindable slot {s.column}:{s.typetag} on a "
                    f"{r.classification} statement: no compiled chunk "
                    "pipeline exists to bind its operand into"))
            if s.value is not None and \
                    not domain_contains(s.typetag, s.value):
                findings.append(Finding(
                    r.file, r.query, "param-domain-escape", "error",
                    f"slot {s.column}:{s.typetag} instantiated at "
                    f"{s.value!r}, outside its proven safe domain "
                    f"{s.domain}"))
    return findings


def param_audit_findings(template_dir: str | None = None) -> list:
    """Findings of the whole corpus (the reference's lint pass)."""
    return reports_to_findings(audit_param_corpus(template_dir))


def bindability_counts(reports) -> dict:
    """``verdict -> literal-occurrence count`` over the corpus (the
    pinned bindability story), plus the bindable-statement count."""
    counts = {VERDICT_BINDABLE: 0}
    statements = 0
    for r in reports:
        counts[VERDICT_BINDABLE] += r.n_bindable
        if r.n_bindable:
            statements += 1
        for reason, k in r.folds.items():
            counts[reason] = counts.get(reason, 0) + k
    counts["statements-with-bindable"] = statements
    return counts


def format_param_report(reports) -> str:
    """The per-template signature table (the reference's
    ``--param-report``): literal census, bindable slot count, fold
    reasons, and the parameter signature a plan bank would key on."""
    lines = ["# param-audit: literal bindability / parameter signatures",
             f"{'template':<18} {'class':<16} {'lits':>5} {'bind':>5}  "
             "signature"]
    for r in reports:
        sig = r.signature()
        if len(sig) > 48:
            sig = sig[:45] + "..."
        lines.append(f"{r.query:<18} {r.classification:<16} "
                     f"{r.n_literals:>5} {r.n_bindable:>5}  {sig}")
    counts = bindability_counts(reports)
    summary = ", ".join(f"{k}: {v}" for k, v in sorted(counts.items()))
    lines.append(f"# {len(reports)} statements — {summary}")
    return "\n".join(lines)
