# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The two plan-audit helpers the execution auditor stands on: the coarse
type class of a schema type (:func:`type_class`) and the one-row test of a
derived table (:func:`_single_row_query`). The rest of the reference's plan
audit (column resolution, dtype and join-graph checks) is not ported yet.
"""

from __future__ import annotations

from nds_tpu_torch.sql import ast as A
from nds_tpu_torch.sql.parser import AGG_FUNCS


def type_class(canonical: str | None) -> str | None:
    """Canonical schema type -> the coarse class the audits compare on."""
    if canonical is None:
        return None
    t = canonical.lower()
    if t in ("int32", "int64", "double", "float", "bigint", "int",
             "integer", "smallint", "tinyint") or t.startswith("decimal"):
        return "num"
    if t == "date":
        return "date"
    if t == "string" or t.startswith(("char", "varchar")):
        return "str"
    if t in ("bool", "boolean"):
        return "bool"
    return None


def _children(e):
    if isinstance(e, A.BinaryOp):
        return (e.left, e.right)
    if isinstance(e, A.UnaryOp):
        return (e.operand,)
    if isinstance(e, A.Between):
        return (e.expr, e.low, e.high)
    if isinstance(e, (A.InList,)):
        return (e.expr, *e.items)
    if isinstance(e, (A.Like, A.IsNull)):
        return (e.expr,)
    if isinstance(e, A.Case):
        out = [c for b in e.branches for c in b]
        if e.operand is not None:
            out.append(e.operand)
        if e.else_ is not None:
            out.append(e.else_)
        return tuple(out)
    if isinstance(e, A.Cast):
        return (e.expr,)
    if isinstance(e, A.FuncCall):
        return tuple(e.args)
    if isinstance(e, A.WindowFunc):
        return (e.func, *e.spec.partition_by,
                *(oe for oe, _, _ in e.spec.order_by))
    if isinstance(e, (A.InSubquery, A.QuantifiedCompare)):
        return (e.expr,)
    return ()


def _single_row_query(q: A.Query) -> bool:
    """True when the derived table is guaranteed one row: LIMIT 1 or an
    ungrouped aggregate-only projection."""
    if q.limit == 1:
        return True
    body = q.body
    if not isinstance(body, A.Select) or body.group_by is not None:
        return False

    def aggregate_valued(e) -> bool:
        if isinstance(e, A.FuncCall):
            if e.name.lower() in AGG_FUNCS:
                return True
            return bool(e.args) and all(aggregate_valued(a)
                                        for a in e.args)
        if isinstance(e, (A.Literal, A.DateLiteral, A.IntervalLiteral)):
            return True
        if isinstance(e, A.BinaryOp):
            return aggregate_valued(e.left) and aggregate_valued(e.right)
        if isinstance(e, A.UnaryOp):
            return aggregate_valued(e.operand)
        if isinstance(e, A.Cast):
            return aggregate_valued(e.expr)
        return False

    def has_aggregate(e) -> bool:
        if isinstance(e, A.FuncCall) and e.name.lower() in AGG_FUNCS:
            return True
        return any(has_aggregate(c) for c in _children(e))

    # every item aggregate-valued is not enough: a constants-only
    # projection (select 1 from t) is one row PER INPUT ROW — at least one
    # real aggregate is what collapses the select to a single row
    items = body.items
    return bool(items) and all(
        not isinstance(i.expr, A.Star) and aggregate_valued(i.expr)
        for i in items) and any(has_aggregate(i.expr) for i in items)
