# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""SQL AST node definitions (expressions + relational structure)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------


@dataclass
class Expr:
    pass


@dataclass
class Literal(Expr):
    value: object           # int | float | Decimal | str | bool | None


@dataclass
class DateLiteral(Expr):
    text: str


@dataclass
class IntervalLiteral(Expr):
    amount: int
    unit: str               # 'day' | 'month' | 'year'


@dataclass
class ColumnRef(Expr):
    name: str
    table: Optional[str] = None   # qualifier


@dataclass
class Star(Expr):
    table: Optional[str] = None


@dataclass
class UnaryOp(Expr):
    op: str                 # '-', 'not'
    operand: Expr


@dataclass
class BinaryOp(Expr):
    op: str                 # + - * / % = <> < <= > >= and or ||
    left: Expr
    right: Expr


@dataclass
class Between(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclass
class InList(Expr):
    expr: Expr
    items: list
    negated: bool = False


@dataclass
class InSubquery(Expr):
    expr: Expr
    query: "Query"
    negated: bool = False


@dataclass
class Exists(Expr):
    query: "Query"
    negated: bool = False


@dataclass
class ScalarSubquery(Expr):
    query: "Query"


@dataclass
class QuantifiedCompare(Expr):
    """expr op ANY/ALL (subquery)"""
    op: str
    expr: Expr
    query: "Query"
    quantifier: str          # 'any' | 'all'


@dataclass
class Like(Expr):
    expr: Expr
    pattern: str
    negated: bool = False


@dataclass
class IsNull(Expr):
    expr: Expr
    negated: bool = False


@dataclass
class Case(Expr):
    branches: list          # [(cond Expr, result Expr)]
    else_: Optional[Expr]
    operand: Optional[Expr] = None   # CASE operand WHEN v THEN ...


@dataclass
class Cast(Expr):
    expr: Expr
    target: str


@dataclass
class FuncCall(Expr):
    name: str
    args: list
    distinct: bool = False
    star: bool = False               # count(*)


@dataclass
class WindowSpec:
    partition_by: list
    order_by: list                   # [(expr, desc, nulls_last)]
    frame: Optional[str] = None      # '{rows,range}_unbounded_preceding' |
                                     # None (= SQL default: RANGE..CURRENT ROW
                                     # with ORDER BY, full partition without)


@dataclass
class WindowFunc(Expr):
    func: FuncCall
    spec: WindowSpec


# ---------------------------------------------------------------------------
# relational structure
# ---------------------------------------------------------------------------


@dataclass
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


@dataclass
class TableRef:
    name: str
    alias: Optional[str] = None


@dataclass
class SubqueryRef:
    query: "Query"
    alias: str


@dataclass
class Join:
    left: object            # TableRef | SubqueryRef | Join
    right: object
    kind: str               # 'inner' | 'left' | 'right' | 'full' | 'cross'
    condition: Optional[Expr] = None


@dataclass
class GroupingSets:
    kind: str               # 'rollup' | 'cube' | 'sets' | 'plain'
    sets: list              # list of lists of Expr (resolved grouping sets)
    exprs: list             # flat list of all grouping exprs


@dataclass
class Select:
    items: list             # [SelectItem]
    from_: object           # TableRef | SubqueryRef | Join | None
    where: Optional[Expr] = None
    group_by: Optional[GroupingSets] = None
    having: Optional[Expr] = None
    distinct: bool = False


@dataclass
class Query:
    """A full query expression: SELECT core + set ops + order/limit + CTEs."""
    body: object            # Select | SetOp
    order_by: list = field(default_factory=list)   # [(expr, desc, nulls_last)]
    limit: Optional[int] = None
    ctes: list = field(default_factory=list)       # [(name, Query)]


@dataclass
class SetOp:
    op: str                 # 'union' | 'union_all' | 'intersect' | 'except'
    left: object            # Select | SetOp
    right: object


# ---------------------------------------------------------------------------
# DML (Data Maintenance)
# ---------------------------------------------------------------------------


@dataclass
class InsertInto:
    table: str
    query: Query


@dataclass
class DeleteFrom:
    table: str
    where: Optional[Expr]


@dataclass
class CreateTempView:
    name: str
    query: Query
