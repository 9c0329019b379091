# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Recursive-descent SQL parser for the Spark dialect the query templates
emit. Covers the constructs the 99 TPC-DS queries and the data-maintenance
functions use: CTEs, joins, grouping sets/rollup, window functions, set
operations, subqueries (scalar/IN/EXISTS/quantified), CASE, CAST, interval
date arithmetic, and the INSERT/DELETE/CREATE TEMP VIEW statements."""

from __future__ import annotations

from decimal import Decimal

from nds_tpu_torch.sql import ast as A
from nds_tpu_torch.sql.lexer import Token, tokenize


class ParseError(ValueError):
    def __init__(self, msg, tok: Token | None = None):
        super().__init__(f"{msg} (at token {tok.value!r} pos {tok.pos})" if tok else msg)


AGG_FUNCS = {"sum", "min", "max", "avg", "count", "stddev_samp", "stddev",
             "var_samp", "variance", "approx_count_distinct"}
WINDOW_ONLY_FUNCS = {"rank", "dense_rank", "row_number", "ntile", "lag", "lead"}


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # -- token helpers ------------------------------------------------------

    def peek(self, k=0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_kw(self, *words) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.value in words

    def at_op(self, *ops) -> bool:
        t = self.peek()
        return t.kind == "op" and t.value in ops

    def accept_kw(self, *words) -> bool:
        if self.at_kw(*words):
            self.next()
            return True
        return False

    def accept_op(self, *ops) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_kw(self, word):
        if not self.accept_kw(word):
            raise ParseError(f"expected {word.upper()}", self.peek())

    def expect_op(self, op):
        if not self.accept_op(op):
            raise ParseError(f"expected {op!r}", self.peek())

    def ident(self) -> str:
        t = self.peek()
        if t.kind == "ident":
            self.next()
            return t.value
        # some keywords double as identifiers/aliases in the templates
        if t.kind == "kw" and t.value in ("date", "year", "day", "month", "first",
                                          "last", "current", "row", "rows", "range",
                                          "top", "sets", "any", "some", "values"):
            self.next()
            return t.value
        raise ParseError("expected identifier", t)

    # -- statements ---------------------------------------------------------

    def parse_statement(self):
        if self.at_kw("insert"):
            return self.parse_insert()
        if self.at_kw("delete"):
            return self.parse_delete()
        if self.at_kw("create"):
            return self.parse_create_view()
        return self.parse_query()

    def parse_insert(self) -> A.InsertInto:
        self.expect_kw("insert")
        self.expect_kw("into")
        self.accept_kw("table")
        name = self.ident()
        q = self.parse_query()
        return A.InsertInto(name, q)

    def parse_delete(self) -> A.DeleteFrom:
        self.expect_kw("delete")
        self.expect_kw("from")
        name = self.ident()
        where = None
        if self.accept_kw("where"):
            where = self.parse_expr()
        return A.DeleteFrom(name, where)

    def parse_create_view(self) -> A.CreateTempView:
        self.expect_kw("create")
        if not (self.accept_kw("temp") or self.accept_kw("temporary")):
            raise ParseError("only CREATE TEMP VIEW supported", self.peek())
        self.expect_kw("view")
        name = self.ident()
        self.expect_kw("as")
        return A.CreateTempView(name, self.parse_query())

    # -- query expression ---------------------------------------------------

    def parse_query(self) -> A.Query:
        ctes = []
        if self.accept_kw("with"):
            while True:
                name = self.ident()
                self.expect_kw("as")
                self.expect_op("(")
                q = self.parse_query()
                self.expect_op(")")
                ctes.append((name, q))
                if not self.accept_op(","):
                    break
        body = self.parse_set_expr()
        order_by, limit = self.parse_order_limit()
        return A.Query(body, order_by, limit, ctes)

    def parse_order_limit(self):
        order_by = []
        limit = None
        if self.accept_kw("order"):
            self.expect_kw("by")
            while True:
                e = self.parse_expr()
                desc = False
                if self.accept_kw("desc"):
                    desc = True
                else:
                    self.accept_kw("asc")
                nulls_last = desc  # Spark default: asc->nulls first, desc->nulls last
                if self.accept_kw("nulls"):
                    if self.accept_kw("first"):
                        nulls_last = False
                    else:
                        self.expect_kw("last")
                        nulls_last = True
                order_by.append((e, desc, nulls_last))
                if not self.accept_op(","):
                    break
        if self.accept_kw("limit"):
            t = self.next()
            if t.kind != "number":
                raise ParseError("expected number after LIMIT", t)
            limit = int(t.value)
        return order_by, limit

    def parse_set_expr(self):
        left = self.parse_select_core()
        while True:
            if self.accept_kw("union"):
                all_ = self.accept_kw("all")
                right = self.parse_select_core()
                left = A.SetOp("union_all" if all_ else "union", left, right)
            elif self.accept_kw("intersect"):
                right = self.parse_select_core()
                left = A.SetOp("intersect", left, right)
            elif self.accept_kw("except"):
                right = self.parse_select_core()
                left = A.SetOp("except", left, right)
            else:
                return left

    def parse_select_core(self):
        if self.accept_op("("):
            # parenthesized query expression (maybe with its own order/limit)
            q = self.parse_query()
            self.expect_op(")")
            if not q.order_by and q.limit is None and not q.ctes:
                return q.body
            return q
        self.expect_kw("select")
        distinct = False
        if self.accept_kw("distinct"):
            distinct = True
        else:
            self.accept_kw("all")
        items = [self.parse_select_item()]
        while self.accept_op(","):
            items.append(self.parse_select_item())
        from_ = None
        if self.accept_kw("from"):
            from_ = self.parse_table_expr()
        where = self.parse_expr() if self.accept_kw("where") else None
        group_by = None
        if self.accept_kw("group"):
            self.expect_kw("by")
            group_by = self.parse_group_by()
        having = self.parse_expr() if self.accept_kw("having") else None
        return A.Select(items, from_, where, group_by, having, distinct)

    def parse_select_item(self) -> A.SelectItem:
        if self.at_op("*"):
            self.next()
            return A.SelectItem(A.Star())
        # table.* form
        if self.peek().kind == "ident" and self.peek(1).kind == "op" and \
                self.peek(1).value == "." and self.peek(2).kind == "op" and \
                self.peek(2).value == "*":
            t = self.ident()
            self.next()
            self.next()
            return A.SelectItem(A.Star(t))
        e = self.parse_expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "ident":
            alias = self.ident()
        return A.SelectItem(e, alias)

    def parse_group_by(self) -> A.GroupingSets:
        if self.accept_kw("rollup"):
            self.expect_op("(")
            exprs = [self.parse_expr()]
            while self.accept_op(","):
                exprs.append(self.parse_expr())
            self.expect_op(")")
            sets = [exprs[:k] for k in range(len(exprs), -1, -1)]
            return A.GroupingSets("rollup", sets, exprs)
        if self.accept_kw("cube"):
            self.expect_op("(")
            exprs = [self.parse_expr()]
            while self.accept_op(","):
                exprs.append(self.parse_expr())
            self.expect_op(")")
            sets = []
            for mask in range(1 << len(exprs)):
                sets.append([e for i, e in enumerate(exprs) if mask & (1 << i)])
            sets.sort(key=len, reverse=True)
            return A.GroupingSets("cube", sets, exprs)
        if self.accept_kw("grouping"):
            self.expect_kw("sets")
            self.expect_op("(")
            sets = []
            while True:
                self.expect_op("(")
                s = []
                if not self.at_op(")"):
                    s.append(self.parse_expr())
                    while self.accept_op(","):
                        s.append(self.parse_expr())
                self.expect_op(")")
                sets.append(s)
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            flat = []
            seen = set()
            for s in sets:
                for e in s:
                    key = expr_key(e)
                    if key not in seen:
                        seen.add(key)
                        flat.append(e)
            return A.GroupingSets("sets", sets, flat)
        exprs = [self.parse_expr()]
        while self.accept_op(","):
            # trailing rollup inside plain group by: GROUP BY a, rollup(b, c)
            if self.at_kw("rollup"):
                inner = self.parse_group_by()
                sets = [exprs + s for s in inner.sets]
                return A.GroupingSets("rollup", sets, exprs + inner.exprs)
            exprs.append(self.parse_expr())
        return A.GroupingSets("plain", [exprs], exprs)

    # -- FROM clause --------------------------------------------------------

    def parse_table_expr(self):
        left = self.parse_table_primary()
        while True:
            if self.accept_op(","):
                right = self.parse_table_primary()
                left = A.Join(left, right, "cross")
            elif self.at_kw("join", "inner", "left", "right", "full", "cross"):
                kind = "inner"
                if self.accept_kw("inner"):
                    kind = "inner"
                elif self.accept_kw("left"):
                    self.accept_kw("outer")
                    kind = "left"
                    if self.accept_kw("semi"):
                        kind = "semi"
                    elif self.accept_kw("anti"):
                        kind = "anti"
                elif self.accept_kw("right"):
                    self.accept_kw("outer")
                    kind = "right"
                elif self.accept_kw("full"):
                    self.accept_kw("outer")
                    kind = "full"
                elif self.accept_kw("cross"):
                    kind = "cross"
                self.expect_kw("join")
                right = self.parse_table_primary()
                cond = None
                if kind != "cross" and self.accept_kw("on"):
                    cond = self.parse_expr()
                left = A.Join(left, right, kind, cond)
            else:
                return left

    def parse_table_primary(self):
        if self.accept_op("("):
            if self.at_kw("select", "with") or self.at_op("("):
                q = self.parse_query()
                self.expect_op(")")
                alias = None
                self.accept_kw("as")
                if self.peek().kind == "ident":
                    alias = self.ident()
                if alias is None:
                    alias = f"_subq{id(q) % 10000}"
                return A.SubqueryRef(q, alias)
            t = self.parse_table_expr()
            self.expect_op(")")
            return t
        name = self.ident()
        alias = None
        if self.accept_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "ident":
            alias = self.ident()
        return A.TableRef(name, alias)

    # -- expressions --------------------------------------------------------

    def parse_expr(self):
        return self.parse_or()

    def parse_or(self):
        left = self.parse_and()
        while self.accept_kw("or"):
            left = A.BinaryOp("or", left, self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_not()
        while self.accept_kw("and"):
            left = A.BinaryOp("and", left, self.parse_not())
        return left

    def parse_not(self):
        if self.accept_kw("not"):
            return A.UnaryOp("not", self.parse_not())
        return self.parse_predicate()

    def parse_predicate(self):
        if self.at_kw("exists"):
            self.next()
            self.expect_op("(")
            q = self.parse_query()
            self.expect_op(")")
            return A.Exists(q)
        left = self.parse_additive()
        while True:
            negated = False
            if self.at_kw("not") and self.peek(1).kind == "kw" and \
                    self.peek(1).value in ("in", "between", "like"):
                self.next()
                negated = True
            if self.accept_kw("between"):
                low = self.parse_additive()
                self.expect_kw("and")
                high = self.parse_additive()
                left = A.Between(left, low, high, negated)
                continue
            if self.accept_kw("in"):
                self.expect_op("(")
                if self.at_kw("select", "with"):
                    q = self.parse_query()
                    self.expect_op(")")
                    left = A.InSubquery(left, q, negated)
                else:
                    items = [self.parse_expr()]
                    while self.accept_op(","):
                        items.append(self.parse_expr())
                    self.expect_op(")")
                    left = A.InList(left, items, negated)
                continue
            if self.accept_kw("like"):
                t = self.next()
                if t.kind != "string":
                    raise ParseError("expected string pattern after LIKE", t)
                left = A.Like(left, t.value, negated)
                continue
            if self.accept_kw("is"):
                neg = self.accept_kw("not")
                self.expect_kw("null")
                left = A.IsNull(left, neg)
                continue
            if self.peek().kind == "op" and self.peek().value in (
                    "=", "<>", "!=", "<", "<=", ">", ">="):
                op = self.next().value
                if op == "!=":
                    op = "<>"
                # quantified comparison: expr op ANY/ALL/SOME (subquery)
                if self.at_kw("any", "some", "all") and self.peek(1).kind == "op" \
                        and self.peek(1).value == "(":
                    quant = self.next().value
                    quant = "any" if quant == "some" else quant
                    self.expect_op("(")
                    q = self.parse_query()
                    self.expect_op(")")
                    left = A.QuantifiedCompare(op, left, q, quant)
                    continue
                right = self.parse_additive()
                left = A.BinaryOp(op, left, right)
                continue
            return left

    def parse_additive(self):
        left = self.parse_multiplicative()
        while True:
            if self.at_op("+", "-"):
                op = self.next().value
                left = A.BinaryOp(op, left, self.parse_multiplicative())
            elif self.at_op("||"):
                self.next()
                left = A.BinaryOp("||", left, self.parse_multiplicative())
            else:
                return left

    def parse_multiplicative(self):
        left = self.parse_unary()
        while self.at_op("*", "/", "%"):
            op = self.next().value
            left = A.BinaryOp(op, left, self.parse_unary())
        return left

    def parse_unary(self):
        if self.accept_op("-"):
            return A.UnaryOp("-", self.parse_unary())
        if self.accept_op("+"):
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self):
        t = self.peek()
        if t.kind == "number":
            self.next()
            if "." in t.value or "e" in t.value.lower():
                if "e" in t.value.lower():
                    return A.Literal(float(t.value))
                return A.Literal(Decimal(t.value))
            return A.Literal(int(t.value))
        if t.kind == "string":
            self.next()
            return A.Literal(t.value)
        if t.kind == "op" and t.value == "(":
            self.next()
            if self.at_kw("select", "with"):
                q = self.parse_query()
                self.expect_op(")")
                return A.ScalarSubquery(q)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind == "kw":
            if t.value == "null":
                self.next()
                return A.Literal(None)
            if t.value in ("true", "false"):
                self.next()
                return A.Literal(t.value == "true")
            if t.value == "case":
                return self.parse_case()
            if t.value == "cast":
                self.next()
                self.expect_op("(")
                e = self.parse_expr()
                self.expect_kw("as")
                target = self.parse_type_name()
                self.expect_op(")")
                return A.Cast(e, target)
            if t.value == "date" and self.peek(1).kind == "string":
                self.next()
                lit = self.next()
                return A.DateLiteral(lit.value)
            if t.value == "interval":
                self.next()
                amt_tok = self.next()
                neg = False
                if amt_tok.kind == "op" and amt_tok.value == "-":
                    neg = True
                    amt_tok = self.next()
                if amt_tok.kind == "string":
                    amt = int(amt_tok.value)
                elif amt_tok.kind == "number":
                    amt = int(amt_tok.value)
                else:
                    raise ParseError("expected interval amount", amt_tok)
                unit_tok = self.next()
                unit = unit_tok.value.rstrip("s")
                if unit not in ("day", "month", "year"):
                    raise ParseError(f"unsupported interval unit {unit}", unit_tok)
                return A.IntervalLiteral(-amt if neg else amt, unit)
            if t.value in ("substr", "substring"):
                return self.parse_function(self.next().value)
            if t.value == "grouping":
                return self.parse_function(self.next().value)
            if t.value == "current":
                # current_date etc. not needed by the corpus; fall through
                pass
        if t.kind == "ident" or (t.kind == "kw" and t.value in ("date", "year",
                                                                "day", "month",
                                                                "first", "last")):
            # function call or column ref
            if self.peek(1).kind == "op" and self.peek(1).value == "(":
                name = self.next().value
                return self.parse_function(name)
            name = self.ident()
            if self.accept_op("."):
                col = self.ident()
                return A.ColumnRef(col, name)
            return A.ColumnRef(name)
        raise ParseError("unexpected token in expression", t)

    def parse_case(self) -> A.Case:
        self.expect_kw("case")
        operand = None
        if not self.at_kw("when"):
            operand = self.parse_expr()
        branches = []
        while self.accept_kw("when"):
            cond = self.parse_expr()
            self.expect_kw("then")
            res = self.parse_expr()
            branches.append((cond, res))
        else_ = None
        if self.accept_kw("else"):
            else_ = self.parse_expr()
        self.expect_kw("end")
        return A.Case(branches, else_, operand)

    def parse_type_name(self) -> str:
        t = self.next()
        name = t.value.lower()
        if name == "double" and self.peek().kind == "ident" and \
                self.peek().value.lower() == "precision":
            self.next()
            name = "double"
        if self.accept_op("("):
            args = [self.next().value]
            while self.accept_op(","):
                args.append(self.next().value)
            self.expect_op(")")
            name = f"{name}({','.join(args)})"
        return name

    def parse_function(self, name: str):
        name = name.lower()
        self.expect_op("(")
        distinct = False
        star = False
        args = []
        if self.at_op("*"):
            self.next()
            star = True
        elif not self.at_op(")"):
            if self.accept_kw("distinct"):
                distinct = True
            args.append(self.parse_expr())
            while self.accept_op(","):
                args.append(self.parse_expr())
        self.expect_op(")")
        fc = A.FuncCall(name, args, distinct, star)
        if self.accept_kw("over"):
            self.expect_op("(")
            partition = []
            order = []
            frame = None
            if self.accept_kw("partition"):
                self.expect_kw("by")
                partition.append(self.parse_expr())
                while self.accept_op(","):
                    partition.append(self.parse_expr())
            if self.accept_kw("order"):
                self.expect_kw("by")
                while True:
                    e = self.parse_expr()
                    desc = False
                    if self.accept_kw("desc"):
                        desc = True
                    else:
                        self.accept_kw("asc")
                    nulls_last = desc
                    if self.accept_kw("nulls"):
                        if self.accept_kw("first"):
                            nulls_last = False
                        else:
                            self.expect_kw("last")
                            nulls_last = True
                    order.append((e, desc, nulls_last))
                    if not self.accept_op(","):
                        break
            frame_kw = None
            if self.accept_kw("rows"):
                frame_kw = "rows"
            elif self.accept_kw("range"):
                frame_kw = "range"
            if frame_kw:
                # the corpus uses [ROWS|RANGE] BETWEEN UNBOUNDED PRECEDING
                # AND CURRENT ROW (ROWS and RANGE differ on order-key ties)
                if self.accept_kw("between"):
                    self.expect_kw("unbounded")
                    self.expect_kw("preceding")
                    self.expect_kw("and")
                    self.expect_kw("current")
                    self.expect_kw("row")
                else:
                    self.expect_kw("unbounded")
                    self.expect_kw("preceding")
                frame = f"{frame_kw}_unbounded_preceding"
            self.expect_op(")")
            return A.WindowFunc(fc, A.WindowSpec(partition, order, frame))
        return fc


def expr_key(e) -> str:
    """Canonical textual key for expression identity (GROUP BY matching)."""
    if isinstance(e, A.ColumnRef):
        return f"col:{e.table or ''}.{e.name}".lower()
    if isinstance(e, A.Literal):
        return f"lit:{e.value!r}"
    if isinstance(e, A.BinaryOp):
        return f"({expr_key(e.left)}{e.op}{expr_key(e.right)})"
    if isinstance(e, A.UnaryOp):
        return f"({e.op}{expr_key(e.operand)})"
    if isinstance(e, A.FuncCall):
        inner = ",".join(expr_key(a) for a in e.args)
        return f"fn:{e.name}({'distinct ' if e.distinct else ''}{'*' if e.star else inner})"
    if isinstance(e, A.Cast):
        return f"cast({expr_key(e.expr)} as {e.target})"
    if isinstance(e, A.Case):
        b = ";".join(f"{expr_key(c)}:{expr_key(r)}" for c, r in e.branches)
        el = expr_key(e.else_) if e.else_ else ""
        op = expr_key(e.operand) if e.operand else ""
        return f"case({op}|{b}|{el})"
    if isinstance(e, A.Between):
        return f"between({expr_key(e.expr)},{expr_key(e.low)},{expr_key(e.high)},{e.negated})"
    if isinstance(e, A.InList):
        return f"in({expr_key(e.expr)},{[expr_key(i) for i in e.items]},{e.negated})"
    if isinstance(e, A.Like):
        return f"like({expr_key(e.expr)},{e.pattern},{e.negated})"
    if isinstance(e, A.IsNull):
        return f"isnull({expr_key(e.expr)},{e.negated})"
    if isinstance(e, A.DateLiteral):
        return f"date:{e.text}"
    if isinstance(e, A.IntervalLiteral):
        return f"interval:{e.amount}{e.unit}"
    if isinstance(e, A.WindowFunc):
        part = ",".join(expr_key(p) for p in e.spec.partition_by)
        order = ",".join(f"{expr_key(oe)}:{d}:{nl}" for oe, d, nl in e.spec.order_by)
        return f"win:{expr_key(e.func)}|p={part}|o={order}|f={e.spec.frame}"
    if isinstance(e, (A.ScalarSubquery, A.InSubquery, A.Exists,
                      A.QuantifiedCompare, A.Query, A.Select)) or \
            hasattr(e, "__dataclass_fields__"):
        # subquery/statement nodes key by STRUCTURE, not object identity:
        # the streamed-residual machinery (engine/stream.py) keys
        # pre-planned subquery results — and the pipeline cache keys
        # conjuncts — on expr_key, so two parses of the same text agree
        fields = ",".join(f"{k}={_node_key(v)}" for k, v in vars(e).items())
        return f"{type(e).__name__.lower()}({fields})"
    return f"obj:{id(e)}"


def _node_key(x) -> str:
    """Deterministic structural key of an arbitrary AST node (dataclass
    fields walked recursively; expressions delegate to :func:`expr_key`)."""
    if isinstance(x, A.Expr):
        return expr_key(x)
    if isinstance(x, (list, tuple)):
        return "[" + ",".join(_node_key(i) for i in x) + "]"
    if hasattr(x, "__dataclass_fields__"):
        fields = ",".join(f"{k}={_node_key(v)}" for k, v in vars(x).items())
        return f"{type(x).__name__}({fields})"
    return repr(x)


def parse(sql: str):
    """Parse one SQL statement."""
    p = Parser(sql)
    stmt = p.parse_statement()
    p.accept_op(";")
    if p.peek().kind != "eof":
        raise ParseError("trailing input", p.peek())
    return stmt
