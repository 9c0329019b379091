# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""SQL tokenizer."""

from __future__ import annotations

from dataclasses import dataclass

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "on", "join", "inner", "left", "right", "full", "outer", "cross",
    "union", "all", "intersect", "except", "distinct", "with", "and", "or",
    "not", "in", "exists", "between", "like", "is", "null", "case", "when",
    "then", "else", "end", "cast", "asc", "desc", "nulls", "first", "last",
    "interval", "day", "days", "month", "months", "year", "years", "over",
    "partition", "rows", "range", "unbounded", "preceding", "following",
    "current", "row", "rollup", "cube", "grouping", "sets", "date", "true",
    "false", "substr", "substring", "any", "some", "top", "insert", "into",
    "delete", "values", "create", "temp", "temporary", "view", "table",
    "semi", "anti",
}

TWO_CHAR = {"<=", ">=", "<>", "!=", "||"}
ONE_CHAR = set("+-*/%(),.=<>;")


@dataclass
class Token:
    kind: str   # 'kw', 'ident', 'number', 'string', 'op', 'eof'
    value: str
    pos: int


class LexError(ValueError):
    pass


def tokenize(sql: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c in " \t\r\n":
            i += 1
            continue
        if c == "-" and i + 1 < n and sql[i + 1] == "-":
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and i + 1 < n and sql[i + 1] == "*":
            j = sql.find("*/", i + 2)
            if j < 0:
                raise LexError(f"unterminated comment at {i}")
            i = j + 2
            continue
        if c == "'":
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            if j >= n:
                raise LexError(f"unterminated string at {i}")
            toks.append(Token("string", "".join(buf), i))
            i = j + 1
            continue
        if c == '"' or c == "`":
            close = c
            j = sql.find(close, i + 1)
            if j < 0:
                raise LexError(f"unterminated quoted identifier at {i}")
            toks.append(Token("ident", sql[i + 1:j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_exp = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j + 1 < n and (
                        sql[j + 1].isdigit() or sql[j + 1] in "+-"):
                    seen_exp = True
                    j += 2 if sql[j + 1] in "+-" else 1
                else:
                    break
            toks.append(Token("number", sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            lw = word.lower()
            toks.append(Token("kw" if lw in KEYWORDS else "ident",
                              lw if lw in KEYWORDS else word, i))
            i = j
            continue
        if sql[i:i + 2] in TWO_CHAR:
            toks.append(Token("op", sql[i:i + 2], i))
            i += 2
            continue
        if c in ONE_CHAR:
            toks.append(Token("op", c, i))
            i += 1
            continue
        raise LexError(f"unexpected character {c!r} at {i}")
    toks.append(Token("eof", "", n))
    return toks
