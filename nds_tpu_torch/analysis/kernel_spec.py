# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Shared eligibility + threshold rules of the fused chunk-scan kernel
(K4, ``engine/kernels.chunk_scan``).

The streamed per-chunk hot path fuses its chunk-local predicates into one
kernel pass when every lowered conjunct fits a small encoded-space opcode
set. This module holds the ONE rule that decides which conjuncts lower
(:func:`eligible_conjunct`) — the port's own copy of the reference's rule,
so both engines lower the same conjuncts — and the exact integer threshold
math the lowering uses to move ordered comparisons into ENCODED space
(Fraction boundaries -> stored-code thresholds; sorted-dict values -> code
indexes via bisect), testable with no device in the loop.
"""

from __future__ import annotations

import bisect
import math
from decimal import Decimal
from fractions import Fraction

import numpy as np

from nds_tpu_torch.sql import ast as A

# conjuncts with more IN-list items than this stay in the per-chunk graph:
# each item is one equality per row in the kernel (and the cap is part of
# the shared eligibility rule)
IN_LIST_MAX = 16

_CMP_OPS = {"=", "<>", "<", "<=", ">", ">="}


def _is_num_literal(v) -> bool:
    return isinstance(v, (int, float, Decimal)) and not isinstance(v, bool)


def _ref_lit(e):
    """(ColumnRef, literal node, op-as-written-with-ref-on-left) of a
    comparison, or None. ``5 < ss_x`` flips to ``ss_x > 5``."""
    _FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
             "=": "=", "<>": "<>"}
    if not (isinstance(e, A.BinaryOp) and e.op in _CMP_OPS):
        return None
    left, right = e.left, e.right
    if isinstance(left, A.ColumnRef) and \
            isinstance(right, (A.Literal, A.DateLiteral)):
        return left, right, e.op
    if isinstance(right, A.ColumnRef) and \
            isinstance(left, (A.Literal, A.DateLiteral)):
        return right, left, _FLIP[e.op]
    return None


def eligible_conjunct(c, class_of) -> bool:
    """True when this conjunct lowers to the fused scan kernel's opcode
    set. ``class_of(ref)`` returns the referenced column's coarse type
    class (``"num" | "date" | "str" | "bool"``) — or None when the ref
    does not resolve to a kernel-addressable column (not chunk-owned,
    ambiguous, unknown type), which makes the conjunct ineligible.

    The ONE rule shared by the runtime lowering and the static auditor;
    see the module docstring for why it must stay coarse."""
    got = _ref_lit(c)
    if got is not None:
        ref, lit, op = got
        cls = class_of(ref)
        if cls == "num":
            return isinstance(lit, A.Literal) and (
                lit.value is None or _is_num_literal(lit.value))
        if cls == "date":
            if isinstance(lit, A.DateLiteral):
                # an unparseable DateLiteral raises at eager eval — the
                # conjunct must stay in the graph so both arms raise
                return parse_days(lit.text) is not None
            return isinstance(lit, A.Literal) and (
                lit.value is None or _is_num_literal(lit.value)
                or isinstance(lit.value, str))
        if cls == "str":
            return op in ("=", "<>") and isinstance(lit, A.Literal) and (
                lit.value is None or isinstance(lit.value, str))
        return False
    if isinstance(c, A.Between):
        if not isinstance(c.expr, A.ColumnRef):
            return False
        cls = class_of(c.expr)
        if cls not in ("num", "date"):
            return False

        def bound_ok(b):
            if isinstance(b, A.DateLiteral):
                return cls == "date" and parse_days(b.text) is not None
            if not isinstance(b, A.Literal):
                return False
            if _is_num_literal(b.value):
                return True
            # date-string bounds must parse: Kleene NOT over a
            # half-invalid range is not expressible in the opcode set
            return cls == "date" and isinstance(b.value, str) and \
                parse_days(b.value) is not None
        if c.negated and any(isinstance(b, A.Literal)
                             and isinstance(b.value, float)
                             for b in (c.low, c.high)):
            # negated mixed-lane range (int column, float bound) has no
            # single fused entry — per-conjunct fallback
            return False
        return bound_ok(c.low) and bound_ok(c.high)
    if isinstance(c, A.InList):
        if not isinstance(c.expr, A.ColumnRef):
            return False
        if len(c.items) > IN_LIST_MAX or not c.items:
            return False
        if not all(isinstance(it, A.Literal) for it in c.items):
            return False
        cls = class_of(c.expr)
        vals = [it.value for it in c.items]
        if cls in ("num", "date"):
            return all(v is None or _is_num_literal(v) for v in vals)
        if cls == "str":
            return all(v is None or isinstance(v, str) for v in vals)
        return False
    if isinstance(c, A.IsNull):
        return isinstance(c.expr, A.ColumnRef) and \
            class_of(c.expr) is not None
    return False


def count_eligible(conjuncts, class_of) -> int:
    """Eligible-conjunct count of one chunk-local filter list — the
    number both the runtime spec's ``n_conjuncts`` and the static
    ``kernel_stages`` prediction are built from."""
    return sum(1 for c in conjuncts if eligible_conjunct(c, class_of))


# ---------------------------------------------------------------------------
# exact threshold math (value space -> stored/encoded space)
# ---------------------------------------------------------------------------
#
# Ordered comparisons against a rational boundary q reduce to integer
# thresholds on the stored representation:
#
#   v <  q   <=>   v <= ceil(q) - 1
#   v <= q   <=>   v <= floor(q)
#   v >  q   <=>   v >= floor(q) + 1
#   v >= q   <=>   v >= ceil(q)
#   v =  q   <=>   v == q     (only when q is integral, else FALSE)
#   v <> q   <=>   v != q     (only when q is integral, else TRUE)
#
# and both narrow codecs are order-preserving, so a value-space threshold
# T maps into code space exactly: FOR by subtracting the base, sorted
# dictionaries through bisect on the sorted value table.


def value_cmp(op: str, q: Fraction):
    """Entry kind + integer threshold of ``value OP q`` in VALUE space:
    ``("ieq"|"ine"|"ile"|"ige", T)`` or ``("true",)`` / ``("false",)``."""
    if op == "=":
        return ("ieq", int(q)) if q.denominator == 1 else ("false",)
    if op == "<>":
        return ("ine", int(q)) if q.denominator == 1 else ("true",)
    if op == "<":
        return ("ile", math.ceil(q) - 1)
    if op == "<=":
        return ("ile", math.floor(q))
    if op == ">":
        return ("ige", math.floor(q) + 1)
    if op == ">=":
        return ("ige", math.ceil(q))
    raise ValueError(f"not a comparison op: {op}")


def shift_for(entry, base: int):
    """Rebase a value-space entry into FOR code space (stored = value -
    base)."""
    kind = entry[0]
    if kind in ("ieq", "ine", "ile", "ige"):
        return (kind, entry[1] - base)
    if kind == "irange":
        return (kind, entry[1] - base, entry[2] - base)
    return entry


def dict_map(entry, values):
    """Map a value-space entry into sorted-dict CODE space. ``values`` is
    the codec's sorted logical value table (any sequence bisect can
    search — ints for numeric dicts, strs for string dictionaries).

    Codes are clipped into ``[0, len(values))`` at encode time (the
    out-of-range guard), so a threshold of ``len(values)`` or ``-1``
    correctly selects nothing."""
    kind = entry[0]
    if kind in ("true", "false", "isnull", "notnull"):
        return entry
    if kind == "ieq" or kind == "ine":
        t = entry[1]
        i = bisect.bisect_left(values, t)
        if i < len(values) and values[i] == t:
            return (kind, i)
        return ("false",) if kind == "ieq" else ("true",)
    if kind == "ile":
        return ("ile", bisect.bisect_right(values, entry[1]) - 1)
    if kind == "ige":
        return ("ige", bisect.bisect_left(values, entry[1]))
    if kind == "irange":
        lo = bisect.bisect_left(values, entry[1])
        hi = bisect.bisect_right(values, entry[2]) - 1
        return ("irange", lo, hi)
    raise ValueError(f"unmappable entry {entry!r}")


_EPOCH = np.datetime64("1970-01-01", "D")


def parse_days(text: str) -> int | None:
    """Days-since-epoch of a date string, or None when unparseable —
    numerically identical to ``engine/exprs._parse_date`` (both go
    through ``np.datetime64``), so a lowered date threshold can never
    disagree with the eager cast."""
    try:
        return int((np.datetime64(str(text), "D") - _EPOCH).astype(int))
    except Exception:
        return None
