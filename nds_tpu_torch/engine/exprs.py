# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Scalar expression kernels over device columns.

SQL three-valued logic: every kernel combines operand validity into the
result's validity; AND/OR implement Kleene logic. Decimal arithmetic stays on
the exact int64 fixed-point path (scales align for +/-, add for *), spilling
to float64 for division and for scale overflow. String predicates evaluate
once per distinct dictionary value on host, then map through the device codes
— the dictionary is orders of magnitude smaller than the column.
"""

from __future__ import annotations

import re
import threading

import numpy as np
import torch

from nds_tpu_torch.engine import prim
from nds_tpu_torch.engine.column import Column, encs_equal, is_dec
from nds_tpu_torch.engine.ops import (device, host_table,
                                      ordered_codes_merged, plain_col,
                                      to_host)

I64 = torch.int64
F64 = torch.float64

_MAX_DEC_SCALE = 10
# dictionary memos (literal dictionaries + per-tag _map_dict caches):
# concurrent Throughput streams evaluate expressions at once, and
# identity-keyed caches downstream need ONE winner per key — mutations
# take the dedicated lock, setdefault keeps the first insert.
_str_literal_dicts: dict = {}
_DICT_MEMO_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# literals / lifting
# ---------------------------------------------------------------------------

def _full(n: int, value, dtype, dev=None) -> torch.Tensor:
    return torch.full((n,), value, dtype=dtype,
                      device=device() if dev is None else dev)


def _lookup(table: np.ndarray, codes: torch.Tensor) -> torch.Tensor:
    """Per-dictionary-value host table gathered by device codes."""
    return prim.take(host_table(table, codes.device), codes)


def literal(value, n: int) -> Column:
    """Python literal -> broadcast Column of length n."""
    if value is None:
        return Column("i32", _full(n, 0, torch.int32),
                      _full(n, False, torch.bool))
    if isinstance(value, bool):
        return Column("bool", _full(n, value, torch.bool))
    if isinstance(value, int):
        return Column("i64", _full(n, value, I64))
    if isinstance(value, float):
        return Column("f64", _full(n, value, F64))
    if isinstance(value, str):
        # per-value dictionary cache: identity-keyed caches downstream
        # (expression fusion) need the same host object on every execution.
        # Bounded FIFO like the engine's other dictionary caches.
        d = _str_literal_dicts.get(value)
        if d is None:
            built = np.asarray([value], dtype=object)
            with _DICT_MEMO_LOCK:
                if len(_str_literal_dicts) >= 4096:
                    _str_literal_dicts.pop(next(iter(_str_literal_dicts)))
                d = _str_literal_dicts.setdefault(value, built)
        return Column("str", _full(n, 0, torch.int32), None, d)
    if type(value).__name__ == "Decimal":
        s = -value.as_tuple().exponent
        s = max(0, s)
        return Column(f"dec(38,{s})", _full(n, int(value.scaleb(s)), I64))
    raise TypeError(f"unsupported literal: {value!r}")


# ---------------------------------------------------------------------------
# numeric coercion
# ---------------------------------------------------------------------------


# the scalar kernels funnel value consumption through the ONE decode
# choke point (ops.plain_col); comparisons keep a fast path that stays
# in encoded space (see compare)
_plain = plain_col


def _as_f64(col: Column) -> torch.Tensor:
    col = _plain(col)
    d = col.data.to(F64)
    if is_dec(col.kind):
        d = d / (10.0 ** col.scale)
    return d


def _combine_valid(a: Column, b: Column):
    if a.valid is None and b.valid is None:
        return None
    return a.valid_mask() & b.valid_mask()


def _align_decimals(a: Column, b: Column):
    """Bring two int-path numeric columns to a common scale."""
    a, b = _plain(a), _plain(b)
    sa, sb = a.scale, b.scale
    s = max(sa, sb)
    da = a.data.to(I64) * (10 ** (s - sa))
    db = b.data.to(I64) * (10 ** (s - sb))
    return da, db, s


def _int_path(col: Column) -> bool:
    return col.kind in ("i32", "i64", "date", "bool") or is_dec(col.kind)


def arith(op: str, a: Column, b: Column) -> Column:
    a, b = _plain(a), _plain(b)        # arithmetic needs logical values
    valid = _combine_valid(a, b)
    if op == "/":
        num, den = _as_f64(a), _as_f64(b)
        zero = den == 0
        out = torch.where(zero, 0.0, num / torch.where(zero, 1.0, den))
        v = valid if valid is not None else a.valid_mask()
        return Column("f64", out, v & ~zero)  # SQL: x/0 -> null (Spark semantics)
    if _int_path(a) and _int_path(b):
        if op in ("+", "-"):
            da, db, s = _align_decimals(a, b)
            out = da + db if op == "+" else da - db
            if s:
                kind = f"dec(38,{s})"
            elif (a.kind == "date") != (b.kind == "date"):
                kind = "date"       # date +/- integer days
                out = out.to(torch.int32)
            else:
                kind = "i64"        # incl. date - date = day count
            return Column(kind, out, valid)
        if op == "*":
            s = a.scale + b.scale
            if s <= _MAX_DEC_SCALE:
                out = a.data.to(I64) * b.data.to(I64)
                kind = f"dec(38,{s})" if s else "i64"
                return Column(kind, out, valid)
        if op == "%":
            da, db = a.data.to(I64), b.data.to(I64)
            zero = db == 0
            safe_db = torch.where(zero, 1, db)
            out = torch.where(zero, 0, da % safe_db)
            # SQL/Spark remainder takes the dividend's sign, not the divisor's
            out = torch.where((out != 0) & ((out < 0) != (da < 0)),
                              out - safe_db, out)
            v = valid if valid is not None else a.valid_mask()
            return Column("i64", out, v & ~zero)
    # float path
    fa, fb = _as_f64(a), _as_f64(b)
    if op == "+":
        out = fa + fb
    elif op == "-":
        out = fa - fb
    elif op == "*":
        out = fa * fb
    elif op == "%":
        zero = fb == 0
        # fmod (C semantics: dividend's sign) matches Spark's % on doubles
        out = torch.where(zero, 0.0, torch.fmod(fa, torch.where(zero, 1.0,
                                                                fb)))
        v = valid if valid is not None else a.valid_mask()
        return Column("f64", out, v & ~zero)
    else:
        raise ValueError(f"unknown arith op {op}")
    return Column("f64", out, valid)


def negate(a: Column) -> Column:
    a = _plain(a)
    if a.kind == "f64":
        return Column("f64", -a.data, a.valid)
    return Column(a.kind if is_dec(a.kind) else "i64",
                  -a.data.to(I64), a.valid)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def _encoded_compare_views(a: Column, b: Column):
    """Encoded-space comparison views, or None when the pair must decode.

    Both FOR and sorted-dict encodings are order-preserving, so two sides
    sharing ONE encoding compare by raw codes. For a FOR side against a
    plain int-path side at the same scale, the comparison rebases the
    PLAIN side into the encoded space (``code op (other - base)``) — when
    the other side is a broadcast literal the subtraction folds to a
    constant, so the predicate runs entirely on the narrow encoded
    column."""
    if a.enc is not None and b.enc is not None:
        # same encoding AND same scale: codes of a dec(7,2) and an int
        # column can share (mode, base) while meaning values 100x apart,
        # so scale must align exactly like _align_decimals would
        if encs_equal(a.enc, b.enc) and a.scale == b.scale:
            return a.data.to(I64), b.data.to(I64)
        return None
    enc_side, plain_side = (a, b) if a.enc is not None else (b, a)
    if enc_side.enc.mode != "for" or plain_side.enc is not None or \
            enc_side.scale != plain_side.scale or plain_side.kind == "f64":
        return None
    base_i = int(enc_side.enc.base)
    ev = enc_side.data.to(I64)
    raw = plain_side.data.to(I64)
    diff = raw - base_i
    # The rebase must SATURATE, not wrap: a plain value near ±2^63 with an
    # opposite-signed base overflows int64 and lands back inside the code
    # window with every comparison inverted. The base is a host int, so
    # only one wrap direction is possible per trace: with base < 0 the
    # subtraction can only wrap upward (raw > 0 yet diff < 0), with
    # base > 0 only downward (raw < 0 yet diff > 0). Wrapped values and
    # all out-of-window values pin to the sentinels -1 / code_max + 1,
    # strictly outside the code range [0, span] — every comparison
    # against any code keeps its exact truth value.
    code_max = ((1 << 15) - 1 if enc_side.data.dtype == torch.int16
                else (1 << 31) - 1)
    if base_i < 0:
        diff = torch.where((raw > 0) & (diff < 0), code_max + 1, diff)
    elif base_i > 0:
        diff = torch.where((raw < 0) & (diff > 0), -1, diff)
    pv = diff.clamp(-1, code_max + 1)
    return (ev, pv) if enc_side is a else (pv, ev)


def compare(op: str, a: Column, b: Column) -> Column:
    valid = _combine_valid(a, b)
    if a.kind == "str" or b.kind == "str":
        if a.kind == "str" and b.kind == "str":
            la, lb = ordered_codes_merged(a, b)
        else:
            raise TypeError("cannot compare string with non-string")
        da, db = la, lb
    elif _int_path(a) and _int_path(b):
        views = _encoded_compare_views(a, b) \
            if (a.enc is not None or b.enc is not None) else None
        if views is not None:
            da, db = views
        else:
            da, db, _ = _align_decimals(a, b)
    else:
        da, db = _as_f64(a), _as_f64(b)
    out = {
        "=": lambda: da == db,
        "<>": lambda: da != db,
        "<": lambda: da < db,
        "<=": lambda: da <= db,
        ">": lambda: da > db,
        ">=": lambda: da >= db,
    }[op]()
    return Column("bool", out, valid)


def is_null(a: Column, negate_: bool = False) -> Column:
    m = ~a.valid_mask() if not negate_ else a.valid_mask()
    return Column("bool", m)


# ---------------------------------------------------------------------------
# Kleene boolean logic
# ---------------------------------------------------------------------------


def logical_and(a: Column, b: Column) -> Column:
    av, bv = a.valid_mask(), b.valid_mask()
    ad, bd = a.data.to(torch.bool), b.data.to(torch.bool)
    data = ad & bd
    false_a = av & ~ad
    false_b = bv & ~bd
    valid = (av & bv) | false_a | false_b
    return Column("bool", data, valid)


def logical_or(a: Column, b: Column) -> Column:
    av, bv = a.valid_mask(), b.valid_mask()
    ad, bd = a.data.to(torch.bool), b.data.to(torch.bool)
    data = (av & ad) | (bv & bd)
    true_a = av & ad
    true_b = bv & bd
    valid = (av & bv) | true_a | true_b
    return Column("bool", data, valid)


def logical_not(a: Column) -> Column:
    return Column("bool", ~a.data.to(torch.bool), a.valid)


# ---------------------------------------------------------------------------
# conditionals
# ---------------------------------------------------------------------------


def _unify(cols):
    """Bring branch results to one kind (for CASE/COALESCE/IF)."""
    cols = [_plain(c) for c in cols]
    kinds = {c.kind for c in cols}
    if len(kinds) == 1 and "str" not in kinds:
        return cols, cols[0].kind
    if kinds == {"str"}:
        return cols, "str"
    if "str" in kinds:
        # null literals come through as i32; rewrite them as empty-string nulls
        fixed = []
        str_dict = next(c.dict_values for c in cols if c.kind == "str")
        for c in cols:
            if c.kind == "str":
                fixed.append(c)
            else:
                dev = c.data.device
                fixed.append(Column("str", _full(len(c), 0, torch.int32, dev),
                                    _full(len(c), False, torch.bool, dev),
                                    str_dict))
        return fixed, "str"
    scales = {c.scale for c in cols if is_dec(c.kind)}
    if scales and all(_int_path(c) for c in cols):
        s = max(scales)
        fixed = [Column(f"dec(38,{s})",
                        c.data.to(I64) * (10 ** (s - c.scale)), c.valid)
                 for c in cols]
        return fixed, f"dec(38,{s})"
    if kinds <= {"i32", "i64", "date", "bool"}:
        fixed = [Column("i64", c.data.to(I64), c.valid) for c in cols]
        return fixed, "i64"
    fixed = [Column("f64", _as_f64(c), c.valid) for c in cols]
    return fixed, "f64"


def unify_columns(cols):
    """Public alias of :func:`_unify` for cross-module use (set operations
    align operand columns with it)."""
    return _unify(cols)


def case_when(branches, else_col: Column) -> Column:
    """branches: [(cond Column, value Column)], evaluated first-match-wins."""
    vals = [v for _, v in branches] + [else_col]
    vals, kind = _unify(vals)
    branch_vals, else_v = vals[:-1], vals[-1]
    n = len(else_v)
    if kind == "str":
        # merge dictionaries across branches
        from nds_tpu_torch.engine.ops import concat_columns
        merged = concat_columns([v for v in vals])
        dict_values = merged.dict_values
        datas = [merged.data[i * n:(i + 1) * n] for i in range(len(vals))]
        branch_datas, else_data = datas[:-1], datas[-1]
    else:
        dict_values = None
        branch_datas = [v.data for v in branch_vals]
        else_data = else_v.data
    out = else_data
    out_valid = else_v.valid_mask()
    taken = _full(n, False, torch.bool, else_data.device)
    for (cond, _), val, vdata in zip(branches, branch_vals, branch_datas):
        c = cond.data.to(torch.bool) & cond.valid_mask() & ~taken
        out = torch.where(c, vdata, out)
        out_valid = torch.where(c, val.valid_mask(), out_valid)
        taken = taken | c
    return Column(kind, out, out_valid, dict_values)


def coalesce(cols) -> Column:
    n = len(cols[0])
    branches = [(is_null(c, negate_=True), c) for c in cols[:-1]]
    return case_when(branches, cols[-1]) if len(cols) > 1 else cols[0]


# ---------------------------------------------------------------------------
# casts
# ---------------------------------------------------------------------------


def cast(col: Column, target: str) -> Column:
    """target: canonical-ish SQL type name (int, bigint, double, decimal(p,s),
    date, string, char(n), varchar(n))."""
    col = _plain(col)
    t = target.lower().replace(" ", "")
    if t in ("int", "integer", "i32"):
        if col.kind == "str":
            vals = np.asarray(
                [int(v) if _is_intstr(v) else 0 for v in col.dict_values],
                dtype=np.int64)
            ok = np.asarray([_is_intstr(v) for v in col.dict_values],
                            dtype=np.bool_)
            data = _lookup(vals, col.data)
            valid = col.valid_mask() & torch.as_tensor(
                ok, device=col.data.device)[col.data.long()]
            return Column("i64", data, valid)
        return Column("i64", prim.f64_to_i64(_as_f64(col)) if col.kind == "f64"
                      else (col.data.to(I64) // (10 ** col.scale)), col.valid)
    if t in ("bigint", "long", "i64"):
        return cast(col, "int")
    if t in ("double", "float", "f64", "real"):
        return Column("f64", _as_f64(col) if col.kind != "str" else _str_to_f64(col)[0],
                      col.valid if col.kind != "str" else _str_to_f64(col)[1])
    if t.startswith("decimal("):
        p, s = t[len("decimal("):-1].split(",")
        s = int(s)
        if is_dec(col.kind) or col.kind in ("i32", "i64", "bool"):
            cs = col.scale
            if s >= cs:
                data = col.data.to(I64) * (10 ** (s - cs))
            else:
                # round half away from zero on the dropped digits
                f = 10 ** (cs - s)
                d = col.data.to(I64)
                half = f // 2
                data = torch.where(d >= 0, (d + half) // f,
                                   -((-d + half) // f))
            return Column(f"dec({p},{s})", data, col.valid)
        f64 = _as_f64(col)
        data = prim.f64_to_i64(torch.round(f64 * (10 ** s)))
        return Column(f"dec({p},{s})", data, col.valid)
    if t == "date":
        if col.kind == "date":
            return col
        if col.kind == "str":
            days = np.asarray([_parse_date(v) for v in col.dict_values])
            ok = days >= -(10 ** 8)
            data = _lookup(days.astype(np.int32), col.data)
            valid = col.valid_mask() & _lookup(ok, col.data)
            return Column("date", data, valid)
    if t in ("string", "varchar", "char") or t.startswith(("char(", "varchar(")):
        if col.kind == "str":
            return col

        def fetch():
            # host-side dictionary build from the column values — a whole-
            # column fetch, counted through the host-read choke point
            vals = to_host(col.data)
            if is_dec(col.kind):
                s = col.scale
                strs = np.asarray([_dec_str(int(v), s) for v in vals],
                                  dtype=object)
            elif col.kind == "date":
                strs = np.asarray([_date_str(int(v)) for v in vals],
                                  dtype=object)
            else:
                strs = np.asarray([str(v) for v in vals], dtype=object)
            uniq, inv = np.unique(strs, return_inverse=True)
            return inv.astype(np.int32), uniq.astype(object)

        from nds_tpu_torch.engine.ops import timed_read
        inv, uniq = timed_read("cast_str", fetch)
        return Column("str", torch.as_tensor(inv, device=col.data.device),
                      col.valid, uniq)
    raise ValueError(f"unsupported cast target: {target}")


def _is_intstr(v) -> bool:
    try:
        int(str(v))
        return True
    except ValueError:
        return False


def _str_to_f64(col: Column):
    def conv(v):
        try:
            return float(v)
        except ValueError:
            return np.nan
    vals = np.asarray([conv(v) for v in col.dict_values], dtype=np.float64)
    data = _lookup(vals, col.data)
    valid = col.valid_mask() & ~torch.isnan(data)
    return data, valid


_EPOCH = np.datetime64("1970-01-01", "D")


def _parse_date(v) -> int:
    try:
        return int((np.datetime64(str(v), "D") - _EPOCH).astype(int))
    except Exception:
        return -(10 ** 9)


def _date_str(days: int) -> str:
    return str(_EPOCH + np.timedelta64(days, "D"))


def _dec_str(v: int, s: int) -> str:
    if s == 0:
        return str(v)
    sign = "-" if v < 0 else ""
    v = abs(v)
    return f"{sign}{v // 10**s}.{v % 10**s:0{s}d}"


def parse_date_literal(text: str) -> int:
    d = _parse_date(text)
    if d <= -(10 ** 8):
        raise ValueError(f"bad date literal: {text!r}")
    return d


# ---------------------------------------------------------------------------
# string functions (host-side on dictionaries)
# ---------------------------------------------------------------------------


_map_dict_cache: dict = {}


def _map_dict(col: Column, fn, tag=None) -> Column:
    """Apply a str->str function to the dictionary, re-uniquing the result.
    ``tag`` (a hashable description of ``fn``) enables caching per input
    dictionary, so repeated executions return the SAME output dictionary
    object — identity-keyed caches downstream depend on stable dictionary
    identities across runs."""
    def compute():
        new_vals = np.asarray([fn(str(v)) for v in col.dict_values],
                              dtype=object)
        uniq, inv = np.unique(new_vals.astype(str), return_inverse=True)
        # cache HOST arrays only: device copies are cached per device by
        # ops.host_table
        return inv.astype(np.int32), uniq.astype(object)

    if tag is None:
        remap, uniq = compute()
    else:
        from nds_tpu_torch.engine.ops import _identity_cache
        sub = _map_dict_cache.get(tag)
        if sub is None:
            with _DICT_MEMO_LOCK:
                sub = _map_dict_cache.setdefault(tag, {})
        remap, uniq = _identity_cache(sub, 256, (col.dict_values,), compute)
    return Column("str", _lookup(remap, col.data), col.valid, uniq)


def _dict_predicate(col: Column, fn) -> Column:
    mask = np.asarray([bool(fn(str(v))) for v in col.dict_values],
                      dtype=np.bool_)
    data = _lookup(mask, col.data)
    return Column("bool", data, col.valid)


def fn_substr(col: Column, start: int, length: int | None = None) -> Column:
    def f(s):
        i = start - 1 if start > 0 else len(s) + start
        return s[i:i + length] if length is not None else s[i:]
    return _map_dict(col, f, tag=("substr", start, length))


def fn_upper(col: Column) -> Column:
    return _map_dict(col, str.upper, tag=("upper",))


def fn_lower(col: Column) -> Column:
    return _map_dict(col, str.lower, tag=("lower",))


def fn_trim(col: Column) -> Column:
    return _map_dict(col, str.strip, tag=("trim",))


def fn_length(col: Column) -> Column:
    lens = np.asarray([len(str(v)) for v in col.dict_values], dtype=np.int64)
    return Column("i64", _lookup(lens, col.data), col.valid)


def fn_concat(cols) -> Column:
    """String || concatenation; distinct combinations resolved on host
    (a whole-column fetch, counted through the host-read choke point)."""
    cols = [c if c.kind == "str" else cast(c, "string") for c in cols]

    def fetch():
        parts = [np.asarray(c.dict_values.astype(str))[to_host(c.data)]
                 for c in cols]
        combined = parts[0].astype(object)
        for p in parts[1:]:
            combined = combined + p.astype(object)
        uniq, inv = np.unique(combined.astype(str), return_inverse=True)
        return inv.astype(np.int32), uniq.astype(object)

    from nds_tpu_torch.engine.ops import timed_read
    inv, uniq = timed_read("concat", fetch)
    valid = None
    vs = [c.valid for c in cols if c.valid is not None]
    if vs:
        valid = vs[0]
        for v in vs[1:]:
            valid = valid & v
    return Column("str", torch.as_tensor(inv, device=cols[0].data.device),
                  valid, uniq.astype(object))


def like_to_regex(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "^" + "".join(out) + "$"


def fn_like(col: Column, pattern: str, negate_: bool = False) -> Column:
    rx = re.compile(like_to_regex(pattern), re.DOTALL)
    res = _dict_predicate(col, lambda s: rx.match(s) is not None)
    return logical_not(res) if negate_ else res


def fn_in_strings(col: Column, values) -> Column:
    vs = set(values)
    return _dict_predicate(col, lambda s: s in vs)


# ---------------------------------------------------------------------------
# numeric functions
# ---------------------------------------------------------------------------


def fn_abs(col: Column) -> Column:
    col = _plain(col)
    if col.kind == "f64":
        return Column("f64", torch.abs(col.data), col.valid)
    return Column(col.kind, torch.abs(col.data), col.valid)


def fn_round(col: Column, digits: int = 0) -> Column:
    col = _plain(col)
    if is_dec(col.kind):
        s = col.scale
        if digits >= s:
            return col
        f = 10 ** (s - digits)
        half = f // 2
        data = torch.where(col.data >= 0,
                           (col.data + half) // f,
                           -((-col.data + half) // f)) * f
        return Column(col.kind, data, col.valid)
    scale = 10.0 ** digits
    d = _as_f64(col) * scale
    # SQL ROUND: half away from zero (torch.round is half-to-even)
    out = torch.where(d >= 0, torch.floor(d + 0.5),
                      torch.ceil(d - 0.5)) / scale
    return Column("f64", out, col.valid)


def fn_floor(col: Column) -> Column:
    return Column("i64", prim.f64_to_i64(torch.floor(_as_f64(col))),
                  col.valid)


def fn_ceil(col: Column) -> Column:
    return Column("i64", prim.f64_to_i64(torch.ceil(_as_f64(col))),
                  col.valid)


def fn_sqrt(col: Column) -> Column:
    return Column("f64", torch.sqrt(_as_f64(col).clamp(min=0.0)), col.valid)
