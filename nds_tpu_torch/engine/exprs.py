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
from nds_tpu_torch.engine.column import Column, dec_scale, encs_equal, is_dec
from nds_tpu_torch.engine.ops import (device, host_table,
                                      ordered_codes_merged, plain_col,
                                      to_host, upload)

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
        d = prim.true_div(d, 10.0 ** col.scale)
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
            valid = col.valid_mask() & upload(
                ok, col.data.device)[col.data.long()]
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
        return Column("str", upload(inv, col.data.device), col.valid, uniq)
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
    return Column("str", upload(inv, cols[0].data.device), valid,
                  uniq.astype(object))


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
    out = prim.true_div(torch.where(d >= 0, torch.floor(d + 0.5),
                                    torch.ceil(d - 0.5)), scale)
    return Column("f64", out, col.valid)


def fn_floor(col: Column) -> Column:
    return Column("i64", prim.f64_to_i64(torch.floor(_as_f64(col))),
                  col.valid)


def fn_ceil(col: Column) -> Column:
    return Column("i64", prim.f64_to_i64(torch.ceil(_as_f64(col))),
                  col.valid)


def fn_sqrt(col: Column) -> Column:
    return Column("f64", torch.sqrt(_as_f64(col).clamp(min=0.0)), col.valid)


# ---------------------------------------------------------------------------
# fused chunk-scan predicate lowering (engine half of the shared rule in
# analysis/kernel_spec.py — see DESIGN.md "Fused chunk kernels")
# ---------------------------------------------------------------------------
#
# The streamed pipeline extracts, ONCE at record time, a chunk-invariant
# spec of its chunk-local WHERE conjuncts for the K4 kernel
# (engine/kernels.chunk_scan): ordered comparisons rebase into ENCODED space (FOR codes shift by
# the base, sorted-dict values map to code indexes through bisect — the
# exact rational threshold math lives in analysis/kernel_spec.py), string
# equality resolves against the whole-table dictionary, and anything the
# shared eligibility rule declines stays in the recorded per-chunk graph —
# per conjunct, never all-or-nothing. The lowered semantics are bit for bit
# the eager kernels above (compare/_encoded_compare_views/_eval_in_list/
# is_null).


def scan_class(kind: str) -> str | None:
    """Device kind -> the coarse class the shared eligibility rule
    speaks."""
    if kind == "str":
        return "str"
    if kind == "date":
        return "date"
    if kind in ("i32", "i64", "f64") or is_dec(kind):
        return "num"
    if kind == "bool":
        return "bool"
    return None


def _scan_resolve(cols_meta):
    """ref -> column position resolver over the chunk's aliased columns
    (planner suffix-match scoping: bare names must match exactly one)."""
    def resolve(ref):
        name = ref.name.lower()
        if ref.table:
            key = f"{ref.table.lower()}.{name}"
            hits = [i for i, m in enumerate(cols_meta)
                    if m["name"] == key]
        else:
            hits = [i for i, m in enumerate(cols_meta)
                    if m["name"].split(".")[-1] == name]
        return hits[0] if len(hits) == 1 else None
    return resolve


def _scan_float_meta(meta):
    """(fmode, base, values-or-None, sdiv) of one column's float-lane
    decode — exactly ``_as_f64(plain(col))``."""
    kind, enc = meta["kind"], meta["enc"]
    sdiv = float(10 ** dec_scale(kind)) if is_dec(kind) else 1.0
    if enc is None:
        return "id", 0, None, sdiv
    if enc.mode == "for":
        return "for", int(enc.base), None, sdiv
    return "dict", 0, enc.values, sdiv


def _scan_int_entry(entry, meta):
    """Map a VALUE-space integer entry into the column's STORED space
    (raw uploaded codes) — the encoded-space evaluation."""
    from nds_tpu_torch.analysis.kernel_spec import dict_map, shift_for
    enc = meta["enc"]
    if enc is None:
        return entry
    if enc.mode == "for":
        return shift_for(entry, int(enc.base))
    return dict_map(entry, [int(v) for v in enc.values])


def _scan_frac(value, scale: int):
    """Exact rational of a numeric literal at the column's stored scale
    (the engine's _align_decimals arithmetic, as a Fraction — Fraction
    is exact for int, Decimal AND float inputs)."""
    from fractions import Fraction
    return Fraction(value) * (10 ** scale)


def _lower_compare(op, lit, ci, meta):
    from fractions import Fraction

    from nds_tpu_torch.analysis import kernel_spec as KS
    from nds_tpu_torch.sql import ast as A
    kind = meta["kind"]
    cls = scan_class(kind)
    if cls == "str":
        if not isinstance(lit, A.Literal) or lit.value is None:
            return [("false", ci)]
        # an equality maps to the literal's one code in the whole-table
        # dictionary (absent literal -> constant False/True). The
        # dictionary is in first-appearance order, not sorted, so the code
        # is looked up, not bisected (the reference bisects here, which
        # finds a wrong or no code on an unsorted dictionary)
        if meta["dict_values"] is None or not len(meta["dict_values"]):
            return [("false", ci)]
        code = _dict_codes(meta["dict_values"]).get(str(lit.value))
        if code is None:
            return [("false" if op == "=" else "true", ci)]
        return [("ieq" if op == "=" else "ine", ci, code)]
    # date column vs date-ish literal -> integer days
    if isinstance(lit, A.DateLiteral) or (cls == "date"
                                          and isinstance(lit, A.Literal)
                                          and isinstance(lit.value, str)):
        text = lit.text if isinstance(lit, A.DateLiteral) else lit.value
        days = KS.parse_days(text)
        if isinstance(lit, A.DateLiteral) and days is None:
            return None            # eager arm raises on a bad DateLiteral
        if days is None:
            return [("false", ci)]  # str cast -> invalid literal (engine)
        ent = _scan_int_entry(KS.value_cmp(op, Fraction(days)), meta)
        return [_with_ci(ent, ci)]
    if lit.value is None:
        return [("false", ci)]     # NULL literal: comparison never true
    v = lit.value
    if kind == "f64" or isinstance(v, float):
        # the eager engine float-compares whenever either side is f64
        # (_as_f64 both); the kernel's float lane decodes identically
        fop = {"=": "feq", "<>": "fne", "<": "flt", "<=": "fle",
               ">": "fgt", ">=": "fge"}[op]
        return [(fop, ci, _f64_literal(v))]
    q = _scan_frac(v, dec_scale(kind) if is_dec(kind) else 0)
    ent = _scan_int_entry(KS.value_cmp(op, q), meta)
    return [_with_ci(ent, ci)]


def _dict_codes(dict_values) -> dict:
    """value -> code of a string dictionary (first code of a value)."""
    out: dict = {}
    for i, v in enumerate(dict_values):
        out.setdefault(str(v), i)
    return out


def _f64_literal(v) -> float:
    """float64 value of a numeric literal exactly as X.literal +
    _as_f64 would produce it (Decimal: scaled int divided by 10**s)."""
    from decimal import Decimal
    if isinstance(v, Decimal):
        s = max(0, -v.as_tuple().exponent)
        return int(v.scaleb(s)) / (10.0 ** s)
    return float(v)


def _with_ci(ent, ci):
    """Insert the column index into a kernel_spec entry tuple."""
    kind = ent[0]
    if kind in ("true", "false"):
        return (kind, ci)
    if kind in ("ieq", "ine", "ile", "ige"):
        return (kind, ci, ent[1])
    if kind in ("irange", "nrange"):
        return (kind, ci, ent[1], ent[2])
    raise ValueError(f"unexpected entry {ent!r}")


def _lower_between(c, ci, meta):
    """Total over the eligible shapes (analysis/kernel_spec.py rejects
    unparseable date bounds and negated-with-float-bounds up front):
    int-lane bounds fuse into one (n)range entry in encoded space;
    an f64 column (or a float bound) takes the float lane — a mixed
    pair lowers to TWO entries under one conjunct (the engine
    evaluates each side in its own lane; the entries AND exactly
    like logical_and of the two compares)."""
    from fractions import Fraction

    from nds_tpu_torch.analysis import kernel_spec as KS
    from nds_tpu_torch.sql import ast as A
    kind = meta["kind"]

    def bound_days(b):
        text = b.text if isinstance(b, A.DateLiteral) else b.value
        return KS.parse_days(text)

    def is_float_bound(b):
        return kind == "f64" or (isinstance(b, A.Literal)
                                 and isinstance(b.value, float))

    def bound_frac(b):
        if isinstance(b, A.DateLiteral) or isinstance(b.value, str):
            d = bound_days(b)
            return None if d is None else Fraction(d)
        return _scan_frac(b.value, dec_scale(kind) if is_dec(kind) else 0)

    flo, fhi = is_float_bound(c.low), is_float_bound(c.high)
    if flo and fhi:
        lo = _f64_literal(c.low.value)
        hi = _f64_literal(c.high.value)
        return [("fnrange" if c.negated else "frange", ci, lo, hi)]
    if flo or fhi:
        if c.negated:
            return None       # mixed-lane negation is not expressible
        ents = []
        for b, fl, fop, iop in ((c.low, flo, "fge", ">="),
                                (c.high, fhi, "fle", "<=")):
            if fl:
                ents.append((fop, ci, _f64_literal(b.value)))
            else:
                q = bound_frac(b)
                if q is None:
                    return None
                ents.append(_with_ci(
                    _scan_int_entry(KS.value_cmp(iop, q), meta), ci))
        return ents
    qlo, qhi = bound_frac(c.low), bound_frac(c.high)
    if qlo is None or qhi is None:
        return None           # eligibility pre-checks parseability
    ge = KS.value_cmp(">=", qlo)
    le = KS.value_cmp("<=", qhi)
    ent = _scan_int_entry(("irange", ge[1], le[1]), meta)
    if c.negated:
        # both codecs are order-preserving, so value BETWEEN [lo,hi]
        # <=> code in the mapped range — negation flips in code space
        ent = ("nrange", ent[1], ent[2])
    return [_with_ci(ent, ci)]


def _lower_in_list(c, ci, meta):
    """Mirror Planner._eval_in_list exactly (Decimal scaling, fractional
    drop, ANSI NOT IN with NULL, string dictionary membership)."""
    import bisect
    from decimal import Decimal
    kind = meta["kind"]
    vals = [it.value for it in c.items]
    has_null = any(v is None for v in vals)
    vals = [v for v in vals if v is not None]
    if c.negated and has_null:
        return [("false", ci)]     # ANSI: NOT IN with NULL never true
    enc = meta["enc"]
    if kind == "str":
        index = _dict_codes(meta["dict_values"]) \
            if meta["dict_values"] is not None else {}
        codes = [index[str(v)] for v in vals if str(v) in index]
        if not codes:
            # no literal occurs in the dictionary: membership is
            # all-false, so NOT IN is true for every non-null row
            return [("true" if c.negated else "false", ci)]
        return [("inotin" if c.negated else "iin", ci, tuple(codes))]
    if kind == "f64":
        fl = tuple(float(v) for v in vals)
        if not fl:
            return [("true" if c.negated else "false", ci)]
        return [("fnotin" if c.negated else "fin", ci, fl)]
    scale = dec_scale(kind) if is_dec(kind) else 0
    nums = []
    for v in vals:
        if not isinstance(v, Decimal):
            v = Decimal(str(v))
        scaled = v.scaleb(scale)
        if scaled == scaled.to_integral_value():
            nums.append(int(scaled))
    if not nums:
        # every literal is fractional at this scale: membership is
        # all-false (engine drops them), so NOT IN keeps non-null rows
        return [("true" if c.negated else "false", ci)]
    if enc is not None and enc.mode == "for":
        stored = tuple(n - int(enc.base) for n in nums)
    elif enc is not None:
        tv = [int(x) for x in enc.values]
        stored = []
        for n in nums:
            i = bisect.bisect_left(tv, n)
            if i < len(tv) and tv[i] == n:
                stored.append(i)
        if not stored and not c.negated:
            return [("false", ci)]
        if not stored and c.negated:
            return [("true", ci)]
        stored = tuple(stored)
    else:
        stored = tuple(nums)
    return [("inotin" if c.negated else "iin", ci, stored)]


def lower_scan_spec(conjuncts, cols_meta, owned):
    """(ScanSpec | None, kept conjuncts): lower every eligible
    chunk-owned conjunct into the fused scan pass and return the rest
    for the recorded per-chunk graph. ``cols_meta`` describes the chunk's
    columns in flattened-buffer order (dicts with name/kind/enc/
    dict_values/data_slot/valid_slot); ``owned(c)`` is the planner's
    single-ownership test for the streamed part.

    None means NO fused pass (nothing eligible, or an eligible conjunct
    that the lowering declines — the whole pass then stands down, as in
    the reference). An error inside the lowering raises."""
    from nds_tpu_torch.analysis.kernel_spec import eligible_conjunct
    from nds_tpu_torch.engine.kernels import ScanSpec

    resolve = _scan_resolve(cols_meta)

    def class_of(ref):
        i = resolve(ref)
        return None if i is None else scan_class(cols_meta[i]["kind"])

    kept, entries, used = [], [], {}
    tables = []
    spec_cols = []

    def col_index(i):
        if i in used:
            return used[i]
        meta = cols_meta[i]
        fmode, base, values, sdiv = _scan_float_meta(meta)
        tbl = -1
        if fmode == "dict":
            tbl = len(tables)
            tables.append(np.asarray(values).astype(np.int64))
        spec_cols.append((meta["data_slot"], meta["valid_slot"],
                          fmode, base, tbl, sdiv))
        used[i] = len(spec_cols) - 1
        return used[i]

    n_lowered = 0
    for c in conjuncts:
        if not owned(c) or not eligible_conjunct(c, class_of):
            kept.append(c)
            continue
        ents = _lower_one(c, resolve, cols_meta, col_index)
        if ents is None:
            return None, list(conjuncts)
        entries.extend(ents)
        n_lowered += 1
    if not n_lowered:
        return None, list(conjuncts)
    return ScanSpec(entries, spec_cols, tables=tables,
                    n_conjuncts=n_lowered), kept


def _lower_one(c, resolve, cols_meta, col_index):
    from nds_tpu_torch.analysis.kernel_spec import _ref_lit
    from nds_tpu_torch.sql import ast as A
    got = _ref_lit(c)
    if got is not None:
        ref, lit, op = got
        i = resolve(ref)
        return _lower_compare(op, lit, col_index(i), cols_meta[i])
    if isinstance(c, A.Between):
        i = resolve(c.expr)
        return _lower_between(c, col_index(i), cols_meta[i])
    if isinstance(c, A.InList):
        i = resolve(c.expr)
        return _lower_in_list(c, col_index(i), cols_meta[i])
    if isinstance(c, A.IsNull):
        i = resolve(c.expr)
        ci = col_index(i)
        if cols_meta[i]["valid_slot"] < 0 and not c.negated:
            return [("false", ci)]   # no mask: nothing is null
        return [("notnull" if c.negated else "isnull", ci)]
    return None
