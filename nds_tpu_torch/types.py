# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Canonical type system shared by schema, IO, and the device engine.

Canonical type strings (see :mod:`nds_tpu_torch.schema`):

    int32 | int64 | double | date | string | char(N) | varchar(N) | decimal(P,S)

Three lowerings live here:

- ``to_arrow``: canonical -> pyarrow DataType (file/interchange representation)
- ``device_kind``: canonical -> how the column lives on device:
    * ``i32`` / ``i64``    : plain integers
    * ``date``             : int32 days-since-epoch
    * ``dec(P,S)``         : int64 scaled fixed point (value * 10**S) — exact
                             decimal arithmetic on the integer path,
                             replacing the reference's Spark Decimal
                             (ref: nds/nds_schema.py:43-47)
    * ``f64``              : float64
    * ``str``              : dictionary codes (int32) + host-side value table
"""

from __future__ import annotations

import pyarrow as pa

# Pure-string type predicates live with the schema (pyarrow-free); re-exported
# here so IO/engine code has a single import site.
from nds_tpu_torch.schema import decimal_precision_scale, is_decimal, is_string  # noqa: F401


def to_arrow(t: str) -> pa.DataType:
    """Canonical type -> pyarrow DataType used in Parquet/ORC/CSV files."""
    if t == "int32":
        return pa.int32()
    if t == "int64":
        return pa.int64()
    if t == "double":
        return pa.float64()
    if t == "date":
        return pa.date32()
    if is_string(t):
        return pa.string()
    if is_decimal(t):
        p, s = decimal_precision_scale(t)
        return pa.decimal128(p, s)
    raise ValueError(f"unknown canonical type: {t}")


def device_kind(t: str) -> str:
    """Canonical type -> device representation tag."""
    if t == "int32":
        return "i32"
    if t == "int64":
        return "i64"
    if t == "double":
        return "f64"
    if t == "date":
        return "date"
    if is_string(t):
        return "str"
    if is_decimal(t):
        p, s = decimal_precision_scale(t)
        return f"dec({p},{s})"
    raise ValueError(f"unknown canonical type: {t}")


def arrow_to_canonical(dt: pa.DataType) -> str:
    if pa.types.is_int32(dt):
        return "int32"
    if pa.types.is_int64(dt):
        return "int64"
    if pa.types.is_float64(dt) or pa.types.is_float32(dt):
        return "double"
    if pa.types.is_date(dt):
        return "date"
    if pa.types.is_string(dt) or pa.types.is_large_string(dt) or pa.types.is_dictionary(dt):
        return "string"
    if pa.types.is_decimal(dt):
        return f"decimal({dt.precision},{dt.scale})"
    if pa.types.is_timestamp(dt):
        return "date"
    raise ValueError(f"unsupported arrow type: {dt}")
