# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Minimal Avro Object Container File codec for arrow tables.

The reference's Load Test can transcode to avro through spark-avro
(ref: nds/nds_transcode.py:61,85,257,263); this environment ships no avro
library, so the subset of the format the NDS schemas need is implemented
here directly against the Avro 1.11 spec: null-union primitives, the
``date`` logical type on int, and the ``decimal`` logical type on bytes.
Container layout: magic ``Obj\\x01``, metadata map (``avro.schema``,
``avro.codec``), 16-byte sync marker, then blocks of
``(row count, byte size, data, sync)`` with optional deflate codec.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib

import pyarrow as pa

MAGIC = b"Obj\x01"
_BLOCK_ROWS = 4096


# -- varint / primitive encoders --------------------------------------------

def _w_long(buf: io.BytesIO, n: int) -> None:
    n = (n << 1) ^ (n >> 63)                     # zigzag
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.write(bytes((b | 0x80,)))
        else:
            buf.write(bytes((b,)))
            return


def _w_bytes(buf: io.BytesIO, b: bytes) -> None:
    _w_long(buf, len(b))
    buf.write(b)


def _r_long(buf) -> int:
    shift, acc = 0, 0
    while True:
        byte = buf.read(1)
        if not byte:
            raise ValueError("truncated avro file: unexpected EOF in varint")
        b = byte[0]
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)               # un-zigzag


def _r_bytes(buf) -> bytes:
    return buf.read(_r_long(buf))


# -- arrow <-> avro schema mapping ------------------------------------------

def _avro_type(t: pa.DataType):
    if pa.types.is_boolean(t):
        return "boolean"
    if pa.types.is_date32(t):
        return {"type": "int", "logicalType": "date"}
    if pa.types.is_integer(t):
        return "int" if t.bit_width <= 32 else "long"
    if pa.types.is_float32(t):
        return "float"
    if pa.types.is_floating(t):
        return "double"
    if pa.types.is_decimal(t):
        return {"type": "bytes", "logicalType": "decimal",
                "precision": t.precision, "scale": t.scale}
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return "string"
    raise ValueError(f"avro: unsupported arrow type {t}")


def _arrow_type(t) -> pa.DataType:
    if isinstance(t, list):                      # ["null", T]
        inner = [x for x in t if x != "null"]
        return _arrow_type(inner[0])
    if isinstance(t, dict):
        lt = t.get("logicalType")
        if lt == "date":
            return pa.date32()
        if lt == "decimal":
            return pa.decimal128(t["precision"], t["scale"])
        return _arrow_type(t["type"])
    return {"boolean": pa.bool_(), "int": pa.int32(), "long": pa.int64(),
            "float": pa.float32(), "double": pa.float64(),
            "string": pa.string(), "bytes": pa.binary()}[t]


def _schema_json(schema: pa.Schema, name: str) -> str:
    fields = [{"name": f.name, "type": ["null", _avro_type(f.type)]}
              for f in schema]
    return json.dumps({"type": "record", "name": name or "row",
                       "fields": fields})


# -- value encoders (one closure per column type, applied row-wise) ----------

def _encoder(t: pa.DataType):
    if pa.types.is_decimal(t):
        scale = t.scale

        def enc(buf, v):
            unscaled = int(v.scaleb(scale))      # decimal.Decimal in
            length = max(1, (unscaled.bit_length() + 8) // 8)
            _w_bytes(buf, unscaled.to_bytes(length, "big", signed=True))
        return enc
    if pa.types.is_date32(t):
        epoch = __import__("datetime").date(1970, 1, 1)
        return lambda buf, v: _w_long(buf, (v - epoch).days)
    if pa.types.is_boolean(t):
        return lambda buf, v: buf.write(b"\x01" if v else b"\x00")
    if pa.types.is_integer(t):
        return _w_long
    if pa.types.is_float32(t):
        return lambda buf, v: buf.write(struct.pack("<f", v))
    if pa.types.is_floating(t):
        return lambda buf, v: buf.write(struct.pack("<d", v))
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return lambda buf, v: _w_bytes(buf, v.encode("utf-8"))
    raise ValueError(f"avro: unsupported arrow type {t}")


def _decoder(t):
    if isinstance(t, list):
        inner = _decoder([x for x in t if x != "null"][0])

        def dec(buf):
            return None if _r_long(buf) == 0 else inner(buf)
        return dec
    if isinstance(t, dict):
        lt = t.get("logicalType")
        if lt == "date":
            import datetime
            epoch = datetime.date(1970, 1, 1)
            day = datetime.timedelta(days=1)
            return lambda buf: epoch + day * _r_long(buf)
        if lt == "decimal":
            import decimal
            scale = t["scale"]

            def dec(buf):
                raw = _r_bytes(buf)
                return decimal.Decimal(
                    int.from_bytes(raw, "big", signed=True)).scaleb(-scale)
            return dec
        return _decoder(t["type"])
    return {
        "boolean": lambda buf: buf.read(1) == b"\x01",
        "int": _r_long, "long": _r_long,
        "float": lambda buf: struct.unpack("<f", buf.read(4))[0],
        "double": lambda buf: struct.unpack("<d", buf.read(8))[0],
        "string": lambda buf: _r_bytes(buf).decode("utf-8"),
        "bytes": _r_bytes,
    }[t]


# -- container read/write ----------------------------------------------------

def write_avro(table: pa.Table, path: str, compression: str | None = None,
               name: str | None = None) -> None:
    """Write an arrow table as one Avro Object Container File.

    Row-at-a-time pure-python codec: functional-only by design — avro is
    for format coverage and round-trip validation, not the timed Load
    Test path (use parquet/orc there; this encoder is orders of magnitude
    slower on SF>=1 fact tables).
    """
    if compression in ("deflate", "zlib"):
        codec = "deflate"
    elif compression in (None, "none", "null", "uncompressed"):
        codec = "null"
    else:
        raise ValueError(
            f"unsupported avro codec {compression!r}: this writer "
            "implements deflate and null only")
    sync = os.urandom(16)
    encoders = [_encoder(f.type) for f in table.schema]
    cols = [table.column(i).to_pylist() for i in range(table.num_columns)]
    with open(path, "wb") as f:
        head = io.BytesIO()
        head.write(MAGIC)
        meta = {"avro.schema": _schema_json(table.schema, name),
                "avro.codec": codec}
        _w_long(head, len(meta))
        for k, v in meta.items():
            _w_bytes(head, k.encode())
            _w_bytes(head, v.encode())
        _w_long(head, 0)                          # end of metadata map
        head.write(sync)
        f.write(head.getvalue())
        for lo in range(0, table.num_rows, _BLOCK_ROWS):
            hi = min(lo + _BLOCK_ROWS, table.num_rows)
            block = io.BytesIO()
            for r in range(lo, hi):
                for enc, col in zip(encoders, cols):
                    v = col[r]
                    if v is None:
                        _w_long(block, 0)         # union branch: null
                    else:
                        _w_long(block, 1)
                        enc(block, v)
            data = block.getvalue()
            if codec == "deflate":
                data = zlib.compress(data)[2:-4]  # raw deflate per spec
            out = io.BytesIO()
            _w_long(out, hi - lo)
            _w_bytes(out, data)
            out.write(sync)
            f.write(out.getvalue())


def read_avro(path: str) -> pa.Table:
    """Read an Avro Object Container File back into arrow."""
    with open(path, "rb") as f:
        raw = f.read()
    buf = io.BytesIO(raw)
    if buf.read(4) != MAGIC:
        raise ValueError(f"not an avro container file: {path}")
    meta = {}
    while True:
        n = _r_long(buf)
        if n == 0:
            break
        if n < 0:
            # spec: a negative block count is followed by the block's
            # byte size, then |n| entries
            _r_long(buf)
            n = -n
        for _ in range(n):
            k = _r_bytes(buf).decode()
            meta[k] = _r_bytes(buf)
    sync = buf.read(16)
    schema = json.loads(meta["avro.schema"])
    codec = meta.get("avro.codec", b"null").decode()
    decoders = [(_decoder(fld["type"])) for fld in schema["fields"]]
    names = [fld["name"] for fld in schema["fields"]]
    rows = [[] for _ in names]
    while buf.tell() < len(raw):
        count = _r_long(buf)
        data = _r_bytes(buf)
        if buf.read(16) != sync:
            raise ValueError("avro: sync marker mismatch")
        if codec == "deflate":
            data = zlib.decompress(data, wbits=-15)
        block = io.BytesIO(data)
        for _ in range(count):
            for dec, acc in zip(decoders, rows):
                acc.append(dec(block))
    arrow_types = [_arrow_type(fld["type"]) for fld in schema["fields"]]
    arrays = [pa.array(vals, type=t) for vals, t in zip(rows, arrow_types)]
    return pa.table(arrays, names=names)
