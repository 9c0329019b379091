# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Device column representation and arrow <-> device conversion.

Device kinds (see :func:`nds_tpu_torch.types.device_kind`):

    i32 / i64   plain integers                  -> int32 / int64 tensors
    f64         doubles                         -> float64 tensors
    date        calendar dates                  -> int32 days-since-epoch
    dec(P,S)    decimals                        -> int64 scaled by 10**S
    str         char/varchar/string             -> int32 dictionary codes +
                                                   host-side value table
    bool        intermediate predicates         -> bool tensors

Null handling: every column optionally carries a ``valid`` bool mask; ``None``
means all-valid. Data under invalid slots is zeroed so reductions can run
unmasked where the zero is the identity.

Encoded columns: :class:`Encoding` describes a narrow representation of
an int-path column (frame-of-reference offsets or sorted-dictionary codes).
The device-resident path loads every column plain; the streamed path of a
later slice uploads encoded chunks, and :meth:`Column.plain` decodes them.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, replace

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from nds_tpu_torch.engine import prim

_DEC_KIND_RE = re.compile(r"dec\((\d+),(\d+)\)")


@dataclass
class Encoding:
    """Narrow device representation of an int-path column.

    ``mode`` "for": stored codes are offsets from ``base`` — logical value
    = ``base + stored``. ``mode`` "dict": stored codes index the SORTED
    host-side ``values`` table — logical value = ``values[stored]``. Both
    are order-preserving (dict values are sorted ascending), which is
    what lets comparisons run in encoded space. Like a string column's
    ``dict_values``, the encoding is host metadata shared identically by
    every chunk of a table (chunk-invariant: a cache-key member)."""

    mode: str                        # "for" | "dict"
    base: int = 0                    # FOR: logical = base + stored
    values: np.ndarray | None = None  # dict: sorted logical values (host)


def encs_equal(a: Encoding | None, b: Encoding | None) -> bool:
    """Value equality of two encodings (identity fast path) — the test
    cached compiled programs apply before serving differently-encoded
    buffers (mirrors ``stream._dicts_equal`` for string dictionaries)."""
    if a is None or b is None:
        return a is b
    if a is b:
        return True
    if a.mode != b.mode or a.base != b.base:
        return False
    if a.values is None or b.values is None:
        return a.values is b.values
    return a.values is b.values or np.array_equal(a.values, b.values)


_WIDE_DTYPES = {"i32": "int32", "date": "int32", "i64": "int64",
                "bool": "bool", "f64": "float64"}


def _wide_dtype(kind: str):
    if kind.startswith("dec("):
        return np.dtype("int64")
    return np.dtype(_WIDE_DTYPES.get(kind, "int64"))


def dec_scale(kind: str) -> int:
    m = _DEC_KIND_RE.match(kind)
    if not m:
        raise ValueError(f"not a decimal kind: {kind}")
    return int(m.group(2))


def is_dec(kind: str) -> bool:
    return kind.startswith("dec(")


@dataclass
class Column:
    kind: str
    data: torch.Tensor
    valid: torch.Tensor | None = None          # bool mask; None = all valid
    dict_values: np.ndarray | None = None     # host-side strings for kind 'str'
    enc: Encoding | None = None               # narrow encoded representation

    def __len__(self) -> int:
        return int(self.data.shape[0])

    def plain(self) -> "Column":
        """Decode an encoded column to its logical (wide) representation.
        An elementwise device op that never syncs. Invalid slots are re-zeroed to
        preserve the zero-under-null invariant (an encoded 0 decodes to
        ``base``, not 0)."""
        if self.enc is None:
            return self
        wide = _TORCH_DTYPES[_wide_dtype(self.kind).name]
        if self.enc.mode == "for":
            data = self.data.to(wide) + int(self.enc.base)
        else:                                  # "dict": sorted value table
            table = torch.as_tensor(self.enc.values.astype(
                _wide_dtype(self.kind)), device=self.data.device)
            data = prim.take_clip(table, self.data)
        if self.valid is not None:
            data = torch.where(self.valid, data,
                               torch.zeros((), dtype=wide,
                                           device=data.device))
        return replace(self, data=data, enc=None)

    @property
    def scale(self) -> int:
        return dec_scale(self.kind) if is_dec(self.kind) else 0

    def valid_mask(self) -> torch.Tensor:
        """Materialized validity mask."""
        if self.valid is None:
            return torch.ones(self.data.shape[0], dtype=torch.bool,
                              device=self.data.device)
        return self.valid

    def null_count(self, nrows=None) -> int:
        """Nulls among the first ``nrows`` rows (pass the table's logical
        count — host int or DeviceCount — for a bucket-padded column; pad
        slots carry garbage validity). This is a host read: it syncs, and
        the sync is counted."""
        if self.valid is None:
            return 0
        from nds_tpu_torch.engine import ops as _ops
        invalid = ~self.valid
        # mask pads whenever the actual count may be below the physical
        # length (always for a device count: its bound can equal plen while
        # the true count is lower — pad slots carry cloned garbage validity)
        if nrows is not None and (
                isinstance(nrows, _ops.DeviceCount)
                or int(nrows) < int(self.data.shape[0])):
            invalid = invalid & _ops.live_mask(int(self.data.shape[0]),
                                               nrows, self.data.device)
        return _ops.host_sync(invalid.sum())

    def take(self, indices) -> "Column":
        # clip mode: out-of-range pad indices duplicate a real row, so pad
        # slots never hold values outside the column's domain (dict codes
        # stay in range, host-side conversions stay safe)
        return replace(
            self,
            data=prim.take_clip(self.data, indices),
            valid=None if self.valid is None else prim.take_clip(
                self.valid, indices),
        )

    def with_valid(self, valid) -> "Column":
        """Attach a (possibly combined) validity mask, zeroing masked slots."""
        if valid is None:
            return self
        data = torch.where(valid, self.data,
                           torch.zeros((), dtype=self.data.dtype,
                                       device=self.data.device))
        return replace(self, data=data, valid=valid)


# ---------------------------------------------------------------------------
# arrow -> device
# ---------------------------------------------------------------------------

_NUMERIC_DTYPES = {
    "i32": np.int32,
    "i64": np.int64,
    "f64": np.float64,
    "date": np.int32,
    "bool": np.bool_,
}

# numpy dtype name -> torch dtype (host <-> device transfers)
_TORCH_DTYPES = {"int8": torch.int8, "int16": torch.int16,
                 "int32": torch.int32, "int64": torch.int64,
                 "float32": torch.float32, "float64": torch.float64,
                 "bool": torch.bool}


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """Host numpy array -> tensor on ``device`` with the same dtype."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:            # arrow-backed zero-copy buffer
        a = a.copy()
    return torch.from_numpy(a).to(device)


def _decimal_to_int64(arr: pa.ChunkedArray, s: int, target_scale: int) -> np.ndarray:
    """decimal128(p, s) -> int64 of value * 10**target_scale, exactly.

    Reads the unscaled int128 values straight out of the arrow buffer (low
    word is the exact value while it fits in int64, which every schema decimal
    does) and rescales in integer arithmetic.
    """
    out = np.empty(len(arr), dtype=np.int64)
    pos = 0
    for chunk in arr.chunks:
        n = len(chunk)
        buf = chunk.buffers()[1]
        raw = np.frombuffer(buf, dtype="<i8")
        lo = raw[2 * chunk.offset: 2 * (chunk.offset + n): 2]
        out[pos:pos + n] = lo
        pos += n
    if target_scale > s:
        out = out * (10 ** (target_scale - s))
    elif target_scale < s:
        out = out // (10 ** (s - target_scale))
    return out


def _bucket_pad(a: np.ndarray, cap: int):
    """Zero-pad a host array to the bucket capacity (the padded-prefix
    invariant: rows past the logical count are ignored garbage). Padding on
    host keeps raw table lengths out of the device shape universe: every
    tensor length is a power-of-two bucket."""
    n = a.shape[0]
    if n >= cap:
        return a
    return np.concatenate([a, np.zeros(cap - n, dtype=a.dtype)])


def from_arrow_array(arr, canonical_type: str, cap: int | None = None,
                     device=None) -> Column:
    """One arrow column (Array or ChunkedArray) -> device Column on
    ``device`` (default ``cuda``; raises without a GPU unless ``cpu`` is
    asked for), physically padded to ``cap`` rows when given."""
    from nds_tpu_torch import resolve_device
    from nds_tpu_torch import types as _t

    device = resolve_device(device)

    if isinstance(arr, pa.Array):
        arr = pa.chunked_array([arr])
    kind = _t.device_kind(canonical_type)
    n = len(arr)
    if cap is None:
        cap = n
    null_count = arr.null_count
    valid_np = None
    if null_count:
        valid_np = _bucket_pad(
            ~np.asarray(pc.is_null(arr).combine_chunks().to_numpy(zero_copy_only=False)),
            cap)

    if kind == "str":
        if not pa.types.is_dictionary(arr.type):
            arr = pc.dictionary_encode(arr)
        combined = arr.combine_chunks()
        if isinstance(combined, pa.ChunkedArray):
            combined = combined.chunk(0) if combined.num_chunks else pa.array(
                [], type=combined.type)
        codes_arr = combined.indices
        if null_count:
            codes_arr = pc.fill_null(codes_arr, 0)
        codes = np.asarray(codes_arr.to_numpy(zero_copy_only=False), dtype=np.int32)
        values = np.asarray(combined.dictionary.to_pylist(), dtype=object)
        if values.size == 0:
            values = np.asarray([""], dtype=object)
            codes = np.zeros(n, dtype=np.int32)
        col = Column("str", to_device(_bucket_pad(codes, cap), device),
                     None if valid_np is None else to_device(valid_np, device),
                     values)
        return col

    if kind.startswith("dec("):
        s = dec_scale(kind)
        if pa.types.is_decimal(arr.type):
            filled = pc.fill_null(arr, pa.scalar(0, arr.type)) if null_count else arr
            data_np = _decimal_to_int64(filled, arr.type.scale, s)
        else:  # e.g. float column being treated as decimal
            data_np = np.asarray(pc.fill_null(arr, 0).combine_chunks().to_numpy(
                zero_copy_only=False))
            data_np = np.round(data_np * (10 ** s)).astype(np.int64)
        return Column(kind, to_device(_bucket_pad(data_np, cap), device),
                      None if valid_np is None else to_device(valid_np, device))

    # plain numeric / date / bool
    if kind == "date":
        arr = pc.cast(arr, pa.int32())
    filled = pc.fill_null(arr, 0) if null_count else arr
    np_arr = np.asarray(filled.combine_chunks().to_numpy(zero_copy_only=False))
    data = to_device(_bucket_pad(np_arr.astype(_NUMERIC_DTYPES[kind]), cap),
                     device)
    return Column(kind, data,
                  None if valid_np is None else to_device(valid_np, device))


def from_arrow(table: pa.Table, canonical_types: dict | None = None,
               device=None):
    """arrow Table -> DeviceTable on ``device`` (default ``cuda``; raises
    without a GPU unless ``cpu`` is asked for). ``canonical_types``
    overrides the per-column canonical type (defaults to inference from
    arrow types). Columns are physically padded to the power-of-two bucket
    (padded-prefix invariant)."""
    from nds_tpu_torch import resolve_device
    from nds_tpu_torch import types as _t
    from nds_tpu_torch.engine.ops import bucket_len
    from nds_tpu_torch.engine.table import DeviceTable

    device = resolve_device(device)
    cap = bucket_len(table.num_rows)
    cols = {}
    for name in table.column_names:
        ct = (canonical_types or {}).get(name) or _t.arrow_to_canonical(
            table.schema.field(name).type)
        cols[name] = from_arrow_array(table[name], ct, cap, device)
    return DeviceTable(cols, table.num_rows)


# ---------------------------------------------------------------------------
# device -> arrow
# ---------------------------------------------------------------------------

def _slice_col(col: Column, nrows: int | None) -> Column:
    """Slice off the bucket-padding suffix (padded-prefix invariant)."""
    if nrows is None or nrows >= col.data.shape[0]:
        return col
    return replace(col, data=col.data[:nrows],
                   valid=None if col.valid is None else col.valid[:nrows])


def slice_col_prefix(col: Column, cap: int) -> Column:
    """Public prefix slice — re-bucketing a lazily-compacted column down to
    a resolved tight capacity (see ``ops.resolve_table``)."""
    return _slice_col(col, cap)


def _decode_host(col: Column) -> Column:
    """Host-side decode of an encoded column whose data is already a
    fetched numpy array (materialize path): the device->host transfer
    moved the NARROW codes, and the widening happens here — the exact
    analogue of ``dict_values[codes]`` for strings."""
    if col.enc is None:
        return col
    wide = _wide_dtype(col.kind)
    codes = np.asarray(col.data)
    if col.enc.mode == "for":
        data = codes.astype(wide) + wide.type(col.enc.base)
    else:
        data = col.enc.values.astype(wide)[
            np.clip(codes, 0, len(col.enc.values) - 1)]
    if col.valid is not None:
        data = np.where(np.asarray(col.valid), data,
                        np.zeros((), dtype=wide))
    return replace(col, data=data, enc=None)


def column_to_arrow(col: Column, nrows: int | None = None) -> pa.Array:
    """Device -> arrow; ``nrows`` drops the padding before the transfer.
    Encoded columns decode on HOST after the fetch, so the transfer moves
    the narrow representation."""
    col = _slice_col(col, nrows)
    if not isinstance(col.data, np.ndarray):     # not already fetched
        col = _fetch_columns([col])[0]
    col = _decode_host(col)
    valid_np = None if col.valid is None else np.asarray(col.valid)

    if col.kind == "str":
        codes = np.asarray(col.data)
        out = col.dict_values[codes]
        mask = None if valid_np is None else ~valid_np
        return pa.array(out, type=pa.string(), mask=mask)

    data_np = np.asarray(col.data)
    mask = None if valid_np is None else ~valid_np
    if col.kind == "date":
        return pa.array(data_np.astype("int32"), type=pa.int32(), mask=mask).cast(pa.date32())
    if is_dec(col.kind):
        s = dec_scale(col.kind)
        # reinterpret the int64 fixed-point values as decimal128(38, s) by
        # building the 128-bit little-endian buffer directly (a cast would
        # multiply by 10**s instead of reinterpreting)
        lo = data_np.astype(np.int64)
        n = lo.shape[0]
        buf = np.empty((n, 2), dtype=np.int64)
        buf[:, 0] = lo
        buf[:, 1] = np.where(lo < 0, -1, 0)
        arr = pa.Array.from_buffers(
            pa.decimal128(38, s), n, [None, pa.py_buffer(buf.tobytes())])
        if valid_np is not None:
            arr = pc.if_else(pa.array(valid_np), arr, pa.scalar(None, arr.type))
        return arr
    pa_type = {
        "i32": pa.int32(), "i64": pa.int64(), "f64": pa.float64(), "bool": pa.bool_(),
    }[col.kind]
    return pa.array(data_np, type=pa_type, mask=mask)


def _fetch_columns(cols):
    """Materialize device buffers on host in one pass, returning Columns
    whose data/valid are host numpy arrays. Blocked time and bytes feed the
    per-query accounting (ops.sync_wait_ns / fetch_bytes)."""
    import time as _time

    from nds_tpu_torch.engine import ops as _ops

    def host(x):
        if x is None or isinstance(x, np.ndarray):
            return x
        return _ops.to_host(x)

    t0 = _time.perf_counter_ns()
    # the result fetch passes the host-read choke point (not a counted
    # sync: its blocked time is charged as wait, as for every read)
    fetched = _ops.host_read("fetch", lambda: [
        (host(c.data), host(c.valid)) for c in cols])
    _ops.add_sync_wait(_time.perf_counter_ns() - t0)
    _ops.add_fetch_bytes(sum(
        d.nbytes + (0 if v is None else v.nbytes) for d, v in fetched))
    return [replace(c, data=d, valid=v)
            for c, (d, v) in zip(cols, fetched)]


def to_arrow(dt) -> pa.Table:
    """DeviceTable -> arrow Table. Crossing to host is THE legitimate
    resolve point for a lazy count (DESIGN.md item 1)."""
    from nds_tpu_torch.engine import ops as _ops
    nrows = _ops.count_int(dt.nrows)
    cols = [_slice_col(c, nrows) for c in dt.columns.values()]
    cols = _fetch_columns(cols)   # one device->host round trip for the table
    arrays = [column_to_arrow(c) for c in cols]
    return pa.table(arrays, names=list(dt.columns.keys()))
