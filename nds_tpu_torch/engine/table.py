# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""DeviceTable: an ordered set of named device columns of equal length.

Padded-prefix invariant: columns may be physically longer than the table's
logical row count (``nrows``); rows past ``nrows`` are garbage pads that
every operator ignores (see :mod:`nds_tpu_torch.engine.ops` — bucketed shapes).
``plen`` is the physical length.

ChunkedTable: a host-resident table bigger than the session's
``stream_bytes`` threshold, streamed through statements in row chunks
(engine/stream.py).
"""

from __future__ import annotations

import numpy as np
import torch

from nds_tpu_torch.engine.column import Column

# rows per streamed chunk (the ``stream_chunk_rows`` session setting
# overrides it per table)
CHUNK_ROWS = 1 << 22


class DeviceTable:
    def __init__(self, columns: dict[str, Column], nrows: int | None = None,
                 plen: int | None = None):
        self.columns = dict(columns)
        if nrows is None:
            nrows = len(next(iter(columns.values()))) if columns else 0
        self.nrows = nrows
        # physical length; only meaningful to pass for column-less tables
        # (aggregation contexts carry capacity without materialized columns)
        if plen is None:
            plen = len(next(iter(columns.values()))) if columns else nrows
        self._plen = plen

    @property
    def plen(self) -> int:
        if self.columns:
            return len(next(iter(self.columns.values())))
        return self._plen

    @property
    def column_names(self):
        return list(self.columns.keys())

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def select(self, names) -> "DeviceTable":
        return DeviceTable({n: self.columns[n] for n in names}, self.nrows,
                           self.plen)

    def with_column(self, name: str, col: Column) -> "DeviceTable":
        cols = dict(self.columns)
        cols[name] = col
        return DeviceTable(cols, self.nrows, self.plen)

    def rename(self, mapping: dict[str, str]) -> "DeviceTable":
        return DeviceTable(
            {mapping.get(n, n): c for n, c in self.columns.items()},
            self.nrows, self.plen)

    def take(self, indices, nrows: int | None = None) -> "DeviceTable":
        """Row gather (one fused device dispatch for every column): logical
        length defaults to the index count (exact materialization). Pass
        ``nrows`` when gathering with a padded index vector or permutation
        to preserve the logical count."""
        from nds_tpu_torch.engine.ops import gather_table_rows
        n = int(indices.shape[0]) if nrows is None else nrows
        if not self.columns:
            return DeviceTable({}, n, plen=int(indices.shape[0]))
        return gather_table_rows(self, indices, n)

    def to_arrow(self):
        from nds_tpu_torch.engine.column import to_arrow
        return to_arrow(self)

    @staticmethod
    def from_arrow(table, canonical_types=None,
                   device=None) -> "DeviceTable":
        from nds_tpu_torch.engine.column import from_arrow
        return from_arrow(table, canonical_types, device)

    def __repr__(self):
        cols = ", ".join(f"{n}:{c.kind}" for n, c in self.columns.items())
        return f"DeviceTable[{self.nrows}/{self.plen} rows]({cols})"


class HostChunk:
    """One padded chunk of a ChunkedTable on the HOST, ready to upload:
    ``cols`` holds ``(name, kind, data, valid, dict_values, enc)`` with
    numpy (or pinned torch) buffers of the table's uniform chunk capacity,
    ``live`` the chunk's real rows."""

    __slots__ = ("live", "cap", "cols")

    def __init__(self, live: int, cap: int, cols: list):
        self.live, self.cap, self.cols = live, cap, cols

    @property
    def nbytes(self) -> int:
        return sum(int(b.nbytes) for (_n, _k, d, v, _dv, _e) in self.cols
                   for b in (d, v))


def _host_buffer(dtype, cap: int, pinned: bool):
    """(buffer, numpy view to fill) of one zeroed host buffer: a numpy
    array, or page-locked torch memory when ``pinned`` (kept as the torch
    tensor, so an asynchronous copy from it holds the block until the copy
    is done)."""
    if not pinned:
        a = np.zeros(cap, dtype=dtype)
        return a, a
    from nds_tpu_torch.engine.column import _TORCH_DTYPES
    t = torch.zeros(cap, dtype=_TORCH_DTYPES[np.dtype(dtype).name],
                    pin_memory=True)
    return t, t.numpy()


class ChunkedTable:
    """A host-resident (arrow) table streamed through statements in row
    chunks — the scan path for tables larger than device memory.

    The planner binds each device chunk in turn and runs the join graph per
    chunk (filters and joins shrink the chunk before anything is kept),
    keeping the surviving rows; aggregation runs downstream on the union,
    so no operator ever sees the whole table on device. Every padded chunk
    (the trailing partial one included) has one power-of-two capacity and
    one structure, so one recorded per-chunk program serves every chunk.
    """

    def __init__(self, arrow, canonical_types: dict | None = None,
                 chunk_rows: int | None = None):
        self.arrow = arrow
        self.canonical_types = canonical_types or {}
        self.chunk_rows = int(chunk_rows or CHUNK_ROWS)
        # whole-table string dictionaries and narrow codecs, built once and
        # shared with select() views (a projection never changes contents)
        self._str_store: dict = {}
        self._enc_store: dict = {}

    @property
    def nrows(self) -> int:
        return self.arrow.num_rows

    @property
    def nbytes(self) -> int:
        return self.arrow.nbytes

    @property
    def column_names(self):
        return list(self.arrow.column_names)

    def select(self, names) -> "ChunkedTable":
        out = ChunkedTable(self.arrow.select(names), self.canonical_types,
                           self.chunk_rows)
        out._str_store = self._str_store
        out._enc_store = self._enc_store
        return out

    def _canonical(self, name: str) -> str:
        from nds_tpu_torch import types as _t
        return self.canonical_types.get(name) or _t.arrow_to_canonical(
            self.arrow.schema.field(name).type)

    def device_chunks(self, device):
        """Yield unpadded, unencoded DeviceTable chunks on ``device`` (at
        least one, possibly empty, so the schema always survives) — the
        eager loop's chunks."""
        from nds_tpu_torch import resolve_device
        from nds_tpu_torch.engine.column import from_arrow
        device = resolve_device(device)
        n = self.arrow.num_rows
        if n == 0:
            yield from_arrow(self.arrow, self.canonical_types, device)
            return
        for s in range(0, n, self.chunk_rows):
            sl = self.arrow.slice(s, min(self.chunk_rows, n - s))
            yield from_arrow(sl.combine_chunks(), self.canonical_types,
                             device)

    @property
    def chunk_cap(self) -> int:
        """Uniform physical capacity of every padded chunk."""
        from nds_tpu_torch.engine.ops import bucket_len
        return bucket_len(self.chunk_rows)

    def num_chunks(self) -> int:
        return max(1, -(-self.arrow.num_rows // self.chunk_rows))

    def _string_encodings(self) -> dict:
        """name -> (int32 codes, shared value table, valid | None) for every
        string column, encoded ONCE against a single whole-table
        dictionary: the per-chunk program is recorded once for every
        chunk, so all chunks must share one dictionary (per-chunk encodings
        would make the same code mean different strings chunk to chunk).
        The value table is the SAME host object for every chunk, keeping
        identity-keyed caches warm."""
        import pyarrow as pa
        import pyarrow.compute as pc
        from nds_tpu_torch import types as _t
        enc: dict = {}
        for name in self.arrow.column_names:
            hit = self._str_store.get(name)
            if hit is not None:
                enc[name] = hit
                continue
            if _t.device_kind(self._canonical(name)) != "str":
                continue
            col = self.arrow[name].combine_chunks()
            if not pa.types.is_dictionary(col.type):
                col = pc.dictionary_encode(col)
            codes = np.asarray(
                pc.fill_null(col.indices, 0).to_numpy(zero_copy_only=False),
                dtype=np.int32)
            values = np.asarray(col.dictionary.to_pylist(), dtype=object)
            if values.size == 0:
                values = np.asarray([""], dtype=object)
            valid = None
            if col.null_count:
                valid = ~np.asarray(pc.is_null(col).to_numpy(
                    zero_copy_only=False))
            enc[name] = self._str_store[name] = (codes, values, valid)
        return enc

    def _int_encodings(self) -> dict:
        """name -> (narrow whole-table codes, valid | None, Encoding) for
        every encodable int-path column (io/columnar.plan_column_codec),
        computed ONCE per table and shared across select() views."""
        from nds_tpu_torch.io.columnar import plan_column_codec
        out = {}
        for name in self.arrow.column_names:
            if name not in self._enc_store:
                self._enc_store[name] = plan_column_codec(
                    self.arrow[name], self._canonical(name))
            got = self._enc_store[name]
            if got is not None:
                out[name] = got
        return out

    def host_chunks(self, pinned: bool = False):
        """Yield :class:`HostChunk`s at ONE uniform physical capacity
        (``chunk_cap``), the final partial chunk zero-padded up to it, with
        every column carrying an explicit validity mask (False past the
        live prefix): chunk k differs from chunk j only in buffer CONTENTS
        — same shapes, same dictionaries, same encodings. String columns
        carry whole-table dictionary codes and encodable int columns their
        narrow whole-table codes. ``pinned`` fills page-locked buffers for
        an asynchronous upload. Pure host work: no device is touched."""
        from nds_tpu_torch import types as _t
        from nds_tpu_torch.engine.column import lower_arrow_array
        cap = self.chunk_cap
        n = self.arrow.num_rows
        strings = self._string_encodings()
        narrow = self._int_encodings()
        for s in (range(0, n, self.chunk_rows) if n else (0,)):
            live = min(self.chunk_rows, n - s) if n else 0
            rows = slice(s, s + live)
            sl = self.arrow.slice(s, live)
            cols = []
            for name in self.arrow.column_names:
                enc = dv = None
                if name in strings:
                    codes, dv, valid = strings[name]
                    kind = "str"
                elif name in narrow:
                    codes, valid, enc = narrow[name]
                    kind = _t.device_kind(self._canonical(name))
                else:
                    kind, codes, valid, dv = lower_arrow_array(
                        sl[name], self._canonical(name))
                    rows = slice(0, live)
                data, data_np = _host_buffer(codes.dtype, cap, pinned)
                v, v_np = _host_buffer(np.bool_, cap, pinned)
                data_np[:live] = codes[rows]
                v_np[:live] = True if valid is None else valid[rows]
                cols.append((name, kind, data, v, dv, enc))
                rows = slice(s, s + live)
            yield HostChunk(live, cap, cols)

    def materialize(self, device) -> DeviceTable:
        from nds_tpu_torch.engine.column import from_arrow
        return from_arrow(self.arrow, self.canonical_types, device)

    def __repr__(self):
        return (f"ChunkedTable[{self.nrows} rows x "
                f"{len(self.arrow.column_names)} cols, "
                f"chunk={self.chunk_rows}]")


def upload_chunk(hc: HostChunk, device, non_blocking: bool = False) -> \
        DeviceTable:
    """A :class:`HostChunk` as a DeviceTable on ``device`` (logical count
    ``hc.live``, physical length ``hc.cap``). ``non_blocking`` copies from
    pinned buffers asynchronously on the caller's current stream."""
    cols = {}
    for (name, kind, data, valid, dv, enc) in hc.cols:
        cols[name] = Column(kind, _to(data, device, non_blocking),
                            _to(valid, device, non_blocking), dv, enc)
    return DeviceTable(cols, hc.live, plen=hc.cap)


def _to(a, device, non_blocking: bool) -> torch.Tensor:
    t = a if torch.is_tensor(a) else torch.from_numpy(a)
    if torch.device(device).type == "cpu":
        return t
    return t.to(device, non_blocking=non_blocking)


def from_reference_arrays(cols, nrows: int, device=None) -> DeviceTable:
    """Build a DeviceTable on ``device`` (default ``cuda``; raises without a
    GPU unless ``cpu`` is asked for) from host arrays with identical codes.

    ``cols`` maps a column name to ``(kind, data, valid, dict_values)``:
    the device kind string, the data array (already bucket-padded, as a
    device column holds it), the bool validity array or None, and the host
    dictionary of a string column (else None). This is how the same data
    that another engine already encoded (for instance a reference table
    pulled out to numpy by a differential test) lands in this engine
    without re-encoding: codes, scaled decimals and day numbers carry over
    bit for bit."""
    import numpy as np

    from nds_tpu_torch import resolve_device
    from nds_tpu_torch.engine.column import to_device

    device = resolve_device(device)
    out = {}
    for name, (kind, data, valid, dict_values) in cols.items():
        data = np.asarray(data)
        if kind == "str":
            data = data.astype(np.int32)
            dict_values = np.asarray(dict_values, dtype=object)
        out[name] = Column(
            kind, to_device(data, device),
            None if valid is None else to_device(
                np.asarray(valid, dtype=np.bool_), device),
            dict_values if kind == "str" else None)
    return DeviceTable(out, int(nrows))
