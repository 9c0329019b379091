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

import time

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
    ``live`` the chunk's real rows. Pinned buffers are leased from the
    generator's pool: :meth:`release` hands them back."""

    __slots__ = ("live", "cap", "cols", "_lease")

    def __init__(self, live: int, cap: int, cols: list, lease=None):
        self.live, self.cap, self.cols = live, cap, cols
        self._lease = lease

    @property
    def nbytes(self) -> int:
        return sum(int(b.nbytes) for (_n, _k, d, v, _dv, _e) in self.cols
                   for b in (d, v))

    def release(self, event=None) -> None:
        """Hand the chunk's pinned buffers back to their pool once the
        copy that reads them is done: ``event`` is the CUDA event recorded
        after that copy (None: the copy already completed). The pool
        refills them only after the event. A no-op for numpy buffers and
        on a second call."""
        if self._lease is not None:
            self._lease.release(event)
            self._lease = None


class _PinnedSet:
    """One chunk's page-locked buffers in a :class:`_PinnedPool`: data and
    validity per column (torch tensors, kept so that an asynchronous copy
    holds them), their numpy views, the rows the last fill left non-zero,
    and the event of the copy that last read them."""

    __slots__ = ("data", "valid", "views", "dirty", "event", "leased")

    def __init__(self, dtypes, cap: int):
        from nds_tpu_torch.engine.column import _TORCH_DTYPES
        self.data = [_pinned_zeros(cap, _TORCH_DTYPES[np.dtype(d).name])
                     for d in dtypes]
        self.valid = [_pinned_zeros(cap, torch.bool) for _ in dtypes]
        self.views = [(d.numpy(), v.numpy())
                      for d, v in zip(self.data, self.valid)]
        self.dirty = 0
        self.event = None
        self.leased = True

    def fill(self, j: int, codes, valid, s: int, live: int):
        """Column ``j`` of the chunk at rows ``[s, s + live)`` of the
        whole-table ``codes``/``valid``: only the live prefix is written,
        and only the tail the previous fill left dirty is zeroed."""
        d, v = self.views[j]
        d[:live] = codes[s:s + live]
        v[:live] = True if valid is None else valid[s:s + live]
        if self.dirty > live:
            d[live:self.dirty] = 0
            v[live:self.dirty] = False
        return self.data[j], self.valid[j]

    def release(self, event) -> None:
        self.event = event
        self.leased = False

    def wait(self) -> None:
        """Block this (producer) thread until the copy that last read the
        buffers completed: an event query, never a synchronizing call."""
        ev, self.event = self.event, None
        for e in (ev if isinstance(ev, (list, tuple)) else [ev]):
            while e is not None and not e.query():
                time.sleep(_EVENT_POLL_S)


# how long a producer waiting on a buffer's copy sleeps between queries
_EVENT_POLL_S = 5e-5


def _pinned_zeros(cap: int, dtype) -> torch.Tensor:
    return torch.zeros(cap, dtype=dtype, pin_memory=True)


class _PinnedPool:
    """At most ``size`` page-locked buffer sets of one column set, reused
    across chunks: a set is refilled only after its consumer released it
    and the copy that read it completed. While every set is leased (a
    consumer that keeps its chunks) a chunk gets a fresh set of its own."""

    def __init__(self, dtypes, cap: int, size: int):
        self.dtypes, self.cap, self.size = list(dtypes), cap, max(size, 1)
        self.sets: list = []
        self._next = 0

    def acquire(self) -> _PinnedSet:
        if len(self.sets) < self.size:
            self.sets.append(_PinnedSet(self.dtypes, self.cap))
            return self.sets[-1]
        for _ in range(len(self.sets)):
            st = self.sets[self._next]
            self._next = (self._next + 1) % len(self.sets)
            if not st.leased:
                st.wait()
                st.leased = True
                return st
        return _PinnedSet(self.dtypes, self.cap)


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
        # whole-table string dictionaries, narrow codecs and host lowerings
        # of the plain columns, built once and shared with select() views
        # (a projection never changes contents)
        self._str_store: dict = {}
        self._enc_store: dict = {}
        self._plain_store: dict = {}
        # wire plans (_wire_plan), one per (column set, store directory),
        # shared with select() views too
        self._wire_store: dict = {}

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
        out._plain_store = self._plain_store
        out._wire_store = self._wire_store
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
        computed ONCE per table and shared across select() views. Empty
        when ``NDS_TPU_ENCODED=0`` (read per call; a plan already
        computed stays cached for a later re-enable)."""
        from nds_tpu_torch.io.columnar import (encoded_enabled,
                                               plan_column_codec)
        if not encoded_enabled():
            return {}
        out = {}
        for name in self.arrow.column_names:
            if name not in self._enc_store:
                self._enc_store[name] = plan_column_codec(
                    self.arrow[name], self._canonical(name))
            got = self._enc_store[name]
            if got is not None:
                out[name] = got
        return out

    def _wire_plan(self) -> dict:
        """``name -> io.chunk_store.WireColumn``: the whole-table wire
        arrays (string codes, narrow codes, the host lowering of the
        plain columns) of which every chunk is a slice, once per column
        set. With the chunk store on (``NDS_TPU_CHUNK_STORE``) a warm
        entry memory-maps back, with no codec planning and no lowering,
        and a miss (or a stale fingerprint) builds the plan and persists
        it; with it off the plan stays in memory. Either way the chunks
        are the ones lowering each arrow slice gives, bit for bit. The plan
        is keyed by the column set, the store root and the encoded gate
        (``NDS_TPU_ENCODED``), so a flip of the gate builds the other plan.

        Faults: a corrupt entry (or an injected ``chunk-store-read``
        fault) is deleted and re-encoded once from the arrow source,
        recorded as a fault event; a failed save is the
        ``chunk-store-write`` seam's degrade to the in-memory plan. A
        version drift (``ChunkStoreError``) raises."""
        from nds_tpu_torch.io import chunk_store
        from nds_tpu_torch.io.columnar import encoded_enabled
        root = chunk_store.store_root()
        key = (tuple(self.arrow.column_names), root, encoded_enabled())
        hit = self._wire_store.get(key)
        if hit is not None:
            return hit
        if root is None:
            plan = self._wire_store[key] = self._build_wire_plan()
            return plan
        from nds_tpu_torch.engine import faults as _F
        try:
            plan = chunk_store.load_plan(root, self.arrow,
                                         self.canonical_types)
        except (chunk_store.ChunkStoreCorrupt, _F.FaultInjected) as exc:
            # the store is a cache of the arrow source: a corrupt entry
            # is deleted and rebuilt once, never uploaded
            _F.record_fault_event("chunk-store-read", "recovered",
                                  attempt=1, detail=str(exc)[:200])
            chunk_store.invalidate_entry(root, self.arrow,
                                         self.canonical_types)
            plan = None
        if plan is None:
            plan = self._build_wire_plan()
            try:
                chunk_store.save_plan(root, self.arrow,
                                      self.canonical_types, plan)
            except Exception as exc:
                # persisting is best-effort: a full disk or a read-only
                # store serves the plan just built
                _F.record_fault_event("chunk-store-write", "degrade",
                                      detail=str(exc)[:200])
                import logging
                logging.getLogger(__name__).warning(
                    "chunk store save failed (%s); serving the in-memory "
                    "wire plan for this process", exc)
        self._wire_store[key] = plan
        return plan

    def _build_wire_plan(self) -> dict:
        """The wire form of every column from the whole-table codecs:
        string dictionaries, narrow FOR/dict codes, and the host lowering
        of the remaining plain columns (cached per column)."""
        from nds_tpu_torch import types as _t
        from nds_tpu_torch.io.chunk_store import (WireColumn,
                                                  lower_plain_column)
        strings = self._string_encodings()
        narrow = self._int_encodings()
        plan = {}
        for name in self.arrow.column_names:
            kind = _t.device_kind(self._canonical(name))
            if name in strings:
                codes, values, valid = strings[name]
                plan[name] = WireColumn("str", codes, valid, values, None,
                                        "str")
            elif name in narrow:
                codes, valid, enc = narrow[name]
                plan[name] = WireColumn("enc", codes, valid, None, enc, kind)
            else:
                if name not in self._plain_store:
                    self._plain_store[name] = lower_plain_column(
                        self.arrow[name], self._canonical(name))
                data, valid = self._plain_store[name]
                plan[name] = WireColumn("plain", data, valid, None, None,
                                        kind)
        return plan

    def host_chunks(self, pinned: bool = False, buffers: int = 2):
        """Yield :class:`HostChunk`s at ONE uniform physical capacity
        (``chunk_cap``), the final partial chunk zero-padded up to it, with
        every column carrying an explicit validity mask (False past the
        live prefix): chunk k differs from chunk j only in buffer CONTENTS
        — same shapes, same dictionaries, same encodings. Every chunk is a
        slice of the table's wire plan (:meth:`_wire_plan`): string columns
        carry whole-table dictionary codes, encodable int columns their
        narrow whole-table codes, the rest their whole-table lowering.

        ``pinned`` fills page-locked buffers for an asynchronous upload,
        leased from a pool of ``buffers`` sets: the consumer hands each
        chunk's set back with :meth:`HostChunk.release` and the event of
        the copy that read it, and the set is refilled only after that
        event. Unpinned chunks get fresh numpy buffers. The plan is built
        (or loaded) at the first chunk; the rest is pure host work, no
        device is touched."""
        cap = self.chunk_cap
        n = self.arrow.num_rows
        names = list(self.arrow.column_names)
        plan = self._wire_plan()
        wire = [plan[name] for name in names]
        pool = _PinnedPool([wc.data.dtype for wc in wire], cap, buffers) \
            if pinned else None
        for s in (range(0, n, self.chunk_rows) if n else (0,)):
            live = min(self.chunk_rows, n - s) if n else 0
            lease = pool.acquire() if pool is not None else None
            cols = []
            for j, (name, wc) in enumerate(zip(names, wire)):
                if lease is not None:
                    data, v = lease.fill(j, wc.data, wc.valid, s, live)
                else:
                    data = np.zeros(cap, dtype=wc.data.dtype)
                    v = np.zeros(cap, dtype=np.bool_)
                    data[:live] = wc.data[s:s + live]
                    v[:live] = True if wc.valid is None \
                        else wc.valid[s:s + live]
                cols.append((name, wc.kind, data, v, wc.values, wc.enc))
            if lease is not None:
                lease.dirty = live
            yield HostChunk(live, cap, cols, lease)

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
