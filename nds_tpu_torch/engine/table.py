# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""DeviceTable: an ordered set of named device columns of equal length.

Padded-prefix invariant: columns may be physically longer than the table's
logical row count (``nrows``); rows past ``nrows`` are garbage pads that
every operator ignores (see :mod:`nds_tpu_torch.engine.ops` — bucketed shapes).
``plen`` is the physical length.

Tables bigger than ``NDS_TPU_STREAM_BYTES`` (the streamed ``ChunkedTable``
path) are not part of this package yet: ``Session.read_columnar_view``
refuses them.
"""

from __future__ import annotations

from nds_tpu_torch.engine.column import Column


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
