# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Session: the engine's user-facing entry point.

Holds the table catalog and its device, parses and executes SQL, and
exposes collect()/write() result surfaces. Tables live on the session's
device (``cuda`` unless the caller asks for ``cpu``); a table bigger than
the ``stream_bytes`` setting (default ``NDS_TPU_STREAM_BYTES``, else 8 GiB)
stays on the host as a ``ChunkedTable`` that statements stream through in
chunks of ``stream_chunk_rows`` rows (engine/stream.py). The streamed
path's other settings are ``conf`` keys too (``ops.STREAM_DEFAULTS``).
"""

from __future__ import annotations

import os
import time

import pyarrow as pa

from nds_tpu_torch import resolve_device
from nds_tpu_torch.engine import faults as _faults
from nds_tpu_torch.engine import ops as E
from nds_tpu_torch.engine.column import from_arrow
from nds_tpu_torch.engine.table import ChunkedTable, DeviceTable
from nds_tpu_torch.obs import trace as _obs
from nds_tpu_torch.sql import ast as A
from nds_tpu_torch.sql.parser import parse
from nds_tpu_torch.sql.planner import ExecError, Planner


class Result:
    """A materialized query result."""

    def __init__(self, table: DeviceTable):
        self.table = table

    @property
    def num_rows(self) -> int:
        return E.count_int(self.table.nrows)

    @property
    def column_names(self):
        return self.table.column_names

    def to_arrow(self) -> pa.Table:
        # the device->host result fetch: the "materialize" phase of the
        # query trace (collect() and the write path both land here)
        with _obs.span("materialize"):
            return self.table.to_arrow()

    def collect(self):
        """Device -> host gather; returns a list of row tuples."""
        arrow = self.to_arrow()
        cols = [arrow.column(i).to_pylist() for i in range(arrow.num_columns)]
        return list(zip(*cols)) if cols else []

    def write(self, path: str, fmt: str = "parquet"):
        from nds_tpu_torch.io.columnar import write_table
        write_table(self.to_arrow(), path, fmt)


class Session:
    def __init__(self, conf: dict | None = None, device=None):
        self.conf = dict(conf or {})
        self.device = resolve_device(device or self.conf.get("device"))
        self.catalog: dict[str, DeviceTable] = {}
        self.base_tables: set[str] = set()   # names loaded as pristine scans
        self.app_id = f"nds-tpu-torch-{int(time.time() * 1000)}"
        self.app_name = "nds-tpu-torch"
        self.last_scanned: dict = {}

    # -- catalog ------------------------------------------------------------

    def create_temp_view(self, name: str, table, base: bool = False,
                         arrow=None) -> None:
        """Register a table. ``base=True`` marks a pristine base-table load,
        which lets the planner trust schema facts like primary-key
        uniqueness; re-registration through a non-base path revokes it.
        ``arrow`` optionally passes the host-side source table so load-time
        statistics need no device->host read. A DeviceTable must already
        lie on the session's device; a ChunkedTable stays on the host."""
        if isinstance(table, pa.Table):
            arrow = table if arrow is None else arrow
            table = from_arrow(table, device=self.device)
        self._check_on_device(name, table)
        key = name.lower()
        self.catalog[key] = table
        if base and arrow is not None:
            self._collect_load_stats(key, arrow)
        if base:
            self.base_tables.add(key)
        else:
            self.base_tables.discard(key)

    def _check_on_device(self, name: str, table) -> None:
        """Refuse a table whose tensors lie off the session's device: its
        statements would otherwise run there, and quietly past the
        kernels."""
        want = self.device
        for cname, col in getattr(table, "columns", {}).items():
            for t in (col.data, col.valid):
                if t is None:
                    continue
                d = t.device
                if d.type != want.type or (want.index is not None
                                           and d.index != want.index):
                    raise ValueError(
                        f"table {name!r}: column {cname!r} lies on {d}, "
                        f"the session runs on {want}; build the table "
                        f"with device={str(want)!r}")

    def _collect_load_stats(self, key: str, arrow) -> None:
        """Load-time key statistics from HOST data: prewarm the dense
        dimension position map for a table whose FIRST column is a unique
        dense integer key (every TPC-DS dimension PK is), so the first star
        join against it needs no whole-column device fetch."""
        import numpy as np
        import torch
        t = self.catalog.get(key)
        if not isinstance(t, DeviceTable) or not t.columns:
            return
        first = next(iter(t.columns))
        col = t.columns[first]
        n = t.nrows if isinstance(t.nrows, int) else None
        if not n or n > (1 << 24) or col.kind == "str" or \
                first not in arrow.column_names:
            return
        src = arrow.column(first)
        if src.null_count or not pa.types.is_integer(src.type):
            return
        live = src.to_numpy(zero_copy_only=False).astype(np.int64)
        if len(live) != n:
            return
        mn = int(live.min())
        span = int(live.max()) - mn + 1
        # the same density gate _dense_dim_info applies at query time
        if span > max(4 * n, 1 << 16) or span > (1 << 26):
            return
        pos = np.full(span, n, dtype=np.int64)
        pos[live - mn] = np.arange(n)
        if int((pos != n).sum()) != n:
            return                            # duplicate keys: not a PK
        dev = col.data.device
        E._identity_cache(E._dense_dim_cache, 64, (col.data,),
                          lambda: (mn, torch.as_tensor(pos, device=dev)),
                          static_key=n)

    def read_raw_view(self, name: str, path: str, fields) -> float:
        """Register a raw '|'-delimited table; returns elapsed seconds."""
        from nds_tpu_torch.io import read_raw_table
        start = time.perf_counter()
        arrow = read_raw_table(path, fields)
        self._register_base(name, arrow, {f.name: f.type for f in fields})
        return time.perf_counter() - start

    def read_columnar_view(self, name: str, path: str, fmt: str = "parquet",
                           canonical_types: dict | None = None) -> float:
        from nds_tpu_torch.io import read_table
        start = time.perf_counter()
        arrow = read_table(path, fmt)
        self._register_base(name, arrow, canonical_types)
        return time.perf_counter() - start

    def _register_base(self, name: str, arrow, canonical_types) -> None:
        """The streaming decision: a table past the ``stream_bytes``
        threshold stays host-resident as a ChunkedTable that the planner
        binds chunk by chunk; anything smaller uploads whole."""
        # float() first: operators write thresholds like "1.5e9"
        limit = int(float(self.conf.get(
            "stream_bytes",
            os.environ.get("NDS_TPU_STREAM_BYTES", str(8 << 30)))))
        if arrow.nbytes > limit:
            self.create_temp_view(
                name, ChunkedTable(arrow, canonical_types,
                                   self.conf.get("stream_chunk_rows")),
                base=True)
        else:
            self.create_temp_view(name, from_arrow(arrow, canonical_types,
                                                   self.device),
                                  base=True, arrow=arrow)

    # -- SQL ----------------------------------------------------------------

    def sql(self, text: str) -> Result:
        # scope this thread's trace ring: a query-executing thread drains
        # only its own spans
        _obs.attach()
        stmt = parse(text)
        planner = Planner(self.catalog, base_tables=self.base_tables)
        # bytes of every catalog table the statement binds (per-query
        # summaries)
        self.last_scanned = planner.scanned
        # statement-end barrier: lazy scalar-subquery checks must raise
        # inside the statement that registered them. The statement scope
        # charges every blocking wait to one budget when
        # NDS_TPU_STATEMENT_DEADLINE_S is armed (engine/faults.py)
        try:
            with E.on_device(self.device, self.conf), \
                    _faults.statement_scope():
                out = self._sql_dispatch(stmt, planner)
        except BaseException:
            E.discard_deferred_checks()
            raise
        E.flush_deferred_checks()
        return out

    def _sql_dispatch(self, stmt, planner) -> Result:
        if isinstance(stmt, A.Query):
            return Result(planner.query(stmt))
        if isinstance(stmt, A.CreateTempView):
            self.create_temp_view(stmt.name, planner.query(stmt.query))
            return Result(DeviceTable({}, 0))
        if isinstance(stmt, (A.InsertInto, A.DeleteFrom)):
            raise ExecError(
                f"{type(stmt).__name__}: Data Maintenance DML is not ported "
                "to nds_tpu_torch yet")
        raise ExecError(f"unsupported statement {type(stmt).__name__}")
