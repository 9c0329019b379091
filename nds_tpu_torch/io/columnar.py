# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Columnar table IO: Parquet / ORC / Avro / CSV / JSON read+write with
hive-style date partitioning.

Covers the reference's Load Test output surface (ref: nds/nds_transcode.py:
69-152): the seven fact tables are date-partitioned, everything else is
written as a single file, with per-format compression options.
"""

from __future__ import annotations

import os

import pyarrow as pa
import pyarrow.dataset as pads

# ---------------------------------------------------------------------------
# encoded columnar execution: per-column narrow-upload codecs
# ---------------------------------------------------------------------------
#
# The streamed scan path (engine/table.py host_chunks) uploads int-path
# columns in a narrow ENCODED representation chosen here, once per table,
# from whole-table stats — chunk-invariant by construction, exactly like
# the whole-table string dictionaries (per "GPU Acceleration of SQL
# Analytics on Compressed Data", PAPERS.md):
#
#   * frame-of-reference ("for"): store value - base as int16/int32 where
#     the table's value span proves the narrow width (dates and surrogate
#     keys span tiny windows; decimal(7,2) always fits int32 by type);
#   * sorted dictionary ("dict"): int16 codes into a sorted host value
#     table for low-cardinality ints whose span is too wide for FOR.
#
# Both are order-preserving, so predicates/joins/group-bys evaluate on
# encoded values inside the per-chunk program and decode happens only at
# materialize (engine/column.py). A column whose span fits no narrow width
# stays unencoded — the narrow-width overflow guard. NDS_TPU_ENCODED=0
# turns the int-path codecs off: every such column then goes up at its
# plain lowering (the raw wire).


def encoded_enabled() -> bool:
    """The ``NDS_TPU_ENCODED`` gate (default on; "0" uploads int-path
    columns at their plain widths). Read at use time, never at import."""
    return os.environ.get("NDS_TPU_ENCODED", "1") != "0"


# max distinct values for the sorted-dictionary codec (int16 codes with
# headroom; past this the value-table gather stops paying for itself)
DICT_MAX_VALUES = 4096


def plan_column_codec(arr, canonical_type: str):
    """``(narrow whole-table codes, valid | None, Encoding)`` for one
    arrow column, or None when the column is not narrowably encodable
    (non-int kind, empty table, or value span past every narrow width —
    the overflow guard; an ALL-NULL int column encodes as trivial FOR so
    the static width model never under-prices it). ``arr`` is the WHOLE
    table's column (Array or ChunkedArray): stats and codes are computed
    once, so the encoding is identical for every chunk sliced from it.

    The width rules (the 2^15 / 2^31 - 1 spans, dict refusal past
    DICT_MAX_VALUES, all-null/empty trivial FOR) are the reference's, so
    both engines encode every column identically."""
    import numpy as np

    from nds_tpu_torch import types as _t
    from nds_tpu_torch.engine.column import Encoding, _decimal_to_int64

    kind = _t.device_kind(canonical_type)
    if kind not in ("i32", "i64", "date") and not kind.startswith("dec("):
        return None
    if isinstance(arr, pa.Array):
        arr = pa.chunked_array([arr])
    n = len(arr)
    if n == 0:
        # empty table: same trivial-FOR rule as all-null below
        return np.zeros(0, dtype=np.int16), None, Encoding("for", 0, None)
    import pyarrow.compute as pc
    valid = None
    if arr.null_count:
        valid = ~np.asarray(pc.is_null(arr).combine_chunks().to_numpy(
            zero_copy_only=False))
    # logical device values (the exact representation engine/column.py
    # lowers to): dates as int32 days, decimals as scaled int64
    if kind.startswith("dec("):
        from nds_tpu_torch.engine.column import dec_scale
        s = dec_scale(kind)
        if pa.types.is_decimal(arr.type):
            filled = pc.fill_null(arr, pa.scalar(0, arr.type)) \
                if arr.null_count else arr
            vals = _decimal_to_int64(filled, arr.type.scale, s)
        else:
            vals = np.asarray(pc.fill_null(arr, 0).combine_chunks()
                              .to_numpy(zero_copy_only=False))
            vals = np.round(vals * (10 ** s)).astype(np.int64)
    else:
        if kind == "date":
            arr = pc.cast(arr, pa.int32())
        filled = pc.fill_null(arr, 0) if arr.null_count else arr
        vals = np.asarray(filled.combine_chunks().to_numpy(
            zero_copy_only=False)).astype(np.int64)
    live = vals if valid is None else vals[valid]
    if live.size == 0:
        # all-null column: trivially FOR-encodable (every slot invalid)
        return (np.zeros(n, dtype=np.int16), valid,
                Encoding("for", 0, None))
    lo, hi = int(live.min()), int(live.max())
    span = hi - lo
    logical_bytes = 4 if kind in ("i32", "date") else 8
    # frame-of-reference first (cheapest decode: one fused add)
    if span < (1 << 15):
        dtype = np.int16
    elif span < (1 << 31) - 1 and logical_bytes == 8:
        dtype = np.int32
    else:
        dtype = None
    if dtype is None:
        # no FOR width fits: a sorted dictionary is the only narrow
        # option (wide-span low-cardinality columns). Distinct-count a
        # SAMPLE first — a full np.unique sorts the whole fact column on
        # host, and sequence-like keys always blow past DICT_MAX_VALUES
        if live.size > (1 << 16) and \
                len(np.unique(live[:1 << 16])) > DICT_MAX_VALUES:
            return None                  # narrow-width overflow guard
        uniq = np.unique(live)
        if len(uniq) <= DICT_MAX_VALUES:
            codes = np.searchsorted(uniq, vals).astype(np.int16)
            codes = np.clip(codes, 0, len(uniq) - 1)
            if valid is not None:
                codes = np.where(valid, codes, np.int16(0))
            return codes, valid, Encoding("dict", 0, uniq.astype(np.int64))
        return None                      # narrow-width overflow guard
    codes = (vals - lo).astype(dtype)
    if valid is not None:
        codes = np.where(valid, codes, dtype(0))
    return codes, valid, Encoding("for", lo, None)


def plan_table_codecs(table: pa.Table, canonical_types: dict | None = None):
    """name -> (codes, valid, Encoding) for every encodable column of an
    arrow table — the per-table encoding plan ``ChunkedTable`` caches and
    ``host_chunks`` slices per chunk."""
    from nds_tpu_torch import types as _t
    out = {}
    for name in table.column_names:
        ct = (canonical_types or {}).get(name) or _t.arrow_to_canonical(
            table.schema.field(name).type)
        got = plan_column_codec(table[name], ct)
        if got is not None:
            out[name] = got
    return out


# The 7 date-partitioned fact tables (ref: nds/nds_transcode.py:45-53)
TABLE_PARTITIONING = {
    "catalog_sales": "cs_sold_date_sk",
    "catalog_returns": "cr_returned_date_sk",
    "inventory": "inv_date_sk",
    "store_sales": "ss_sold_date_sk",
    "store_returns": "sr_returned_date_sk",
    "web_sales": "ws_sold_date_sk",
    "web_returns": "wr_returned_date_sk",
}


def _hive_partition_runs(table: pa.Table, partition_col: str):
    """Yield (partition dir name, partition slice) by sorting on the
    partition column and slicing contiguous runs — ONE pass, one file per
    partition. pyarrow's dataset writer churns past its open-file cap when
    a fact table has a 5-year daily date_sk domain (observed: 54M tiny
    write syscalls on store_sales SF1), so both formats partition through
    this path (Spark's partitionBy sort-within semantics; ref:
    nds/nds_transcode.py:69-152 date-partitioned fact tables)."""
    import numpy as np
    order = pa.compute.sort_indices(
        table, sort_keys=[(partition_col, "ascending")])
    sorted_tbl = table.take(order)
    col = sorted_tbl[partition_col].to_numpy(zero_copy_only=False)
    # nulls sort to the end and surface as NaN; NaN != NaN would split
    # them into 1-row runs, so bound the non-null region first
    n_null = int(pa.compute.is_null(sorted_tbl[partition_col]).to_numpy(
        zero_copy_only=False).sum())
    n_valid = len(col) - n_null
    valid = col[:n_valid]
    boundaries = [0] + list(np.nonzero(valid[1:] != valid[:-1])[0] + 1) + \
        [n_valid]
    if n_null:
        boundaries.append(len(col))
    for lo, hi in zip(boundaries[:-1], boundaries[1:]):
        value = col[lo]
        if value is None or value != value:          # null (None or NaN)
            part_name = "__HIVE_DEFAULT_PARTITION__"
        else:
            # nullable int columns surface as floats in numpy; keep
            # integral partition names so hive read-back types match
            part_name = str(int(value)) if float(value).is_integer() \
                else str(value)
        yield (f"{partition_col}={part_name}",
               sorted_tbl.slice(lo, hi - lo).drop_columns([partition_col]))


def write_table(table: pa.Table, path: str, fmt: str = "parquet",
                partition_col: str | None = None, compression: str | None = None) -> None:
    os.makedirs(path, exist_ok=True)
    if fmt == "parquet":
        import pyarrow.parquet as pq
        comp = compression or "snappy"
        if partition_col:
            for part_dir, part in _hive_partition_runs(table, partition_col):
                sub = os.path.join(path, part_dir)
                os.makedirs(sub, exist_ok=True)
                pq.write_table(part, os.path.join(sub, "part-0.parquet"),
                               compression=comp)
        else:
            pq.write_table(table, os.path.join(path, "part-0.parquet"), compression=comp)
    elif fmt == "orc":
        import pyarrow.orc as paorc
        comp = compression or "zstd"
        if partition_col:
            for part_dir, part in _hive_partition_runs(table, partition_col):
                sub = os.path.join(path, part_dir)
                os.makedirs(sub, exist_ok=True)
                paorc.write_table(part, os.path.join(sub, "part-0.orc"),
                                  compression=comp)
        else:
            paorc.write_table(table, os.path.join(path, "part-0.orc"),
                              compression=comp)
    elif fmt == "avro":
        from nds_tpu_torch.io.avro import write_avro
        if partition_col:
            for part_dir, part in _hive_partition_runs(table, partition_col):
                sub = os.path.join(path, part_dir)
                os.makedirs(sub, exist_ok=True)
                write_avro(part, os.path.join(sub, "part-0.avro"),
                           compression=compression)
        else:
            write_avro(table, os.path.join(path, "part-0.avro"),
                       compression=compression)
    elif fmt == "csv":
        import pyarrow.csv as pacsv
        pacsv.write_csv(table, os.path.join(path, "part-0.csv"))
    elif fmt == "json":
        import json
        with open(os.path.join(path, "part-0.json"), "w") as f:
            for row in table.to_pylist():
                f.write(json.dumps(row, default=str) + "\n")
    else:
        raise ValueError(f"unsupported output format: {fmt}")


def read_table(path: str, fmt: str = "parquet") -> pa.Table:
    """Read a table written by :func:`write_table` (including hive-partitioned
    layouts) back into arrow."""
    if fmt in ("parquet", "orc"):
        ds = pads.dataset(path, format=fmt, partitioning="hive")
        return ds.to_table()
    if fmt == "avro":
        from nds_tpu_torch.io.avro import read_avro
        parts = []
        for root, _dirs, files in sorted(os.walk(path)):
            for fn in sorted(files):
                if not fn.endswith(".avro"):
                    continue
                t = read_avro(os.path.join(root, fn))
                # restore hive partition columns from the directory path
                rel = os.path.relpath(root, path)
                if rel != ".":
                    for seg in rel.split(os.sep):
                        col, _, val = seg.partition("=")
                        if val == "__HIVE_DEFAULT_PARTITION__":
                            arr = pa.nulls(t.num_rows, type=pa.int64())
                        else:
                            try:
                                arr = pa.array([int(val)] * t.num_rows,
                                               type=pa.int64())
                            except ValueError:  # non-integral partition
                                arr = pa.array([float(val)] * t.num_rows,
                                               type=pa.float64())
                        t = t.append_column(col, arr)
                parts.append(t)
        if not parts:
            raise FileNotFoundError(f"no .avro files under {path}")
        return pa.concat_tables(parts, promote_options="default")
    if fmt == "csv":
        import pyarrow.csv as pacsv
        files = [os.path.join(path, f) for f in sorted(os.listdir(path))
                 if f.endswith(".csv")]
        return pa.concat_tables([pacsv.read_csv(f) for f in files])
    if fmt == "json":
        import pyarrow.json as pajson
        files = [os.path.join(path, f) for f in sorted(os.listdir(path))
                 if f.endswith(".json")]
        return pa.concat_tables([pajson.read_json(f) for f in files])
    raise ValueError(f"unsupported input format: {fmt}")
