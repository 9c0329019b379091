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
