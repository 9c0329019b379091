# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Raw-data ingest: '|'-delimited, ISO-8859-1, schema-typed CSV reading.

Mirrors the reference load path (ref: nds/nds_transcode.py:56-66: delimiter
'|', encoding ISO-8859-1, explicit schema) on pyarrow. Handles the
dsdgen/ndsgen trailing delimiter by parsing (and dropping) a sentinel last
column. Empty fields are nulls.
"""

from __future__ import annotations

import os

import pyarrow as pa
import pyarrow.csv as pacsv

from nds_tpu_torch import types

_TRAILER = "__nds_trailer__"


def _convert_options(fields) -> pacsv.ConvertOptions:
    column_types = {f.name: types.to_arrow(f.type) for f in fields}
    column_types[_TRAILER] = pa.string()
    return pacsv.ConvertOptions(
        column_types=column_types,
        strings_can_be_null=True,
        quoted_strings_can_be_null=False,
    )


def _read_one(path: str, fields) -> pa.Table:
    names = [f.name for f in fields] + [_TRAILER]
    read_opts = pacsv.ReadOptions(column_names=names, encoding="iso8859-1")
    parse_opts = pacsv.ParseOptions(delimiter="|", quote_char=False)
    table = pacsv.read_csv(path, read_options=read_opts, parse_options=parse_opts,
                           convert_options=_convert_options(fields))
    return table.drop_columns([_TRAILER])


def read_raw_table(path: str, fields) -> pa.Table:
    """Read one raw table from a file or a per-table directory of ``.dat``
    chunk files, returning a typed arrow Table.

    ``fields`` is the schema tuple from :func:`nds_tpu_torch.schema.get_schemas`.
    """
    if os.path.isdir(path):
        chunks = sorted(
            os.path.join(path, f) for f in os.listdir(path) if f.endswith(".dat")
        )
        if not chunks:
            raise FileNotFoundError(f"no .dat chunks under {path}")
        tables = [_read_one(c, fields) for c in chunks]
        return pa.concat_tables(tables)
    return _read_one(path, fields)
