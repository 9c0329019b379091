# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The slice as a whole: the 25 CI statements of ``test_oracle.py`` at
SF0.01 through ``nds_tpu.engine.session.Session`` and through the torch
port on ``device="cpu"`` give equal rows in equal order (exact kinds bit for
bit, doubles within ``rel_tol=1e-5``, as ``nds_validate.py`` compares)."""

import math
import os

import pyarrow as pa
import pytest
import torch

from tests.test_oracle import CI_QUERIES

torch.set_num_threads(1)   # tiny tensors: spare the other workers' cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tables_agree(a: pa.Table, b: pa.Table):
    """None when the results agree, else the first difference."""
    if a.num_rows != b.num_rows or a.num_columns != b.num_columns:
        return f"shape {a.shape} vs {b.shape}"
    for i in range(a.num_columns):
        ca, cb = a.column(i), b.column(i)
        if ca.type != cb.type:
            return f"column {i}: type {ca.type} vs {cb.type}"
        la, lb = ca.to_pylist(), cb.to_pylist()
        if pa.types.is_floating(ca.type):
            for r, (x, y) in enumerate(zip(la, lb)):
                if (x is None) != (y is None):
                    return f"column {i} row {r}: {x} vs {y}"
                if x is None or (math.isnan(x) and math.isnan(y)):
                    continue
                if not math.isclose(x, y, rel_tol=1e-5, abs_tol=1e-12):
                    return f"column {i} row {r}: {x} vs {y}"
        elif la != lb:
            r = next(r for r, (x, y) in enumerate(zip(la, lb)) if x != y)
            return f"column {i} row {r}: {la[r]!r} vs {lb[r]!r}"
    return None


@pytest.fixture(scope="module")
def slice_setup():
    os.environ.setdefault("NDS_TPU_COMP_CACHE", "force")
    from tools.coverage_sweep import ensure_data
    from nds_tpu.engine.session import Session
    from nds_tpu.queries import generate_query_streams
    from nds_tpu.schema import get_schemas
    from nds_tpu_torch.engine.session import Session as PortSession
    from nds_tpu_torch.power import gen_sql_from_stream, strip_stream_markers

    data_dir = ensure_data()
    stream_dir = os.path.join(REPO, ".bench_cache", "oracle_stream")
    os.makedirs(stream_dir, exist_ok=True)
    stream_file = os.path.join(stream_dir, "query_0.sql")
    if not os.path.exists(stream_file):
        generate_query_streams(stream_dir, streams=1, rngseed=19620718,
                               scale=0.01)
    queries = {k: strip_stream_markers(v)
               for k, v in gen_sql_from_stream(stream_file).items()}
    ref, port = Session(), PortSession(device="cpu")
    for tname, fields in get_schemas(use_decimal=True).items():
        path = os.path.join(data_dir, f"{tname}.dat")
        ref.read_raw_view(tname, path, fields)
        port.read_raw_view(tname, path, fields)
    return ref, port, queries


@pytest.mark.parametrize("qname", CI_QUERIES)
def test_port_matches_reference(slice_setup, qname):
    ref, port, queries = slice_setup
    sql = queries[qname]
    why = tables_agree(ref.sql(sql).to_arrow(), port.sql(sql).to_arrow())
    assert why is None, f"{qname}: {why}"


def test_agreement_check_rejects_a_perturbed_decimal(slice_setup):
    """The comparison must fail when it should: one decimal moved by one
    unit in the last place."""
    ref, _, queries = slice_setup
    a = ref.sql(queries["query3"]).to_arrow()
    i = next(i for i, f in enumerate(a.schema)
             if pa.types.is_decimal(f.type))
    vals = a.column(i).to_pylist()
    k = next(r for r, v in enumerate(vals) if v is not None)
    vals[k] = vals[k] + vals[k].__class__(1).scaleb(-a.schema[i].type.scale)
    b = a.set_column(i, a.schema[i], pa.array(vals, type=a.schema[i].type))
    assert tables_agree(a, b) is not None
    assert tables_agree(a, a) is None
