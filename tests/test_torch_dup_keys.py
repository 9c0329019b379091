# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Statement ab10 of the streamed A/B set (``tests/test_synccount.py``:
store_returns LEFT JOIN store_sales on the declared store_sales key
``(ss_item_sk, ss_ticket_number)``) at SF0.01, the port against the JAX
reference, resident and with store_sales streamed (the outer-build join)
each.

The generated data repeats that key. The resident plans of both packages
trust the declared key and gather one match per return; the streamed
plans of both keep every match. So the port's rows equal the reference's
in each arm, and in both packages the streamed result holds one row more
per extra match than the resident one: a limit the port shares with the
reference, not a fault of the port. Inputs are the cached SF0.01 data."""

import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from tests.test_synccount import _STREAM_AB_QUERIES
from tests.test_torch_slice import tables_agree

torch.set_num_threads(1)

AB10 = _STREAM_AB_QUERIES[10][0]
# streamed as in the smoke's stream phase: the fact table, not the returns
STREAMED = "store_sales"
CHUNK_ROWS = 4096


def _keys(t: pa.Table, a: str, b: str) -> np.ndarray:
    x = t[a].to_numpy(zero_copy_only=False).astype(float)
    y = t[b].to_numpy(zero_copy_only=False).astype(float)
    ok = ~(np.isnan(x) | np.isnan(y))
    return x[ok].astype(np.int64) * (1 << 32) + y[ok].astype(np.int64)


def _duplicates(ss: pa.Table, sr: pa.Table):
    """(store_sales keys (item, ticket) that repeat, matches of
    store_returns rows in store_sales beyond the first)."""
    uniq, counts = np.unique(_keys(ss, "ss_item_sk", "ss_ticket_number"),
                             return_counts=True)
    ret = _keys(sr, "sr_item_sk", "sr_ticket_number")
    pos = np.clip(np.searchsorted(uniq, ret), 0, len(uniq) - 1)
    hit = uniq[pos] == ret
    return int((counts > 1).sum()), int((counts[pos][hit] - 1).sum())


@pytest.fixture(scope="module")
def arms():
    """(rows of the four arms, the data's duplicates)."""
    from tools.coverage_sweep import ensure_data
    from nds_tpu.engine.session import Session as RefSession
    from nds_tpu.engine.table import ChunkedTable as RefChunked
    from nds_tpu.io import read_raw_table
    from nds_tpu.schema import get_schemas
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.engine.table import ChunkedTable

    data = ensure_data()
    schemas = get_schemas(use_decimal=True)
    needed = ("store_sales", "store_returns")
    arrows = {t: read_raw_table(os.path.join(data, f"{t}.dat"), schemas[t])
              for t in needed}
    canon = {t: {f.name: f.type for f in schemas[t]} for t in needed}
    ref_res, ref_str = RefSession(), RefSession()
    port_res, port_str = Session(device="cpu"), Session(device="cpu")
    for t in needed:
        ref_res.create_temp_view(t, arrows[t], base=True)
        port_res.create_temp_view(t, arrows[t], base=True)
        if t == STREAMED:
            ref_str.create_temp_view(t, RefChunked(arrows[t], canon[t],
                                                   chunk_rows=CHUNK_ROWS),
                                     base=True)
            port_str.create_temp_view(t, ChunkedTable(
                arrows[t], canon[t], CHUNK_ROWS), base=True)
        else:
            ref_str.create_temp_view(t, arrows[t], base=True)
            port_str.create_temp_view(t, arrows[t], base=True)
    rows = {name: s.sql(AB10).to_arrow() for name, s in (
        ("ref_resident", ref_res), ("ref_streamed", ref_str),
        ("port_resident", port_res), ("port_streamed", port_str))}
    return rows, _duplicates(arrows["store_sales"], arrows["store_returns"])


@pytest.mark.parametrize("arm", ["resident", "streamed"])
def test_ab10_matches_reference(arms, arm):
    rows, _ = arms
    why = tables_agree(rows[f"ref_{arm}"], rows[f"port_{arm}"])
    assert why is None, why


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_ab10_streamed_keeps_every_duplicate_match(arms, pkg):
    """The data repeats the declared key (22 keys at SF0.01, 6 of them
    matched by returns once more), and each package's streamed result is
    its resident one plus a row per extra match."""
    rows, (dup_keys, extra) = arms
    assert (dup_keys, extra) == (22, 6)
    assert rows[f"{pkg}_streamed"].num_rows == \
        rows[f"{pkg}_resident"].num_rows + extra
