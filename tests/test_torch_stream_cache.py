# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The port's streamed pipeline cache when the data under a cached
pipeline changes, against the reference on the CPU.

The cache is global to the process, so a pipeline built over one
session's tables is found again by another session's statement of the
same shape, and by the first statement after a table is registered anew
with the same row count (a Data Maintenance overwrite can do that). As
in the reference (``nds_tpu/engine/stream.py`` ``_cache_hit``), such an
execution evicts the entry and builds and drives a fresh pipeline: every
event's path is ``compiled``, never an eager rerun. The rows are the
reference's (``NDS_TPU_PALLAS=off``) bit for bit for each state of the
data, and each execution's host syncs no more than the reference's on
the same sequence. Repeat executions over unchanged tables still hit
(``tests/test_torch_param_bind.py``). A derived part over the same
tables whose content changed under one pipeline key is caught by the
check on the held parts, and the execution rebuilds too."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from nds_tpu.engine import ops as RE
from nds_tpu.engine import stream as RS
from nds_tpu.listener import drain_stream_events as ref_drain
from nds_tpu_torch.engine import ops as E
from nds_tpu_torch.engine import stream as S
from nds_tpu_torch.listener import drain_stream_events
from tests.test_synccount import _STREAM_AB_QUERIES, _chunked_star_session
from tests.test_torch_stream import _port_star

torch.set_num_threads(1)   # tiny tensors: spare the other workers' cores

# the star join whose item part the two seeds fill differently
_Q = _STREAM_AB_QUERIES[0][0]


@pytest.fixture()
def pallas_off(monkeypatch):
    monkeypatch.setenv("NDS_TPU_PALLAS", "off")
    monkeypatch.delenv("NDS_TPU_CHUNK_STORE", raising=False)
    # one sequence from a clean cache on both sides
    RS._PIPELINE_CACHE.clear()
    for key in list(S._PIPELINE_CACHE):
        S._evict(key)


def _port(session, sql):
    drain_stream_events()
    before = E.sync_count()
    rows = session.sql(sql).collect()
    return rows, E.sync_count() - before, drain_stream_events()


def _ref(session, sql):
    ref_drain()
    before = RE.sync_count()
    rows = session.sql(sql).collect()
    return rows, RE.sync_count() - before, ref_drain()


def _item(seed):
    """The item table ``_port_star(seed)`` draws (its first draw)."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "i_item_sk": pa.array(np.arange(1, 201), pa.int64()),
        "i_brand_id": pa.array(rng.integers(1000, 1020, 200), pa.int64()),
    })


def _hold(port, ref):
    """Each execution's port and reference runs agree: rows bit for bit,
    one compiled scan, syncs no more than the reference's."""
    for (rows, syncs, events), (want, ref_syncs, ref_events) in \
            zip(port, ref):
        assert rows == want and rows
        assert [e.path for e in events] == ["compiled"], \
            [(e.path, e.reason) for e in events]
        assert [e.path for e in ref_events] == ["compiled"]
        assert syncs <= ref_syncs, (syncs, ref_syncs)


def test_two_sessions_each_rebuild_over_their_own_tables(pallas_off):
    """Sessions over seeds 42 and 7 (equal shapes, other dimension
    content), driven A, B, A in one process."""
    port = {seed: _port_star(seed, {}) for seed in (42, 7)}
    ref = {seed: _chunked_star_session(np.random.default_rng(seed))
           for seed in (42, 7)}
    order = (42, 7, 42)
    got = [_port(port[seed], _Q) for seed in order]
    want = [_ref(ref[seed], _Q) for seed in order]
    _hold(got, want)
    assert got[0][0] != got[1][0]          # the seeds' rows differ
    # the last pipeline is cached: a repeat in the same session hits
    assert _port(port[42], _Q)[0] == got[0][0]
    assert len(S._PIPELINE_CACHE) == 1


def test_reregistered_dimension_rebuilds(pallas_off):
    """One session; ``item`` registered anew between two executions with
    the same row count and another seed's brands, then back."""
    port = _port_star(42, {})
    ref = _chunked_star_session(np.random.default_rng(42))
    got, want = [_port(port, _Q)], [_ref(ref, _Q)]
    for seed in (7, 42):
        port.create_temp_view("item", _item(seed), base=True)
        ref.create_temp_view("item", _item(seed), base=True)
        got.append(_port(port, _Q))
        want.append(_ref(ref, _Q))
    _hold(got, want)
    assert got[0][0] == got[2][0] != got[1][0]


def test_changed_derived_part_rebuilds_instead_of_rerunning_eagerly(
        pallas_off):
    """Two statements that differ only in a literal inside a derived
    dimension (30 rows either way) share one pipeline key; the second
    finds the first's pipeline, the check on the held parts finds other
    content, and the execution builds a fresh pipeline (path
    ``compiled``) with the reference's rows."""
    sql = ("select d_year, sum(ss_ext_sales_price) s from store_sales, "
           "(select d_date_sk, d_year from date_dim where d_moy = {}) d "
           "where ss_sold_date_sk = d_date_sk group by d_year "
           "order by d_year")
    port = _port_star(42, {})
    ref = _chunked_star_session(np.random.default_rng(42))
    evicted = []
    real = S._evict

    def spy(key):
        evicted.append(key)
        real(key)

    S._evict = spy
    try:
        got = [_port(port, sql.format(m)) for m in (11, 12)]
    finally:
        S._evict = real
    want = [_ref(ref, sql.format(m)) for m in (11, 12)]
    assert got[0][0] != got[1][0]
    for (rows, _syncs, events), (ref_rows, _r, _e) in zip(got, want):
        assert rows == ref_rows and rows
        assert [e.path for e in events] == ["compiled"], \
            [(e.path, e.reason) for e in events]
    # the held parts were checked and found stale: the one pipeline went
    assert len(evicted) == 1 and len(S._PIPELINE_CACHE) == 1
