# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The torch port's chunk store (``nds_tpu_torch/io/chunk_store.py``) and
whole-table wire plan (``ChunkedTable._wire_plan``) against the reference's
(``nds_tpu/io/chunk_store.py``, ``nds_tpu/engine/table.py``) on the CPU.

Each side gets the same numpy-seeded arrow table. A store written by
either package reads in the other, bit for bit, and both write the same
files; the version gate is fatal, a corrupt entry (or an injected
``chunk-store-read`` fault) is deleted and re-encoded with a recorded
fault event, a stale fingerprint reads as a miss, a dead writer's lock is
stolen and a live one respected, and a failed save degrades to the
in-memory plan (``chunk-store-write``). The chunks the wire plan gives,
with the store off, cold or warm, equal the inline lowering of each arrow
slice (the port's chunks before the wire plan) and the reference's
``padded_chunks`` bit for bit; the pinned-buffer pool refills a buffer
only after its copy completed and re-zeroes only the dirty tail."""

import decimal
import json
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest
import torch

from nds_tpu_torch.engine import faults as F
from nds_tpu_torch.engine import table as T
from nds_tpu_torch.engine.session import Session
from nds_tpu_torch.engine.table import ChunkedTable
from nds_tpu_torch.io import chunk_store as CS

torch.set_num_threads(1)   # tiny tensors: spare the other workers' cores


def _table(n=3000, seed=3, shift=0):
    """Every wire codec: strings with nulls (str), narrow ints (enc), a
    wide int, a double, a decimal with nulls and a date (plain)."""
    rng = np.random.default_rng(seed)
    amt = [None if i % 11 == 0 else decimal.Decimal(f"{v / 100:.2f}")
           for i, v in enumerate(rng.integers(-5000, 900000, n))]
    return pa.table({
        "k": pa.array(rng.integers(0, 50, n) + shift, pa.int64()),
        "w": pa.array(rng.integers(-(1 << 40), 1 << 40, n), pa.int64()),
        "s": pa.array([None if i % 17 == 0 else f"x{i % 7}"
                       for i in range(n)], pa.string()),
        "f": pa.array(rng.random(n), pa.float64()),
        "a": pa.array(amt, pa.decimal128(7, 2)),
        "d": pa.array(rng.integers(10950, 11400, n).astype("int32"),
                      pa.int32()).cast(pa.date32()),
    })


_SQL = ("select k, s, count(*) c, sum(w) sw, sum(a) sa from t "
        "where k > 3 group by k, s order by k, s")


def _run(tbl, chunk_rows=700):
    s = Session(conf={"hbm_bytes": 16 << 30}, device="cpu")
    s.create_temp_view("t", ChunkedTable(tbl, chunk_rows=chunk_rows),
                       base=True)
    return s.sql(_SQL).collect()


def _entry(root):
    (e,) = [d for d in os.listdir(root)
            if not d.startswith(".") and not d.endswith(".lock")]
    return os.path.join(root, e)


def _plans_equal(a, b):
    assert list(a) == list(b)
    for name in a:
        x, y = a[name], b[name]
        assert (x.codec, x.kind) == (y.codec, y.kind), name
        assert np.asarray(x.data).dtype == np.asarray(y.data).dtype, name
        np.testing.assert_array_equal(np.asarray(x.data),
                                      np.asarray(y.data))
        assert (x.valid is None) == (y.valid is None), name
        if x.valid is not None:
            np.testing.assert_array_equal(np.asarray(x.valid),
                                          np.asarray(y.valid))
        if x.codec == "str":
            assert list(x.values) == list(y.values), name
        if x.codec == "enc":
            assert (x.enc.mode, x.enc.base) == (y.enc.mode, y.enc.base)
            assert (x.enc.values is None) == (y.enc.values is None)
            if x.enc.values is not None:
                np.testing.assert_array_equal(x.enc.values, y.enc.values)


def _plans(tbl):
    from nds_tpu.engine.table import ChunkedTable as RefChunked
    return (ChunkedTable(tbl, chunk_rows=700)._build_wire_plan(),
            RefChunked(tbl, chunk_rows=700)._build_wire_plan())


def test_both_packages_write_the_same_files(tmp_path):
    from nds_tpu.io import chunk_store as RCS
    tbl = _table()
    ours, theirs = _plans(tbl)
    _plans_equal(ours, theirs)
    a = CS.save_plan(str(tmp_path / "a"), tbl, {}, ours)
    b = RCS.save_plan(str(tmp_path / "b"), tbl, {}, theirs)
    assert os.path.basename(a) == os.path.basename(b)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_written_by_one_package_reads_in_the_other(tmp_path, writer):
    from nds_tpu.io import chunk_store as RCS
    tbl = _table(seed=5)
    ours, theirs = _plans(tbl)
    save, load = (CS.save_plan, RCS.load_plan) if writer == "port" \
        else (RCS.save_plan, CS.load_plan)
    save(str(tmp_path), tbl, {}, ours if writer == "port" else theirs)
    got = load(str(tmp_path), tbl, {})
    assert got is not None
    _plans_equal(got, ours)
    assert isinstance(np.asarray(got["k"].data), np.ndarray)


def test_version_gate_is_fatal(tmp_path, monkeypatch):
    tbl = _table()
    monkeypatch.setenv("NDS_TPU_CHUNK_STORE", str(tmp_path))
    _run(tbl)
    mp = os.path.join(_entry(str(tmp_path)), "manifest.json")
    m = json.load(open(mp))
    m["version"] = CS.STORE_VERSION + 1
    json.dump(m, open(mp, "w"))
    with pytest.raises(CS.ChunkStoreError, match="layout version"):
        _run(tbl)


def _corrupt(entry):
    p = os.path.join(entry, "000.data.npy")
    with open(p, "r+b") as f:
        f.seek(-1, 2)
        b = f.read(1)
        f.seek(-1, 2)
        f.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("fault", ["checksum", "injected"])
def test_corrupt_entry_is_reencoded_with_a_fault_event(tmp_path,
                                                       monkeypatch, fault):
    tbl = _table()
    want = _run(tbl)
    monkeypatch.setenv("NDS_TPU_CHUNK_STORE", str(tmp_path))
    assert _run(tbl) == want                   # cold: builds and saves
    entry = _entry(str(tmp_path))
    pruned = tbl.select([c["name"] for c in json.load(
        open(os.path.join(entry, "manifest.json")))["columns"]])
    if fault == "checksum":
        _corrupt(entry)
        with pytest.raises(CS.ChunkStoreCorrupt, match="checksum"):
            CS.load_plan(str(tmp_path), pruned, {})
    else:
        monkeypatch.setenv("NDS_TPU_FAULT", "chunk-store-read:error:1")
        F.reset_fault_counts()
    F.drain_fault_events()
    assert _run(tbl) == want
    events = [(e.seam, e.action) for e in F.drain_fault_events()]
    assert events == [("chunk-store-read", "recovered")]
    monkeypatch.delenv("NDS_TPU_FAULT", raising=False)
    assert CS.load_plan(str(tmp_path), pruned, {}) is not None


def test_failed_save_degrades_to_the_in_memory_plan(tmp_path, monkeypatch):
    tbl = _table()
    want = _run(tbl)
    monkeypatch.setenv("NDS_TPU_CHUNK_STORE", str(tmp_path))
    monkeypatch.setenv("NDS_TPU_FAULT", "chunk-store-write:error:1")
    F.reset_fault_counts()
    F.drain_fault_events()
    assert _run(tbl) == want
    assert [(e.seam, e.action) for e in F.drain_fault_events()] == \
        [("chunk-store-write", "degrade")]
    assert not [d for d in os.listdir(tmp_path) if not d.startswith(".")]


def test_stale_fingerprint_reads_as_a_miss(tmp_path, monkeypatch):
    old, new = _table(shift=0), _table(shift=1000)
    monkeypatch.setenv("NDS_TPU_CHUNK_STORE", str(tmp_path))
    _run(old)
    entry = _entry(str(tmp_path))
    names = [c["name"] for c in json.load(
        open(os.path.join(entry, "manifest.json")))["columns"]]
    fp_old = json.load(open(os.path.join(entry, "manifest.json")))[
        "fingerprint"]
    assert CS.load_plan(str(tmp_path), new.select(names), {}) is None
    monkeypatch.delenv("NDS_TPU_CHUNK_STORE")
    want = _run(new)
    monkeypatch.setenv("NDS_TPU_CHUNK_STORE", str(tmp_path))
    assert _run(new) == want and want
    fp_new = json.load(open(os.path.join(entry, "manifest.json")))[
        "fingerprint"]
    assert fp_new != fp_old


def test_dead_writers_lock_is_stolen_and_a_live_one_respected(tmp_path):
    tbl = _table(n=256)
    root = str(tmp_path)
    plan = ChunkedTable(tbl, chunk_rows=128)._build_wire_plan()
    final = CS._entry_dir(root, tbl, {})
    os.makedirs(root, exist_ok=True)
    dead = subprocess.run([sys.executable, "-c",
                           "import os; print(os.getpid())"],
                          capture_output=True, text=True, check=True)
    with open(final + ".lock", "w") as f:
        f.write(dead.stdout.strip())
    assert CS.save_plan(root, tbl, {}, plan) is not None
    assert not os.path.exists(final + ".lock")
    lock = CS._acquire_entry_lock(final)          # a live writer: us
    try:
        assert CS.save_plan(root, tbl, {}, plan) is None
    finally:
        CS._release_entry_lock(lock)
    assert CS.load_plan(root, tbl, {}) is not None


# --------------------------------------------------------- the chunks


def _inline_chunks(ct):
    """The port's chunks before the wire plan: each plain column's arrow
    slice lowered per chunk (``column.lower_arrow_array``), strings and
    narrow ints sliced from their whole-table codes."""
    from nds_tpu_torch import types as _t
    from nds_tpu_torch.engine.column import lower_arrow_array
    cap, n = ct.chunk_cap, ct.nrows
    strings, narrow = ct._string_encodings(), ct._int_encodings()
    out = []
    for s in range(0, n, ct.chunk_rows):
        live = min(ct.chunk_rows, n - s)
        sl = ct.arrow.slice(s, live)
        cols = []
        for name in ct.arrow.column_names:
            rows = slice(s, s + live)
            enc = dv = None
            if name in strings:
                codes, dv, valid = strings[name]
                kind = "str"
            elif name in narrow:
                codes, valid, enc = narrow[name]
                kind = _t.device_kind(ct._canonical(name))
            else:
                kind, codes, valid, dv = lower_arrow_array(
                    sl[name], ct._canonical(name))
                rows = slice(0, live)
            data = np.zeros(cap, dtype=codes.dtype)
            v = np.zeros(cap, dtype=np.bool_)
            data[:live] = codes[rows]
            v[:live] = True if valid is None else valid[rows]
            cols.append((name, kind, data, v, dv, enc))
        out.append((live, cols))
    return out


def _chunk_arrays(hc):
    return (hc.live, [(n, k, np.asarray(d).copy(), np.asarray(v).copy(), dv,
                       e) for (n, k, d, v, dv, e) in hc.cols])


def _chunks_equal(got, want):
    assert len(got) == len(want)
    for (la, ca), (lb, cb) in zip(got, want):
        assert la == lb
        for (n1, k1, d1, v1, dv1, e1), (n2, k2, d2, v2, dv2, e2) in \
                zip(ca, cb):
            assert (n1, k1) == (n2, k2)
            assert d1.dtype == d2.dtype, n1
            np.testing.assert_array_equal(d1.view(np.uint8),
                                          d2.view(np.uint8))
            np.testing.assert_array_equal(v1, v2)
            assert (dv1 is None) == (dv2 is None)
            if dv1 is not None:
                assert list(dv1) == list(dv2)
            assert (e1 is None) == (e2 is None)
            if e1 is not None:
                assert (e1.mode, e1.base) == (e2.mode, e2.base)


@pytest.mark.parametrize("store", ["off", "cold", "warm"])
def test_wire_chunks_equal_the_inline_chunks(tmp_path, monkeypatch, store):
    tbl = _table(n=2500, seed=9)
    want = _inline_chunks(ChunkedTable(tbl, chunk_rows=700))
    if store != "off":
        monkeypatch.setenv("NDS_TPU_CHUNK_STORE", str(tmp_path))
    if store == "warm":
        list(ChunkedTable(tbl, chunk_rows=700).host_chunks())

        def refuse(*_a, **_k):
            raise AssertionError("a warm store re-encoded the table")
        monkeypatch.setattr(ChunkedTable, "_build_wire_plan", refuse)
    ct = ChunkedTable(tbl, chunk_rows=700)
    got = [_chunk_arrays(hc) for hc in ct.host_chunks()]
    _chunks_equal(got, want)
    assert [live for live, _c in got] == [700, 700, 700, 400]
    if store != "off":
        assert os.path.exists(os.path.join(_entry(str(tmp_path)),
                                           "manifest.json"))


def test_wire_chunks_equal_the_references_padded_chunks(tmp_path,
                                                        monkeypatch):
    from nds_tpu.engine.table import ChunkedTable as RefChunked
    monkeypatch.setenv("NDS_TPU_CHUNK_STORE", str(tmp_path))
    tbl = _table(n=2500, seed=4)
    theirs = list(RefChunked(tbl, chunk_rows=700).padded_chunks())
    ours = [_chunk_arrays(hc) for hc in
            ChunkedTable(tbl, chunk_rows=700).host_chunks()]
    want = [(int(c.nrows), [
        (n, c[n].kind, np.asarray(c[n].data), np.asarray(c[n].valid),
         c[n].dict_values, c[n].enc) for n in c.column_names])
        for c in theirs]
    _chunks_equal(ours, want)


class _Event:
    """A copy's completion event: done after ``polls`` queries."""

    def __init__(self, polls):
        self.polls = polls

    def query(self):
        self.polls -= 1
        return self.polls < 0


def test_pinned_pool_reuses_buffers_after_their_copy(monkeypatch):
    """A released set is refilled only once its copy's event completes;
    a set still leased is never refilled; the chunks stay bit-identical to
    unpinned ones (only the dirty tail is re-zeroed)."""
    monkeypatch.setattr(T, "_pinned_zeros",
                        lambda cap, dtype: torch.zeros(cap, dtype=dtype))
    monkeypatch.setattr(T, "_EVENT_POLL_S", 0.0)
    tbl = _table(n=2500, seed=9)
    want = [_chunk_arrays(hc) for hc in
            ChunkedTable(tbl, chunk_rows=900).host_chunks()]
    it = ChunkedTable(tbl, chunk_rows=900).host_chunks(pinned=True,
                                                       buffers=2)
    got, ptrs, events = [], [], []
    for i, hc in enumerate(it):
        got.append(_chunk_arrays(hc))
        ptrs.append(hc.cols[0][2].data_ptr())
        ev = _Event(3)
        events.append(ev)
        if i != 0:                       # chunk 0's set stays leased
            hc.release(ev)
    _chunks_equal(got, want)
    assert [live for live, _c in got] == [900, 900, 700]
    # chunk 2 takes chunk 1's set, after its event completed; chunk 0's
    # leased set was never refilled
    assert ptrs[2] == ptrs[1] != ptrs[0]
    assert events[1].polls < 0 and events[0].polls == 3
