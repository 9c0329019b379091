# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Whole-statement replay: a device-resident statement recorded once, then
replayed as ONE CUDA graph.

The engine executes eagerly, table at a time: a statement launches
hundreds to thousands of small kernels from Python and reads the host a
few times on the way (bucket sizes, batched counts, host-built maps). On
the card the Python dispatch of those launches, not the device, takes
most of a statement's wall. The tiers (``Session._sql_replay``):

1. RECORD: run the statement eagerly once under ``ops.recording()``: every
   host read logs its value in order.
2. COMPILE: lift the log's array payloads into device operands
   (:func:`_lift_log`, uploaded once), then run the SAME planner code
   again under ``ops.replaying(log, operands)``, which serves every host
   read from the log. On ``cuda`` this runs once uncaptured on a side
   stream (the warm-up: it fills every cache and uploads every host array
   the statement needs, see ``ops.UploadStage``), then once inside
   ``torch.cuda.graph``: the statement's kernels, the hand-written ones
   (K1-K3) included, become one graph whose output columns and row count
   are its static outputs. The session's graphs share one memory pool
   and capture on one stream (``ops.capture_stream``), so that they share
   its blocks.
3. REPLAY: later executions of the same text on the same data version
   replay the graph (one launch, no host read) and clone its outputs, so
   that a result the caller still holds never changes on the next replay.
   On ``cpu`` there is nothing to capture: the tier re-runs the planner
   under ``ops.replaying`` (no host read), which lets the CPU tests hold
   the tiers against the reference.

A capture that fails (a synchronizing call or a host-to-device copy inside
the region; the capture runs under ``torch.cuda.set_sync_debug_mode
("error")`` so that a missed sync raises instead of hanging) raises
:class:`ops.CaptureError` from :meth:`CompiledQuery.compile`; the session
blacklists the statement with the reason. Nothing falls back to the CPU.

The kernels' launch counts (``kernels.LAUNCHES``) stay true: a replayed
graph launches its kernels without passing through their wrappers, so the
compiled statement keeps the launches its capture recorded (taken back
out of the counts: a capture runs nothing) and adds them on every replay.

What the reference's XLA build has and this module has not: the program
size gate and the segment chain (``_count_eqns``, ``_split_jaxpr``, the
``NDS_TPU_REPLAY_MAX_EQNS`` and ``NDS_TPU_REPLAY_MAX_SEGMENTS`` knobs).
They bound XLA's optimisation time, which grows superlinearly with the
program; a CUDA graph records launches as they come and has no such
optimisation to bound, so there is nothing to split.

Safety: the session keys each compiled statement on (text, data
version), and any catalog change bumps the version. The graph reads the
catalog's tensors at the addresses they had at capture; :meth:`run`
refuses a catalog whose tensors are no longer those objects. A replay
that diverges from its recording raises ``ops.ReplayMismatch``. A
statement that binds a host-resident ``ChunkedTable`` never records
(:func:`record_eligible`): its chunks stream through engine/stream.py.

Lifting recorded logs also serves the streamed pipeline: a log's arrays
that the replayed program only hands back to the device lift into device
operands uploaded ONCE, when the pipeline or the statement is built.
Entries whose values drive HOST decisions (sync counts, chunk spans, key
ranges) stay literal.
"""

from __future__ import annotations

import time
from dataclasses import replace as _replace

import numpy as np
import torch

from nds_tpu_torch.engine import kernels as K
from nds_tpu_torch.engine import ops as E
from nds_tpu_torch.engine.table import DeviceTable
from nds_tpu_torch.obs import trace as _obs

# tag -> indices of liftable tuple elements (None = the whole value is one
# array)
_LIFTABLE = {
    "cast_str": (0,),          # (inv codes, dictionary)
    "concat": (0,),
    "date_part": None,
    "month_arith": None,
    "dense_dim": (1,),         # (base, position map) — may be None
}
# every liftable array lifts, however small: a replayed array that stayed
# on the host would cost a blocking host-to-device copy per replay
_LIFT_MIN_ELEMS = 0


def _lift_log(log, device):
    """Split a recorded log into (log-with-ArgRefs, operand tensors on
    ``device``)."""
    out_log, operands = [], []

    def lift(arr):
        operands.append(E.upload(arr, device))
        return E.ArgRef(len(operands) - 1)

    def liftable(x):
        return isinstance(x, np.ndarray) and x.size >= _LIFT_MIN_ELEMS

    for tag, val in log:
        idxs = _LIFTABLE.get(tag, ())
        if idxs is None and liftable(val):
            val = lift(val)
        elif idxs and isinstance(val, tuple):
            val = tuple(lift(x) if (i in idxs and liftable(x)) else x
                        for i, x in enumerate(val))
        out_log.append((tag, val))
    return out_log, operands


def _engine_site(exc) -> str:
    """``file.py:line:function`` of the deepest frame of this package in
    ``exc``'s traceback (where a capture failed)."""
    import os
    import traceback
    site = "?"
    for fr in traceback.extract_tb(exc.__traceback__):
        if "nds_tpu_torch" in fr.filename:
            site = f"{os.path.basename(fr.filename)}:{fr.lineno}:{fr.name}"
    return site


def _launch_delta(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in K.LAUNCHES.items()
            if v != before.get(k, 0)}


class CompiledQuery:
    """One recorded statement and, on ``cuda``, its captured graph."""

    def __init__(self, session, stmt, log, out_template):
        self.session = session
        self.stmt = stmt
        self.device = session.device
        self.log, self.operands = _lift_log(list(log), self.device)
        # (names, kinds, dict_values, valids-present, plen, nrows_bound)
        self.out_template = out_template
        self.arg_spec = None       # [(table, col, has_valid)]
        self.args = None           # the catalog tensors the graph reads
        self.graph = None
        self.static_out = None     # the graph's output table
        self.static_count = None   # (count tensor, bound) or (int, None)
        self.stage = None          # host arrays uploaded before capture
        self.launches: dict = {}   # kernel launches one replay makes
        self.warm_launches: dict = {}
        self.capture_s = 0.0
        # set by the session
        self.eager_s = 0.0
        self.strikes = 0
        self.first_run = True
        self.scan_bytes: dict = {}

    # ---------------------------------------------------------------- build

    def _flat_args(self):
        """The session catalog's column buffers, in ``arg_spec`` order."""
        args = []
        for tname, i, cname, has_valid in self.arg_spec:
            col = _stored(self.session.catalog[tname])[i][cname]
            args.append(col.data)
            if has_valid:
                args.append(col.valid)
        return args

    def _replay_planner(self) -> DeviceTable:
        """The statement's planner code with every host read served from
        the log."""
        from nds_tpu_torch.sql.planner import Planner
        planner = Planner(self.session.catalog,
                          base_tables=self.session.base_tables)
        with E.replaying(self.log, self.operands):
            out = planner.query(self.stmt)
        names = self.out_template[0]
        if list(out.column_names) != list(names) \
                or out.plen != self.out_template[4]:
            raise E.ReplayMismatch(
                "replay produced a different output schema or capacity "
                "than the recording")
        return out

    def compile(self):
        catalog = self.session.catalog
        # lazy view counts resolve up front: a DeviceCount read inside the
        # replay would leak a stale device scalar into the graph
        for t in catalog.values():
            for part in _stored(t):
                if isinstance(part.nrows, E.DeviceCount):
                    part.nrows = part.nrows.to_int()
        # argument universe: every DEVICE table in the catalog (each shard
        # of a meshed session's table). A statement that binds a
        # host-resident ChunkedTable never gets here (record_eligible)
        self.arg_spec = []
        for tname in sorted(catalog):
            for i, part in enumerate(_stored(catalog[tname])):
                for cname, col in part.columns.items():
                    self.arg_spec.append((tname, i, cname,
                                          col.valid is not None))
        self.args = self._flat_args()
        E.resolve_counts()   # the replay must start with a clean batch
        # the capture's time is charged to the compile meter, as the
        # reference charges its XLA compile; on the CPU there is nothing
        # to capture
        t0 = time.perf_counter_ns()
        with _obs.span("replay.compile", statement="whole-statement",
                       device=self.device.type):
            try:
                if self.device.type == "cuda":
                    self._capture()
            finally:
                dt = time.perf_counter_ns() - t0
                E.add_compile_ns(dt)
                self.capture_s = dt / 1e9
        return self

    def _capture(self):
        dev = self.device
        cur = torch.cuda.current_stream(dev)
        self.stage = E.UploadStage()
        # warm-up: uncaptured, on a side stream. It fills every cache the
        # statement reaches and uploads its host arrays, so that nothing
        # inside the capture fills a cache or copies from the host
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        k0 = dict(K.LAUNCHES)
        with torch.cuda.stream(side), E.staged_uploads(self.stage):
            warm = self._replay_planner()
        cur.wait_stream(side)
        self.warm_launches = _launch_delta(k0)
        del warm
        graph = torch.cuda.CUDAGraph()
        k1 = dict(K.LAUNCHES)
        out = inner = None
        try:
            with torch.cuda.graph(graph, pool=self.session.graph_pool(),
                                  stream=E.capture_stream(dev),
                                  capture_error_mode="thread_local"):
                prev = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    with E.staged_uploads(self.stage, serve=True):
                        out = self._replay_planner()
                except Exception as exc:
                    inner = exc        # the cause, not the capture's end
                    raise
                finally:
                    torch.cuda.set_sync_debug_mode(prev)
        except Exception as exc:
            root = inner or exc
            raise E.CaptureError(
                f"capture failed at {_engine_site(root)}: "
                f"{type(root).__name__}: {root}"[:300]) from root
        finally:
            # a capture launches nothing: its wrapper counts go back out
            # and come in again with every replay
            self.launches = _launch_delta(k1)
            for k, v in self.launches.items():
                K.LAUNCHES[k] -= v
        n = out.nrows
        if isinstance(n, E.DeviceCount) and n._host is None:
            self.static_count = (n.dev, n.bound)
        else:
            self.static_count = (E.count_int(n), None)
        self.static_out = out
        self.graph = graph

    # ----------------------------------------------------------------- run

    def run(self, block: bool = False) -> DeviceTable:
        with _obs.span("replay.drive", graph=self.graph is not None):
            return self._run(block)

    def _run(self, block: bool) -> DeviceTable:
        # stray real counts must not sit in the pending list where the
        # replayed resolutions would batch them
        E.resolve_counts()
        if self.graph is None:
            out = self._replay_planner()
            # the replay dropped its counts from the pending list; a
            # lazy output count resolves on its own at the fetch
            return out
        if any(a is not b for a, b in zip(self._flat_args(), self.args)):
            raise E.ReplayMismatch("the catalog's tensors changed since "
                                   "the capture")
        self.graph.replay()
        for k, v in self.launches.items():
            K.LAUNCHES[k] += v
        src = self.static_out
        cols = {n: _replace(c, data=c.data.clone(),
                            valid=None if c.valid is None
                            else c.valid.clone())
                for n, c in src.columns.items()}
        count, bound = self.static_count
        nrows = count if bound is None else E.DeviceCount(count.clone(),
                                                          bound)
        if block:
            torch.cuda.current_stream(self.device).synchronize()
        return DeviceTable(cols, nrows, plen=src.plen)


def _stored(t) -> list:
    """The device tables a catalog entry stores: a meshed table's shards,
    a plain table itself, nothing of a host-resident ChunkedTable."""
    from nds_tpu_torch.engine.sharded import ShardedTable
    if isinstance(t, ShardedTable):
        return t.parts
    return [t] if isinstance(t, DeviceTable) else []


def out_template_of(table: DeviceTable):
    names = list(table.column_names)
    kinds = [table[n].kind for n in names]
    dicts = [table[n].dict_values for n in names]
    valided = [table[n].valid is not None for n in names]
    return (names, kinds, dicts, valided, table.plen,
            E.count_bound(table.nrows))


def _binds_chunked(session, stmt) -> bool:
    """True when any table reference in the statement resolves to a
    host-resident ChunkedTable in the session catalog. Conservative on
    shadowing: a CTE reusing a chunked table's name still counts (the
    statement simply stays on the planner path, which handles it)."""
    from nds_tpu_torch.engine.table import ChunkedTable
    from nds_tpu_torch.sql import ast as A
    chunked = {name for name, t in session.catalog.items()
               if isinstance(t, ChunkedTable)}
    if not chunked:
        return False
    found = False

    def walk(x):
        nonlocal found
        if found:
            return
        if isinstance(x, A.TableRef) and x.name.lower() in chunked:
            found = True
            return
        if hasattr(x, "__dataclass_fields__"):
            for f in vars(x).values():
                walk_any(f)

    def walk_any(f):
        if isinstance(f, (list, tuple)):
            for y in f:
                walk_any(y)
        elif hasattr(f, "__dataclass_fields__"):
            walk(f)
    walk(stmt)
    return found


def record_eligible(session, stmt=None) -> bool:
    """Recording is decided per STATEMENT, not per catalog: a session with
    ChunkedTables still replays every statement that binds only device
    tables. A statement that does bind a chunked scan is routed away from
    whole-statement record/replay up front: recording it would log one
    host decision per chunk, and a graph cannot hold a host-resident
    table. Its chunks stream through engine/stream.py's pipeline, which
    applies the same record/replay machinery to one per-chunk program."""
    if stmt is not None and _binds_chunked(session, stmt):
        return False
    return True
