# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The streamed chunk pipeline: a sync-budgeted executor for scans of tables
bigger than device memory (single device).

The eager chunk loop (``Planner._stream_join_parts``) re-plans the join
graph per chunk, and every chunk pays the per-chunk host syncs (join pair
sizing, adaptive compaction). The pipeline runs the same planner code once
per chunk WITHOUT any host read inside the loop:

1. RECORD — run the join graph ONCE, eagerly, over the first padded chunk
   under ``ops.recording()`` + ``ops.stream_bounds()``. Stream-bounds mode
   forbids any chunk-data-dependent host decision (``StreamSyncError`` =>
   the statement stays on the eager loop), so the only recorded host reads
   are chunk-INVARIANT dimension-side plans (dense key maps, key ranges):
   the log is valid for every chunk.
2. DRIVE — replay the same planner code on every padded chunk under
   ``ops.replaying(log)`` + ``ops.stream_bounds()``: every host read is
   served from the log (a read the log does not serve raises
   ``ReplayMismatch``/``StreamSyncError``). ``ChunkedTable.host_chunks``
   pads every chunk (the trailing partial one included) to one
   power-of-two capacity with one structure, so the one recorded program
   serves all of them. Chunks arrive through the bounded prefetch ring
   (engine/prefetch.py); survivors scatter into device accumulators with a
   device-side running row count.
3. SYNC — one materializing host read at pipeline end fetches the survivor
   count plus the overflow flag. Overflow (a bound-sized pair bucket or
   the accumulator ran out of room on some chunk) means rows were dropped
   on device: the result is discarded and the statement re-runs through
   the eager loop, so streamability is a performance property, never a
   correctness one.

The compiled program (the counterpart of the reference's ``jax.jit`` of
it, with the accumulators donated): on ``cuda`` the first drive of a
pipeline captures one chunk's whole program (the K4 pass, the partition
routing, the body of every partition) as ONE ``torch.cuda.CUDAGraph`` in
the session's graph pool. Its operands are static buffers the pipeline
owns (:class:`_Static`): the chunk slots and live count, which each chunk
from the ring is copied into on the device before the replay (one D2D
copy a chunk; a graph per ring slot would need a capture per slot and
tie the ring's depth to the pipeline), the subquery residual slots,
which each execution copies its re-planned residuals into (a residual's
spec is checked equal on a cache hit), and the accumulators and the
partition histogram, updated in place and zeroed by kernels at the start
of each execution. The part buffers are read in place (a cache hit checks
their identity). The capture follows ``replay.CompiledQuery``: the first
chunk runs for real on a side stream under ``ops.staged_uploads`` (the
warm-up; module caches bypassed), then the capture runs under
``torch.cuda.set_sync_debug_mode("error")``, and the kernel launches it
recorded leave ``kernels.LAUNCHES`` and come back with every replay. The
survivors are cloned out of the accumulators after the final read. On the
CPU nothing is captured: the same static-slot, in-place drive runs the
program from Python. A capture that fails (``ops.CaptureError``) leaves
the pipeline on the eager drive (the program run from Python on each
chunk, into fresh accumulators), with the reason in its stream event
(``graph: "refused: ..."``); ``Session.sql(..., graph=False)`` asks for
the eager drive to compare.

Fused kernels: the chunk-local WHERE conjuncts that the shared eligibility
rule (analysis/kernel_spec.py) accepts lower into one ``ScanSpec``
(engine/exprs.lower_scan_spec) that the K4 kernel (``kernels.chunk_scan``)
evaluates per chunk before the recorded graph, which consumes the survivor
mask as a lazy compact; stream-bounds joins probe through K5
(``kernels.join_probe``, in ops._probe_candidates). Non-lowerable conjuncts
stay in the graph per conjunct, and a graph with deferred outer joins
lowers nothing.

Multi-pass streaming: subquery residuals are planned once (outside the
recording) into device tables the per-chunk program consumes; deferred
LEFT joins ride into the graph (``_OuterProbe``, ``_OuterBuild``: per-chunk
matched-build masks OR into an on-device bitmap and the outer extras emit
once at the end); recorded chunk scalars replay under a device-side
staleness guard (``ops.guarded_scalar_read``).

Accumulators are sized from the statement's PROVEN row bound
(analysis/mem_audit.py: schema PK uniqueness + stream-fanout pair buckets),
so a statement whose bound fits the capacity model never overflows; an
unprovable or over-capacity bound falls back to a 2^23-row guess.

Partitioned (grace-style) accumulation: a provable graph whose bound does
not fit capacity is split by join-key hash. Each chunk's rows get a
partition id from the routing hash (computed by K4 when a scan spec
exists, by the plain hash fold otherwise) and a device histogram; the
per-chunk program then runs once per partition on the chunk masked to that
partition, into the partition's own proof-sized accumulator. The single
materializing read fetches every partition's count and flag and the
histogram together.

Settings (``Session(conf=...)`` keys, ``ops.STREAM_DEFAULTS``):
``stream_exec``, ``stream_partitions``,
``stream_acc_rows``, ``stream_fanout``, ``stream_skew``,
``prefetch_depth``, ``hbm_bytes``.

Faults (engine/faults.py): the chunk uploads are the ``device-put``
seam, retried in place; the record is the ``pipeline-compile`` seam; a
classified fault there or in the drive (an exhausted retry) takes one
step down the ladder, to the eager chunk loop, recorded as a fault event.
A statement timeout raises, and any other exception raises as before.

Chunk-derived host reads: the log serves ``date_part``, ``month_arith``,
``cast_str`` and ``concat`` reads like dimension reads, so a replay would
hand every chunk the first chunk's values. While the program records, such
a read of rows that derive from the chunk raises ``StreamSyncError``
(``ops.chunk_invariant``: only the non-streamed parts are exempt) and the
statement takes the eager chunk loop.
"""

from __future__ import annotations

import logging
import threading
import weakref

import torch

from nds_tpu_torch.engine import faults as _F
from nds_tpu_torch.engine import kernels as _K
from nds_tpu_torch.engine import ops as E
from nds_tpu_torch.engine import prefetch as _PF
from nds_tpu_torch.engine import prim
from nds_tpu_torch.engine.column import Column, slice_col_prefix
from nds_tpu_torch.engine.table import DeviceTable, upload_chunk
from nds_tpu_torch.listener import record_stream_event
from nds_tpu_torch.obs import metrics as _metrics
from nds_tpu_torch.obs import trace as _obs

log = logging.getLogger(__name__)

I64 = torch.int64

# survivor-accumulator row guess: the clamp applied only when the memory
# proof cannot admit a bound (unprovable multiplicity, or a proven bound
# past the capacity model)
_DEFAULT_ACC_ROWS = 1 << 23


def _acc_ceiling() -> int | None:
    """The ``stream_acc_rows`` setting: an explicit hard per-partition
    accumulator ceiling."""
    got = E.setting("stream_acc_rows")
    return None if got is None else int(got)


def _hbm_bytes() -> int:
    from nds_tpu_torch.analysis.mem_audit import hbm_capacity_bytes
    return hbm_capacity_bytes()


def _proved_plan(parts, keep, join_preds, where_conjuncts, sources, nrows):
    """``(proved_rows, k, part_keys)`` of the streamed graph from the memory
    proof (analysis/mem_audit.py): the whole-statement survivor bound
    ``bucket(rows) x fanout^k``, plus the chunk-side equi-key names a
    partition pass may hash on. Deferred outer joins contribute their ON
    conjuncts and pristine sources. ``(None, None, None)`` when unprovable
    (an unconnected graph)."""
    from nds_tpu_torch.analysis.mem_audit import (stream_graph_fanout,
                                                  stream_partition_keys,
                                                  structural_row_bound)
    from nds_tpu_torch.sql.planner import _OuterBuild, _OuterProbe
    part_cols = [{str(c).lower() for c in p.column_names} for p in parts]
    srcs = list(sources)
    conj = list(join_preds) + list(where_conjuncts)
    for i, p in enumerate(parts):
        if isinstance(p, (_OuterProbe, _OuterBuild)):
            srcs[i] = p.src
            conj.extend(p.conjuncts)
    srcs = [s.lower() if isinstance(s, str) else None for s in srcs]
    k = stream_graph_fanout(part_cols, srcs, keep, conj)
    if k is None:
        return None, None, None
    return (structural_row_bound(int(nrows), k, E.stream_fanout()), k,
            stream_partition_keys(part_cols, srcs, keep, conj))


def _ring_bytes(chunk_nbytes: int) -> int:
    """Extra live bytes of the prefetch ring: up to ``prefetch_depth``
    prepared chunks wait beyond the one being consumed. Priced into every
    admission decision below (effective capacity = capacity - ring)."""
    return max(_PF.prefetch_depth(), 0) * max(int(chunk_nbytes), 0)


def _partition_plan(nrows, fan_k, part_keys, proved, row_bytes, n_chunks,
                    chunk_out_plen, ring_bytes=0):
    """``(n_partitions, per_partition_row_bound)``: > 1 only for a provable
    graph with chunk-side equi keys whose whole bound is past capacity (or
    when the ``stream_partitions`` setting pins a count)."""
    if fan_k is None or not part_keys or proved is None:
        return 1, None
    from nds_tpu_torch.analysis.mem_audit import (choose_partitions,
                                                  forced_partitions)
    forced = forced_partitions()
    bound = min(n_chunks * chunk_out_plen, proved)
    ceiling = _acc_ceiling()
    if ceiling is not None:
        bound = min(bound, ceiling)
    cap = max(_hbm_bytes() - ring_bytes, 1)
    need = bound * row_bytes > cap
    if not need and (forced is None or forced <= 1):
        return 1, None
    return choose_partitions(int(nrows), fan_k, E.stream_fanout(),
                             row_bytes, cap, forced=forced)


def _acc_row_budget(n_chunks, chunk_out_plen, proved, row_bytes,
                    ring_bytes=0):
    """Rows the survivor accumulator is sized for: at most the sum of the
    per-chunk output buckets, tightened by the proof; the ceiling setting
    stays a hard clamp; a bound the capacity cannot admit falls back to the
    row guess."""
    rows = n_chunks * chunk_out_plen
    if proved is not None:
        rows = min(rows, proved)
    ceiling = _acc_ceiling()
    if ceiling is not None:
        return min(rows, ceiling)
    if proved is None or \
            rows * row_bytes > max(_hbm_bytes() - ring_bytes, 1):
        return min(rows, _DEFAULT_ACC_ROWS)
    return rows


def _part_acc_budget(n_chunks, chunk_out_plen, part_bound, row_bytes,
                     n_parts, ring_bytes=0):
    """Per-partition accumulator rows: the per-partition proof, with the
    TOTAL allocation clamped to capacity (survivors past the clamp trip the
    per-partition overflow flag and rerun eagerly)."""
    rows = n_chunks * chunk_out_plen
    if part_bound is not None:
        rows = min(rows, part_bound)
    share = max(_hbm_bytes() - ring_bytes, 1) // max(n_parts * row_bytes,
                                                     1)
    rows = min(rows, max(share, chunk_out_plen))
    ceiling = _acc_ceiling()
    if ceiling is not None:
        rows = min(rows, ceiling)
    return rows


# pipelines are cached across statements (a Power Run executes each query
# text 2-4 times); bounded FIFO, identity-validated on hit
_PIPELINE_CACHE: dict = {}
_PIPELINE_MAX = 64
_PIPELINE_LOCK = threading.Lock()


def _evict(key) -> None:
    with _PIPELINE_LOCK:
        pipe = _PIPELINE_CACHE.pop(key, None)
    if pipe is not None:
        pipe.release_static()
        _metrics.default().inc(_metrics.PIPE_EVICT)


# pipelines holding static operands (and, on cuda, a captured graph), oldest
# first: their bytes stay within a quarter of the device-memory model, the
# newest kept regardless. Weak: a pipeline dropped from the cache takes its
# operands with it
_STATIC = weakref.WeakValueDictionary()
_STATIC_LOCK = threading.Lock()
_STATIC_SHARE = 4


def _restore_counts(snapshot, checks_snapshot):
    """Drop DeviceCounts/deferred checks created by a record or drive:
    their values belong to the per-chunk programs, and left in the pending
    list they would cost a later batched resolve."""
    lst = E._pending_counts()
    lst[:] = [c for c in lst if any(c is s for s in snapshot)]
    E._sync_tls.checks = [
        (c, f) for c, f in (getattr(E._sync_tls, "checks", None) or [])
        if any(c is s for s in checks_snapshot)]


def _snapshot():
    return (list(E._pending_counts()),
            [c for c, _f in (getattr(E._sync_tls, "checks", None) or [])])


def _flatten_part(part: DeviceTable):
    """(spec, flat) for one non-streamed part: spec is static metadata
    (names, kinds, dictionaries, valid presence, encodings, logical count,
    physical length), flat the device buffers in spec order."""
    spec, flat = [], []
    nrows = E.count_int(part.nrows)   # resolved up front by the caller
    for name in part.column_names:
        c = part[name]
        spec.append((name, c.kind, c.dict_values, c.valid is not None,
                     c.enc))
        flat.append(c.data)
        if c.valid is not None:
            flat.append(c.valid)
    return (tuple(spec), nrows, part.plen), flat


def _rebuild_part(spec, flat):
    (cols_spec, nrows, plen) = spec
    cols, i = {}, 0
    for name, kind, dv, has_valid, enc in cols_spec:
        data = flat[i]
        i += 1
        valid = None
        if has_valid:
            valid = flat[i]
            i += 1
        cols[name] = Column(kind, data, valid, dv, enc)
    return DeviceTable(cols, nrows, plen=plen)


def _chunk_signature(chunk: DeviceTable, alias: str):
    """Static chunk metadata: aliased names (the per-chunk program sees the
    chunk as the planner's FROM-alias binding), kinds, dictionaries and
    narrow encodings."""
    spec = []
    for name in chunk.column_names:
        c = chunk[name]
        aliased = f"{alias.lower()}.{name.split('.')[-1].lower()}"
        spec.append((aliased, c.kind, c.dict_values, c.enc))
    return tuple(spec)


def _flatten_chunk(chunk: DeviceTable):
    flat = []
    for name in chunk.column_names:
        c = chunk[name]
        flat.append(c.data)
        flat.append(c.valid)
    return tuple(flat)


class _Acc:
    """One survivor accumulator, updated in place per dispatch (the port
    scatters into preallocated buffers instead of donating new ones): data
    and validity buffers with one spare row past ``cap`` that takes every
    dropped or overflowing row, the device row count, the overflow flag and
    the outer-build matched bitmaps."""

    __slots__ = ("datas", "valids", "n", "ovf", "outer")

    def __init__(self, datas, valids, n, ovf, outer):
        self.datas, self.valids = datas, valids
        self.n, self.ovf, self.outer = n, ovf, outer

    def buffers(self):
        return [*self.datas, *(v for v in self.valids if v is not None),
                self.n, self.ovf, *self.outer]


class _Static:
    """The static operands of one pipeline's compiled program: the chunk
    slots (the flattened chunk) and its live count, the subquery residual
    slots, one accumulator per partition and the partition histogram; on
    cuda the captured graph, the upload stage its capture was served from
    and the kernel launches one replay makes. ``lock`` is held while an
    execution drives them (a concurrent execution of the same pipeline
    takes the eager drive)."""

    __slots__ = ("slots", "n_dev", "resid", "accs", "hist", "graph",
                 "stage", "launches", "nbytes", "lock")

    def __init__(self, slots, n_dev, resid, accs, hist):
        self.slots, self.n_dev, self.resid = slots, n_dev, resid
        self.accs, self.hist = accs, hist
        self.graph = self.stage = None
        self.launches: dict = {}
        self.nbytes = sum(int(t.nbytes) for t in (
            *slots, n_dev, *(x for r in resid for x in r), hist,
            *(b for a in accs for b in a.buffers())))
        self.lock = threading.Lock()


class StreamPipeline:
    """One recorded per-chunk program plus the metadata to drive it.

    ``n_partitions`` > 1 turns on grace-style partitioned accumulation:
    ``key_slots`` index the chunk's flattened buffers that the partition
    hash folds, the per-chunk program runs once per partition on the chunk
    masked to it, and ``run`` keeps one proof-sized accumulator per
    partition — all fetched in the single materializing read."""

    def __init__(self, chunk_spec, chunk_cap, part_specs, keep, log_entries,
                 operands, out_template, out_plen, acc_cap, part_refs,
                 join_preds, where_kept, sources, n_partitions=1,
                 key_slots=(),
                 outer_meta=(), residuals=(), resid_specs=(),
                 build_slots=(), name_catalog=None, scan_spec=None):
        self.chunk_spec = chunk_spec      # ((aliased name, kind, dict), ...)
        self.chunk_cap = chunk_cap
        self.part_specs = part_specs      # specs of non-streamed parts
        self.keep = keep
        self.log = log_entries
        self.operands = operands
        self.out_template = out_template  # (names, kinds, dicts, valided,
        #                                    dtypes, encs)
        self.out_plen = out_plen          # the recorded output capacity
        self.acc_cap = acc_cap
        # weakrefs to the part buffers, compared by identity on cache hit
        self.part_refs = part_refs
        self.join_preds = tuple(join_preds)
        self.where_kept = tuple(where_kept)
        self.sources = tuple(sources)
        self.n_partitions = n_partitions
        self.key_slots = tuple(key_slots)
        # per non-keep part, None or the deferred-outer-join marker
        # ("probe"/"build", condition AST, conjunct ASTs, src); subquery
        # residuals as (registry key, replan payload) plus their flattened
        # specs; build_slots index the part_specs whose unmatched-key
        # bitmaps the accumulator carries
        self.outer_meta = tuple(outer_meta)
        self.residuals = tuple(residuals)
        self.resid_specs = tuple(resid_specs)
        self.build_slots = tuple(build_slots)
        self.name_catalog = dict(name_catalog or {})
        # the K4 scan pass: the chunk-invariant predicate/codec spec
        # extracted at record time; None = the graph evaluates them all
        self.scan_spec = scan_spec
        # the compiled program's static operands (allocated at the first
        # compiled drive) and, once a capture failed, why
        self._static: _Static | None = None
        self.refused: str | None = None

    # ------------------------------------------------------------ program

    def _body(self, chunk_flat, n_dev, parts_flat, acc: _Acc, resid_flat,
              live=None, pids=None, part_id=None):
        """The per-chunk program: the recorded join graph replayed on one
        chunk, its survivors scattered into ``acc``. No host read."""
        from nds_tpu_torch.sql.planner import Planner, _OuterBuild, \
            _OuterProbe
        names, kinds, dicts, valided, dtypes, encs = self.out_template
        cols, i = {}, 0
        for (aname, kind, dv, cenc) in self.chunk_spec:
            cols[aname] = Column(kind, chunk_flat[i], chunk_flat[i + 1],
                                 dv, cenc)
            i += 2
        chunk = DeviceTable(cols, E.DeviceCount(n_dev, self.chunk_cap),
                            plen=self.chunk_cap)
        mask = live
        if pids is not None:
            pm = pids == part_id
            mask = pm if mask is None else (mask & pm)
        if mask is not None:
            # partition / K4 mask BEFORE the recorded graph: a lazy compact
            # keeps the chunk's physical shape and bound, so the recorded
            # log stays valid for every (chunk, partition)
            with E.stream_bounds():
                chunk = E.compact_table(chunk, mask)
        sub, pi = [], 0
        for j in range(len(self.part_specs) + 1):
            if j == self.keep:
                sub.append(chunk)
                continue
            t = _rebuild_part(self.part_specs[pi], parts_flat[pi])
            meta = self.outer_meta[pi] if pi < len(self.outer_meta) \
                else None
            if meta is not None:
                mk, mcond, mconjs, msrc = meta
                t = (_OuterProbe if mk == "probe" else _OuterBuild)(
                    t, mcond, list(mconjs), msrc)
            sub.append(t)
            pi += 1
        # a fresh planner with an EMPTY catalog: the per-chunk program must
        # close over no catalog state. Subquery residuals are pre-planned
        # device tables seeded into its registry.
        pl = Planner({}, base_tables=set())
        pl.name_catalog = self.name_catalog
        for (rkey, _p), rspec, rflat in zip(self.residuals,
                                             self.resid_specs, resid_flat):
            pl._subquery_residuals[rkey] = (None,
                                            _rebuild_part(rspec, rflat))
        with E.replaying(self.log, self.operands):
            with E.stream_bounds() as sb:
                with E.outer_match_collector() as omc:
                    out = pl._join_parts(sub, list(self.join_preds),
                                         list(self.where_kept),
                                         list(self.sources))
                flags = list(sb.flags)
                matched = list(omc.masks)
        if list(out.column_names) != list(names):
            raise E.ReplayMismatch(
                "streamed replay produced a different output schema than "
                "the recording")
        if len(matched) != len(self.build_slots):
            raise E.ReplayMismatch(
                "streamed replay registered a different outer-build mask "
                "count than the recording")
        if out.plen != self.out_plen:
            raise E.ReplayMismatch(
                "streamed replay produced a different output capacity "
                "than the recording")
        dev = acc.n.device
        out_n = E.count_arr(out.nrows)
        row = torch.arange(out.plen, device=dev)
        pos = acc.n + row
        pos = torch.where((row < out_n) & (pos < self.acc_cap), pos,
                          torch.full((), self.acc_cap, dtype=I64,
                                     device=dev))
        for j, n in enumerate(names):
            c = out[n]
            acc.datas[j].index_put_((pos,), c.data.to(dtypes[j]))
            if valided[j]:
                acc.valids[j].index_put_((pos,), c.valid_mask())
        # every count and flag is an in-place update of the accumulator:
        # a captured program writes only into its static buffers
        acc.n.add_(out_n)
        ovf = acc.ovf | (acc.n > self.acc_cap)
        for f in flags:
            ovf = ovf | f
        acc.ovf.copy_(ovf)
        for b, m in zip(acc.outer, matched):
            b |= m

    def _scan(self, flat, n_dev):
        """The K4 pass of one chunk: (survivor mask, routing hash)."""
        return _K.chunk_scan(flat, n_dev, self.scan_spec)

    def _route(self, h, flat, n_dev, hist):
        """Partition ids of one chunk from its routing hash (folded here
        when no K4 pass computed it) and the input histogram updated with
        the chunk's live rows."""
        P = self.n_partitions
        if h is None:
            h = _K.fold_hash([flat[s] for s in self.key_slots])
        pids = (h & (P - 1)).to(I64)
        live = torch.arange(self.chunk_cap, device=pids.device) < n_dev
        ids = torch.where(live, pids, torch.full((), P, dtype=I64,
                                                  device=pids.device))
        hist += prim.segment_sum(torch.ones_like(ids), ids, P)
        return pids

    # ---------------------------------------------------------------- run

    def _prepare_first(self, chunk: DeviceTable):
        _F.fault_point("device-put")
        flat = _flatten_chunk(chunk)
        dev = flat[0].device
        n_dev = torch.full((), int(chunk.nrows), dtype=I64, device=dev)
        return flat, n_dev, sum(int(x.nbytes) for x in flat)

    def _preparer(self, device):
        """The prefetch worker's step for one host chunk: upload it (from
        pinned buffers, on a side stream, on cuda), flatten it and stamp
        its live count on the device. No host read, no span."""
        side = torch.cuda.Stream(device=device) \
            if device.type == "cuda" else None

        def prepare(hc):
            _F.fault_point("device-put")

            def copy():
                chunk = upload_chunk(hc, device, non_blocking=True)
                flat = _flatten_chunk(chunk)
                n_dev = torch.full((), hc.live, dtype=I64, device=device)
                return (flat, n_dev, hc.nbytes), list(flat) + [n_dev]
            up = _PF.upload_async(device, side, copy)
            # the pinned buffers go back to their pool once the copies
            # that read them are done
            hc.release(getattr(up, "event", None))
            return up
        return prepare

    def init_acc(self, dev) -> _Acc:
        names, kinds, dicts, valided, dtypes, encs = self.out_template
        cap = self.acc_cap + 1               # + the spare drop row
        datas = [torch.zeros(cap, dtype=dt, device=dev) for dt in dtypes]
        valids = [torch.zeros(cap, dtype=torch.bool, device=dev)
                  if v else None for v in valided]
        outer = [torch.zeros(self.part_specs[s][2], dtype=torch.bool,
                             device=dev) for s in self.build_slots]
        return _Acc(datas, valids, torch.zeros((), dtype=I64, device=dev),
                    torch.zeros((), dtype=torch.bool, device=dev), outer)

    def _outer_miss(self, bitmaps):
        """(miss mask, device miss count) per outer-build slot: build rows
        no dispatch matched — the outer extras."""
        out = []
        for slot, bm in zip(self.build_slots, bitmaps):
            _spec, n_live, plen = self.part_specs[slot]
            miss = ~bm & (torch.arange(plen, device=bm.device) < n_live)
            out.append((miss, miss.sum()))
        return out

    def _program(self, st: _Static, parts_flat):
        """One chunk's whole program over the static operands: the K4
        pass, the partition routing and the body of every partition (what
        the graph captures)."""
        P = self.n_partitions
        live = h = pids = None
        if self.scan_spec is not None:
            live, h = self._scan(st.slots, st.n_dev)
        if P > 1:
            pids = self._route(h, st.slots, st.n_dev, st.hist)
        for p in range(P):
            self._body(st.slots, st.n_dev, parts_flat, st.accs[p],
                       st.resid, live, pids, p if P > 1 else None)

    def _step(self, st: _Static, flat, n_dev, parts_flat):
        """One chunk of the compiled drive: the chunk copied into the
        slots on the device, then the graph replayed (on the CPU, the
        program run). No host read."""
        for dst, src in zip(st.slots, flat):
            dst.copy_(src)
        st.n_dev.copy_(n_dev)
        if st.graph is None:
            self._program(st, parts_flat)
            return
        st.graph.replay()
        for k, v in st.launches.items():
            _K.LAUNCHES[k] += v

    def _capture(self, st: _Static, parts_flat):
        """The first chunk (already in the slots) runs for real on a side
        stream, filling the upload stage (the warm-up), then the same
        program is captured as one CUDA graph. Raises
        :class:`ops.CaptureError`."""
        from nds_tpu_torch.engine.replay import _engine_site, _launch_delta
        dev = st.n_dev.device
        cur = torch.cuda.current_stream(dev)
        stage = E.UploadStage()
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side), E.staged_uploads(stage):
            self._program(st, parts_flat)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        pool = E.graph_pool() or torch.cuda.graph_pool_handle()
        k1 = dict(_K.LAUNCHES)
        inner = None
        # the capture API itself, on the shared capture stream ordered
        # after the warm-up: ``torch.cuda.graph`` would also synchronize
        # the device and collect garbage at every capture, and a pipeline
        # whose parts are bound anew by each execution captures at each
        cap_stream = E.capture_stream(dev)
        cap_stream.wait_stream(cur)
        try:
            with torch.cuda.stream(cap_stream):
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                prev = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    with E.staged_uploads(stage, serve=True):
                        self._program(st, parts_flat)
                except Exception as exc:
                    inner = exc        # the cause, not the capture's end
                    raise
                finally:
                    torch.cuda.set_sync_debug_mode(prev)
                    graph.capture_end()
            cur.wait_stream(cap_stream)
        except Exception as exc:
            root = inner or exc
            raise E.CaptureError(
                f"capture failed at {_engine_site(root)}: "
                f"{type(root).__name__}: {root}"[:300]) from root
        finally:
            # a capture launches nothing: its wrapper counts go back out
            # and come in again with every replay
            launches = _launch_delta(k1)
            for k, v in launches.items():
                _K.LAUNCHES[k] -= v
        st.graph, st.stage, st.launches = graph, stage, launches

    def _claim(self, first: DeviceTable, resid_flat) -> _Static | None:
        """This pipeline's static operands, allocated at the first call
        and locked for one execution; None while another execution holds
        them. Other pipelines' operands go, oldest first, while the total
        passes a quarter of the device-memory model."""
        with _STATIC_LOCK:
            st = self._static
            if st is None:
                flat = _flatten_chunk(first)
                dev = flat[0].device
                st = self._static = _Static(
                    [torch.empty_like(x) for x in flat],
                    torch.zeros((), dtype=I64, device=dev),
                    [[torch.empty_like(x) for x in r] for r in resid_flat],
                    [self.init_acc(dev) for _ in range(self.n_partitions)],
                    torch.zeros(self.n_partitions, dtype=I64, device=dev))
            _STATIC.pop(id(self), None)
            _STATIC[id(self)] = self
            budget = max(_hbm_bytes() // _STATIC_SHARE, 1)
            for pid in list(_STATIC):
                if sum(p._static.nbytes for p in _STATIC.values()) \
                        <= budget or pid == id(self):
                    break
                other = _STATIC.get(pid)
                if other is not None and \
                        other._static.lock.acquire(blocking=False):
                    _STATIC.pop(pid, None)
                    other._static = None
        return st if st.lock.acquire(blocking=False) else None

    def release_static(self) -> None:
        """Drop the static operands and the graph (pipeline eviction)."""
        with _STATIC_LOCK:
            _STATIC.pop(id(self), None)
            self._static = None

    def _ring(self, host_iter, dev):
        return _PF.chunk_ring(host_iter, prepare=self._preparer(dev))

    def _drive_static(self, st: _Static, host_iter, first, parts_flat,
                      resid_flat):
        """The compiled drive: the first chunk captures the graph where
        none is (its warm-up executes that chunk), every other chunk
        replays it. Returns ``(accs, hist, chunks, h2d, stall_ms,
        captured)``."""
        dev = st.n_dev.device
        for a in st.accs:                # reset by kernels
            for b in a.buffers():
                b.zero_()
        st.hist.zero_()
        for dst, src in zip(st.resid, resid_flat):
            for d, x in zip(dst, src):
                d.copy_(x)
        capture = dev.type == "cuda" and st.graph is None
        # no worker runs beside a capture: the ring starts after it
        ring = None if capture else self._ring(host_iter, dev)
        n_chunks = h2d = 0
        try:
            cur = _F.with_retry("device-put",
                                lambda: self._prepare_first(first))
            while cur is not None:
                flat, n_dev, nb = cur
                h2d += nb
                if capture and n_chunks == 0:
                    for dst, src in zip(st.slots, flat):
                        dst.copy_(src)
                    st.n_dev.copy_(n_dev)
                    with _obs.span("stream.capture", chunk=0):
                        self._capture(st, parts_flat)
                    ring = self._ring(host_iter, dev)
                else:
                    with _obs.span("stream.drive", chunk=n_chunks,
                                   graph=st.graph is not None):
                        self._step(st, flat, n_dev, parts_flat)
                n_chunks += 1
                with _obs.span("stream.prefetch", chunk=n_chunks) as sp:
                    cur = ring.next_chunk()
                    if cur is None:
                        sp.drop()
            stall_ms = ring.stall_ms()
        finally:
            if ring is not None:
                ring.close()
        return st.accs, st.hist, n_chunks, h2d, stall_ms, capture

    def _drive_eager(self, host_iter, first, parts_flat, resid_flat):
        """The eager drive: the program run from Python on each chunk as
        the ring hands it over, into fresh accumulators."""
        dev = first[next(iter(first.columns))].data.device
        P = self.n_partitions
        accs = [self.init_acc(dev) for _ in range(P)]
        hist = torch.zeros(P, dtype=I64, device=dev)
        ring = self._ring(host_iter, dev)
        n_chunks = 0
        h2d = 0
        try:
            # the first chunk is already on the device (the record used
            # it); it takes the seam's retry on the driver
            cur = _F.with_retry("device-put",
                                lambda: self._prepare_first(first))
            while cur is not None:
                flat, n_dev, nb = cur
                h2d += nb
                live = h = pids = None
                if self.scan_spec is not None:
                    with _obs.span("stream.kernel", chunk=n_chunks):
                        live, h = self._scan(flat, n_dev)
                if P > 1:
                    with _obs.span("stream.partition", chunk=n_chunks,
                                   partitions=P):
                        pids = self._route(h, flat, n_dev, hist)
                for p in range(P):
                    with _obs.span("stream.drive", chunk=n_chunks,
                                   part=p):
                        self._body(flat, n_dev, parts_flat, accs[p],
                                   resid_flat, live, pids,
                                   p if P > 1 else None)
                n_chunks += 1
                # stall span: driver time BLOCKED on the ring for the next
                # chunk; the end-of-stream probe drops its span
                with _obs.span("stream.prefetch", chunk=n_chunks) as sp:
                    cur = ring.next_chunk()
                    if cur is None:
                        sp.drop()
            stall_ms = ring.stall_ms()
        finally:
            ring.close()
        return accs, hist, n_chunks, h2d, stall_ms

    def run(self, host_iter, first, parts_flat, resid_flat=(),
            graph=True):
        """Drive every chunk through the per-chunk program; returns
        ``(survivor DeviceTable | None on overflow, n_chunks, evidence)``.
        ``host_iter`` continues AFTER ``first`` (already on the device).
        ``graph`` takes the compiled drive (on cuda, the captured graph)
        unless a capture was refused; False takes the eager drive.
        ``evidence`` carries the partition counts of a partitioned run,
        the outer-extras masks/counts, upload bytes, prefetch stall,
        kernel launches and how the graph served (``graph``)."""
        P = self.n_partitions
        launches0 = dict(_K.LAUNCHES)
        dev = first[next(iter(first.columns))].data.device
        st = None
        if not graph:
            status = "eager drive"
        elif self.refused is not None:
            status = f"refused: {self.refused}"
        else:
            st = self._claim(first, resid_flat)
            status = "busy: eager drive" if st is None else None
        try:
            if st is not None:
                try:
                    accs, hist, n_chunks, h2d, stall_ms, captured = \
                        self._drive_static(st, host_iter, first,
                                           parts_flat, resid_flat)
                    status = "uncaptured" if dev.type != "cuda" else \
                        "captured" if captured else "replayed"
                except E.CaptureError as exc:
                    # the warm-up ran the first chunk: its launches go
                    # back out, and the eager drive starts over
                    _K.LAUNCHES.update(launches0)
                    self.refused = str(exc)
                    status = f"refused: {exc}"
                    st.lock.release()
                    self.release_static()
                    st = None
                    log.warning("streamed pipeline graph refused: %s", exc)
            if st is None:
                accs, hist, n_chunks, h2d, stall_ms = self._drive_eager(
                    host_iter, first, parts_flat, resid_flat)
            bitmaps = list(accs[0].outer)
            for a in accs[1:]:
                bitmaps = [b | o for b, o in zip(bitmaps, a.outer)]
            miss = self._outer_miss(bitmaps)

            def fetch():
                got = torch.stack(
                    [a.n for a in accs] + [a.ovf.to(I64) for a in accs]
                    + list(hist) + [n for (_m, n) in miss]).cpu().tolist()
                return ([int(x) for x in got[:P]],
                        [bool(x) for x in got[P:2 * P]],
                        [int(x) for x in got[2 * P:3 * P]],
                        [int(x) for x in got[3 * P:]])

            # THE one materializing read of the pipeline
            with _obs.span("stream.materialize", chunks=n_chunks,
                           partitions=P):
                totals, overflowed, hist_host, extras_n = E.timed_read(
                    "stream_final", fetch)
            evidence = {
                "h2d": h2d, "stall_ms": stall_ms, "graph": status,
                "outer": [(slot, m, n) for (slot, (m, _nd), n)
                          in zip(self.build_slots, miss, extras_n)],
                "scan_launches": _K.LAUNCHES["chunk_scan"]
                - launches0["chunk_scan"],
                "probe_launches": _K.LAUNCHES["join_probe"]
                - launches0["join_probe"],
                "kernel_stages": self.scan_spec.stages()
                if self.scan_spec is not None else 0}
            if P > 1:
                evidence.update(partitions=P, part_rows=tuple(totals),
                                part_input=tuple(hist_host))
            if any(overflowed):
                return None, n_chunks, evidence
            # the static accumulators serve the next execution: their
            # survivors are cloned out
            clone = st is not None
            tables = [self._slice_acc(accs[p], totals[p], clone)
                      for p in range(P) if totals[p] > 0]
            if not tables:                   # every partition empty
                out = self._slice_acc(accs[0], 0, clone)
            elif len(tables) == 1:
                out = tables[0]
            else:
                # counts are host-known here, so the union costs no sync
                out = E.concat_tables(tables)
            return out, n_chunks, evidence
        finally:
            if st is not None:
                st.lock.release()

    def _slice_acc(self, acc: _Acc, total: int,
                   clone: bool = False) -> DeviceTable:
        """Survivor prefix of one accumulator as a DeviceTable (with
        ``clone``, copied out of it)."""
        names, kinds, dicts, valided, dtypes, encs = self.out_template
        cap = min(E.bucket_len(total), self.acc_cap)
        cols = {}
        for j, n in enumerate(names):
            col = slice_col_prefix(Column(kinds[j], acc.datas[j],
                                          acc.valids[j], dicts[j], encs[j]),
                                   cap)
            if clone:
                col = Column(col.kind, col.data.clone(),
                             None if col.valid is None
                             else col.valid.clone(), col.dict_values,
                             col.enc)
            cols[n] = col
        return DeviceTable(cols, total, plen=cap)


def _dicts_equal(a, b) -> bool:
    import numpy as np
    if a is None or b is None:
        return a is b
    return a is b or np.array_equal(a, b)


def _cache_key(alias, keep, join_preds, where_conjuncts, sources,
               part_infos, chunk_spec, chunk_cap, stream_rows, outer_meta):
    from nds_tpu_torch.analysis.mem_audit import (forced_partitions,
                                                  stream_skew_factor)
    from nds_tpu_torch.engine.column import enc_key
    from nds_tpu_torch.sql.parser import expr_key
    return (
        tuple(expr_key(c) for c in join_preds),
        tuple(expr_key(c) for c in where_conjuncts),
        keep, tuple(sources), alias.lower(), chunk_cap,
        tuple((n, k, enc_key(en)) for (n, k, _dv, en) in chunk_spec),
        tuple(((tuple((cn, ck, hv, enc_key(en))
                      for (cn, ck, _dv, hv, en) in spec[0]),
                spec[1], spec[2]))
              for (spec, _flat) in part_infos),
        # deferred outer joins are part of the program's shape
        tuple((m[0], expr_key(m[1]), m[3]) if m else None
              for m in outer_meta),
        # accumulator-sizing settings: a pipeline built under another
        # ceiling/capacity/fanout/partitioning/ring depth must not be reused
        _acc_ceiling(), _hbm_bytes(), E.stream_fanout(),
        forced_partitions(), stream_skew_factor(), int(stream_rows),
        _PF.prefetch_depth(),
    )


def _spec_match(a, b) -> bool:
    """Structural equality of two flattened-part specs (names, kinds,
    validity presence, logical count, physical length, dictionary and
    encoding CONTENT)."""
    from nds_tpu_torch.engine.column import encs_equal
    (ac, an, ap), (bc, bn, bp) = a, b
    if an != bn or ap != bp or len(ac) != len(bc):
        return False
    for (n1, k1, d1, v1, e1), (n2, k2, d2, v2, e2) in zip(ac, bc):
        if n1 != n2 or k1 != k2 or v1 != v2 or not _dicts_equal(d1, d2) \
                or not encs_equal(e1, e2):
            return False
    return True


def _replan_residuals(planner, pipe):
    """Cache-hit path: re-plan every subquery residual for THIS execution
    and flatten the results as pipeline operands; None when a residual's
    shape no longer matches the cached program (the caller rebuilds)."""
    infos = []
    for (rkey, payload), want in zip(pipe.residuals, pipe.resid_specs):
        rt = E.resolve_table(planner._plan_residual(payload))
        planner._subquery_residuals[rkey] = (payload, rt)
        spec, flat = _flatten_part(rt)
        if not _spec_match(spec, want):
            return None
        infos.append((spec, flat))
    return infos


def _cache_hit(key, chunk_spec, part_infos):
    pipe = _PIPELINE_CACHE.get(key)
    if pipe is None:
        return None
    # identity-validate part buffers (the recorded dimension-side host
    # reads would be stale for others) and content-validate the chunk
    # dictionaries and encodings
    from nds_tpu_torch.engine.column import encs_equal
    flat_now = [x for (_spec, flat) in part_infos for x in flat]
    then = [r() for r in pipe.part_refs]
    stale = len(flat_now) != len(then) or \
        any(b is None or a is not b for a, b in zip(flat_now, then)) or \
        any(not _dicts_equal(dv_now, dv_then)
            or not encs_equal(en_now, en_then)
            for (_, _, dv_now, en_now), (_, _, dv_then, en_then)
            in zip(chunk_spec, pipe.chunk_spec))
    if stale:
        _evict(key)
        return None
    return pipe


def stream_execute(planner, parts, keep, join_preds, where_conjuncts,
                   sources):
    """Execute a join graph whose ``keep``-th part is a ``_StreamedScan``
    through the chunk pipeline. Returns ``(table, None)`` on success, or
    ``(None, reason)`` when the graph is not streamable or overflowed — the
    caller (``Planner._stream_join_parts``) then runs the eager chunk loop
    and records its event. ``(None, None)``: fall back silently."""
    if E.replay_mode() != "off":
        return None, None
    from nds_tpu_torch.sql.planner import _OuterBuild, _OuterProbe
    scan = parts[keep]
    chunked, alias = scan.chunked, scan.alias
    dev = E.device()
    syncs0 = E.sync_count()

    # resolve every non-streamed part's count up front (one batched
    # transfer): part counts are per-statement constants of the program
    E.resolve_counts()
    part_infos = []
    outer_meta = []
    for i, p in enumerate(parts):
        if i == keep:
            continue
        if isinstance(p, (_OuterProbe, _OuterBuild)):
            part_infos.append(_flatten_part(p.table))
            outer_meta.append(("probe" if isinstance(p, _OuterProbe)
                               else "build", p.condition,
                               tuple(p.conjuncts), p.src))
        else:
            part_infos.append(_flatten_part(p))
            outer_meta.append(None)
    # the chunk slot must never be the dimension side of a PK-gather plan:
    # that plan fetches the dim side's key ranges on host, which would bake
    # CHUNK data into the chunk-invariant program
    masked_sources = list(sources)
    masked_sources[keep] = None

    # the first sight's set-up, split by span: the wire plan (codec
    # planning and encoding, or the chunk store's load) and the first
    # chunk's upload; the record and the capture follow
    with _obs.span("stream.encode", table=alias):
        chunked._wire_plan()
    host_iter = chunked.host_chunks(pinned=dev.type == "cuda",
                                    buffers=_PF.prefetch_depth() + 2)
    with _obs.span("stream.upload", table=alias):
        hc = next(host_iter)
        first = upload_chunk(hc, dev)
        hc.release()
    chunk_spec = _chunk_signature(first, alias)
    chunk_cap = chunked.chunk_cap
    n_chunks = chunked.num_chunks()

    key = _cache_key(alias, keep, join_preds, where_conjuncts,
                     masked_sources, part_infos, chunk_spec, chunk_cap,
                     chunked.nrows, outer_meta)
    pipe = _cache_hit(key, chunk_spec, part_infos)
    resid_infos = ()
    if pipe is not None and pipe.residuals:
        resid_infos = _replan_residuals(planner, pipe)
        if resid_infos is None:
            _evict(key)
            pipe, resid_infos = None, ()
    parts_flat = tuple(tuple(flat) for (_spec, flat) in part_infos)
    _obs.annotate(pipelineCache="hit" if pipe is not None else "miss")
    _metrics.default().inc(_metrics.PIPE_HIT if pipe is not None
                           else _metrics.PIPE_MISS)

    if pipe is None:
        try:
            pipe, resid_infos = _build_pipeline(
                planner, parts, keep, alias, join_preds, where_conjuncts,
                masked_sources, part_infos, outer_meta, first, chunk_spec,
                chunk_cap, n_chunks)
        except _F.FaultInjected as exc:
            # the pipeline-compile seam's recovery: compiled -> eager
            _F.record_fault_event(exc.seam, "degrade",
                                  detail=f"compiled->eager: {exc}")
            return None, f"fault: {exc.seam} (degraded compiled->eager)"
        if pipe is None:
            return None, "not chunk-invariant"
        evicted = []
        with _PIPELINE_LOCK:
            while len(_PIPELINE_CACHE) >= _PIPELINE_MAX:
                evicted.append(_PIPELINE_CACHE.pop(next(iter(
                    _PIPELINE_CACHE))))
            _PIPELINE_CACHE[key] = pipe
        for old in evicted:
            old.release_static()
        if evicted:
            _metrics.default().inc(_metrics.PIPE_EVICT, len(evicted))

    resid_flat = tuple(tuple(flat) for (_spec, flat) in resid_infos)
    snapshot, checks_snapshot = _snapshot()
    try:
        out, ran, evidence = pipe.run(host_iter, first, parts_flat,
                                      resid_flat, graph=E.stream_graph())
    except (E.ReplayMismatch, E.StreamSyncError) as exc:
        # the replay diverged from the recording: unstreamable after all.
        # Anything else (an engine bug, a kernel refusing its launch)
        # raises: it must not hide behind the eager loop.
        _evict(key)
        log.info("streamed pipeline fell back to eager: %s", exc)
        return None, f"replay diverged [{type(exc).__name__}]: {exc}"
    except _F.StatementTimeout:
        # the watchdog marked the statement: an eager rerun would pay the
        # hang again (the event was recorded at the wait)
        raise
    except _F.FaultError as exc:
        # a classified fault in the drive (an exhausted transient retry):
        # the ladder's step to the eager loop, recorded as evidence
        _evict(key)
        _F.record_fault_event(exc.seam, "degrade",
                              detail=f"drive fault -> eager rerun: {exc}")
        log.info("streamed pipeline hit fault seam %s; re-running %s "
                 "eagerly", exc.seam, alias)
        return None, f"fault: {exc.seam} (degraded to eager)"
    finally:
        _restore_counts(snapshot, checks_snapshot)
    if out is None:
        # device-side overflow: rows were dropped, rerun eagerly. Keep the
        # pipeline — other statements over smaller data may fit.
        log.info("streamed pipeline overflowed its bound buckets; "
                 "re-running %s eagerly", alias)
        return None, "bound-bucket overflow"
    survivor_total = int(out.nrows)
    # deferred outer-build joins: emit the outer extras ONCE, from the
    # unmatched-key bitmaps (their counts rode the materializing read)
    extras = []
    nonkeep_parts = [p for i, p in enumerate(parts) if i != keep]
    for (slot, miss_mask, n_extras) in evidence.get("outer", ()):
        if not n_extras:
            continue
        from nds_tpu_torch.sql.planner import outer_extras_table
        idx = E.compact_indices(miss_mask, n_extras)
        extras.append(outer_extras_table(nonkeep_parts[slot].table, idx,
                                         n_extras, out))
    if extras:
        out = E.concat_tables([out] + extras)
    record_stream_event(alias, ran, E.sync_count() - syncs0, "compiled",
                        rows=survivor_total,
                        partitions=evidence.get("partitions", 1),
                        part_rows=evidence.get("part_rows", ()),
                        bytes_h2d=evidence["h2d"],
                        scan_launches=evidence["scan_launches"],
                        probe_launches=evidence["probe_launches"],
                        kernel_fused_stages=evidence["kernel_stages"],
                        prefetch_stall_ms=evidence["stall_ms"],
                        graph=evidence["graph"])
    _obs.annotate(path="compiled", chunks=ran, graph=evidence["graph"][:300],
                  prefetchStallMs=evidence["stall_ms"],
                  partitions=evidence.get("partitions", 1),
                  bytesH2d=evidence["h2d"],
                  scanLaunches=evidence["scan_launches"],
                  probeLaunches=evidence["probe_launches"],
                  kernelStages=evidence["kernel_stages"])
    return out, None


def _build_pipeline(planner, parts, keep, alias, join_preds,
                    where_conjuncts, masked_sources, part_infos,
                    outer_meta, first, chunk_spec, chunk_cap, n_chunks):
    """RECORD the per-chunk join graph on the first padded chunk; ``(None,
    None)`` when not streamable. Returns ``(pipe, resid_infos)`` — the
    flattened subquery residuals the record phase pre-planned, which are
    THIS execution's residual operands."""
    from nds_tpu_torch.engine.replay import _lift_log
    from nds_tpu_torch.sql.planner import _OuterBuild, _OuterProbe
    # the pipeline-compile seam: stream_execute degrades a fault here to
    # the eager loop
    _F.fault_point("pipeline-compile")
    snapshot, checks_snapshot = _snapshot()
    sub = list(parts)
    aliased = planner._alias_table(first, alias)
    n_first = torch.full((), E.count_int(first.nrows), dtype=I64,
                         device=E.device())
    sub[keep] = DeviceTable(aliased.columns,
                            E.DeviceCount(n_first, chunk_cap),
                            plen=chunk_cap)
    pi = 0
    for i in range(len(parts)):
        if i == keep:
            continue
        t = _rebuild_part(part_infos[pi][0], part_infos[pi][1])
        meta = outer_meta[pi]
        if meta is not None:
            mk, mcond, mconjs, msrc = meta
            t = (_OuterProbe if mk == "probe" else _OuterBuild)(
                t, mcond, list(mconjs), msrc)
        sub[i] = t
        pi += 1
    # the K4 scan pass: split the chunk-owned WHERE conjuncts the shared
    # eligibility rule (analysis/kernel_spec.py) accepts into a
    # chunk-invariant spec; the record and the replays then run WITHOUT
    # them and consume the kernel's survivor mask as a lazy compact.
    # Non-lowerable conjuncts stay in the graph per conjunct; outer-join
    # graphs keep all of them (their pre/post conjunct split must not be
    # disturbed).
    scan_spec = None
    where_kept = list(where_conjuncts)
    if not any(m is not None for m in outer_meta):
        from nds_tpu_torch.engine.exprs import lower_scan_spec
        cols_meta = []
        for pos, cname in enumerate(first.column_names):
            c = first[cname]
            cols_meta.append({
                "name": f"{alias.lower()}.{cname.split('.')[-1].lower()}",
                "kind": c.kind, "enc": c.enc,
                "dict_values": c.dict_values,
                "data_slot": 2 * pos,
                "valid_slot": 2 * pos + 1 if c.valid is not None else -1})
        all_cols = set()
        for p in sub:
            all_cols |= set(p.column_names)
        sub_cols = [set(p.column_names) for p in sub]

        def owned(c):
            # the planner's single-ownership test (_join_parts): only a
            # conjunct the planner would push down to the streamed slot
            # may leave the graph
            if planner._has_subquery(c):
                return False
            tabs = planner._expr_tables(c, all_cols)
            owners = set()
            for p_i, pc in enumerate(sub_cols):
                for t in tabs:
                    if any(cc.startswith(t + ".") for cc in pc):
                        owners.add(p_i)
            return owners == {keep}

        scan_spec, where_kept = lower_scan_spec(where_conjuncts, cols_meta,
                                                owned)
    # save/restore: a subquery residual planned DURING this record may
    # itself stream through a nested pipeline build on the same planner
    prev_touched = planner._residuals_touched
    planner._residuals_touched = touched = []
    # the non-streamed parts are chunk-invariant: a hazard read over any
    # other table refuses the record (ops.chunk_invariant)
    invariant = [getattr(t, "table", t) for i, t in enumerate(sub)
                 if i != keep]
    try:
        with _obs.span("stream.record", table=alias):
            with E.recording() as rec_log, E.chunk_invariant(invariant):
                with E.stream_bounds():
                    with E.outer_match_collector() as omc:
                        out0 = planner._join_parts(sub, list(join_preds),
                                                   list(where_kept),
                                                   list(masked_sources))
    except E.StreamSyncError as exc:
        log.info("streamed scan %s not chunk-invariant: %s", alias, exc)
        return None, None
    finally:
        planner._residuals_touched = prev_touched
        _restore_counts(snapshot, checks_snapshot)
    # subquery residuals the record phase planned (or reused): they become
    # operands of the per-chunk program
    resid_infos = [_flatten_part(rt) for (_k, _p, rt) in touched]
    residuals = [(k, p) for (k, p, _rt) in touched]
    # names-only catalog snapshot: the replayed planner's correlation
    # analysis must resolve subquery scopes exactly like the record did
    name_cat = {}
    if residuals:
        for scope in planner.cte_stack:
            for k, t in scope.items():
                name_cat[k.lower()] = tuple(t.column_names)
        for k, t in planner.catalog.items():
            name_cat.setdefault(k.lower(), tuple(t.column_names))
    build_slots = [i for i, m in enumerate(outer_meta)
                   if m is not None and m[0] == "build"]
    if len(omc.masks) != len(build_slots):
        log.info("streamed scan %s: outer-build mask count mismatch "
                 "(%d masks, %d builds)", alias, len(omc.masks),
                 len(build_slots))
        return None, None
    names = list(out0.column_names)
    template = (names,
                [out0[n].kind for n in names],
                [out0[n].dict_values for n in names],
                [out0[n].valid is not None for n in names],
                [out0[n].data.dtype for n in names],
                # survivors carry their narrow encodings into the
                # accumulator (decode only at materialize)
                [out0[n].enc for n in names])
    row_bytes = sum(out0[n].data.element_size()
                    + (1 if out0[n].valid is not None else 0)
                    for n in names)
    stream_rows = parts[keep].chunked.nrows
    proved, fan_k, part_keys = _proved_plan(parts, keep, join_preds,
                                            where_conjuncts, masked_sources,
                                            stream_rows)
    ring_bytes = _ring_bytes(sum(
        int(first[c].data.nbytes)
        + (0 if first[c].valid is None else int(first[c].valid.nbytes))
        for c in first.column_names))
    n_parts, part_bound = _partition_plan(stream_rows, fan_k, part_keys,
                                          proved, max(row_bytes, 1),
                                          n_chunks, out0.plen,
                                          ring_bytes=ring_bytes)
    key_slots = []
    if n_parts > 1:
        # map the partition keys (bare names) to the chunk's flattened
        # buffer slots (2 slots per column: data, valid)
        spec_names = [nm for (nm, _k, _dv, _en) in chunk_spec]
        for key in part_keys:
            hit = [i for i, nm in enumerate(spec_names)
                   if nm.split(".")[-1] == key]
            if not hit:
                n_parts, part_bound = 1, None    # key pruned off the scan
                break
            key_slots.append(2 * hit[0])
    if n_parts > 1:
        budget = _part_acc_budget(n_chunks, out0.plen, part_bound,
                                  max(row_bytes, 1), n_parts,
                                  ring_bytes=ring_bytes)
    else:
        budget = _acc_row_budget(n_chunks, out0.plen, proved,
                                 max(row_bytes, 1), ring_bytes=ring_bytes)
    acc_cap = E.bucket_len(max(budget, out0.plen))
    if scan_spec is not None and n_parts > 1 and key_slots:
        # the K4 pass also computes the partition routing hash over the
        # SAME buffers the plain hash fold would
        scan_spec = _K.ScanSpec(scan_spec.entries, scan_spec.cols,
                                tables=scan_spec.tables,
                                key_slots=tuple(key_slots),
                                n_conjuncts=scan_spec.n_conjuncts)
    _obs.annotate(accRows=acc_cap, partitions=n_parts,
                  provedRows=proved if proved is not None else "unproven",
                  residuals=len(residuals), outerBuilds=len(build_slots))
    lifted, operands = _lift_log(list(rec_log), E.device())
    pipe = StreamPipeline(
        chunk_spec, chunk_cap,
        tuple(spec for (spec, _flat) in part_infos), keep, lifted,
        tuple(operands), template, out0.plen, acc_cap,
        [weakref.ref(x) for (_spec, flat) in part_infos for x in flat],
        join_preds, where_kept, masked_sources,
        n_partitions=n_parts, key_slots=key_slots,
        outer_meta=outer_meta, residuals=residuals,
        resid_specs=tuple(spec for (spec, _flat) in resid_infos),
        build_slots=build_slots, name_catalog=name_cat,
        scan_spec=scan_spec)
    return pipe, resid_infos
