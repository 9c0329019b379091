# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The streamed chunk pipeline: a sync-budgeted executor for scans of tables
bigger than device memory, on one device or on shards.

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

Sharded execution (``stream_shards`` > 1, on a mesh of that many local
devices, or of shards sharing a device inside
``parallel.exchange.sharing_devices()``; parallel/exchange.py): every padded chunk's rows split contiguously over
the shards, the parts, replay operands and residuals go to every shard's
device, and each shard runs the same per-chunk program on its own slice
into its own accumulators (per shard and partition), sized by the budget
re-shared over the shards (``mem_audit.shard_row_bound``) and guarded by
their overflow flags. A partitioned graph (a fan-out join, whose keys an
arbitrary row split does not co-partition) adds a per-chunk hash-exchange
pass: each shard's K4 pass (or the plain hash fold) gives the routing
hash, whose partition bits pick the partition and whose next bits the
destination shard; the rows are bucketed by destination and cross in one
all-to-all, so each shard owns a key range. The one materializing read fetches every
(shard, partition) count, the flags, the histogram and the outer-build
bitmaps after one cross-shard reduce, so the 6-sync budget holds at any
shard count; one shard is exactly the unsharded pipeline. Shards that
share one device run as one captured graph like the unsharded program;
shards on distinct cards take the eager drive (``graph`` says why). A
pipeline built for one mesh never serves another (the cache key holds
it). The exchange's dispatch is the ``exchange`` fault seam: a fault
there degrades the statement to the single-device eager chunk loop.

Settings (``Session(conf=...)`` keys, ``ops.STREAM_DEFAULTS``):
``stream_exec``, ``stream_partitions``,
``stream_acc_rows``, ``stream_fanout``, ``stream_skew``,
``prefetch_depth``, ``hbm_bytes``, ``stream_shards``.

Faults (engine/faults.py): the chunk uploads are the ``device-put``
seam, retried in place; the record is the ``pipeline-compile`` seam; a
classified fault there or in the drive (an exhausted retry) takes one
step down the ladder, to the eager chunk loop, recorded as a fault event.
A statement timeout raises, and any other exception raises as before.

Parameterized plans (analysis/param_audit.py): a WHERE literal the shared
rule proves bindable keys the pipeline cache on its template skeleton, so
K parameter vectors of a template share one build and one capture. The
pipeline keeps the build statement's slot nodes; each execution passes its
own literal values, which are written before its chunk loop into two of
the program's static operands: the slot scalars the planner's Literal arm
reads (``exprs.bound_literal``), and the K4 spec's entry words where the
slot's conjunct lowered to the scan kernel (``kernels.bind_scan_words``;
the plain version reads the bound entries). The eager drive writes its own
copies. ``NDS_TPU_PARAM_BIND=0`` bakes every literal.

Chunk-derived host reads: the log serves ``date_part``, ``month_arith``,
``cast_str`` and ``concat`` reads like dimension reads, so a replay would
hand every chunk the first chunk's values. While the program records, such
a read of rows that derive from the chunk raises ``StreamSyncError``
(``ops.chunk_invariant``: only the non-streamed parts are exempt) and the
statement takes the eager chunk loop.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import weakref

import torch

from nds_tpu_torch.engine import exprs as _EX
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
from nds_tpu_torch.parallel import exchange as _X

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


def _shard_plan(chunk_cap: int):
    """``(n_shards, mesh)`` of the pipeline being built: > 1 only when the
    ``stream_shards`` setting asks for a count that divides the chunk
    capacity and this process can serve (enough local devices, or
    shards sharing them inside ``exchange.sharing_devices()``)."""
    from nds_tpu_torch.analysis.mem_audit import stream_shards
    n = stream_shards()
    if n <= 1 or chunk_cap % n:
        return 1, None
    mesh = _X.stream_mesh(n, E.device())
    return (1, None) if mesh is None else (n, mesh)


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
# first: their bytes (the operands and the graph pool's growth at each
# capture) stay within a quarter of the device-memory model, the newest
# kept regardless. Weak: a pipeline dropped from the cache takes its
# operands with it
_STATIC = weakref.WeakValueDictionary()
_STATIC_LOCK = threading.Lock()
_STATIC_SHARE = 4
# graph pool bytes that released graphs left free in their pool: the next
# capture may reuse any of them without the pool growing, so it is charged
# with all of them (the pool itself never shrinks)
_POOL_FREE = 0


def static_budget() -> int:
    """Bytes the cached pipelines' static operands and graph pools may
    hold together: a quarter of the device-memory model."""
    return max(_hbm_bytes() // _STATIC_SHARE, 1)


def static_report() -> dict:
    """The pipelines holding static operands now: their count, operand
    and graph-pool bytes, the free pool bytes released graphs left, and
    the budget (as the calling statement's device and settings give it:
    call it under ``ops.on_device``)."""
    with _STATIC_LOCK:
        held = [p._static for p in _STATIC.values()
                if p._static is not None]
        return {"pipelines": len(held),
                "static_bytes": sum(s.static_bytes for s in held),
                "pool_bytes": sum(s.pool_bytes for s in held),
                "free_pool_bytes": _POOL_FREE,
                "budget": static_budget()}


def _release(pipe) -> None:
    """Drop ``pipe``'s static operands and graph (under ``_STATIC_LOCK``):
    the graph's pool bytes stay in the pool, free for the next capture."""
    global _POOL_FREE
    st = pipe._static
    if st is not None and st.graph is not None:
        _POOL_FREE += st.pool_bytes
    _STATIC.pop(id(pipe), None)
    pipe._static = None


# a capture starts only with this share of the card free: it allocates from
# its graph pool alone, and a failed capture leaves the pool unusable
_CAPTURE_FREE_SHARE = 8


def _make_room(dev) -> None:
    """Before a capture: when less than an eighth of the card is free,
    hand the caching allocator's unused blocks back to the device. A
    capture cannot take them (it allocates from its own pool, and
    releasing memory while capturing is not allowed), so with the card
    full of cached blocks it would run out of memory (an SF10 stream run
    on an 80 GB card: 53 GiB allocated, 26 GiB cached)."""
    free, total = torch.cuda.mem_get_info(dev)
    if free * _CAPTURE_FREE_SHARE < total:
        torch.cuda.empty_cache()


def _enforce_budget(keep) -> None:
    """Release other pipelines' static operands and graphs, oldest first
    and only those no execution holds, while the total passes the budget
    (under ``_STATIC_LOCK``)."""
    budget = static_budget()
    for pid in list(_STATIC):
        if sum(p._static.nbytes for p in _STATIC.values()
               if p._static is not None) <= budget:
            break
        other = _STATIC.get(pid)
        if other is None or other is keep or other._static is None:
            continue
        if other._static.lock.acquire(blocking=False):
            _release(other)


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
    slots, one accumulator per shard and partition (shard-major), and per
    shard the partition histogram and the exchange's overflow flag; on
    cuda the captured graph, the upload stage its capture was served from,
    the kernel launches one replay makes and the bytes its capture grew
    the graph pool by; ``params``, the bound-literal scalars and K4 spec
    words each execution writes (:class:`_Params`, None when nothing is
    bound); ``parts``, the part buffers the program was first driven
    with, held so that a later execution whose parts are other buffers of
    the same content (a dimension filtered again, a streamed table bound
    whole again) runs the program on these (see :func:`_parts_differ`).
    ``lock`` is held while an execution drives them (a concurrent
    execution of the same pipeline takes the eager drive)."""

    __slots__ = ("slots", "n_dev", "resid", "accs", "hist", "exovf",
                 "params", "parts", "graph", "stage", "launches",
                 "static_bytes", "pool_bytes", "lock")

    def __init__(self, slots, n_dev, resid, accs, hist, exovf, params=None,
                 parts=()):
        self.slots, self.n_dev, self.resid = slots, n_dev, resid
        self.accs, self.hist, self.exovf = accs, hist, exovf
        self.params = params
        self.parts = tuple(tuple(p) for p in parts)
        self.graph = self.stage = None
        self.launches: dict = {}
        self.static_bytes = sum(int(t.nbytes) for t in (
            *(x for x in slots if x is not None), n_dev,
            *(x for r in resid for x in r), *hist, *exovf,
            *(b for a in accs for b in a.buffers()),
            *(() if params is None else params.buffers()),
            *(x for p in self.parts for x in p)))
        self.pool_bytes = 0
        self.lock = threading.Lock()

    @property
    def nbytes(self) -> int:
        return self.static_bytes + self.pool_bytes


class _Params:
    """One execution's bound literals on one device: ``vec`` holds every
    slot's value as an int64 word (a float slot its bits), ``bindings``
    maps each slot's Literal node to a 0-d view of its word (what the
    planner's Literal arm reads), ``words`` is the K4 spec packed on the
    device with this execution's entry words (None when no slot reaches
    K4), and ``scan`` the :class:`kernels.ScanBinding` of both."""

    __slots__ = ("vec", "bindings", "words", "scan")

    def __init__(self, pipe, dev):
        n = len(pipe.param_nodes)
        self.vec = torch.zeros(max(n, 1), dtype=I64, device=dev)
        self.bindings = {}
        for k, (node, tag) in enumerate(zip(pipe.param_nodes,
                                            pipe.param_tags)):
            view = self.vec[k:k + 1].view(torch.float64).reshape(()) \
                if tag == "f64" else self.vec[k]
            self.bindings[id(node)] = (tag, view)
        spec = pipe.scan_spec
        self.words = None
        if spec is not None and spec.binds:
            self.words = torch.as_tensor(_K.packed_scan_spec(spec)[0],
                                         device=dev).clone()
        self.scan = None

    def buffers(self):
        return [self.vec] + ([] if self.words is None else [self.words])

    def write(self, host) -> None:
        """Copy one execution's host values (:meth:`StreamPipeline.
        param_host`) into the device slots: pinned, non-blocking uploads
        and device copies, no host wait."""
        pvec, entries, ewords = host
        dev = self.vec.device
        if len(pvec):
            self.vec.copy_(E.upload(pvec, dev, I64))
        if self.words is not None:
            self.words[:len(ewords)].copy_(E.upload(ewords, dev, I64))
        self.scan = None if entries is None else \
            _K.ScanBinding(entries, self.words)


class StreamPipeline:
    """One recorded per-chunk program plus the metadata to drive it.

    ``n_partitions`` > 1 turns on grace-style partitioned accumulation:
    ``key_slots`` index the chunk's flattened buffers that the partition
    hash folds, the per-chunk program runs once per partition on the chunk
    masked to it, and ``run`` keeps one proof-sized accumulator per
    partition — all fetched in the single materializing read.

    ``n_shards`` > 1 runs the program on each shard of ``mesh`` (a
    contiguous slice of every chunk, or with ``exchange`` the rows routed
    to the shard, at most ``cap_ex`` from each source shard), into one
    accumulator per shard and partition.

    ``param_nodes`` / ``param_tags``: the build statement's bound Literal
    nodes and their type tags, in the cache key's slot order (kept alive
    so their ids stay valid); ``param_k4`` / ``param_graph`` count the
    slots that reach the K4 spec words and the graph scalars."""

    def __init__(self, chunk_spec, chunk_cap, part_specs, keep, log_entries,
                 operands, out_template, out_plen, acc_cap, part_refs,
                 join_preds, where_kept, sources, n_partitions=1,
                 key_slots=(),
                 outer_meta=(), residuals=(), resid_specs=(),
                 build_slots=(), name_catalog=None, scan_spec=None,
                 n_shards=1, mesh=None, exchange=False, cap_ex=0,
                 param_nodes=(), param_tags=(), param_k4=0, param_graph=0):
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
        # sharded execution: the shard count and mesh, the per-shard slice
        # of a chunk, and under the exchange the bucket capacity of each
        # (source shard, destination) pair; the program's physical chunk
        # length on a shard, and (sharded) the output capacity its first
        # run gave. The exchange's collectives a chunk are counted at the
        # program's first run from Python.
        self.n_shards, self.mesh = n_shards, mesh
        self.exchange, self.cap_ex = exchange, cap_ex
        self.shard_plen = chunk_cap // n_shards
        self.body_plen = chunk_cap if n_shards == 1 else \
            (n_shards * cap_ex if exchange else self.shard_plen)
        self.body_out_plen = out_plen if n_shards == 1 else None
        self.coll_chunk = None
        self.param_nodes = tuple(param_nodes)
        self.param_tags = tuple(param_tags)
        self.param_k4, self.param_graph = param_k4, param_graph
        # the compiled program's static operands (allocated at the first
        # compiled drive) and, once a capture failed, why
        self._static: _Static | None = None
        self.refused: str | None = None
        # the catalog tables the building statement had bound (weakrefs,
        # ``_bound_tables``): a hit on held parts needs the same ones
        self.tables = ()

    # ------------------------------------------------------------ program

    def _body(self, chunk_flat, n_dev, parts_flat, acc: _Acc, resid_flat,
              live=None, pids=None, part_id=None, operands=None,
              params=None):
        """The per-chunk program: the recorded join graph replayed on one
        chunk (a shard's rows of it), its survivors scattered into
        ``acc``. ``operands``: the replay operands on this shard's device
        (default the recorded ones); ``params``: this execution's bound
        literals there (:class:`_Params`). No host read."""
        from nds_tpu_torch.sql.planner import Planner, _OuterBuild, \
            _OuterProbe
        names, kinds, dicts, valided, dtypes, encs = self.out_template
        cols, i = {}, 0
        for (aname, kind, dv, cenc) in self.chunk_spec:
            cols[aname] = Column(kind, chunk_flat[i], chunk_flat[i + 1],
                                 dv, cenc)
            i += 2
        chunk = DeviceTable(cols, E.DeviceCount(n_dev, self.body_plen),
                            plen=self.body_plen)
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
        with _EX.param_binding({} if params is None else params.bindings), \
                E.replaying(self.log, self.operands if operands is None
                            else operands):
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
        if self.body_out_plen is None:
            # a shard's program runs on a shorter chunk than the
            # recording: its first run fixes the output capacity
            self.body_out_plen = out.plen
        elif out.plen != self.body_out_plen:
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

    def _scan(self, flat, n_dev, params=None):
        """The K4 pass of one chunk: (survivor mask, routing hash), over
        this execution's bound spec when ``params`` carries one."""
        return _K.chunk_scan(flat, n_dev, self.scan_spec,
                             None if params is None else params.scan)

    def _route(self, h, flat, n_dev, hist):
        """Partition ids of one chunk from its routing hash (folded here
        when no K4 pass computed it) and the input histogram updated with
        the chunk's live rows."""
        P = self.n_partitions
        if h is None:
            h = _K.fold_hash([flat[s] for s in self.key_slots])
        pids = (h & (P - 1)).to(I64)
        live = torch.arange(pids.shape[0], device=pids.device) < n_dev
        ids = torch.where(live, pids, torch.full((), P, dtype=I64,
                                                  device=pids.device))
        hist += prim.segment_sum(torch.ones_like(ids), ids, P)
        return pids

    # ------------------------------------------------------------- shards

    def _shard_views(self, flat, n_dev):
        """Each shard's contiguous slice of a chunk that lies whole on one
        device: ``(buffers, live count)``, the buffers views, the count
        derived on the device from the chunk's."""
        sp = self.shard_plen
        return [(tuple(None if b is None else b[s * sp:(s + 1) * sp]
                       for b in flat), (n_dev - s * sp).clamp(0, sp))
                for s in range(self.n_shards)]

    def _replicas(self, parts_flat, resid_flat):
        """The parts, residuals and replay operands on every shard's
        device: ``(parts, resid, operands)``, one entry a shard."""
        def on(dev, xs):
            return tuple(x.to(dev, non_blocking=True) if torch.is_tensor(x)
                         else x for x in xs)
        out = ([], [], [])
        for dev in self.mesh.devices:
            out[0].append(tuple(on(dev, p) for p in parts_flat))
            out[1].append(tuple(on(dev, r) for r in resid_flat))
            out[2].append(on(dev, self.operands))
        return out

    def _send_buffers(self, flat, n_s, hist, exovf, params=None):
        """One shard's half of the exchange. Its K4 pass (or the plain
        hash fold) gives the survivor mask and the routing hash; the
        partition bits of every live row count into the shard's
        histogram, the next ``log2(shards)`` bits pick the destination
        shard, and the survivors are bucketed by destination, at most
        ``cap_ex`` a bucket (a fuller bucket sets the shard's overflow
        flag; the rows it drops make the statement rerun eagerly). A
        failed row routes past the last shard and never crosses. Returns
        the send buffers (one per chunk buffer, then the partition ids)
        and their validity."""
        S, P, cap = self.n_shards, self.n_partitions, self.cap_ex
        dev = n_s.device
        alive = torch.arange(self.shard_plen, device=dev) < n_s
        if self.scan_spec is not None:
            mask, h = self._scan(flat, n_s, params)
        else:
            mask = alive
            h = _K.fold_hash([flat[k] for k in self.key_slots])
        h = h.to(I64) & 0xFFFFFFFF
        pids = h & (P - 1)
        past = torch.full((), P, dtype=I64, device=dev)
        hist += prim.segment_sum(torch.ones_like(pids),
                                 torch.where(alive, pids, past), P)
        dest = torch.where(mask, (h >> (P.bit_length() - 1)) & (S - 1),
                           torch.full((), S, dtype=I64, device=dev))
        order, sd, pos = _X.bucket_positions(dest)
        fits = (pos < cap) & (sd < S)
        counts = prim.segment_sum((sd < S).to(I64), sd, S)
        exovf |= (counts > cap).any()
        slot = _X.grid_slots(sd, pos, S, cap)
        bufs = {}
        # the partition ids cross as int32, as the reference sends them
        for i, b in enumerate((*flat, pids.to(torch.int32))):
            if b is None:
                continue
            v = b[order]
            bufs[i] = _X.scatter_grid(
                slot, torch.where(fits, v, torch.zeros((), dtype=v.dtype,
                                                       device=dev)), S, cap)
        return bufs, _X.scatter_grid(slot, fits, S, cap)

    def _sharded_chunk(self, shards, parts_rep, resid_rep, ops_rep, prm_rep,
                       accs, hist, exovf):
        """One chunk's program over the shards (``shards``: each shard's
        buffers and live count, on its device): the K4 pass and the
        routing per shard, or the exchange, then the body of every
        partition on every shard into that shard's accumulators. The
        collectives of its first run from Python are the count a chunk."""
        if self.coll_chunk is None:
            with _X.collective_trace() as ct:
                self._sharded_chunk_run(shards, parts_rep, resid_rep,
                                        ops_rep, prm_rep, accs, hist, exovf)
            self.coll_chunk = dict(ct.counts)
            return
        self._sharded_chunk_run(shards, parts_rep, resid_rep, ops_rep,
                                prm_rep, accs, hist, exovf)

    def _sharded_chunk_run(self, shards, parts_rep, resid_rep, ops_rep,
                           prm_rep, accs, hist, exovf):
        S, P = self.n_shards, self.n_partitions
        devs = self.mesh.devices
        items = []
        if self.exchange:
            bufs, valid = [], []
            for s, (flat, n_s) in enumerate(shards):
                with E.device_scope(devs[s]):
                    b, v = self._send_buffers(flat, n_s, hist[s], exovf[s],
                                              prm_rep[s])
                bufs.append(b)
                valid.append(v)
            got, vgot = _X.all_to_all_exchange(bufs, valid, self.mesh)
            nflat = len(shards[0][0])
            for d in range(S):
                flat = tuple(got[d][i].reshape(-1) if i in got[d] else None
                             for i in range(nflat))
                # every received slot is in range: validity is the mask
                n_d = torch.full((), self.body_plen, dtype=I64,
                                 device=devs[d])
                items.append((flat, n_d, vgot[d].reshape(-1),
                              got[d][nflat].reshape(-1)))
        else:
            for s, (flat, n_s) in enumerate(shards):
                live = h = pids = None
                with E.device_scope(devs[s]):
                    if self.scan_spec is not None:
                        live, h = self._scan(flat, n_s, prm_rep[s])
                    if P > 1:
                        pids = self._route(h, flat, n_s, hist[s])
                items.append((flat, n_s, live, pids))
        for s, (flat, n_s, live, pids) in enumerate(items):
            with E.device_scope(devs[s]):
                for p in range(P):
                    self._body(flat, n_s, parts_rep[s], accs[s * P + p],
                               resid_rep[s], live, pids,
                               p if P > 1 else None, operands=ops_rep[s],
                               params=prm_rep[s])

    def _finish_sharded(self, accs, hist, exovf, n_chunks, stale=None):
        """THE one cross-shard reduce and the one materializing read of a
        sharded drive: an all-gather of every (shard, partition) count, a
        psum of the overflow flags, of the histogram and of each
        outer-build bitmap (a build row matched by any shard of any
        partition is matched). Returns ``(counts[s][p], overflowed,
        hist, outer extras, collectives, ici bytes, parts differ)``;
        ``stale`` is the parts comparison's device flag of a
        content-checked hit (it rides the read)."""
        S, P = self.n_shards, self.n_partitions
        mesh = self.mesh
        with _X.collective_trace() as ct:
            ns = [torch.stack([accs[s * P + p].n for p in range(P)])
                  for s in range(S)]
            flags = [(torch.stack([accs[s * P + p].ovf for p in range(P)])
                      | exovf[s]).to(torch.int32) for s in range(S)]
            counts = _X.all_gather_counted(ns, mesh)[0]
            ovf = _X.psum_counted(flags, mesh)[0]
            hist_tot = _X.psum_counted(hist, mesh)[0]
            miss = []
            for j, slot in enumerate(self.build_slots):
                bms = []
                for s in range(S):
                    bm = accs[s * P].outer[j]
                    for p in range(1, P):
                        bm = bm | accs[s * P + p].outer[j]
                    bms.append(bm.to(torch.int32))
                matched = _X.psum_counted(bms, mesh)[0] > 0
                _spec, n_live, plen = self.part_specs[slot]
                m = ~matched & (torch.arange(plen, device=matched.device)
                                < n_live)
                miss.append((m, m.sum().reshape(1)))

        def fetch():
            return torch.cat([counts, ovf.to(I64), hist_tot]
                             + [n for (_m, n) in miss]
                             + ([] if stale is None else
                                [stale.to(counts.device, I64).reshape(1)])
                             ).cpu().tolist()

        with _obs.span("stream.materialize", chunks=n_chunks,
                       partitions=P, shards=S):
            got = E.timed_read("stream_final", fetch)
        per = [[int(got[s * P + p]) for p in range(P)] for s in range(S)]
        k = S * P
        coll = self.coll_chunk
        e = k + 2 * P + len(miss)
        return (per, any(got[k:k + P]), [int(x) for x in got[k + P:k + 2 * P]],
                [(slot, m, int(n)) for slot, (m, _d), n
                 in zip(self.build_slots, miss, got[k + 2 * P:e])],
                _X.collective_ops(coll) * n_chunks
                + _X.collective_ops(ct.counts),
                (coll["bytes"] if coll else 0) * n_chunks
                + ct.counts["bytes"], bool(sum(got[e:])))

    def _slice_acc_sharded(self, accs, counts) -> DeviceTable:
        """The survivors of one partition's shard accumulators, shard by
        shard, as one DeviceTable on the first shard's device (copied out;
        pad rows zero, as in an unsharded accumulator)."""
        names, kinds, dicts, valided, dtypes, encs = self.out_template
        total = sum(counts)
        cap = E.bucket_len(total)
        dev = self.mesh.devices[0]

        def cat(bufs, dtype):
            return torch.cat([b[:c].to(dev, non_blocking=True)
                              for b, c in zip(bufs, counts)]
                             + [torch.zeros(cap - total, dtype=dtype,
                                            device=dev)])
        cols = {}
        for j, n in enumerate(names):
            cols[n] = Column(
                kinds[j], cat([a.datas[j] for a in accs], dtypes[j]),
                cat([a.valids[j] for a in accs], torch.bool)
                if valided[j] else None, dicts[j], encs[j])
        return DeviceTable(cols, total, plen=cap)

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

    def _distinct(self) -> bool:
        """Sharded over more than one device."""
        return self.n_shards > 1 and not self.mesh.one_device()

    def _prepare_first_shards(self, chunk: DeviceTable):
        """The first chunk (whole on the session's device) split for a
        mesh of distinct devices: each shard's slice copied to its own
        device. Returns ``(shards, bytes)``."""
        _F.fault_point("device-put")
        flat = _flatten_chunk(chunk)
        n_dev = torch.full((), int(chunk.nrows), dtype=I64,
                           device=flat[0].device)
        shards = [(tuple(None if b is None else
                         b.to(dev, non_blocking=True) for b in views),
                   n_s.to(dev, non_blocking=True))
                  for (views, n_s), dev in zip(
                      self._shard_views(flat, n_dev), self.mesh.devices)]
        return shards, sum(int(x.nbytes) for x in flat)

    def _preparer_shards(self):
        """The prefetch worker's step on a mesh of distinct devices: each
        shard's row slice of the host chunk goes to its own shard's device
        (from pinned buffers, non-blocking, on that device's side stream),
        with the shard's live count stamped there. No host read, no span;
        the worker has no device of its own (the devices are captured
        here, on the driver)."""
        devs, sp = self.mesh.devices, self.shard_plen
        sides = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
                 for d in devs]

        def prepare(hc):
            _F.fault_point("device-put")
            ups = []
            for s, dev in enumerate(devs):
                def copy(lo=s * sp, dev=dev):
                    flat = tuple(None if b is None else torch.as_tensor(
                        b)[lo:lo + sp].to(dev, non_blocking=True)
                        for (_n, _k, data, valid, _dv, _e) in hc.cols
                        for b in (data, valid))
                    n_s = torch.full((), min(max(hc.live - lo, 0), sp),
                                     dtype=I64, device=dev)
                    return (flat, n_s), [x for x in (*flat, n_s)
                                         if x is not None]
                ups.append(_PF.upload_async(dev, sides[s], copy))
            up = _PF.Upload.joined(ups, ([_PF.value_of(u) for u in ups],
                                         hc.nbytes))
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
        the graph captures); sharded, each shard's slice of the slots
        through :meth:`_sharded_chunk`."""
        S, P = self.n_shards, self.n_partitions
        if S > 1:
            self._sharded_chunk(self._shard_views(st.slots, st.n_dev),
                                [parts_flat] * S, [st.resid] * S,
                                [self.operands] * S, [st.params] * S,
                                st.accs, st.hist, st.exovf)
            return
        live = h = pids = None
        if self.scan_spec is not None:
            live, h = self._scan(st.slots, st.n_dev, st.params)
        if P > 1:
            pids = self._route(h, st.slots, st.n_dev, st.hist[0])
        for p in range(P):
            self._body(st.slots, st.n_dev, parts_flat, st.accs[p],
                       st.resid, live, pids, p if P > 1 else None,
                       params=st.params)

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
        program is captured as one CUDA graph; what the capture grew the
        device's reserved memory by is the graph's pool bytes. Raises
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
        _make_room(dev)
        # what the capture grows the reserved memory by is its pool's
        # growth: nothing else allocates on this device meanwhile
        reserved = torch.cuda.memory_reserved(dev)
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
        self._charge_pool(st, max(torch.cuda.memory_reserved(dev)
                                  - reserved, 0))

    def _charge_pool(self, st: _Static, grown: int) -> None:
        """Charge a capture to the budget: the bytes the pool grew by and
        every free pool byte released graphs left (the capture may have
        reused any of them); then release other pipelines while the total
        passes the budget."""
        global _POOL_FREE
        with _STATIC_LOCK:
            st.pool_bytes = grown + _POOL_FREE
            _POOL_FREE = 0
            _enforce_budget(self)

    def _claim(self, first: DeviceTable, resid_flat,
               parts_flat=()) -> _Static | None:
        """This pipeline's static operands, allocated at the first call
        and locked for one execution; None while another execution holds
        them. Other pipelines' operands and graphs go, oldest first, while
        the total passes a quarter of the device-memory model."""
        S, P = self.n_shards, self.n_partitions
        with _STATIC_LOCK:
            st = self._static
            if st is None:
                flat = _flatten_chunk(first)
                dev = flat[0].device
                st = self._static = _Static(
                    [torch.empty_like(x) for x in flat],
                    torch.zeros((), dtype=I64, device=dev),
                    [[torch.empty_like(x) for x in r] for r in resid_flat],
                    [self.init_acc(dev) for _ in range(S * P)],
                    [torch.zeros(P, dtype=I64, device=dev)
                     for _ in range(S)],
                    [torch.zeros((), dtype=torch.bool, device=dev)
                     for _ in range(S)],
                    _Params(self, dev) if self.param_nodes else None,
                    parts_flat)
            _STATIC.pop(id(self), None)
            _STATIC[id(self)] = self
            _enforce_budget(self)
        return st if st.lock.acquire(blocking=False) else None

    def release_static(self) -> None:
        """Drop the static operands and the graph (pipeline eviction)."""
        with _STATIC_LOCK:
            _release(self)

    def _ring(self, host_iter, dev):
        prepare = self._preparer_shards() if self._distinct() \
            else self._preparer(dev)
        return _PF.chunk_ring(host_iter, prepare=prepare)

    def _drive_static(self, st: _Static, host_iter, first, parts_flat,
                      resid_flat):
        """The compiled drive: the first chunk captures the graph where
        none is (its warm-up executes that chunk), every other chunk
        replays it (the caller has written this execution's bound
        literals into ``st.params``). Returns ``(accs, hist, exovf,
        chunks, h2d, stall_ms, captured)``."""
        dev = st.n_dev.device
        for a in st.accs:                # reset by kernels
            for b in a.buffers():
                b.zero_()
        for t in (*st.hist, *st.exovf):
            t.zero_()
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
                if self.exchange:
                    # the exchange's dispatch seam: a fault degrades the
                    # statement to the single-device eager chunk loop
                    _F.fault_point("exchange")
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
        return (st.accs, st.hist, st.exovf, n_chunks, h2d, stall_ms,
                capture)

    def _drive_eager(self, host_iter, first, parts_flat, resid_flat,
                     phost=None):
        """The eager drive: the program run from Python on each chunk as
        the ring hands it over, into fresh accumulators (sharded: one per
        shard and partition, each on its shard's device), with this
        execution's own bound literals (``phost``) on every device."""
        dev = first[next(iter(first.columns))].data.device
        S, P = self.n_shards, self.n_partitions
        devs = self.mesh.devices if S > 1 else (dev,)
        prms = {}
        if self.param_nodes:
            for d in devs:
                if d not in prms:
                    with E.device_scope(d):
                        prms[d] = _Params(self, d)
                        prms[d].write(phost)
        prm_rep = [prms.get(d) for d in devs]
        accs = [self.init_acc(d) for d in devs for _ in range(P)]
        hist = [torch.zeros(P, dtype=I64, device=d) for d in devs]
        exovf = [torch.zeros((), dtype=torch.bool, device=d) for d in devs]
        distinct = self._distinct()
        if S > 1:
            reps = self._replicas(parts_flat, resid_flat) if distinct \
                else ([parts_flat] * S, [resid_flat] * S,
                      [self.operands] * S)
            reps = (*reps, prm_rep)
        ring = self._ring(host_iter, dev)
        n_chunks = 0
        h2d = 0
        try:
            # the first chunk is already on the device (the record used
            # it); it takes the seam's retry on the driver
            cur = _F.with_retry(
                "device-put", lambda: self._prepare_first_shards(first)
                if distinct else self._prepare_first(first))
            while cur is not None:
                if S > 1:
                    if distinct:
                        shards, nb = cur
                    else:
                        flat, n_dev, nb = cur
                        shards = self._shard_views(flat, n_dev)
                    h2d += nb
                    if self.exchange:
                        _F.fault_point("exchange")
                    with _obs.span("stream.drive", chunk=n_chunks,
                                   shards=S):
                        self._sharded_chunk(shards, *reps, accs, hist,
                                            exovf)
                else:
                    flat, n_dev, nb = cur
                    h2d += nb
                    self._eager_chunk(flat, n_dev, parts_flat, resid_flat,
                                      accs, hist[0], n_chunks, prm_rep[0])
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
        return accs, hist, exovf, n_chunks, h2d, stall_ms

    def _eager_chunk(self, flat, n_dev, parts_flat, resid_flat, accs, hist,
                     n_chunks, params=None):
        """One chunk of the unsharded eager drive, span by span."""
        P = self.n_partitions
        live = h = pids = None
        if self.scan_spec is not None:
            with _obs.span("stream.kernel", chunk=n_chunks):
                live, h = self._scan(flat, n_dev, params)
        if P > 1:
            with _obs.span("stream.partition", chunk=n_chunks,
                           partitions=P):
                pids = self._route(h, flat, n_dev, hist)
        for p in range(P):
            with _obs.span("stream.drive", chunk=n_chunks, part=p):
                self._body(flat, n_dev, parts_flat, accs[p], resid_flat,
                           live, pids, p if P > 1 else None, params=params)

    def param_host(self, values):
        """One execution's bound literals on the host: ``(slot words,
        bound K4 entries or None, their entry-region words)`` from the
        literal ``values`` of its own statement (slot order). Packing
        reads nothing from the device."""
        from nds_tpu_torch.analysis.param_audit import slot_param_value
        words = []
        for v, tag in zip(values, self.param_tags):
            pv = slot_param_value(v, tag)
            words.append(_K._f64_bits(pv) if tag == "f64"
                         else _K._clamp_i64(pv))
        spec = self.scan_spec
        entries = ewords = None
        if spec is not None and spec.binds:
            entries = _K.bind_scan_entries(spec, values)
            ewords = _K.bind_scan_words(spec, entries)
        return words, entries, ewords

    def run(self, host_iter, first, parts_flat, resid_flat=(),
            graph=True, values=(), check_parts=False):
        """Drive every chunk through the per-chunk program; returns
        ``(survivor DeviceTable | None on overflow, n_chunks, evidence)``.
        ``host_iter`` continues AFTER ``first`` (already on the device).
        ``graph`` takes the compiled drive (on cuda, the captured graph)
        unless a capture was refused; False takes the eager drive, and so
        do shards on distinct devices. ``evidence`` carries the partition
        counts of a partitioned run, the shard counts, collectives and
        their bytes of a sharded one, the outer-extras masks/counts,
        upload bytes, prefetch stall, kernel launches and how the graph
        served (``graph``). ``values``: this execution's literal values of
        the bound slots (never kept: each call writes its own).
        ``check_parts``: ``parts_flat`` are not the buffers the pipeline was
        built on, only of their specs; the program runs on the held ones
        (``_Static.parts``) and the two are compared on the device, the
        verdict riding the one materializing read: when they differ the
        result is dropped and ``evidence["stale_parts"]`` set (also when
        nothing is held to compare with)."""
        S, P = self.n_shards, self.n_partitions
        stale = None
        if check_parts:
            with _STATIC_LOCK:
                held = None if self._static is None else self._static.parts
            if not held:
                return None, 0, {"stale_parts": True}
            stale = _parts_differ(parts_flat, held)
            parts_flat = held
        launches0 = dict(_K.LAUNCHES)
        phost, param_ms = None, -1.0
        if self.param_nodes:
            t0 = time.perf_counter()
            phost = self.param_host(values)
            param_ms = (time.perf_counter() - t0) * 1e3
        dev = first[next(iter(first.columns))].data.device
        st = None
        if not graph:
            status = "eager drive"
        elif self._distinct():
            status = (f"eager drive: {S} shards on "
                      f"{len(set(self.mesh.devices))} devices")
        elif self.refused is not None:
            status = f"refused: {self.refused}"
        else:
            st = self._claim(first, resid_flat, parts_flat)
            status = "busy: eager drive" if st is None else None
        try:
            if st is not None and st.params is not None:
                t0 = time.perf_counter()
                st.params.write(phost)
                param_ms += (time.perf_counter() - t0) * 1e3
            if st is not None:
                try:
                    accs, hist, exovf, n_chunks, h2d, stall_ms, captured = \
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
                accs, hist, exovf, n_chunks, h2d, stall_ms = \
                    self._drive_eager(host_iter, first, parts_flat,
                                      resid_flat, phost)
            evidence = {
                "h2d": h2d, "stall_ms": stall_ms, "graph": status,
                "param_ms": param_ms,
                "scan_launches": _K.LAUNCHES["chunk_scan"]
                - launches0["chunk_scan"],
                "probe_launches": _K.LAUNCHES["join_probe"]
                - launches0["join_probe"],
                "kernel_stages": self.scan_spec.stages()
                if self.scan_spec is not None else 0}
            if S > 1:
                per, overflowed, hist_host, outer, coll, ici, differ = \
                    self._finish_sharded(accs, hist, exovf, n_chunks, stale)
                if differ:
                    evidence["stale_parts"] = True
                    return None, n_chunks, evidence
                evidence.update(
                    outer=outer, shards=S, collectives=coll, bytes_ici=ici,
                    shard_rows=tuple(sum(c) for c in per),
                    # the cards the shards span: shards sharing one card
                    # move their collective bytes through its memory
                    shard_cards=len(set(self.mesh.devices))
                    * self.mesh.world)
                if P > 1:
                    evidence.update(
                        partitions=P, part_input=tuple(hist_host),
                        part_rows=tuple(sum(c[p] for c in per)
                                        for p in range(P)))
                if overflowed:
                    return None, n_chunks, evidence
                tables = [self._slice_acc_sharded(
                    [accs[s * P + p] for s in range(S)],
                    [per[s][p] for s in range(S)])
                    for p in range(P) if sum(c[p] for c in per) > 0]
                if not tables:               # every partition empty
                    out = self._slice_acc_sharded(
                        [accs[s * P] for s in range(S)], [0] * S)
                else:
                    # counts are host-known here: the union costs no sync
                    out = tables[0] if len(tables) == 1 \
                        else E.concat_tables(tables)
                return out, n_chunks, evidence
            bitmaps = list(accs[0].outer)
            for a in accs[1:]:
                bitmaps = [b | o for b, o in zip(bitmaps, a.outer)]
            miss = self._outer_miss(bitmaps)

            def fetch():
                got = torch.stack(
                    [a.n for a in accs] + [a.ovf.to(I64) for a in accs]
                    + list(hist[0]) + [n for (_m, n) in miss]
                    + ([] if stale is None else [stale.to(I64)])
                ).cpu().tolist()
                k = 3 * P + len(miss)
                return ([int(x) for x in got[:P]],
                        [bool(x) for x in got[P:2 * P]],
                        [int(x) for x in got[2 * P:3 * P]],
                        [int(x) for x in got[3 * P:k]], bool(sum(got[k:])))

            # THE one materializing read of the pipeline
            with _obs.span("stream.materialize", chunks=n_chunks,
                           partitions=P):
                totals, overflowed, hist_host, extras_n, differ = \
                    E.timed_read("stream_final", fetch)
            if differ:
                evidence["stale_parts"] = True
                return None, n_chunks, evidence
            evidence["outer"] = [(slot, m, n) for (slot, (m, _nd), n)
                                 in zip(self.build_slots, miss, extras_n)]
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


def _param_bind_active() -> bool:
    """Parameter binding is on unless ``NDS_TPU_PARAM_BIND=0``. Unlike the
    reference, whose Pallas scan specs bake their thresholds on the host,
    the port binds under its K4 pass too: a bound value is written into
    the spec's entry words before each execution."""
    return os.environ.get("NDS_TPU_PARAM_BIND", "1") != "0"


def _param_slots(planner, parts, keep, where_conjuncts, chunk_spec):
    """The audited-bindable slots of this statement's WHERE conjuncts:
    ``((conjunct index, field path, typetag, Literal node), ...)`` in walk
    order. Ownership is ``_build_pipeline``'s ``owned()`` test (the
    planner's ``_expr_tables`` owners == {keep}); the rule itself is
    ``analysis/param_audit.conjunct_bind_slots``, the one the static
    auditor proves corpus-wide."""
    from nds_tpu_torch.analysis.param_audit import (conjunct_bind_slots,
                                                    drift_active)
    names_keep = {nm for (nm, _k, _dv, _en) in chunk_spec}
    sub_cols = [names_keep if i == keep else set(p.column_names)
                for i, p in enumerate(parts)]
    all_cols = set().union(*sub_cols)
    drift = drift_active()
    slots = []
    for ci, c in enumerate(where_conjuncts):
        has_sub = planner._has_subquery(c)
        owned = False
        if not has_sub:
            tabs = planner._expr_tables(c, all_cols)
            owners = set()
            for p_i, pc in enumerate(sub_cols):
                for t in tabs:
                    if any(cc.startswith(t + ".") for cc in pc):
                        owners.add(p_i)
            owned = owners == {keep}
        for (path, node, tag) in conjunct_bind_slots(
                c, owned, has_sub, drift=drift):
            slots.append((ci, path, tag, node))
    return tuple(slots)


def _cache_key(alias, keep, join_preds, where_conjuncts, sources,
               part_infos, chunk_spec, chunk_cap, stream_rows, outer_meta,
               bind_slots=()):
    from nds_tpu_torch.analysis.mem_audit import (forced_partitions,
                                                  stream_shards,
                                                  stream_skew_factor)
    from nds_tpu_torch.analysis.param_audit import skeleton_conjunct_key
    from nds_tpu_torch.engine.column import enc_key
    from nds_tpu_torch.sql.parser import expr_key
    # a bound conjunct keys on its template skeleton (slot values become
    # typed placeholders): K parameter vectors of a template share one
    # entry. The slot signature rides alongside, so two statements share
    # an entry only when their slots line up (count, position, type).
    by_conj = {}
    for (ci, path, tag, node) in bind_slots:
        by_conj.setdefault(ci, []).append((path, node, tag))
    return (
        tuple(expr_key(c) for c in join_preds),
        tuple(skeleton_conjunct_key(c, by_conj[i]) if i in by_conj
              else expr_key(c) for i, c in enumerate(where_conjuncts)),
        tuple((ci, path, tag) for (ci, path, tag, _n) in bind_slots),
        # bind and drift modes are read at key time: a pipeline built
        # under one never serves the other
        os.environ.get("NDS_TPU_PARAM_BIND", "1"),
        os.environ.get("NDS_TPU_PARAM_DRIFT"),
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
        # sharded execution: a pipeline built for one mesh never serves
        # another
        stream_shards(), _mesh_key(chunk_cap),
    )


def _mesh_key(chunk_cap: int):
    """The mesh a pipeline built now would run over, as a cache-key
    member (None: unsharded)."""
    _n, mesh = _shard_plan(chunk_cap)
    return None if mesh is None else mesh.key()


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


def _parts_differ(now, held):
    """0-d device flag: does any buffer of ``now`` (this execution's parts,
    flattened) differ from its counterpart in ``held`` (the parts the
    pipeline was driven with; equal specs)? Floats compare as bits. No
    host read: the flag rides the pipeline's materializing read."""
    flag = None
    for a_part, b_part in zip(now, held):
        for a, b in zip(a_part, b_part):
            if a is b:
                continue
            if a.dtype == torch.float64:
                a, b = a.view(I64), b.view(I64)
            elif a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            d = (a != b).any()
            flag = d if flag is None else flag | d
    if flag is None:
        dev = next((x.device for p in held for x in p), E.device())
        flag = torch.zeros((), dtype=torch.bool, device=dev)
    return flag


def _bound_tables(planner):
    """The catalog tables the statement has bound so far, as ``(name,
    weakref)`` pairs: the data its parts were derived from."""
    return tuple((n, weakref.ref(planner.catalog[n]))
                 for n in sorted(planner.scanned))


def _cache_hit(key, chunk_spec, part_infos, planner):
    """``(pipeline, check_parts)`` of a key, or ``(None, False)``. A hit
    needs the chunk dictionaries and encodings equal in content (a
    re-registered streamed table re-encodes) and the part buffers the
    pipeline was built on (the recorded dimension-side host reads hold
    for their content alone): the same buffers, or, when the pipeline
    still holds its first drive's parts (``_Static.parts``) and the
    statement bound the very catalog tables the pipeline was built over
    (not another session's, nor tables re-registered since, as a Data
    Maintenance commit does), buffers of the same specs, whose content
    ``run`` then holds against them on the device (``check_parts``).
    Anything else evicts the entry."""
    pipe = _PIPELINE_CACHE.get(key)
    if pipe is None:
        return None, False
    from nds_tpu_torch.engine.column import encs_equal
    chunk_same = all(
        _dicts_equal(dv_now, dv_then) and encs_equal(en_now, en_then)
        for (_, _, dv_now, en_now), (_, _, dv_then, en_then)
        in zip(chunk_spec, pipe.chunk_spec))
    flat_now = [x for (_spec, flat) in part_infos for x in flat]
    then = [r() for r in pipe.part_refs]
    if chunk_same and len(flat_now) == len(then) and \
            all(b is not None and a is b for a, b in zip(flat_now, then)):
        return pipe, False
    st = pipe._static
    tables = _bound_tables(planner)
    same_tables = len(tables) == len(pipe.tables) and all(
        n1 == n2 and r1() is not None and r1() is r2()
        for (n1, r1), (n2, r2) in zip(tables, pipe.tables))
    if chunk_same and same_tables and st is not None and st.parts and \
            len(part_infos) == len(pipe.part_specs) and \
            all(_spec_match(spec, want) for (spec, _f), want
                in zip(part_infos, pipe.part_specs)):
        return pipe, True
    _evict(key)
    return None, False


def stream_execute(planner, parts, keep, join_preds, where_conjuncts,
                   sources, syncs0=None):
    """Execute a join graph whose ``keep``-th part is a ``_StreamedScan``
    through the chunk pipeline. Returns ``(table, None)`` on success, or
    ``(None, reason)`` when the graph is not streamable or overflowed — the
    caller (``Planner._stream_join_parts``) then runs the eager chunk loop
    and records its event. ``(None, None)``: fall back silently.
    ``syncs0``: the sync count the event's window opens at (set when a
    stale pipeline's drive already ran for this execution)."""
    if E.replay_mode() != "off":
        return None, None
    from nds_tpu_torch.sql.planner import _OuterBuild, _OuterProbe
    scan = parts[keep]
    chunked, alias = scan.chunked, scan.alias
    dev = E.device()
    rebuilt = syncs0 is not None
    if not rebuilt:
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

    bind_slots = _param_slots(planner, parts, keep, where_conjuncts,
                              chunk_spec) if _param_bind_active() else ()
    key = _cache_key(alias, keep, join_preds, where_conjuncts,
                     masked_sources, part_infos, chunk_spec, chunk_cap,
                     chunked.nrows, outer_meta, bind_slots)
    pipe, check_parts = _cache_hit(key, chunk_spec, part_infos, planner)
    resid_infos = ()
    if pipe is not None and pipe.residuals:
        resid_infos = _replan_residuals(planner, pipe)
        if resid_infos is None:
            _evict(key)
            pipe, resid_infos, check_parts = None, (), False
    parts_flat = tuple(tuple(flat) for (_spec, flat) in part_infos)
    _obs.annotate(pipelineCache="hit" if pipe is not None else "miss")
    _metrics.default().inc(_metrics.PIPE_HIT if pipe is not None
                           else _metrics.PIPE_MISS)

    if pipe is None:
        try:
            pipe, resid_infos = _build_pipeline(
                planner, parts, keep, alias, join_preds, where_conjuncts,
                masked_sources, part_infos, outer_meta, first, chunk_spec,
                chunk_cap, n_chunks, bind_slots)
        except _F.FaultInjected as exc:
            # the pipeline-compile seam's recovery: compiled -> eager
            _F.record_fault_event(exc.seam, "degrade",
                                  detail=f"compiled->eager: {exc}")
            return None, f"fault: {exc.seam} (degraded compiled->eager)"
        if pipe is None:
            return None, "not chunk-invariant"
        pipe.tables = _bound_tables(planner)
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
        # THIS statement's literal values for the pipe's bound slots (a hit
        # agrees on the slots' count, order and types by its key)
        out, ran, evidence = pipe.run(
            host_iter, first, parts_flat, resid_flat, graph=E.stream_graph(),
            values=tuple(nd.value for (_ci, _p, _t, nd) in bind_slots),
            check_parts=check_parts)
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
    if evidence.get("stale_parts"):
        # the parts are other buffers of other content than the pipeline
        # was built on (a derived part over the same catalog tables): its
        # recorded reads do not hold, so it goes, and a fresh pipeline is
        # built and driven for this execution, as the reference does on
        # any new part buffer. A fresh pipeline drives the parts it was
        # built on, so this happens at most once an execution.
        _evict(key)
        if rebuilt:
            return None, "parts changed since the pipeline was built"
        log.info("streamed pipeline's parts changed; rebuilding it for %s",
                 alias)
        return stream_execute(planner, parts, keep, join_preds,
                              where_conjuncts, sources, syncs0=syncs0)
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
                        graph=evidence["graph"],
                        shards=evidence.get("shards", 1),
                        shard_rows=evidence.get("shard_rows", ()),
                        collectives=evidence.get("collectives", -1),
                        bytes_ici=evidence.get("bytes_ici", -1),
                        param_k4=pipe.param_k4,
                        param_graph=pipe.param_graph,
                        param_ms=evidence["param_ms"])
    _obs.annotate(path="compiled", chunks=ran, graph=evidence["graph"][:300],
                  prefetchStallMs=evidence["stall_ms"],
                  partitions=evidence.get("partitions", 1),
                  shards=evidence.get("shards", 1),
                  collectives=evidence.get("collectives", -1),
                  bytesIci=evidence.get("bytes_ici", -1),
                  shardCards=evidence.get("shard_cards", 1),
                  bytesH2d=evidence["h2d"],
                  scanLaunches=evidence["scan_launches"],
                  probeLaunches=evidence["probe_launches"],
                  kernelStages=evidence["kernel_stages"])
    return out, None


def _build_pipeline(planner, parts, keep, alias, join_preds,
                    where_conjuncts, masked_sources, part_infos,
                    outer_meta, first, chunk_spec, chunk_cap, n_chunks,
                    bind_slots=()):
    """RECORD the per-chunk join graph on the first padded chunk; ``(None,
    None)`` when not streamable. Returns ``(pipe, resid_infos)`` — the
    flattened subquery residuals the record phase pre-planned, which are
    THIS execution's residual operands. ``bind_slots``
    (:func:`_param_slots`) lower into the K4 spec's bound fields or stay
    in the graph as bound scalars; the record itself bakes this
    execution's values, which no recorded host read depends on."""
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

        scan_spec, where_kept = lower_scan_spec(
            where_conjuncts, cols_meta, owned,
            {id(nd): k for k, (_ci, _p, _t, nd) in enumerate(bind_slots)})
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
    # sharded execution: each shard accumulates its own slice, so the
    # budget re-shares over the shards (skew-factored like the partition
    # share: mem_audit.shard_row_bound); the recorded output bucket stays
    # the floor, so one dispatch can always land a whole chunk's output
    n_shards, mesh = _shard_plan(chunk_cap)
    exchange, cap_ex = False, 0
    if n_shards > 1:
        from nds_tpu_torch.analysis.mem_audit import stream_skew_factor
        skew = stream_skew_factor()
        budget = min(budget, -(-budget // n_shards) * skew)
        if n_parts > 1 and key_slots:
            # the partitioned graph's keys are not co-partitioned with
            # the row split: exchange each chunk's rows so every shard
            # owns a key range
            exchange = True
            cap_ex = E.bucket_len(
                max((chunk_cap // n_shards) // n_shards, 1) * skew)
    acc_cap = E.bucket_len(max(budget, out0.plen))
    if scan_spec is not None and n_parts > 1 and key_slots:
        # the K4 pass also computes the partition routing hash over the
        # SAME buffers the plain hash fold would
        scan_spec = _K.ScanSpec(scan_spec.entries, scan_spec.cols,
                                tables=scan_spec.tables,
                                key_slots=tuple(key_slots),
                                n_conjuncts=scan_spec.n_conjuncts,
                                binds=scan_spec.binds)
    _obs.annotate(accRows=acc_cap, partitions=n_parts, shards=n_shards,
                  provedRows=proved if proved is not None else "unproven",
                  residuals=len(residuals), outerBuilds=len(build_slots))
    lifted, operands = _lift_log(list(rec_log), E.device())
    # bound slots by where they reach the program: the K4 spec's words,
    # or a graph scalar (a slot whose conjunct stayed in the graph)
    in_graph = {id(c) for c in where_kept}
    param_k4 = len({k for (_i, _f, k, _m) in scan_spec.binds}) \
        if scan_spec is not None else 0
    param_graph = sum(1 for (ci, _p, _t, _nd) in bind_slots
                      if id(where_conjuncts[ci]) in in_graph)
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
        scan_spec=scan_spec, n_shards=n_shards, mesh=mesh,
        exchange=exchange, cap_ex=cap_ex,
        param_nodes=tuple(nd for (_ci, _p, _t, nd) in bind_slots),
        param_tags=tuple(t for (_ci, _p, t, _nd) in bind_slots),
        param_k4=param_k4, param_graph=param_graph)
    return pipe, resid_infos
