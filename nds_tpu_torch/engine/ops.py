# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Structural relational operators over DeviceTable, on torch tensors.

All grouping and joining is sort-based on device: stable sorts, run
boundaries and segment reductions (collision-free), with searchsorted
probes for the join build/probe phases. The grouped aggregations run on the
hand-written kernels of :mod:`nds_tpu_torch.engine.kernels`.

Shape discipline: every materialization pads its row count up to a
power-of-two bucket (:func:`bucket_len`), with valid rows in a prefix
(``DeviceTable.nrows`` logical rows out of ``plen`` physical). Data past the
logical count is garbage that every operator ignores: joins hash pad rows to
unmatchable sentinels, grouping gives them a discardable trailing group, and
sorts order them last.

Host reads: every device->host read (``.item()``, ``.cpu()``,
``.tolist()``) goes through :func:`host_read`, and the ones that block are
counted per thread (:func:`sync_count`, :func:`sync_wait_ns`).

Hashes are 64-bit and unsigned in meaning but computed in int64: torch has
no logical right shift on int64 and no unsigned sort or searchsorted on the
CPU, so a logical shift masks the arithmetic one and unsigned order is
signed order after flipping bit 63.
"""

from __future__ import annotations

import os
import sys
import threading
import time

import numpy as np
import torch

from nds_tpu_torch.engine import prim
from nds_tpu_torch.engine.column import Column, encs_equal, is_dec
from nds_tpu_torch.engine.table import DeviceTable
from nds_tpu_torch.obs import trace as _trace

I64 = torch.int64
F64 = torch.float64

# ---------------------------------------------------------------------------
# bucketed shapes
# ---------------------------------------------------------------------------


# the bucket floor: the smallest physical length of any column
_MIN_BUCKET = 16


def bucket_len(n: int) -> int:
    """Smallest power-of-two capacity >= n (floor ``_MIN_BUCKET``)."""
    if n <= _MIN_BUCKET:
        return _MIN_BUCKET
    return 1 << (int(n) - 1).bit_length()


# ---------------------------------------------------------------------------
# the execution device and host-sync accounting (thread-local: concurrent
# streams each count their own syncs)
# ---------------------------------------------------------------------------

_sync_tls = threading.local()


def device() -> torch.device:
    """The calling thread's execution device (set by the Session around
    every statement; ``cpu`` when none is set)."""
    return getattr(_sync_tls, "device", None) or torch.device("cpu")


class _OnDevice:
    def __init__(self, dev):
        self.dev = torch.device(dev)

    def __enter__(self):
        self._prev = getattr(_sync_tls, "device", None)
        _sync_tls.device = self.dev
        return self.dev

    def __exit__(self, *exc):
        _sync_tls.device = self._prev


def on_device(dev):
    """Context: run the enclosed operators on ``dev``."""
    return _OnDevice(dev)


def add_syncs(n: int = 1) -> None:
    """Charge ``n`` host syncs to the calling thread's stream."""
    _sync_tls.count = getattr(_sync_tls, "count", 0) + n


def sync_count() -> int:
    """Host syncs counted on the calling thread so far."""
    return getattr(_sync_tls, "count", 0)


def add_sync_wait(ns: int) -> None:
    """Charge nanoseconds spent BLOCKED on a device->host read."""
    _sync_tls.wait_ns = getattr(_sync_tls, "wait_ns", 0) + ns


def sync_wait_ns() -> int:
    return getattr(_sync_tls, "wait_ns", 0)


def add_fetch_bytes(n: int) -> None:
    """Record device->host result bytes (collect()/to_arrow transfers)."""
    _sync_tls.fetch_bytes = getattr(_sync_tls, "fetch_bytes", 0) + n


def fetch_bytes() -> int:
    return getattr(_sync_tls, "fetch_bytes", 0)


def add_compile_ns(ns: int) -> None:
    """Charge kernel-build (nvcc) nanoseconds to the calling thread."""
    _sync_tls.compile_ns = getattr(_sync_tls, "compile_ns", 0) + ns


def compile_ns() -> int:
    """Nanoseconds of kernel building on the calling thread."""
    return getattr(_sync_tls, "compile_ns", 0)


def _sync_site() -> str:
    """First non-ops engine frame above the fetch — the call-site tag
    every sync-charging host read carries into the trace layer."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if "nds_tpu_torch" in fn and not fn.endswith("ops.py"):
            return (f"{os.path.basename(fn)}:{f.f_lineno}:"
                    f"{f.f_code.co_name}")
        f = f.f_back
    return "?"


def host_read(tag: str, fetch):
    """The single host-read choke point: run ``fetch`` and emit a
    sync-site event naming its engine call site. Attribution is
    re-entrancy-exact: a fetch that re-enters host_read charges each site
    only its OWN syncs."""
    s0, w0 = sync_count(), sync_wait_ns()
    a_s0, a_w0 = _trace.attributed()
    val = fetch()
    a_s1, a_w1 = _trace.attributed()
    own = (sync_count() - s0) - (a_s1 - a_s0)
    if own > 0:
        own_wait = max((sync_wait_ns() - w0) - (a_w1 - a_w0), 0)
        _trace.note_sync(tag, own, own_wait, _sync_site())
    return val


def timed_read(tag: str, fetch):
    """host_read() with the fetch charged to the thread's sync/wait
    accounting — for blocking device->host reads that are not simple
    scalar syncs (chunk spans, whole-column string/date fetches)."""

    def timed():
        add_syncs()
        t0 = time.perf_counter_ns()
        out = fetch()
        add_sync_wait(time.perf_counter_ns() - t0)
        return out

    return host_read(tag, timed)


def host_sync(value) -> int:
    """Read a device scalar on host, counting the sync."""

    def fetch():
        add_syncs()
        t0 = time.perf_counter_ns()
        out = int(value.item()) if torch.is_tensor(value) else int(value)
        add_sync_wait(time.perf_counter_ns() - t0)
        return out

    return host_read("sync", fetch)


def to_host(t: torch.Tensor) -> np.ndarray:
    """Uncounted host copy of a tensor that the caller's counted read
    (``timed_read``/``host_read``) already wraps."""
    return t.cpu().numpy()


class DeviceCount:
    """A logical row count that stays on device (no-shrink capacity
    propagation with batched sync points).

    ``dev`` is a 0-d device tensor; ``bound`` the static upper bound used
    for every physical-shape choice. Only a consumer that truly needs the
    host integer resolves, and resolution drains EVERY pending count of the
    calling thread in one transfer.
    """

    __slots__ = ("dev", "bound", "_host")

    def __init__(self, dev, bound: int):
        self.dev = dev
        self.bound = int(bound)
        self._host: int | None = None
        _pending_counts().append(self)

    def to_int(self) -> int:
        if self._host is None:
            resolve_counts()
        if self._host is None:
            # not in the calling thread's pending list: fetch directly
            def fetch():
                add_syncs()
                t0 = time.perf_counter_ns()
                out = int(self.dev.item())
                add_sync_wait(time.perf_counter_ns() - t0)
                return out

            self._host = host_read("count1", fetch)
            _run_deferred_checks()
        return self._host

    def __repr__(self):
        state = self._host if self._host is not None else "?"
        return f"DeviceCount({state}/{self.bound})"

    # implicit coercions raise so every host consumer is an EXPLICIT,
    # counted choice between count_int (syncs, batched) and count_bound
    def _no_host(self, *_a, **_k):
        raise TypeError(
            "DeviceCount is not a host value; use ops.count_int (syncs, "
            "batched) or ops.count_bound (free upper bound)")

    __bool__ = __index__ = __int__ = __eq__ = __lt__ = __le__ = __gt__ = \
        __ge__ = __add__ = __radd__ = __mul__ = __rmul__ = _no_host
    __hash__ = None


def _pending_counts() -> list:
    lst = getattr(_sync_tls, "pending", None)
    if lst is None:
        lst = _sync_tls.pending = []
    return lst


def resolve_counts() -> None:
    """Fetch every pending device count of this thread in ONE transfer
    (counted as one host sync — the batching is the point)."""
    lst = _pending_counts()
    pend = [c for c in lst if c._host is None]
    if not pend:
        lst.clear()
        _run_deferred_checks()
        return

    def fetch():
        t0 = time.perf_counter_ns()
        devs = [c.dev if torch.is_tensor(c.dev)
                else torch.tensor(int(c.dev), dtype=I64) for c in pend]
        dev0 = devs[0].device
        vals = torch.stack([d.to(dev0, I64).reshape(()) for d in devs])
        out = [int(v) for v in vals.cpu().tolist()]
        add_sync_wait(time.perf_counter_ns() - t0)
        add_syncs()
        return out

    vals = host_read(f"counts{len(pend)}", fetch)
    for c, v in zip(pend, vals):
        c._host = v
    lst.clear()
    _run_deferred_checks()


def defer_check(count: DeviceCount, fn) -> None:
    """Register a validation against a count's eventual host value; it
    runs at whichever batched resolution produces the value."""
    lst = getattr(_sync_tls, "checks", None)
    if lst is None:
        lst = _sync_tls.checks = []
    lst.append((count, fn))


def _run_deferred_checks() -> None:
    lst = getattr(_sync_tls, "checks", None)
    if not lst:
        return
    ready = [(c, f) for c, f in lst if c._host is not None]
    _sync_tls.checks = [(c, f) for c, f in lst if c._host is None]
    first_err = None
    for c, f in ready:          # every ready check runs even if one raises
        try:
            f(c._host)
        except Exception as e:
            first_err = first_err or e
    if first_err is not None:
        raise first_err


def flush_deferred_checks() -> None:
    """Statement-end barrier: resolve any counts that deferred checks are
    waiting on so SQL runtime errors surface inside their statement."""
    if getattr(_sync_tls, "checks", None):
        resolve_counts()


def discard_deferred_checks() -> None:
    """Drop pending deferred checks (the statement aborted)."""
    _sync_tls.checks = []


def count_int(n) -> int:
    """Host integer of a count (resolves a DeviceCount, batched)."""
    return n.to_int() if isinstance(n, DeviceCount) else int(n)


def count_bound(n) -> int:
    """Static upper bound of a count — free of any sync."""
    if isinstance(n, DeviceCount):
        return n.bound if n._host is None else n._host
    return int(n)


def count_arr(n):
    """Tensor-use form: the device scalar (or the plain int)."""
    return n.dev if isinstance(n, DeviceCount) else n


def live_mask(plen: int, nrows, dev=None) -> torch.Tensor:
    """Bool mask of the logical (non-pad) prefix of a physical array.
    ``nrows`` may be a host int or a :class:`DeviceCount` (no sync)."""
    if dev is None:
        dev = nrows.dev.device if isinstance(nrows, DeviceCount) \
            and torch.is_tensor(nrows.dev) else device()
    return torch.arange(plen, device=dev) < count_arr(nrows)


def compact_indices(mask: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of the first ``n`` True rows of ``mask``, padded to
    ``bucket_len(n)`` with an out-of-range fill (gathers clip, scatters
    drop)."""
    cap = bucket_len(n)
    plen = int(mask.shape[0])
    return prim.nonzero_sized(mask, cap, max(plen, 1))


# bucket ceiling below which a lazily-compacted table keeps its un-shrunk
# bucket
LAZY_SHRINK_ROWS = 1 << 20


def compact_table(table: DeviceTable, mask: torch.Tensor,
                  shrink: bool = False) -> DeviceTable:
    """Keep rows where ``mask`` is true, as a prefix-padded table.

    Default (``shrink=False``): NO host sync — live rows gather to the
    prefix of a bucket sized from the producer's bound and the logical
    count rides along as a :class:`DeviceCount`. ``shrink=True`` syncs once
    and re-buckets to the tight capacity."""
    m = mask & live_mask(table.plen, table.nrows, mask.device)
    if shrink:
        n = host_sync(m.sum())
        return take_padded(table, compact_indices(m, n), n)
    cap = min(bucket_len(count_bound(table.nrows)), bucket_len(table.plen))
    idx = prim.nonzero_sized(m, cap, max(table.plen, 1))
    n = DeviceCount(m.sum(), min(count_bound(table.nrows), cap))
    out = take_padded(table, idx, n)
    if cap > LAZY_SHRINK_ROWS:
        # past this bucket size the downstream sorts a fat bucket drags
        # through cost more than one (batched) round trip: resolve now
        return resolve_table(out)
    return out


def resolve_table(table: DeviceTable, shrink: bool = True) -> DeviceTable:
    """Resolve a table's lazy count to a host int (batched) and, by
    default, slice the physical bucket down to the tight capacity."""
    n = table.nrows
    if not isinstance(n, DeviceCount):
        return table
    ni = n.to_int()
    cap = bucket_len(ni)
    if not shrink or cap >= table.plen:
        return DeviceTable(table.columns, ni, plen=table.plen)
    from nds_tpu_torch.engine.column import slice_col_prefix
    cols = {nm: slice_col_prefix(c, cap) for nm, c in table.columns.items()}
    return DeviceTable(cols, ni, plen=cap)


def gather_table_rows(table: DeviceTable, idx: torch.Tensor,
                      nrows) -> DeviceTable:
    """Whole-table row gather (clip mode); logical length ``nrows``."""
    from dataclasses import replace as _replace
    out = {}
    for n, c in table.columns.items():
        out[n] = _replace(
            c, data=prim.take_clip(c.data, idx),
            valid=None if c.valid is None else prim.take_clip(c.valid, idx))
    return DeviceTable(out, nrows, plen=int(idx.shape[0]))


def take_padded(table: DeviceTable, idx: torch.Tensor, nrows) -> DeviceTable:
    """Gather rows by (possibly out-of-range padded) ``idx``; logical length
    ``nrows``. The physical length follows ``idx``."""
    cap = int(idx.shape[0])
    if table.plen == 0:
        cols = {n: _null_column_like(c, cap)
                for n, c in table.columns.items()}
        return DeviceTable(cols, 0, plen=cap)
    if not table.columns:
        return DeviceTable({}, nrows, plen=cap)
    return gather_table_rows(table, idx, nrows)


# ---------------------------------------------------------------------------
# sort-key preparation
# ---------------------------------------------------------------------------

# ONE lock for every _identity_cache-managed dict; compute() stays off-lock
_IDENTITY_LOCK = threading.Lock()


def _identity_cache(cache: dict, max_size: int, key_arrays: tuple, compute,
                    static_key=()):
    """Bounded FIFO cache keyed by the identity of host arrays or tensors
    (plus an optional hashable ``static_key``). The entry holds references
    to the keyed objects so a recycled id() can never alias a freed one."""
    key = (static_key,) + tuple(id(a) for a in key_arrays)
    hit = cache.get(key)
    if hit is not None and all(h is a for h, a in zip(hit[0], key_arrays)):
        return hit[1]
    value = compute()
    with _IDENTITY_LOCK:
        hit = cache.get(key)
        if hit is not None and all(h is a
                                   for h, a in zip(hit[0], key_arrays)):
            return hit[1]
        if len(cache) >= max_size:
            cache.pop(next(iter(cache)))
        cache[key] = (key_arrays, value)
    return value


_rank_cache: dict = {}
_dev_cache: dict = {}


def host_table(arr: np.ndarray, dev) -> torch.Tensor:
    """Device copy of a cached HOST lookup table (dictionary ranks, merged
    maps), itself cached per (array identity, device)."""
    return _identity_cache(_dev_cache, 2048, (arr,),
                           lambda: torch.as_tensor(arr, device=dev),
                           static_key=str(dev))


def _dict_ranks(dict_values) -> tuple:
    """(code -> lexicographic rank, rank -> code) maps for one string
    dictionary, cached per dictionary as HOST arrays."""
    def compute():
        order = np.argsort(dict_values.astype(str), kind="stable")
        ranks = np.empty(len(order), dtype=np.int64)
        ranks[order] = np.arange(len(order))
        return ranks, order.astype(np.int64)
    return _identity_cache(_rank_cache, 512, (dict_values,), compute)


def ordered_codes(col: Column) -> torch.Tensor:
    """For a string column, map dictionary codes to lexicographic ranks so
    integer comparisons order like string comparisons."""
    ranks = host_table(_dict_ranks(col.dict_values)[0], col.data.device)
    return prim.take(ranks, col.data)


def plain_col(col: Column) -> Column:
    """Decoded (logical-representation) view of a possibly-encoded column."""
    return col.plain() if col.enc is not None else col


def plain_data(col: Column) -> torch.Tensor:
    """Decoded data of a possibly-encoded column."""
    return col.plain().data if col.enc is not None else col.data


def sortable_view(col: Column) -> torch.Tensor:
    """Numeric view of a column that sorts in SQL ascending order."""
    if col.kind == "str":
        return ordered_codes(col)
    if col.kind == "bool":
        return col.data.to(torch.int32)
    return col.data


def _lexsort_impl(views, valids, descending, nulls_last, pad_key, n_valid):
    """Multi-key stable sort by iterative order-preserving re-coding: each
    key folds into one combined int64 code via :func:`_dense_codes` (codes
    ascend with the value, so ``dense(combined)*fold + code`` keeps
    lexicographic order), and one stable single-key argsort finishes."""
    n = views[0].shape[0]
    dev = views[0].device
    fold = 2 * n + 4
    combined = None
    if pad_key:
        combined = (torch.arange(n, device=dev) >= n_valid).to(I64)
    for v, valid, desc, nl in zip(views, valids, descending, nulls_last):
        if desc:
            v = -v.to(I64) if v.dtype != F64 else -v
        if v.dtype == F64:
            # NaNs compare EQUAL (one code, greatest) so later keys can
            # still break their ties
            nan = torch.isnan(v)
            c = _dense_codes(torch.where(nan, torch.full(
                (), float("inf"), dtype=F64, device=dev), v))
            code = 2 * c + nan.to(I64) + 1                # 1..2n
        else:
            code = _dense_codes(v) + 1                    # 1..n
        if valid is not None:
            code = torch.where(valid, code, torch.full(
                (), 2 * n + 3 if nl else 0, dtype=I64, device=dev))
        combined = code if combined is None else \
            _dense_codes(combined) * fold + code
    if combined is None:
        return torch.arange(n, device=dev)
    return prim.argsort_stable(combined)


def lexsort_indices(cols, descending=None, nulls_last=None,
                    n_valid=None) -> torch.Tensor:
    """Stable multi-key sort. ``cols`` primary-first; per-key descending and
    nulls-last flags (SQL default: asc, nulls first). With ``n_valid``,
    rows past the logical count sort after every live row."""
    n = len(cols[0])
    if descending is None:
        descending = [False] * len(cols)
    if nulls_last is None:
        nulls_last = [False] * len(cols)
    pad_key = n_valid is not None and (
        isinstance(n_valid, DeviceCount) or n_valid < n)
    views = tuple(sortable_view(c) for c in cols)
    valids = tuple(c.valid for c in cols)
    return _lexsort_impl(views, valids, tuple(descending), tuple(nulls_last),
                         pad_key, 0 if n_valid is None else count_arr(n_valid))


# ---------------------------------------------------------------------------
# grouping
# ---------------------------------------------------------------------------


def _dense_codes(v: torch.Tensor) -> torch.Tensor:
    """Dense group codes of a single 1-D key (exact, via one stable sort).
    Codes are < len(v); no host sync."""
    n = v.shape[0]
    order = prim.argsort_stable(v)
    sv = v[order]
    boundary = torch.cat([torch.ones(1, dtype=torch.bool, device=v.device),
                          sv[1:] != sv[:-1]])
    code_sorted = torch.cumsum(boundary.to(I64), 0) - 1
    out = torch.zeros(n, dtype=I64, device=v.device)
    out[order] = code_sorted
    return out


_PAD_GROUP_KEY = prim.I64_MAX // 2


def _group_rep_impl(gids, n_valid, cap):
    """First-occurrence row index of each live group, bucket-padded to
    ``cap``; the pad group scatters out of range and is dropped."""
    plen = gids.shape[0]
    dev = gids.device
    live = torch.arange(plen, device=dev) < n_valid
    scatter_ids = torch.where(live, gids, torch.full((), cap, dtype=I64,
                                                     device=dev))
    return prim.scatter_amin(torch.full((cap,), plen, dtype=I64, device=dev),
                             scatter_ids, torch.arange(plen, dtype=I64,
                                                       device=dev))


def _group_ids_impl(views, valids, n_valid):
    """Iterative dense re-coding (see :func:`group_ids`): per-row dense
    group ids with pads in one trailing group, plus the live group count
    as a device scalar."""
    plen = views[0].shape[0]
    dev = views[0].device
    live = torch.arange(plen, device=dev) < n_valid
    fold = 2 * plen + 2
    combined = None
    for v, valid in zip(views, valids):
        if valid is not None:
            # zero data under nulls: all-null rows must compare equal
            v = torch.where(valid, v, torch.zeros((), dtype=v.dtype,
                                                  device=dev))
        codes = _dense_codes(v)
        if valid is not None:
            codes = 2 * codes + (~valid).to(I64)
        if combined is None:
            combined = codes
        else:
            combined = _dense_codes(combined) * fold + codes
    combined = torch.where(live, combined, torch.full(
        (), _PAD_GROUP_KEY, dtype=I64, device=dev))
    gids = _dense_codes(combined)
    ngroups = torch.where(live, gids, torch.full((), -1, dtype=I64,
                                                 device=dev)).max() + 1
    return gids, ngroups


# row count from which multi-key groupings try the packed single-sort plan
GROUP_PACK_MIN = 1 << 20


def _int_key_ranges(views, n_valid):
    """(min, max) of every integer key view over live rows."""
    plen = views[0].shape[0]
    dev = views[0].device
    live = torch.arange(plen, device=dev) < n_valid
    big = torch.full((), prim.I64_MAX, dtype=I64, device=dev)
    small = torch.full((), prim.I64_MIN, dtype=I64, device=dev)
    mins = torch.stack([torch.where(live, v.to(I64), big).min()
                        for v in views])
    maxs = torch.stack([torch.where(live, v.to(I64), small).max()
                        for v in views])
    return mins, maxs


def _group_ids_packed(views, valids, offsets, widths, n_valid):
    """Single-sort grouping: every key's offset code (null flag folded)
    packs into one int64, so ONE :func:`_dense_codes` sort replaces the
    K+1 sorts of the iterative fold."""
    plen = views[0].shape[0]
    dev = views[0].device
    combined = torch.zeros(plen, dtype=I64, device=dev)
    for v, valid, off, width in zip(views, valids, offsets, widths):
        code = v.to(I64) - off
        if valid is not None:
            code = 2 * torch.where(valid, code, torch.zeros(
                (), dtype=I64, device=dev)) + (~valid).to(I64)
        combined = (combined << width) | code
    live = torch.arange(plen, device=dev) < n_valid
    combined = torch.where(live, combined, torch.full(
        (), _PAD_GROUP_KEY, dtype=I64, device=dev))
    gids = _dense_codes(combined)
    ngroups = torch.where(live, gids, torch.full((), -1, dtype=I64,
                                                 device=dev)).max() + 1
    return gids, ngroups


def _packed_group_plan(key_cols, views, n_valid):
    """(offsets, widths) when the combined key fits 62 bits, else None.
    String/bool key spans are host-known; integer keys cost ONE range
    sync."""
    int_idx = [i for i, c in enumerate(key_cols)
               if c.kind not in ("str", "bool")]
    spans = [None] * len(key_cols)
    for i, c in enumerate(key_cols):
        if c.kind == "str":
            spans[i] = (0, max(len(c.dict_values) - 1, 0))
        elif c.kind == "bool":
            spans[i] = (0, 1)
    if int_idx:
        def fetch():
            mins, maxs = _int_key_ranges(
                tuple(views[i] for i in int_idx), n_valid)
            return to_host(mins), to_host(maxs)

        mins, maxs = timed_read("group_ranges", fetch)
        for k, i in enumerate(int_idx):
            if mins[k] > maxs[k]:              # no live rows
                spans[i] = (0, 0)
            else:
                spans[i] = (int(mins[k]), int(maxs[k]))
    offsets, widths, total = [], [], 0
    for (lo, hi), c in zip(spans, key_cols):
        span = hi - lo
        if c.valid is not None:
            span = 2 * span + 1                # null flag folded in
        width = max(int(span).bit_length(), 1)
        offsets.append(lo)
        widths.append(width)
        total += width
    if total > 62:
        return None
    return tuple(offsets), tuple(widths)


def group_ids(key_cols, n_valid=None):
    """Grouping by iterative dense re-coding.

    Returns ``(gids, ngroups, rep_indices, cap)``: per-row dense group id
    (pad rows land in one trailing, discardable group), the live group
    count, the (bucket-padded, ``cap``-long) row index of each group's first
    occurrence, and the bucket capacity every grouped output is allocated
    with. SQL GROUP BY treats nulls as equal; each column's code folds its
    null flag in (``2*value_code + is_null``)."""
    plen = len(key_cols[0])
    dev = key_cols[0].data.device
    if n_valid is None:
        n_valid = plen
    if plen == 0:
        cap = bucket_len(0)
        return (torch.zeros(0, dtype=I64, device=dev), 0,
                torch.full((cap,), 1, dtype=I64, device=dev), cap)
    views = tuple(sortable_view(c) for c in key_cols)
    valids = tuple(c.valid for c in key_cols)
    nv = count_arr(n_valid)
    plan = None
    if len(key_cols) > 1 and plen >= GROUP_PACK_MIN:
        plan = _packed_group_plan(key_cols, views, nv)
    if plan is not None:
        gids, ng_dev = _group_ids_packed(views, valids, plan[0], plan[1], nv)
    else:
        gids, ng_dev = _group_ids_impl(views, valids, nv)
    # the one host sync — routed through the pending batch
    ngroups = DeviceCount(ng_dev, count_bound(n_valid)).to_int()
    cap = bucket_len(ngroups)
    rep = _group_rep_impl(gids, nv, cap)
    return gids, ngroups, rep, cap


# ---------------------------------------------------------------------------
# aggregation: the grouped sum, count, min and max run on the hand-written
# kernels (engine/kernels.py); a row takes part when its (validity-masked)
# group id lies in [0, ngroups)
# ---------------------------------------------------------------------------


def _masked_gids(gids, valid):
    if valid is None:
        return gids
    return torch.where(valid, gids, torch.full((), -1, dtype=gids.dtype,
                                               device=gids.device))


def agg_count(col: Column | None, gids, ngroups) -> Column:
    """count(*) when col is None else count(col) (non-null). Pad rows need
    no masking here: grouping routes them to a trailing group that lands
    past the logical group count or is dropped by the kernel."""
    from nds_tpu_torch.engine.kernels import segment_sum_f64
    valid = None if col is None else col.valid
    _, counts = segment_sum_f64(None, _masked_gids(gids, valid), ngroups)
    return Column("i64", counts)


def agg_sum(col: Column, gids, ngroups) -> Column:
    col = plain_col(col)           # sums need logical values
    g = _masked_gids(gids, col.valid)
    if col.kind == "f64":
        from nds_tpu_torch.engine.kernels import segment_sum_f64
        sums, counts = segment_sum_f64(col.data, g, ngroups)
        return Column("f64", sums, counts > 0)
    # exact two's-complement int64 sum for decimals and integers
    from nds_tpu_torch.engine.kernels import segment_sum_i64
    sums, counts = segment_sum_i64(col.data.to(I64), g, ngroups)
    kind = f"dec(38,{col.scale})" if is_dec(col.kind) else "i64"
    return Column(kind, sums, counts > 0)


def _agg_min_impl(view, valid, gids, ngroups, is_max):
    """Exact-kind MIN/MAX (integers, decimals, dates, string ranks)."""
    dev = view.device
    v = (torch.ones(view.shape[0], dtype=torch.bool, device=dev)
         if valid is None else valid)
    sentinel = prim.I64_MIN if is_max else prim.I64_MAX
    data = torch.where(v, view.to(I64), torch.full((), sentinel, dtype=I64,
                                                   device=dev))
    seg = prim.segment_max if is_max else prim.segment_min
    out = seg(data, gids, ngroups)
    cnt = prim.segment_sum(v.to(I64), gids, ngroups)
    return out, cnt > 0


def agg_min(col: Column, gids, ngroups, is_max=False) -> Column:
    if col.kind == "f64":
        from nds_tpu_torch.engine.kernels import (segment_minmax_f64,
                                                  segment_sum_f64)
        g = _masked_gids(gids, col.valid)
        mins, maxs = segment_minmax_f64(col.data, g, ngroups)
        _, cnt = segment_sum_f64(None, g, ngroups)
        out = maxs if is_max else mins
        return Column("f64", torch.where(cnt > 0, out, torch.zeros(
            (), dtype=F64, device=out.device)), cnt > 0)
    out, out_valid = _agg_min_impl(sortable_view(col), col.valid, gids,
                                   ngroups, bool(is_max))
    if col.kind == "str":
        # min/max of strings: map the winning rank back to a dictionary code
        rank_to_code = host_table(_dict_ranks(col.dict_values)[1],
                                  out.device)
        codes = prim.take(rank_to_code,
                          out.clamp(0, rank_to_code.shape[0] - 1))
        return Column("str", codes.to(torch.int32), out_valid,
                      col.dict_values)
    # order-preserving encodings: min/max of codes IS the code of the
    # min/max value, so the result stays encoded (decode at materialize)
    return Column(col.kind, out.to(col.data.dtype), out_valid, enc=col.enc)


def agg_avg(col: Column, gids, ngroups) -> Column:
    col = plain_col(col)
    g = _masked_gids(gids, col.valid)
    if col.kind == "f64":
        from nds_tpu_torch.engine.kernels import segment_sum_f64
        sums, counts = segment_sum_f64(col.data, g, ngroups)
    else:
        # exact int64 sum first, then one f64 divide
        from nds_tpu_torch.engine.kernels import segment_sum_i64
        isums, counts = segment_sum_i64(col.data.to(I64), g, ngroups)
        sums = isums.to(F64)
        if is_dec(col.kind):
            sums = sums / (10.0 ** col.scale)
    out = torch.where(counts > 0, sums / counts.clamp(min=1).to(F64),
                      torch.zeros((), dtype=F64, device=sums.device))
    return Column("f64", out, counts > 0)


def _agg_stddev_impl(data, valid, gids, ngroups):
    dev = data.device
    v = (torch.ones(data.shape[0], dtype=torch.bool, device=dev)
         if valid is None else valid)
    d = torch.where(v, data, torch.zeros((), dtype=F64, device=dev))
    s1 = prim.segment_sum(d, gids, ngroups)
    s2 = prim.segment_sum(d * d, gids, ngroups)
    c = prim.segment_sum(v.to(F64), gids, ngroups)
    mean = s1 / c.clamp(min=1.0)
    var = (s2 - c * mean * mean) / (c - 1.0).clamp(min=1.0)
    return torch.sqrt(var.clamp(min=0.0)), c > 1


def agg_stddev_samp(col: Column, gids, ngroups) -> Column:
    col = plain_col(col)
    data = col.data.to(F64)
    if is_dec(col.kind):
        data = data / (10.0 ** col.scale)
    out, enough = _agg_stddev_impl(data, col.valid, gids, ngroups)
    return Column("f64", out, enough)


# ---------------------------------------------------------------------------
# filter / compact
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------


def _u64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


_HASH_C1 = _u64(0x9E3779B97F4A7C15)
_HASH_C2 = _u64(0xBF58476D1CE4E5B9)
_HASH_C3 = _u64(0x94D049BB133111EB)
_HASH_SEED = _u64(0x243F6A8885A308D3)
_NULL_MARK = _u64(0xA5A5A5A5A5A5A5A5)


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    x = (x ^ _srl(x, 30)) * _HASH_C2
    x = (x ^ _srl(x, 27)) * _HASH_C3
    return x ^ _srl(x, 31)


def unsigned_order(h: torch.Tensor) -> torch.Tensor:
    """Signed view of uint64 bits that sorts in unsigned order."""
    return h ^ prim.I64_MIN


def _key_hash_impl(views, valids, side_salt: int, null_safe: bool, n_valid,
                   excluded=None):
    """64-bit composite hash of prepared key views (uint64 bits in int64).

    Default SQL join semantics: rows with any null key get a per-row unique
    value that cannot match the other side. With ``null_safe`` the null
    flag is folded into the hash instead so null keys compare equal. Pad
    rows past ``n_valid``, and rows flagged in ``excluded``, always get the
    unmatchable per-row value."""
    n = views[0].shape[0]
    dev = views[0].device
    h = torch.full((n,), _HASH_SEED, dtype=I64, device=dev)
    any_null = torch.zeros(n, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=I64, device=dev)
    for v, valid in zip(views, valids):
        if v.dtype == F64:
            # equality-preserving int words: the integer part plus a 52-bit
            # fraction word (the hash is only a candidate prefilter)
            vf = torch.nan_to_num(v)
            ip = vf.clamp(-9.0e18, 9.0e18).to(I64)
            frac = ((vf - torch.floor(vf)) * float(2 ** 52)).to(I64)
            words = (ip, frac)
        else:
            words = (v.to(I64),)
        if valid is not None:
            words = tuple(torch.where(valid, w, zero) for w in words)
            marker = torch.where(valid, zero, torch.full(
                (), _NULL_MARK, dtype=I64, device=dev))
            any_null = any_null | ~valid
        else:
            marker = torch.zeros(n, dtype=I64, device=dev)
        h = _mix64(h ^ marker)
        for w in words:
            h = _mix64(h ^ (w * _HASH_C1))
    unmatchable = torch.zeros(n, dtype=torch.bool, device=dev) \
        if null_safe else any_null
    unmatchable = unmatchable | (torch.arange(n, device=dev) >= n_valid)
    if excluded is not None:
        unmatchable = unmatchable | excluded
    row_ids = torch.arange(n, dtype=I64, device=dev)
    # bit layout: bits 0-1 side tag, bit 2 = REAL marker, row id from bit 3
    sentinel = (1 if side_salt else 2) + (row_ids << 3)
    return torch.where(unmatchable, sentinel, h | 4)


def _hash_views(left_keys, right_keys):
    """Per-pair hashable views of the join keys. String pairs map through
    one merged dictionary ordering first (codes of two dictionaries are not
    comparable)."""
    lviews, rviews = [], []
    for lk, rk in zip(left_keys, right_keys):
        if lk.kind == "str" and rk.kind == "str":
            lv, rv = ordered_codes_merged(lk, rk)
        else:
            lv, rv = plain_data(lk), plain_data(rk)
        lviews.append(lv)
        rviews.append(rv)
    return tuple(lviews), tuple(rviews)


def _verify_pairs(l_idx, r_idx, left_keys, right_keys,
                  null_safe: bool = False) -> torch.Tensor:
    """Exact key equality for candidate pairs (hash-collision safety).
    With ``null_safe``, null == null."""
    ok = torch.ones(l_idx.shape[0], dtype=torch.bool, device=l_idx.device)
    for lk, rk in zip(left_keys, right_keys):
        if lk.kind == "str" and rk.kind == "str":
            lmap, rmap = ordered_codes_merged(lk, rk)
            lv = prim.take(lmap, l_idx)
            rv = prim.take(rmap, r_idx)
        else:
            lv = prim.take(plain_data(lk), l_idx)
            rv = prim.take(plain_data(rk), r_idx)
        eq = lv == rv
        lvalid = None if lk.valid is None else prim.take(lk.valid, l_idx)
        rvalid = None if rk.valid is None else prim.take(rk.valid, r_idx)
        if null_safe:
            lnull = torch.zeros_like(eq) if lvalid is None else ~lvalid
            rnull = torch.zeros_like(eq) if rvalid is None else ~rvalid
            eq = torch.where(lnull | rnull, lnull & rnull, eq)
        else:
            if lvalid is not None:
                eq = eq & lvalid
            if rvalid is not None:
                eq = eq & rvalid
        ok = ok & eq
    return ok


_merged_cache: dict = {}


def ordered_codes_merged(a: Column, b: Column):
    """Map two string columns' codes into one shared value ordering, cached
    per dictionary pair (host arrays — see :func:`_dict_ranks`)."""
    def compute():
        union, inverse = np.unique(
            np.concatenate([a.dict_values.astype(str),
                            b.dict_values.astype(str)]),
            return_inverse=True)
        a_map = inverse[: len(a.dict_values)].astype(np.int64)
        b_map = inverse[len(a.dict_values):].astype(np.int64)
        return a_map, b_map
    a_map, b_map = _identity_cache(
        _merged_cache, 256, (a.dict_values, b.dict_values), compute)
    return prim.take(host_table(a_map, a.data.device), a.data), \
        prim.take(host_table(b_map, b.data.device), b.data)


def _probe_candidates(left_keys, right_keys, null_safe=False,
                      n_left=None, n_right=None, l_excl=None, r_excl=None):
    """Hash-probe phase shared by the monolithic and chunked joins: returns
    ``(counts, lo, order, total)`` — per-left-row candidate counts, start
    offsets into the hash-sorted right side, the right-side sort order, and
    the total candidate-pair count (host sync)."""
    plen_l = len(left_keys[0])
    plen_r = len(right_keys[0])
    n_left = plen_l if n_left is None else n_left
    n_right = plen_r if n_right is None else n_right
    lviews, rviews = _hash_views(left_keys, right_keys)
    lvalids = tuple(c.valid for c in left_keys)
    rvalids = tuple(c.valid for c in right_keys)
    rh = unsigned_order(_key_hash_impl(rviews, rvalids, 1, null_safe,
                                       count_arr(n_right), r_excl))
    order = prim.argsort_stable(rh)
    rh_sorted = rh[order]
    lh = unsigned_order(_key_hash_impl(lviews, lvalids, 0, null_safe,
                                       count_arr(n_left), l_excl))
    lo = prim.searchsorted(rh_sorted, lh)
    hi = prim.searchsorted(rh_sorted, lh, right=True)
    counts = hi - lo
    total = host_sync(counts.sum())                    # host sync 1
    return counts, lo, order, total


def _pair_indices(counts, lo, order, cand, plen_r, row_mask=None):
    """Candidate pair indices (left row, right row), padded to ``cand``;
    ``row_mask`` restricts the probe rows."""
    plen_l = counts.shape[0]
    dev = counts.device
    row = torch.arange(plen_l, device=dev)
    if row_mask is not None:
        counts = torch.where(row_mask, counts, torch.zeros(
            (), dtype=counts.dtype, device=dev))
    l_idx = prim.repeat_total(row, counts, cand)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(cand, device=dev) - prim.repeat_total(starts, counts,
                                                             cand)
    r_pos = prim.repeat_total(lo, counts, cand) + pos
    r_idx = prim.take_clip(order, r_pos.clamp(0, max(plen_r - 1, 0)))
    return l_idx, r_idx


def join_indices(left_keys, right_keys, how: str = "inner",
                 null_safe: bool = False, n_left=None, n_right=None,
                 l_excl=None, r_excl=None, probe=None):
    """Equi-join. Returns ``(l_idx, r_idx, n_pairs, l_extra, n_lx, r_extra,
    n_rx)``: bucket-padded matched pair indices with their logical count,
    plus (for outer joins) the bucket-padded unmatched row indices of each
    side. Pad slots hold out-of-range indices (gathers clip, scatters drop).
    ``l_excl``/``r_excl`` are deferred filter masks (True = row filtered
    out). ``probe`` passes a precomputed :func:`_probe_candidates` result.
    """
    plen_l = len(left_keys[0])
    plen_r = len(right_keys[0])
    dev = left_keys[0].data.device
    n_left = plen_l if n_left is None else n_left
    n_right = plen_r if n_right is None else n_right
    counts, lo, order, total = probe if probe is not None else \
        _probe_candidates(left_keys, right_keys, null_safe,
                          n_left, n_right, l_excl, r_excl)
    if total > 0:
        cand = bucket_len(total)
        pair_live = live_mask(cand, total, dev)
        l_idx, r_idx = _pair_indices(counts, lo, order, cand, plen_r)
        ok = _verify_pairs(l_idx, r_idx, left_keys, right_keys, null_safe)
        ok = ok & pair_live
        # NO pair-count sync: verified pairs compact to the prefix of the
        # candidate bucket and the exact count rides as a DeviceCount
        n_pairs = DeviceCount(ok.sum(), total)
        keep = prim.nonzero_sized(ok, cand, cand)
        l_idx = prim.take_fill(l_idx, keep, plen_l)
        r_idx = prim.take_fill(r_idx, keep, plen_r)
    else:
        n_pairs = 0
        cap0 = bucket_len(0)
        l_idx = torch.full((cap0,), plen_l, dtype=I64, device=dev)
        r_idx = torch.full((cap0,), plen_r, dtype=I64, device=dev)

    l_extra = r_extra = None
    n_lx = n_rx = 0
    miss = miss_r = None
    if how in ("left", "full"):
        matched = prim.scatter_set(
            torch.zeros(plen_l, dtype=torch.bool, device=dev), l_idx, True)
        miss = ~matched & live_mask(plen_l, n_left, dev)
        if l_excl is not None:
            miss = miss & ~l_excl
        n_lx = DeviceCount(miss.sum(), count_bound(n_left))
    if how in ("right", "full"):
        matched_r = prim.scatter_set(
            torch.zeros(plen_r, dtype=torch.bool, device=dev), r_idx, True)
        miss_r = ~matched_r & live_mask(plen_r, n_right, dev)
        if r_excl is not None:
            miss_r = miss_r & ~r_excl
        n_rx = DeviceCount(miss_r.sum(), count_bound(n_right))
    # one batched transfer resolves every count this join created
    if miss is not None:
        n_lx = n_lx.to_int()
        l_extra = compact_indices(miss, n_lx)
    if miss_r is not None:
        n_rx = n_rx.to_int()
        r_extra = compact_indices(miss_r, n_rx)
    return l_idx, r_idx, n_pairs, l_extra, n_lx, r_extra, n_rx


_PK_SENTINEL = prim.I64_MAX


def _semi_sorted_impl(lv, lvalid, rv, rvalid, n_left, n_right):
    """Sort-based existence probe on directly comparable key views: dead
    right rows take the sentinel, live rows sort live-first, so one
    leftmost searchsorted + equality + liveness check answers "does any
    LIVE right row hold this value" — exact and sync-free."""
    plen_r = rv.shape[0]
    dev = rv.device
    ok_r = torch.arange(plen_r, device=dev) < n_right
    if rvalid is not None:
        ok_r = ok_r & rvalid
    dk = torch.where(ok_r, rv.to(I64), torch.full((), _PK_SENTINEL,
                                                  dtype=I64, device=dev))
    order = prim.lexsort2(~ok_r, dk)
    dks = dk[order]
    lvv = lv.to(I64)
    lo = prim.searchsorted(dks, lvv).clamp(0, max(plen_r - 1, 0))
    hit = (prim.take(dks, lo) == lvv) & prim.take(ok_r[order], lo)
    ok_l = torch.arange(lv.shape[0], device=dev) < n_left
    if lvalid is not None:
        ok_l = ok_l & lvalid
    return hit & ok_l


def semi_join_mask(left_keys, right_keys, negate: bool = False,
                   null_safe: bool = False, n_left=None,
                   n_right=None) -> torch.Tensor:
    """Boolean per-left-row mask: has (semi) / lacks (anti) a match on the
    right. Used for IN / EXISTS / NOT EXISTS and (null-safe) set ops.
    Pad rows always come back False."""
    plen_l = len(left_keys[0])
    dev = left_keys[0].data.device
    n_left = plen_l if n_left is None else n_left
    lk, rk = left_keys[0], right_keys[0]
    if len(left_keys) == 1 and not null_safe and \
            lk.kind != "f64" and rk.kind != "f64" and \
            (lk.kind == rk.kind or
             {lk.kind, rk.kind} <= {"i64", "date"}):
        # single integer-comparable key: the sort probe answers existence
        # directly — no candidate-pair sync
        if lk.kind == "str" and rk.kind == "str":
            lview, rview = ordered_codes_merged(lk, rk)
        elif lk.kind != "str" and rk.kind != "str":
            lview, rview = plain_data(lk), plain_data(rk)
        else:
            lview = rview = None
        if lview is not None:
            plen_r = len(rk)
            n_r = plen_r if n_right is None else n_right
            matched = _semi_sorted_impl(lview, lk.valid, rview, rk.valid,
                                        count_arr(n_left), count_arr(n_r))
            out = ~matched if negate else matched
            return out & live_mask(plen_l, n_left, dev)
    l_idx, _, _, _, _, _, _ = join_indices(
        left_keys, right_keys, "inner", null_safe, n_left, n_right)
    matched = prim.scatter_set(
        torch.zeros(plen_l, dtype=torch.bool, device=dev), l_idx, True)
    out = ~matched if negate else matched
    return out & live_mask(plen_l, n_left, dev)


def _live_dim(plen_d, n_dim, dvalid, d_excl, dev):
    ok_d = torch.arange(plen_d, device=dev) < n_dim
    if dvalid is not None:
        ok_d = ok_d & dvalid
    if d_excl is not None:
        ok_d = ok_d & ~d_excl
    return ok_d


def _pk_gather_impl(fkey, fvalid, dkey, dvalid, n_fact, n_dim,
                    f_excl, d_excl):
    """Exact merge-probe of fact keys against a UNIQUE dimension key.

    Dead dimension rows (pads, filtered, null keys) take an unmatchable
    sentinel before the sort, so one searchsorted + equality check finds
    the unique match. Returns ``(r_idx, matched)`` at fact length."""
    plen_d = dkey.shape[0]
    dev = dkey.device
    ok_d = _live_dim(plen_d, n_dim, dvalid, d_excl, dev)
    dk = torch.where(ok_d, dkey.to(I64), torch.full((), _PK_SENTINEL,
                                                    dtype=I64, device=dev))
    # live-first tie-break: leftmost searchsorted lands on the live row
    order = prim.lexsort2(~ok_d, dk)
    dks = dk[order]
    fk = fkey.to(I64)
    lo = prim.searchsorted(dks, fk).clamp(0, plen_d - 1)
    hit = prim.take(dks, lo) == fk
    plen_f = fkey.shape[0]
    ok_f = _live_dim(plen_f, n_fact, fvalid, f_excl, dev)
    matched = hit & ok_f & prim.take(ok_d[order], lo)
    return prim.take(order, lo), matched


_dense_dim_cache: dict = {}


def _dense_dim_info(dim_key: Column, n_dim: int):
    """(base, device position map) when the dimension key is a dense-ish
    unique integer range (every TPC-DS surrogate key is), else None.
    Cached per key-tensor identity: one gather replaces the per-join sort
    probe."""
    if dim_key.kind == "str" or dim_key.enc is not None or n_dim == 0 \
            or n_dim > (1 << 24):
        return None

    def compute():
        def fetch():
            live = to_host(dim_key.data[:n_dim]).astype(np.int64)
            if dim_key.valid is not None and \
                    not bool(np.all(to_host(dim_key.valid[:n_dim]))):
                return None                   # null PKs: sort path handles
            mn = int(live.min())
            span = int(live.max()) - mn + 1
            # sparse keys blow the map; 4x slack covers SCD-style gaps
            if span > max(4 * n_dim, 1 << 16) or span > (1 << 26):
                return None
            pos = np.full(span, n_dim, dtype=np.int64)  # n_dim = miss mark
            pos[live - mn] = np.arange(n_dim)
            return mn, pos

        got = timed_read("dense_dim", fetch)
        if got is None:
            return None
        mn, pos = got
        return mn, torch.as_tensor(pos, device=dim_key.data.device)

    return _identity_cache(_dense_dim_cache, 64, (dim_key.data,), compute,
                           static_key=n_dim)


def _pk_gather_dense_impl(fkey, fvalid, dkey, dvalid, pos_map, base,
                          n_fact, n_dim, f_excl, d_excl):
    """Dense-range merge probe: position-map gather instead of sort +
    searchsorted. Same contract as :func:`_pk_gather_impl`."""
    plen_d = dkey.shape[0]
    plen_f = fkey.shape[0]
    dev = dkey.device
    ok_d = _live_dim(plen_d, n_dim, dvalid, d_excl, dev)
    fk = fkey.to(I64)
    off = fk - base
    span = pos_map.shape[0]
    inb = (off >= 0) & (off < span)
    r_idx = prim.take(pos_map, off.clamp(0, span - 1))
    r_ok = inb & (r_idx < n_dim)
    r_idx = r_idx.clamp(0, plen_d - 1)
    hit = r_ok & (prim.take(dkey.to(I64), r_idx) == fk)
    hit = hit & prim.take(ok_d, r_idx)
    ok_f = _live_dim(plen_f, n_fact, fvalid, f_excl, dev)
    return r_idx, hit & ok_f


def pk_gather_join(fact_key: Column, dim_key: Column, n_fact, n_dim,
                   f_excl=None, d_excl=None):
    """Planner-facing wrapper of :func:`_pk_gather_impl`: prepares
    comparable integer views (merged dictionary ranks for string pairs),
    and takes the dense-range position-map probe when the dimension key
    is a dense unique integer range."""
    if isinstance(n_dim, DeviceCount):
        n_dim = n_dim.to_int()
    if fact_key.kind == "str" and dim_key.kind == "str":
        fview, dview = ordered_codes_merged(fact_key, dim_key)
    else:
        fview, dview = plain_data(fact_key), plain_data(dim_key)
        dense = _dense_dim_info(dim_key, n_dim)
        if dense is not None:
            base, pos_map = dense
            return _pk_gather_dense_impl(
                fview, fact_key.valid, dview, dim_key.valid, pos_map,
                int(base), count_arr(n_fact), n_dim, f_excl, d_excl)
    return _pk_gather_impl(fview, fact_key.valid, dview, dim_key.valid,
                           count_arr(n_fact), n_dim, f_excl, d_excl)


_dim_span_cache: dict = {}


def _pack_keys_impl(views, valids, offsets, widths, spans):
    """Pack offset key codes into one int64, with a combined validity
    (per-key nulls AND in-range)."""
    plen = views[0].shape[0]
    dev = views[0].device
    packed = torch.zeros(plen, dtype=I64, device=dev)
    ok = torch.ones(plen, dtype=torch.bool, device=dev)
    for v, valid, off, width, span in zip(views, valids, offsets, widths,
                                          spans):
        k = v.to(I64) - off
        ok = ok & (k >= 0) & (k <= span)
        if valid is not None:
            ok = ok & valid
        packed = (packed << width) | k.clamp(0, span)
    return packed, ok


def pk_gather_join_multi(fact_keys, dim_keys, n_fact, n_dim,
                         f_excl=None, d_excl=None):
    """Composite-key merge probe against a UNIQUE key set: pack every key
    into one int64 (widths from the dim side's value spans — one range
    sync, identity-cached per key set) and run the single-key exact probe.
    Returns ``(r_idx, matched)`` or None when the keys cannot pack."""
    if len(fact_keys) == 1:
        return pk_gather_join(fact_keys[0], dim_keys[0], n_fact, n_dim,
                              f_excl, d_excl)
    kinds = {c.kind for c in list(fact_keys) + list(dim_keys)}
    if any(k in ("str", "f64") or k.startswith("dec") for k in kinds):
        return None
    if isinstance(n_dim, DeviceCount):
        n_dim = n_dim.to_int()
    fact_keys = [plain_col(c) for c in fact_keys]
    dim_keys = [plain_col(c) for c in dim_keys]

    def compute():
        def fetch():
            mins, maxs = _int_key_ranges(
                tuple(c.data for c in dim_keys), n_dim)
            return to_host(mins), to_host(maxs)

        mins, maxs = timed_read("dim_ranges", fetch)
        offsets, widths, spans, total = [], [], [], 0
        for lo, hi in zip(mins, maxs):
            span = max(int(hi) - int(lo), 0)
            width = max(int(span).bit_length(), 1)
            offsets.append(int(lo))
            widths.append(width)
            spans.append(span)
            total += width
        if total > 62:
            return None
        return tuple(offsets), tuple(widths), tuple(spans)

    plan = _identity_cache(_dim_span_cache, 128,
                           tuple(c.data for c in dim_keys), compute,
                           static_key=n_dim)
    if plan is None:
        return None
    offsets, widths, spans = plan
    fpacked, fok = _pack_keys_impl(
        tuple(c.data for c in fact_keys),
        tuple(c.valid for c in fact_keys), offsets, widths, spans)
    dpacked, dok = _pack_keys_impl(
        tuple(c.data for c in dim_keys),
        tuple(c.valid for c in dim_keys), offsets, widths, spans)
    return _pk_gather_impl(fpacked, fok, dpacked, dok, count_arr(n_fact),
                           n_dim, f_excl, d_excl)


def _null_column_like(col: Column, n: int) -> Column:
    dev = col.data.device
    data = torch.zeros((n,) + tuple(col.data.shape[1:]),
                       dtype=col.data.dtype, device=dev)
    return Column(col.kind, data, torch.zeros(n, dtype=torch.bool,
                                              device=dev),
                  col.dict_values, enc=col.enc)


# candidate-pair budget of one materialized join chunk: beyond it the inner
# join splits the probe side into capacity-bounded spans
PAIR_BUDGET = 1 << 22


def _chunk_spans(counts_np, budget):
    """Greedy contiguous spans of probe rows whose candidate-pair sums stay
    within ``budget`` (a single row exceeding it gets its own span)."""
    n = len(counts_np)
    cum = np.cumsum(counts_np, dtype=np.int64)
    spans, s = [], 0
    while s < n:
        base = cum[s - 1] if s else 0
        e = int(np.searchsorted(cum, base + budget, side="right"))
        if e <= s:
            e = s + 1                    # oversized single row: own span
        spans.append((s, e))
        s = e
    return spans


def _chunked_inner_join(left, right, left_keys, right_keys, probe,
                        residual_fn) -> DeviceTable:
    """Inner join materialized span-by-span so peak memory is bounded by
    ``PAIR_BUDGET`` pairs, with residual predicates applied per span."""
    counts, lo, order, total = probe
    plen_r = len(right_keys[0])
    dev = counts.device

    def fetch():
        counts_np = to_host(counts)
        return (_chunk_spans(counts_np, PAIR_BUDGET),
                np.concatenate([[0], np.cumsum(counts_np)]))

    spans, cum = timed_read("chunk_spans", fetch)
    parts, schema_chunk = [], None
    row = torch.arange(counts.shape[0], device=dev)
    for (s, e) in spans:
        span_total = int(cum[e] - cum[s])
        if span_total == 0:
            continue
        cand = bucket_len(span_total)
        l_idx, r_idx = _pair_indices(counts, lo, order, cand, plen_r,
                                     (row >= s) & (row < e))
        ok = _verify_pairs(l_idx, r_idx, left_keys, right_keys)
        ok = ok & live_mask(cand, span_total, dev)
        raw = DeviceTable(
            {**gather_table_rows(left, l_idx, cand).columns,
             **gather_table_rows(right, r_idx, cand).columns}, cand)
        schema_chunk = raw
        if residual_fn is not None:
            ok = ok & residual_fn(raw)
        n_live = host_sync(ok.sum())                   # host sync per span
        if n_live == 0:
            continue
        keep = compact_indices(ok, n_live)
        parts.append(take_padded(raw, keep, n_live))
    if not parts:
        empty = torch.zeros(bucket_len(0), dtype=I64, device=dev)
        return take_padded(schema_chunk, empty + schema_chunk.plen, 0)
    return concat_tables(parts) if len(parts) > 1 else parts[0]


def join_tables(left: DeviceTable, right: DeviceTable, left_on, right_on,
                how: str = "inner", l_excl=None, r_excl=None,
                residual_fn=None) -> DeviceTable:
    """Materialized equi-join of two tables; column name collisions must be
    resolved by the caller. ``residual_fn`` (inner joins) maps a
    materialized pair table to a keep mask."""
    left_keys = [left[c] for c in left_on]
    right_keys = [right[c] for c in right_on]
    probe = None
    if how == "inner":
        probe = _probe_candidates(left_keys, right_keys,
                                  n_left=left.nrows, n_right=right.nrows,
                                  l_excl=l_excl, r_excl=r_excl)
        if probe[3] > PAIR_BUDGET:
            return _chunked_inner_join(left, right, left_keys, right_keys,
                                       probe, residual_fn)
    l_idx, r_idx, n_pairs, l_extra, n_lx, r_extra, n_rx = join_indices(
        left_keys, right_keys, how,
        n_left=left.nrows, n_right=right.nrows,
        l_excl=l_excl, r_excl=r_excl, probe=probe)
    matched = DeviceTable(
        {**gather_table_rows(left, l_idx, n_pairs).columns,
         **gather_table_rows(right, r_idx, n_pairs).columns}, n_pairs)
    if residual_fn is not None and how == "inner":
        mask = residual_fn(matched) & live_mask(matched.plen, n_pairs,
                                                l_idx.device)
        matched = compact_table(matched, mask)
    parts = [matched]
    if l_extra is not None and n_lx:
        cols = dict(gather_table_rows(left, l_extra, n_lx).columns)
        cols.update({n: _null_column_like(c, int(l_extra.shape[0]))
                     for n, c in right.columns.items()})
        parts.append(DeviceTable(cols, n_lx))
    if r_extra is not None and n_rx:
        cols = {n: _null_column_like(c, int(r_extra.shape[0]))
                for n, c in left.columns.items()}
        cols.update(gather_table_rows(right, r_extra, n_rx).columns)
        parts.append(DeviceTable(cols, n_rx))
    return concat_tables(parts) if len(parts) > 1 else matched


# ---------------------------------------------------------------------------
# concatenation (UNION ALL) with dictionary merging
# ---------------------------------------------------------------------------


_union_cache: dict = {}


def _align_str_dicts(cols):
    """(per-part code tensors, shared dictionary) for string columns whose
    dictionaries may differ: remap every part's codes into one merged
    value table (identity fast path when all parts share one dictionary).
    The merged dictionary is cached per input-dictionary identity tuple so
    repeated executions hand out the SAME host object."""
    dicts = [c.dict_values for c in cols]
    if all(d is dicts[0] for d in dicts):
        return [c.data for c in cols], dicts[0]

    def compute():
        union, inverse = np.unique(
            np.concatenate([d.astype(str) for d in dicts]),
            return_inverse=True)
        maps, off = [], 0
        for d in dicts:
            maps.append(inverse[off:off + len(d)].astype(np.int32))
            off += len(d)
        return maps, union.astype(object)

    maps, union = _identity_cache(_union_cache, 256, tuple(dicts), compute)
    return [prim.take(host_table(m, c.data.device), c.data)
            for m, c in zip(maps, cols)], union


def _align_encodings(cols):
    """Decode parts whose encodings differ; identical encodings
    concatenate narrow and stay encoded."""
    enc0 = cols[0].enc
    if all(encs_equal(c.enc, enc0) for c in cols) and \
            len({c.data.dtype for c in cols}) == 1:
        return cols, enc0
    return [plain_col(c) for c in cols], None


def concat_columns(cols) -> Column:
    kind = cols[0].kind
    if kind == "str":
        datas, dict_values = _align_str_dicts(cols)
        data = torch.cat(datas)
        valid = _concat_valids(cols)
        return Column("str", data.to(torch.int32), valid, dict_values)
    cols, enc = _align_encodings(cols)
    data = torch.cat([c.data for c in cols])
    return Column(kind, data, _concat_valids(cols), enc=enc)


def _concat_valids(cols):
    if all(c.valid is None for c in cols):
        return None
    return torch.cat([c.valid_mask() for c in cols])


def concat_tables(tables) -> DeviceTable:
    """UNION ALL. Physical concatenation interleaves each part's pad rows, so
    the result is re-compacted back to prefix-padded form; the logical counts
    are resolved on host (all parts in one batched transfer)."""
    names = tables[0].column_names
    total = sum(count_int(t.nrows) for t in tables)
    if not names:
        return DeviceTable({}, total, plen=max(bucket_len(total), total))
    out = {}
    for n in names:
        cols = [t[n] for t in tables]
        kind = cols[0].kind
        enc = None
        if kind == "str":
            datas, dict_values = _align_str_dicts(cols)
        else:
            cols, enc = _align_encodings(cols)
            datas, dict_values = [c.data for c in cols], None
        d = torch.cat(datas)
        if kind == "str":
            d = d.to(torch.int32)
        v = None if all(c.valid is None for c in cols) else \
            torch.cat([c.valid_mask() for c in cols])
        out[n] = Column(kind, d, v, dict_values, enc)
    dev = out[names[0]].data.device
    live = torch.cat([torch.arange(t.plen, device=dev) < count_int(t.nrows)
                      for t in tables])
    raw = DeviceTable(out, total)
    # fast path only when the summed physical length is itself a bucket
    if total == int(live.shape[0]) and total == bucket_len(total):
        return raw                                    # no pads anywhere
    idx = compact_indices(live, total)
    return take_padded(raw, idx, total)


# ---------------------------------------------------------------------------
# sort / limit
# ---------------------------------------------------------------------------


def limit_table(table: DeviceTable, n: int) -> DeviceTable:
    """First ``n`` logical rows (callers sort first; pads always trail).
    LIMIT is output-shaping: a lazy count legitimately resolves here."""
    new_n = min(n, count_int(table.nrows))
    cap = bucket_len(new_n)
    if cap >= table.plen:
        return DeviceTable(dict(table.columns), new_n)
    dev = next(iter(table.columns.values())).data.device \
        if table.columns else device()
    return gather_table_rows(table, torch.arange(cap, device=dev), new_n)
