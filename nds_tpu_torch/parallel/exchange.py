# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The exchange: shards, their collectives and the repartition join.

A shard is one slice of the rows and the device it lives on. A
:class:`Mesh` is the ordered tuple of shard devices plus an axis name; a
device may repeat, so several shards can share one card (or the CPU). The
per-shard body of every sharded program here is explicit: a loop over the
shards, each working on its own slice on its own device, with the
collectives between them written out:

* ``all_to_all``: slice ``d`` of every source shard's send buffer lands on
  shard ``d``; each slice is copied to its destination's device without
  blocking, and between shards on one device the exchange is an index
  gather (one stack and a transpose);
* ``psum``: the shards' values summed on the first shard's device, the sum
  copied back to every shard;
* ``all_gather``: the shards' values concatenated the same way.

A mesh may span processes (multihost federation,
``parallel/multihost.py``): its shards are ordered by rank, then by local
shard, each process holds only its own shards, and every collective here
takes a process-group arm (``torch.distributed``: ``all_to_all``,
``all_reduce``, ``all_gather``; gloo on the CPU, NCCL on cuda) after the
local shards met on the process's first shard device. Both arms count
their collectives alike.

Static shapes carry over from the exchange's design: each shard packs its
rows into a ``(P, capacity)`` buffer slotted by destination, with a
validity plane marking real rows. A full bucket drops rows on the device
and reports the deficit, so the caller can retry with a bigger capacity.

Grouped sums here (:func:`sharded_filter_agg_step`, and the per-shard
aggregates of ``distributed.py``) are ``prim.segment_sum``, an
``index_add_``: the reference's are ``jax.ops.segment_sum``, not Pallas
kernels, so none of K1-K3 stands in for them.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from nds_tpu_torch.engine import prim

I64 = torch.int64

# ---------------------------------------------------------------------------
# collective accounting: every collective this module or the sharded
# streamed pipeline (engine/stream.py) issues notes its kind and the bytes
# one shard sends, into the innermost active trace of the calling thread
# ---------------------------------------------------------------------------

_coll_tls = threading.local()


class _CollectiveTrace:
    def __enter__(self):
        self._prev = getattr(_coll_tls, "counts", None)
        self.counts = {"a2a": 0, "psum": 0, "all_gather": 0, "bytes": 0}
        _coll_tls.counts = self.counts
        return self

    def __exit__(self, *exc):
        _coll_tls.counts = self._prev


def collective_trace():
    """Context collecting the collectives (and their bytes) issued while
    it is open on the calling thread."""
    return _CollectiveTrace()


def _note_collective(kind: str, n: int = 1, nbytes: int = 0) -> None:
    c = getattr(_coll_tls, "counts", None)
    if c is not None:
        c[kind] += n
        c["bytes"] += int(nbytes)


def collective_ops(counts) -> int:
    """Collective count of a trace's ``counts`` (0 for None)."""
    return (counts["a2a"] + counts["psum"] + counts["all_gather"]) \
        if counts else 0


# ---------------------------------------------------------------------------
# the mesh and sharded tensors
# ---------------------------------------------------------------------------


class Mesh:
    """A 1-D mesh: this process's shard devices in shard order (a device
    may repeat: shards that share a card) and the axis name. A mesh that
    spans processes (``world`` > 1, over the default ``torch.distributed``
    group) has ``len(devices)`` shards in every process, ordered by
    ``rank`` and then by local shard."""

    __slots__ = ("devices", "axis", "rank", "world")

    def __init__(self, devices, axis: str = "part", rank: int = 0,
                 world: int = 1):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis = axis
        self.rank, self.world = int(rank), int(world)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        """The shard count over every process."""
        return len(self.devices) * self.world

    @property
    def first(self) -> int:
        """The global index of this process's first shard."""
        return self.rank * len(self.devices)

    def one_device(self) -> bool:
        """Every shard on one device (of one process)."""
        return self.world == 1 and len(set(self.devices)) == 1

    def key(self) -> tuple:
        """What identifies the mesh in a cache key."""
        return (tuple(str(d) for d in self.devices), self.axis, self.rank,
                self.world)

    def __repr__(self):
        procs = f", rank {self.rank} of {self.world}" if self.world > 1 \
            else ""
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis!r}{procs})"


class Sharded:
    """A tensor laid over a mesh: ``parts[s]`` lives on ``mesh.devices[s]``.
    ``spec`` is ``"row"`` (a contiguous row split, shard order) or
    ``"rep"`` (a whole copy on every shard). On a mesh that spans
    processes, ``parts`` are this process's shards only."""

    __slots__ = ("parts", "mesh", "spec")

    def __init__(self, parts, mesh: Mesh, spec: str = "row"):
        if len(parts) != len(mesh.devices):
            raise ValueError(f"{len(parts)} parts for a mesh of "
                             f"{len(mesh.devices)} local shards")
        self.parts, self.mesh, self.spec = list(parts), mesh, spec

    @property
    def shape(self) -> tuple:
        """The shape of this process's share (the whole tensor's on a
        mesh of one process)."""
        if self.spec == "rep":
            return tuple(self.parts[0].shape)
        return (sum(int(p.shape[0]) for p in self.parts),
                *self.parts[0].shape[1:])

    def gather(self) -> torch.Tensor:
        """The whole tensor on the first shard's device (the row parts
        concatenated in shard order, across processes too; a replicated
        tensor's first copy)."""
        if self.spec == "rep":
            return self.parts[0]
        return gather_rows(self.parts, self.mesh)


def local_devices(kind: str = "cuda") -> list:
    """This process's devices of ``kind``: every visible card, or the one
    CPU device."""
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(n_devices: int | None = None, axis: str = "part",
              device=None, share: bool = False) -> Mesh:
    """1-D mesh over the row-partition axis, on the local devices of
    ``device``'s kind (default ``cuda``; raises without a GPU). Without
    ``share`` each shard takes its own device, and asking for more shards
    than devices raises; with ``share`` shard ``s`` takes local device
    ``s mod count``, so shards may share a card (the counterpart of a
    virtual multi-device mesh on one host)."""
    from nds_tpu_torch import resolve_device
    kind = resolve_device(device).type
    devs = local_devices(kind)
    n = len(devs) if n_devices is None else int(n_devices)
    if share:
        return Mesh([devs[i % len(devs)] for i in range(n)], axis)
    if n > len(devs):
        raise ValueError(f"make_mesh: {n} shards need {n} {kind} devices, "
                         f"this process has {len(devs)}; pass share=True "
                         "to let shards share a device")
    return Mesh(devs[:n], axis)


def stream_mesh_axis() -> str:
    """The streamed pipeline's mesh axis name (the session mesh's axis is
    ``part``; a streamed pipeline's is ``shard``)."""
    return "shard"


# the streamed pipelines' meshes: concurrent Throughput streams building
# sharded pipelines share them, so an insert takes the lock (double-checked;
# building a Mesh is plain host object construction)
_STREAM_MESHES: dict = {}
_MESH_LOCK = threading.Lock()
# whether a streamed pipeline's shards may share a device: no setting a
# user can reach, only the seam :func:`sharing_devices`, for the tests and
# the chip smoke that run a sharded pipeline on one card or the CPU (shards
# sharing one device do the same work plus the exchange)
_share_devices = False


@contextlib.contextmanager
def sharing_devices(on: bool = True):
    """Context: the sharded streamed pipelines built inside it may put
    several shards on one device (shard ``s`` on local device ``s mod
    count``), and the meshed sessions built inside it put every shard on
    the session's own device: the counterpart of the reference tests'
    virtual multi-device mesh on one host, the same layout on a host of
    any number of cards. Process-wide, for tests and smoke drives."""
    global _share_devices
    prev, _share_devices = _share_devices, bool(on)
    try:
        yield
    finally:
        _share_devices = prev


def sharing() -> bool:
    """Whether the calling code runs inside :func:`sharing_devices`."""
    return _share_devices


def stream_mesh(n_shards: int, device, share: bool | None = None,
                axis: str | None = None) -> Mesh | None:
    """The local mesh a sharded streamed pipeline runs over: ``n_shards``
    distinct devices of ``device``'s kind, or, with ``share`` (default:
    inside :func:`sharing_devices`), shards that share them. None when
    this process has fewer than ``n_shards`` devices and sharing was not
    asked for (the pipeline then builds unsharded)."""
    share = _share_devices if share is None else share
    axis = axis or stream_mesh_axis()
    kind = torch.device(device).type
    key = (int(n_shards), kind, bool(share), axis)
    m = _STREAM_MESHES.get(key)
    if m is None:
        devs = local_devices(kind)
        if not devs or (len(devs) < n_shards and not share):
            return None
        with _MESH_LOCK:
            m = _STREAM_MESHES.get(key)
            if m is None:
                m = _STREAM_MESHES[key] = Mesh(
                    [devs[i % len(devs)] for i in range(int(n_shards))],
                    axis)
    return m


def mesh_of(*arrays) -> Mesh | None:
    """The >1-shard mesh a set of arrays is row-sharded over, or None."""
    for a in arrays:
        if isinstance(a, Sharded) and a.mesh.size > 1 and a.spec == "row":
            return a.mesh
    return None


def split_rows(x, mesh: Mesh) -> Sharded:
    """A whole tensor (or a Sharded one, returned as is) split into
    ``mesh.size`` contiguous row parts, this process's each on its shard's
    device. The row count must divide evenly."""
    if isinstance(x, Sharded):
        return x
    x = torch.as_tensor(x)
    n, S = int(x.shape[0]), mesh.size
    if n % S:
        raise ValueError(f"{n} rows do not split evenly over {S} shards")
    step = n // S
    return Sharded([x[g * step:(g + 1) * step].to(d, non_blocking=True)
                    for g, d in enumerate(mesh.devices, mesh.first)], mesh)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _nbytes(t) -> int:
    return int(t.numel()) * t.element_size()


def psum_counted(parts, mesh: Mesh) -> list:
    """``psum``: the shards' tensors summed, one copy per shard (counted)."""
    _note_collective("psum", 1, _nbytes(parts[0]))
    return _replicated(_reduce(parts, mesh, torch.add, "sum"), mesh)


def pmax(parts, mesh: Mesh) -> list:
    """Elementwise max over the shards, one copy per shard (not counted,
    as the reference's ``pmax`` is not)."""
    return _replicated(_reduce(parts, mesh, torch.maximum, "max"), mesh)


def all_gather_counted(parts, mesh: Mesh) -> list:
    """``all_gather`` (tiled): the shards' tensors concatenated in shard
    order, one copy per shard (counted)."""
    _note_collective("all_gather", 1, _nbytes(parts[0]))
    return _replicated(gather_rows(parts, mesh), mesh)


def gather_rows(parts, mesh: Mesh) -> torch.Tensor:
    """This process's row parts concatenated in shard order on its first
    shard device and, on a mesh that spans processes, every process's
    concatenated in rank order (an all-gather of parts whose lengths may
    differ). Not counted: the callers count."""
    dev = mesh.devices[0]
    whole = torch.cat([p.to(dev, non_blocking=True) for p in parts])
    if mesh.world == 1:
        return whole
    return _pg_all_gather(whole, mesh)


def _reduce(parts, mesh: Mesh, op, pg_op: str):
    dev = mesh.devices[0]
    out = parts[0].to(dev, non_blocking=True)
    for p in parts[1:]:
        out = op(out, p.to(dev, non_blocking=True))
    if mesh.world > 1:
        out = _pg_all_reduce(out, pg_op)
    return out


# ---------------------------------------------------------------------------
# the process-group arm (a mesh that spans processes)
# ---------------------------------------------------------------------------


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A tensor as the collectives carry it: bool travels as uint8."""
    return t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()


def _pg_all_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    import torch.distributed as dist
    w = _wire(t).clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX)
    return w.to(t.dtype)


def _pg_all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every process's ``t`` concatenated in rank order. The lengths meet
    first (one small all-gather, read through the host-read choke point);
    each process then sends its rows padded to the longest."""
    import torch.distributed as dist
    from nds_tpu_torch.engine.ops import timed_read
    n = torch.tensor([int(t.shape[0])], dtype=I64, device=t.device)
    ns = [torch.zeros_like(n) for _ in range(mesh.world)]
    dist.all_gather(ns, n)
    sizes = timed_read("mesh_rows",
                       lambda: [int(x) for x in torch.cat(ns).tolist()])
    cap = max(max(sizes), 1)
    w = _wire(t)
    if int(w.shape[0]) < cap:
        w = torch.cat([w, w.new_zeros((cap - int(w.shape[0]),
                                       *w.shape[1:]))])
    outs = [torch.empty_like(w) for _ in range(mesh.world)]
    dist.all_gather(outs, w)
    return torch.cat([o[:k] for o, k in zip(outs, sizes)]).to(t.dtype)


def _pg_all_to_all(plane, mesh: Mesh) -> list:
    """The all-to-all over processes of one plane: ``plane[i]`` is local
    shard ``i``'s ``(S, capacity)`` send buffer. Process ``q`` receives
    the rows of its own shards from every process; returns per local
    destination shard its ``(S, capacity)`` receive buffer, row ``g``
    what global shard ``g`` sent, on the shard's device."""
    import torch.distributed as dist
    L, W = len(mesh.devices), mesh.world
    dev = mesh.devices[0]
    x = torch.stack([p.to(dev, non_blocking=True) for p in plane])
    w = _wire(x)                                   # (L src, S dst, cap)
    sends = [w[:, q * L:(q + 1) * L].contiguous() for q in range(W)]
    recvs = [torch.empty_like(t) for t in sends]
    dist.all_to_all(recvs, sends)
    got = torch.cat(recvs).to(x.dtype)             # (S src, L dst, cap)
    return [got[:, j].to(d, non_blocking=True)
            for j, d in enumerate(mesh.devices)]


def _replicated(t, mesh: Mesh) -> list:
    return [t.to(d, non_blocking=True) for d in mesh.devices]


def all_to_all_exchange(bufs, valid, mesh: Mesh):
    """The all-to-all: bucket ``d`` of every shard lands on shard ``d``.

    ``bufs[s]`` maps a name to shard ``s``'s ``(P, capacity)`` send buffer,
    ``valid[s]`` is its validity plane. Returns ``(out, vout)``, per
    destination shard: ``out[d][name]`` and ``vout[d]`` of shape
    ``(P, capacity)``, row ``s`` the bucket shard ``s`` sent; every row of
    them shares shard ``d``'s key range. On a mesh that spans processes,
    ``bufs`` and the outputs are this process's shards'."""
    S = mesh.size
    names = list(bufs[0])
    _note_collective("a2a", len(names) + 1,
                     sum(_nbytes(bufs[0][n]) for n in names)
                     + _nbytes(valid[0]))
    planes = [[b[n] for b in bufs] for n in names] + [list(valid)]
    got = []
    if mesh.world > 1:
        got = [_pg_all_to_all(plane, mesh) for plane in planes]
    elif mesh.one_device():
        # one device: the exchange is an index gather
        for plane in planes:
            t = torch.stack(plane).transpose(0, 1)
            got.append([t[d] for d in range(S)])
    else:
        for plane in planes:
            got.append([torch.stack([plane[s][d].to(mesh.devices[d],
                                                    non_blocking=True)
                                     for s in range(S)])
                        for d in range(S)])
    out = [{n: got[i][d] for i, n in enumerate(names)}
           for d in range(len(mesh.devices))]
    return out, got[-1]


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------


def hash_partition_dest(key: torch.Tensor, n_parts: int) -> torch.Tensor:
    """Destination partition of each row: the key's bits (uint64 in int64)
    mixed, then mod ``n_parts`` as an unsigned number (int64)."""
    from nds_tpu_torch.engine.ops import _mix64
    x = _mix64(key.to(I64))
    n = int(n_parts)
    if n & (n - 1) == 0:
        return x & (n - 1)
    low = (x & prim.I64_MAX) % n
    high = (1 << 63) % n
    return torch.where(x < 0, (low + high) % n, low)


def grid_slots(sd, pos, n_parts: int, capacity: int):
    """Flat slot of each (bucket, position) pair; pairs outside the
    ``(n_parts, capacity)`` grid go to one spare slot past its end."""
    inside = (sd >= 0) & (sd < n_parts) & (pos >= 0) & (pos < capacity)
    spare = torch.full((), n_parts * capacity, dtype=I64, device=sd.device)
    return torch.where(inside, sd * capacity + pos, spare)


def scatter_grid(slot, vals, n_parts: int, capacity: int):
    """``zeros((n_parts, capacity)).at[sd, pos].set(vals, mode="drop")``
    through the flat slots of :func:`grid_slots`."""
    grid = torch.zeros(n_parts * capacity + 1, dtype=vals.dtype,
                       device=vals.device)
    grid[slot] = vals
    return grid[:-1].reshape(n_parts, capacity)


def bucket_positions(dest):
    """``(order, sorted dest, position in its bucket)`` of a stable sort by
    destination."""
    order = prim.argsort_stable(dest)
    sd = dest[order]
    first = prim.searchsorted(sd, sd)
    pos = torch.arange(dest.shape[0], device=dest.device) - first
    return order, sd, pos


def bucketize(dest: torch.Tensor, cols: dict, n_parts: int, capacity: int):
    """Pack rows into per-destination send buffers.

    Returns ``(buffers, valid, overflow)``: ``buffers[name]`` is ``(P,
    capacity)`` with rows grouped by destination in their original order,
    ``valid`` marks occupied slots, ``overflow`` (a 0-d device tensor)
    counts rows dropped because their bucket was full."""
    order, sd, pos = bucket_positions(dest)
    fits = pos < capacity
    overflow = (~fits).sum()
    slot = grid_slots(sd, pos, n_parts, capacity)
    valid = scatter_grid(slot, fits, n_parts, capacity)
    bufs = {}
    for name, arr in cols.items():
        v = arr[order]
        bufs[name] = scatter_grid(
            slot, torch.where(fits, v, torch.zeros((), dtype=v.dtype,
                                                   device=v.device)),
            n_parts, capacity)
    return bufs, valid, overflow


def sharded_filter_agg_step(mesh: Mesh, num_groups: int, capacity: int):
    """The partitioned filter -> exchange -> aggregate step: each shard
    filters its rows (``lo <= sold <= hi``; a dead row keeps its slot at
    weight 0), routes them by group-key hash through the all-to-all so it
    owns a key range, sums its rows per group, and a ``psum`` of the group
    counts checks that no row was lost. Returns a function of row-sharded
    ``group_key``, ``qty``, ``sold`` (tensors split evenly, or
    :class:`Sharded`) and the bounds:

        -> (sums: Sharded, G a shard; counts int64[G]; total)

    ``counts`` and ``total`` on the first shard's device."""
    S, L = mesh.size, len(mesh.devices)

    def step(group_key, qty, sold, lo, hi):
        gk, q, sd = (split_rows(x, mesh) for x in (group_key, qty, sold))
        bufs, valid = [], []
        for s in range(L):
            keep = (sd.parts[s] >= lo) & (sd.parts[s] <= hi)
            dest = hash_partition_dest(gk.parts[s], S)
            w = torch.where(keep, q.parts[s],
                            torch.zeros((), dtype=q.parts[s].dtype,
                                        device=q.parts[s].device))
            b, v, _ = bucketize(dest, {"key": gk.parts[s], "w": w}, S,
                                capacity)
            bufs.append(b)
            valid.append(v)
        ex, vex = all_to_all_exchange(bufs, valid, mesh)
        sums, counts, totals = [], [], []
        for d in range(L):
            keys = ex[d]["key"].reshape(-1)
            wts = ex[d]["w"].reshape(-1)
            vflat = vex[d].reshape(-1)
            gids = keys.clamp(0, num_groups - 1).to(I64)
            zero = torch.zeros((), dtype=wts.dtype, device=wts.device)
            w_live = torch.where(vflat, wts, zero)
            sums.append(prim.segment_sum(w_live, gids, num_groups))
            ones = torch.where(vflat, torch.ones_like(wts),
                               torch.zeros_like(wts))
            counts.append(prim.segment_sum(ones, gids, num_groups))
            totals.append(w_live.sum())
        return (Sharded(sums, mesh), psum_counted(counts, mesh)[0],
                psum_counted(totals, mesh)[0])

    return step


# ---------------------------------------------------------------------------
# the repartition join
# ---------------------------------------------------------------------------


def _pow2(n: int) -> int:
    p = 16
    while p < n:
        p *= 2
    return p


def _exchange_join_step(mesh: Mesh, cap_in: int, pair_cap: int):
    """The repartition join's per-shard program: bucket both sides' (hash,
    global row id) pairs by destination, exchange them so equal hashes
    share a shard, then probe locally and emit the matched row-id pairs at
    a fixed capacity. Returns a function of row-sharded ``lh``, ``lrow``,
    ``rh``, ``rrow`` giving per-shard ``(l_out, r_out, pair_live)`` lists
    and the device overflow counters ``[left bucket deficit, right bucket
    deficit, pair deficit]`` (the max over the shards)."""
    from nds_tpu_torch.engine.ops import unsigned_order
    S, L = mesh.size, len(mesh.devices)

    def side(h, row):
        dev = h.device
        # bit 2 marks a real (matchable) hash; dead rows route to bucket
        # S, past the last real one, so the sorted destinations stay a
        # valid searchsorted haystack and the dead rows drop out of both
        # the scatter and the bucket counts
        real = (h & 4) != 0
        dest = torch.where(real, hash_partition_dest(h, S),
                           torch.full((), S, dtype=I64, device=dev))
        order, sd, pos = bucket_positions(dest)
        sreal = real[order]
        fits = (pos < cap_in) & sreal
        # the deficit (not the count): one retry sizes the capacity even
        # under quadratic key skew
        bucket_counts = prim.segment_sum(sreal.to(I64), sd, S)
        over = (bucket_counts.max() - cap_in).clamp(min=0)
        slot = grid_slots(sd, pos, S, cap_in)
        valid = scatter_grid(slot, fits, S, cap_in)
        bufs = {}
        for name, arr in (("h", h[order]), ("row", row[order])):
            zero = torch.zeros((), dtype=arr.dtype, device=dev)
            bufs[name] = scatter_grid(slot, torch.where(fits, arr, zero),
                                       S, cap_in)
        return bufs, valid, over

    def probe(lhx, lrx, lvx, rhx, rrx, rvx):
        # equal hashes are now on this shard: sort the right side's hashes
        # in unsigned order (invalid slots hash 0, the smallest; invalid
        # left slots hash 1, which nothing real matches)
        dev = lhx.device
        m = rhx.shape[0]
        rh_key = unsigned_order(torch.where(
            rvx, rhx, torch.zeros((), dtype=I64, device=dev)))
        rorder = prim.argsort_stable(rh_key)
        rh_sorted = rh_key[rorder]
        lh_key = unsigned_order(torch.where(
            lvx, lhx, torch.ones((), dtype=I64, device=dev)))
        lo = prim.searchsorted(rh_sorted, lh_key)
        hi = prim.searchsorted(rh_sorted, lh_key, right=True)
        counts = torch.where(lvx, hi - lo, torch.zeros((), dtype=I64,
                                                       device=dev))
        total = counts.sum()
        l_pos = prim.repeat_total(torch.arange(m, device=dev), counts,
                                  pair_cap)
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.arange(pair_cap, device=dev)
        pos = slot - prim.repeat_total(starts, counts, pair_cap)
        r_pos = prim.repeat_total(lo, counts, pair_cap) + pos
        pair_live = slot < torch.minimum(total, torch.full(
            (), pair_cap, dtype=I64, device=dev))
        l_out = prim.take_clip(lrx, l_pos)
        r_out = prim.take_clip(rrx, prim.take_clip(
            rorder, r_pos.clamp(0, m - 1)))
        p_over = (total - pair_cap).clamp(min=0)
        return l_out, r_out, pair_live, p_over

    def step(lh, lrow, rh, rrow):
        lh, lrow, rh, rrow = (split_rows(x, mesh)
                              for x in (lh, lrow, rh, rrow))
        sent = {}
        for name, (h, row) in (("l", (lh, lrow)), ("r", (rh, rrow))):
            got = [side(h.parts[s], row.parts[s]) for s in range(L)]
            ex, vex = all_to_all_exchange([g[0] for g in got],
                                          [g[1] for g in got], mesh)
            sent[name] = (ex, vex, [g[2] for g in got])
        outs, overs = [], []
        for d in range(L):
            (lex, lvex, lover), (rex, rvex, rover) = sent["l"], sent["r"]
            l_out, r_out, live, p_over = probe(
                lex[d]["h"].reshape(-1), lex[d]["row"].reshape(-1),
                lvex[d].reshape(-1), rex[d]["h"].reshape(-1),
                rex[d]["row"].reshape(-1), rvex[d].reshape(-1))
            outs.append((l_out, r_out, live))
            dev = mesh.devices[d]
            overs.append(torch.stack([lover[d].to(dev), rover[d].to(dev),
                                      p_over]))
        return outs, pmax(overs, mesh)[0]

    return step


# capacity retries of the repartition join in this process (each one is
# reported to the failure listeners as well)
CAPACITY_RETRIES = [0]


def exchange_join_pairs(lh, lrow, rh, rrow, mesh: Mesh):
    """Repartition (all-to-all) join of two row-sharded hash columns.

    Returns ``(l_idx, r_idx, pair_live)`` on the first shard's device: the
    row-id pairs whose hashes matched, shard by shard at a fixed capacity,
    with a validity mask (on a mesh that spans processes, the pairs of
    this process's shards). When a bucket or the pair buffer overflowed
    (the counters come back through the one host-read choke point) the
    join runs again with the capacities grown by the reported deficit,
    and the retry is reported to the run's failure listeners."""
    from nds_tpu_torch.engine.ops import timed_read
    from nds_tpu_torch.listener import report_task_failure
    S = mesh.size
    n_l, n_r = int(lh.shape[0]), int(rh.shape[0])
    if mesh.world > 1:
        # every process sizes the same buffers: the rows of all of them
        rows = _pg_all_reduce(torch.tensor(
            [n_l, n_r], dtype=I64, device=mesh.devices[0]), "sum")
        n_l, n_r = timed_read("exch_rows",
                              lambda: tuple(int(x) for x in rows.tolist()))
    # expected rows a (shard, destination) bucket with 2x slack
    cap_in = _pow2(max(n_l, n_r) * 2 // (S * S) + 16)
    pair_cap = _pow2(max(n_l, n_r) * 2 // S + 16)
    for _ in range(5):
        outs, overs = _exchange_join_step(mesh, cap_in, pair_cap)(
            lh, lrow, rh, rrow)
        lo, ro, po = timed_read(
            "exch_overs", lambda: tuple(int(x) for x in overs.tolist()))
        if lo == 0 and ro == 0 and po == 0:
            dev = mesh.devices[0]
            return tuple(torch.cat([o[i].to(dev, non_blocking=True)
                                    for o in outs]) for i in range(3))
        if lo or ro:
            cap_in = _pow2(cap_in + max(lo, ro))
        if po:
            pair_cap = _pow2(pair_cap + po)
        CAPACITY_RETRIES[0] += 1
        report_task_failure(
            "exchange join capacity retry",
            f"bucket deficit l={lo} r={ro}, pair deficit {po}; "
            f"retrying with cap_in={cap_in}, pair_cap={pair_cap}")
    raise RuntimeError("exchange join: capacity retry limit exceeded")
