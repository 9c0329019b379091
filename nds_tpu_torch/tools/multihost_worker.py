# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""One process of a multihost federation of the port.

Launch it once per process, from the repository root:

    NDS_TPU_MULTIHOST=1 NDS_COORDINATOR=localhost:<port> \\
    NDS_NUM_PROCESSES=2 NDS_PROCESS_ID=<i> \\
    python -m nds_tpu_torch.tools.multihost_worker [--device cpu|cuda]

The device defaults to cuda, and without a GPU the worker refuses to run
unless given ``--device cpu``.

Each process holds shards of the session mesh: on the CPU four, sharing
its one device (``sharing_devices()``); on cuda one on each of its cards,
so give every process its own cards
(``CUDA_VISIBLE_DEVICES``): NCCL refuses two ranks on one card. The
collectives cross processes through gloo on the CPU and NCCL on cuda.

Three arms:

1. three statements through a meshed Session over row-sharded tables:
   an aggregation (scan, filter, group, sort), whose filter runs shard by
   shard in each process and whose gather before the aggregate crosses
   processes, and two joins of two row-sharded tables, which take the
   repartition join across processes (one matching more pairs than a
   side has rows, one fewer);
2. the repartition join's pairs (``exchange_join_pairs``) driven directly
   over the session mesh, the pair count summed over the processes;
3. a streamed template through the compiled chunk pipeline sharded over
   each process's own shards (``stream_shards`` 2) while the federation
   is live.

Rank 0 prints one JSON line with the three arms' results and, beside
them, the same arms run in this one process without a mesh
(:func:`expected`); ``"ok"`` says whether every arm gave the
single-process rows bit for bit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

SQL = ("select a_k, count(*) c, sum(a_v) s from a "
       "where a_v < 500 group by a_k order by a_k")
# two row-sharded sides: the repartition join, across the processes; on
# the group key alone it matches far more pairs than a side has rows (each
# side gathers whole), on both columns far fewer (each shard hands over
# just its matched rows)
JOIN_SQL = ("select a_k, count(*) c, sum(a_v + b_v) s from a, b "
            "where a_k = b_k and a_v < b_v group by a_k order by a_k")
FETCH_SQL = ("select a_k, count(*) c, sum(a_v) s from a, b "
             "where a_k = b_k and a_v = b_v group by a_k order by a_k")
STATEMENTS = (SQL, JOIN_SQL, FETCH_SQL)
# the broadcast threshold that row-shards the aggregation arm's tables
BROADCAST_BYTES = 2048
# shards in each process on the CPU (they share its one device); on cuda
# a process takes a shard on each of its cards
CPU_SHARDS = 4

# the exchange arm's key distribution
EXCHANGE_SEED, EXCHANGE_N, EXCHANGE_KEYS = 3, 4096, 200

STREAM_SQL = ("select f_k, count(*) c, sum(f_v) s from f "
              "where f_v > 100 group by f_k order by f_k")
STREAM_CHUNK_ROWS, STREAM_SHARDS = 2048, 2


def make_tables() -> dict:
    """The aggregation arm's tables, the same in every process (every
    process of a federation presents the same global data)."""
    import pyarrow as pa
    rng = np.random.default_rng(11)
    n = 4096
    return {p: pa.table({
        f"{p}_k": pa.array(rng.integers(0, 40, n), pa.int64()),
        f"{p}_v": pa.array(rng.integers(0, 1000, n), pa.int64()),
    }) for p in ("a", "b")}


def _sql_rows(sess) -> list:
    return [[list(r) for r in sess.sql(q).collect()]
            for q in STATEMENTS]


def exchange_keys() -> np.ndarray:
    return np.random.default_rng(EXCHANGE_SEED).integers(
        0, EXCHANGE_KEYS, EXCHANGE_N)


def expected_pairs() -> int:
    """The self-join's pair count: the sum over keys of count squared."""
    return int(sum(int(c) ** 2 for c in np.bincount(exchange_keys())))


def make_stream_table():
    """The streamed arm's fact table (4 chunks of STREAM_CHUNK_ROWS)."""
    import pyarrow as pa
    rng = np.random.default_rng(7)
    n = 8192
    return pa.table({
        "f_k": pa.array(rng.integers(0, 25, n), pa.int64()),
        "f_v": pa.array(rng.integers(0, 1000, n), pa.int64()),
    })


def _stream_session(device, shards: int):
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.engine.table import ChunkedTable
    conf = {"stream_chunk_rows": STREAM_CHUNK_ROWS}
    if shards > 1:
        conf["stream_shards"] = shards
    s = Session(conf, device=device)
    s.create_temp_view("f", ChunkedTable(make_stream_table(),
                                         chunk_rows=STREAM_CHUNK_ROWS),
                       base=True)
    return s


def expected(device) -> dict:
    """The aggregation and streamed arms in this process without a mesh
    or shards, and the exchange arm's pair count from the keys."""
    from nds_tpu_torch.engine.session import Session
    s = Session(device=device)
    for name, t in make_tables().items():
        s.create_temp_view(name, t)
    return {"rows": _sql_rows(s),
            "pairs": expected_pairs(),
            "streamRows": [list(r) for r in
                           _stream_session(device, 1).sql(STREAM_SQL)
                           .collect()]}


def exchange_arm(mesh) -> int:
    """The self-join of the exchange keys over ``mesh``: every returned
    pair is checked to match, and the live pairs are summed over the
    processes."""
    import torch
    import torch.distributed as dist

    from nds_tpu_torch.parallel.exchange import (exchange_join_pairs,
                                                 split_rows)
    keys = exchange_keys()
    h = torch.as_tensor((keys.astype(np.int64) << 3) | 4)
    rows = torch.arange(EXCHANGE_N, dtype=torch.int64)
    li, ri, live = exchange_join_pairs(split_rows(h, mesh),
                                       split_rows(rows, mesh),
                                       split_rows(h, mesh),
                                       split_rows(rows, mesh), mesh)
    kt = torch.as_tensor(keys, device=li.device)
    bad = (live & (kt[li.clamp(0, EXCHANGE_N - 1)]
                   != kt[ri.clamp(0, EXCHANGE_N - 1)])).sum()
    got = torch.stack([live.sum(), bad])
    dist.all_reduce(got)
    n, wrong = (int(x) for x in got.tolist())
    if wrong:
        raise AssertionError(f"{wrong} exchanged pairs do not match")
    return n


def streamed_arm(device):
    """The streamed template over this process's own shards; returns its
    rows and the stream event (path, shards, chunks)."""
    from nds_tpu_torch.listener import drain_stream_events
    s = _stream_session(device, STREAM_SHARDS)
    drain_stream_events()
    rows = s.sql(STREAM_SQL).collect()
    events = drain_stream_events()
    ev = events[0] if events else None
    return rows, (None if ev is None else {
        "path": ev.path, "shards": ev.shards, "chunks": ev.chunks})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="execution device (default cuda; raises when no "
                    "GPU is present)")
    args = ap.parse_args(argv)
    from nds_tpu_torch import resolve_device
    resolve_device(args.device)
    wd = float(os.environ.get("NDS_MULTIHOST_WATCHDOG_S", "0"))
    if wd:
        import faulthandler
        faulthandler.dump_traceback_later(wd, exit=True)
    import torch
    import torch.distributed as dist

    from nds_tpu_torch.engine import sharded as SH
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.parallel.exchange import collective_trace, \
        sharing_devices
    from nds_tpu_torch.parallel.multihost import (maybe_initialize,
                                                  process_info)
    torch.set_num_threads(1)
    if not maybe_initialize(args.device):
        print("multihost_worker: set NDS_TPU_MULTIHOST and the federation's "
              "variables", file=sys.stderr)
        return 2
    rank, world = process_info()
    want = int(os.environ.get("NDS_NUM_PROCESSES", world))
    if world != want:
        raise AssertionError(f"federation failed: {world} of {want} "
                             "processes")
    shards = torch.cuda.device_count() if args.device == "cuda" \
        else CPU_SHARDS
    share = args.device == "cpu"
    with sharing_devices(share):
        sess = Session({"mesh_shape": shards * world,
                        "broadcast_bytes": BROADCAST_BYTES},
                       device=args.device)
        for name, t in make_tables().items():
            sess.create_temp_view(name, t)
            if sess.catalog[name].spec != "row":
                raise AssertionError(f"table {name} is not row-sharded")
        with collective_trace() as trace:
            rows = _sql_rows(sess)
            pairs = exchange_arm(sess.mesh)
        stream_rows, stream_ev = streamed_arm(args.device)
    got = {"rows": rows, "pairs": pairs,
           "streamRows": [list(r) for r in stream_rows]}
    if rank == 0:
        want_rows = expected(args.device)
        print(json.dumps({
            "world": world, "mesh": sess.mesh.size, "shards": shards,
            "device": args.device, "backend": dist.get_backend(),
            **got, "streamEvent": stream_ev,
            "collectives": dict(trace.counts),
            "gathers": SH.COUNTS["gathers"],
            "exchangeJoins": SH.COUNTS["exchange_joins"],
            "fetches": SH.COUNTS["fetches"],
            "expected": want_rows, "ok": got == want_rows}), flush=True)
    # every process reaches the barrier, or a peer hangs in a collective
    dist.barrier(**({"device_ids": [torch.cuda.current_device()]}
                    if args.device == "cuda" else {}))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
