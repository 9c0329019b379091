# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--only PHASE,...] [--stream-scale N]
                          [--stream-ci N]

Phases (each prints one JSON line; any failure makes the exit code non-zero
and suppresses the final ``ok`` line; ``--only`` runs the named ones of
kernels, power, mesh, census, replay, stream, shard, agreement,
validate, bench, campaign and full_bench after device, build and data, and
ends without the ``ok`` line). ``--stream-scale 10 --stream-ci 13`` runs
the stream phase as the reference's SF10 setting (tables above 1.5e9
bytes) with the first 13 CI statements, the run that once took the card
out of memory:

1. device      the card's name and power limit (nvidia-smi);
2. build       the CUDA kernels of ``nds_tpu_torch/csrc`` (nvcc, sm_90a);
3. kernels     each grouped-aggregation kernel against its plain PyTorch
               version at n = 2,880,404 rows (SF1 store_sales): K1 at G in
               {1, 16, 256, 1000, 4096, 100000}, K2 (with values and
               count-only) and K3 at G in {1, 16, 1000, 100000}, with int64
               extremes, NaN, signed zeros, empty groups, null (-1) and pad
               (>= G) group ids; the kernel's own time (raw launches on
               preallocated outputs; at G = 1 and 1000 also with a cold
               L2), the wrapper's, the plain version's and the library
               call's (K3: ``scatter_reduce_`` amin then amax, two calls;
               count-only K2: ``bincount``), the bytes bound (16 B a row,
               8 B for count-only) and the path the plan takes; the
               build's ptxas report (spills, registers), the atomics in
               SASS and K4's 16-byte and local-memory loads and stores;
   k1 sweep    K1's two paths across G and blocks an SM, bit-exact, with
               ``index_add_`` beside them: the evidence for
               ``kernels.PRIV_PER_SM`` and for running the private path
               up to ``G_PRIV``, the shared-memory cap;
   k23 sweep   the same for K2 (with values and count-only) and K3, from
               G = 1 to 100,000: the evidence for the caps;
   scan/probe  K4 ``chunk_scan`` at n = 2^22 rows (one default chunk) on
               a synthetic spec (six entries: an int range on FOR int16
               codes with validity, two float-lane compares on a FOR int32
               decimal, an IN-list on int16 codes with validity, a compare
               on a dict-encoded int16 column, notnull; the routing hash
               over two int32 keys; 25 B a row), and K5 ``join_probe`` at
               n = 2^22 probe rows against r in {1000, 102000, 2^20} build
               rows, a duplicate-heavy build side (fanout 4, one key 1,000
               times) and a sparse one (2^20 rows, all null but 16):
               bit-exact against their plain versions, with kernel (warm
               and cold L2), wrapper, plain and bound ms (and, for K5, the
               ``torch.searchsorted`` pair); a ``k4_sweep`` line times
               every plan of ``kernels.scan_plans`` on the same chunk,
               each checked bit for bit;
4. data        builds ``native/ndsgen`` and writes SF0.01, SF1 and SF3
               raw data (parallel children) under ``.smoke_data/``, in
               the background while the earlier phases run, then SF3 and
               SF1 as parquet for the stream and shard phases (a child
               process, so the power, mesh, census and replay phases
               run beside it); SF3 is waited for only by the stream
               phase; for the full_bench
               phase also SF1's refresh sets 1-3 (``nds_tpu_torch.datagen
               --update``, in ``.smoke_data/sf1_<n>``);
5. power       the 25 CI statements at SF1 through the port's Power Run
               entry on ``cuda``, plus one MIN/MAX-of-double statement;
               per-query ms, syncs and kernel launches; lines before it
               count K1's (``k1_groups``) and K2's and K3's
               (``k23_groups``) launches by group count and path; a
               ``watchdog`` line times query78 (the most host syncs) with
               ``NDS_TPU_STATEMENT_DEADLINE_S`` unset and set, in
               alternating pairs, on the same session;
   mesh        the meshed resident session over the power phase's SF1
               tables, its shards sharing the card: the 25 CI statements
               at ``mesh_shape`` 2 and 4 at the default 128 MiB broadcast
               threshold (the facts past it row-sharded),
               then five of them with ``NDS_TPU_BROADCAST_BYTES=64``
               (every table row-sharded: query37, query50 and query84
               join two row-sharded sides through the exchange). One
               ``mesh_arm`` line an arm: statements equal to the unmeshed
               rows, exchange joins, gathers, the join sides whose
               shards handed over just their matched rows
               (``fetches``), collectives and bytes,
               summed ms against the unmeshed run (each statement run
               twice eagerly, the second timed), K1-K3 and K5 launches,
               peak memory (no ``torch.profiler`` runs here, for the
               smoke's time limit); a
               ``mesh_retry`` line drives a skewed
               repartition join whose capacity retries must each reach
               the failure listeners; the ``mesh`` line gives the replay
               tiers of two statements on a meshed session (one CUDA
               graph) and fails on a differing statement, a forced arm
               without an exchange join, an unreported retry or a
               statement whose tiers are not eager, record, replayed;
   census      the first 13 of those statements (``CENSUS_QUERIES``,
               for the smoke's time limit) again under ``torch.profiler``
               (the Power Run's ``--profile``): every CUDA kernel they
               launch and its device time, with ``prim.true_div``'s
               divisors kept as the port keeps them (the arm with a fresh
               divisor a call, PR 6's comparison, was dropped for time),
               and the calls of ``true_div``;
   replay      the SF1 resident session on ``cuda`` with
               ``NDS_TPU_REPLAY=force`` over the 25 CI statements and the
               MIN/MAX-of-double one: per statement its first-sight syncs
               and eager wall, its record and capture ms, the median of 5
               replay walls, syncs and launches per kernel of a replay,
               and its tier or blacklist reason (``replay_statement``
               lines); each replayed result against its eager one (exact
               kinds bit for bit, doubles within rel 1e-5). The ``replay``
               line counts captured and blacklisted statements, sums
               eager and replay walls, gives the session's peak memory
               with every graph held and the sync threshold the walls
               decide; it fails on a differing result, on a statement
               that does not capture (its reason printed), on a replay
               with more than 1 sync before the fetch, or on launches
               unequal to eager. The watchdog line runs with
               replay off (it arms blocking reads, which a replay lacks);
6. stream      SF3 as parquet (the port's ``write_table``, data phase); a
               cuda session that streams every table above 4.5e8 bytes
               in 2^22-row chunks (store_sales: 3 chunks) against an
               all-resident one: the 14 streamed A/B statements of
               ``tests/test_synccount.py`` (and the partitioned subset at 2
               partitions; the three that join two fact tables on the
               item alone run on SF1 in 2^19-row chunks, since at SF5 and
               up their joins outgrow the card) and the 25 CI statements
               through the Power Run entry with ``--input_format
               parquet``; streamed rows equal
               resident rows, every ``must_stream`` statement runs
               ``compiled`` within 6 syncs, K4/K5 launch, and no
               synchronizing CUDA call happens inside the chunk loop
               (``torch.cuda.set_sync_debug_mode("warn")`` around it).
               Every compiled scan runs its per-chunk program as a
               captured CUDA graph (a refusal fails the phase, with its
               reason); each statement runs again through the eager
               drive (``Session.sql(..., graph=False)``): rows and K4/K5
               launches equal. Per statement: ``graph`` (captured,
               replayed or the reason), launches, synchronizing calls in
               its chunk loops. A ``chunk_split`` line splits query37's
               cost a chunk, in four arms (eager drive and graph, each
               with the chunk store off and warm; the warm arms in a
               child process, ``--chunk-split-child``), into wall, launch
               or Python time, prefetch wait and device kernel time (a
               second run under ``torch.profiler``), and splits each
               first sight's time outside the chunk loop into codec
               planning and encoding, record, capture, the first chunk's
               upload and the rest;
               the raw-wire arm runs ab0, ab2, query37 and ab7 twice
               more in the same process under ``NDS_TPU_ENCODED=0`` (plain
               widths): rows equal to the encoded runs bit for bit, every
               scan a captured or replayed graph, at most 6 syncs, no
               synchronizing call in the loop, K4/K5 launches equal to
               the encoded runs' (one ``raw_wire_statement`` line each,
               and a ``raw_wire`` line with query37's host-to-device
               bytes and ms a chunk, encoded against raw);
               the ``pipeline_budget`` record holds the cached
               pipelines' static operands and graph-pool bytes
               (``stream.static_report``) against their budget after
               every statement, and the phase fails when more than one
               pipeline held more than it;
               a ``k4_specs`` line counts K4's launches by spec shape
               (entry kinds, column dtypes and validity, dict table sizes,
               IN-list lengths, decimal divisors, key dtypes, plen) and by
               the statement that made them (``<q>/compare``: the second
               run of a CI statement whose rows are compared;
               ``raw/<q>``: the raw-wire arm), and ``k1_groups`` /
               ``k23_groups`` lines count K1-K3's launches by group count;
   k4 real     K4 at each spec shape of ``k4_specs``, on the first chunk
               of that shape (repeated to 2^22 rows where shorter):
               bit-exact, warm and cold L2, the bytes bound and its
               share, the plain time, the wire that launched it
               (``encoded``, ``raw``: the plain-width int64 and ``"id"``
               lanes), and a ``k4_sweep`` line of every plan;
   shard       ``exchange_join_pairs`` on cuda against cpu (50 % and 95 %
               dead rows, the skewed capacity retry; 2, 4 and 8 shards
               sharing the card; exact pair arrays) and
               ``run_distributed_q3`` against its numpy answer
               (``shard_exchange`` line); then sharded streaming: the A/B
               statements ab0 and ab2 and the CI statements query3,
               query7 and query37 on the stream phase's data and
               threshold, and the fan-out ab7 at 2 partitions on SF1, at
               1, 2 and 4 shards sharing the card, each run twice (the
               capture, then a replay): rows equal to the one-shard run
               bit for bit, every compiled scan at the shard count asked
               for with its shard rows summing to its rows, no eager
               rerun (a bound-bucket overflow's only where the one-shard
               run overflowed too), at most 6
               syncs, no synchronizing call in the chunk loop, ab7 at
               least one all-to-all a chunk, K4 and K5 launched (counts
               zeroed before the phase). One ``shard`` line a statement
               with its ms at each count (first run and replay); with two
               or more cards ab7 runs again on shards of distinct cards;
               the last line gives the device count and the card;
7. agreement   every statement of the SF0.01 stream (103) plus the
               MIN/MAX-of-double one, on ``cuda`` and on ``cpu``: exact
               kinds bit for bit, doubles within rel 1e-5; the line names
               each statement that differs and gives the phase's seconds.
   validate    the 25 CI statements at SF1 through ``python -m
               nds_tpu_torch.power --output_prefix`` on ``cuda`` and on
               ``cpu`` (two processes in the background, both started
               before the shard phase; the shard and agreement phases run
               meanwhile), then ``python -m
               nds_tpu_torch.validate`` of the cpu outputs against the
               cuda ones: exit 0 and every summary ``Pass``; then a copy
               of the cuda outputs with the first double of the first
               statement that has one changed by 1e-3 relative: exit 1,
               that statement alone unmatched and ``Fail``. The line gives
               the statements, rows, both runs' and the phase's seconds;
8. bench       ``python -m nds_tpu_torch.bench`` (run A, a fresh process)
               at SF1 over every statement of its stream (103) on the SF1
               raw data of the data phase, its ledger beside the other
               results: it ends ``completed`` with every
               statement ``ok`` and K1 and K2 launched (the stream has no
               MIN/MAX of a double, so no K3) under the default replay
               policy, ``auto`` (the line counts the statements replayed
               and names those blacklisted, with the reason; a blacklist
               other than the eviction of a slower replay fails it), the
               ledger loads, ``bench_compare --gate`` of A against itself
               passes and its ``--inject-drift`` self-test rejects; a
               second line gives the phase's seconds and the card. Run B
               (the first 14 templates, 15 statements,
               ``BENCH_B_QUERIES``, resident, in a fresh process) is the
               campaign's ``resident`` arm;
   campaign    ``python -m nds_tpu_torch.tools.campaign`` over the arms
               ``base``, ``encoded-off`` (``NDS_TPU_ENCODED=0``) and
               ``prefetch-off`` (``NDS_TPU_PREFETCH_DEPTH=0``), each
               ``python -m nds_tpu_torch.bench`` over ``BENCH_B_QUERIES``
               at SF1 with ``NDS_TPU_STREAM_BYTES=1.5e8`` (store_sales,
               catalog_sales and inventory stream), and ``resident`` (the
               threshold unset: nothing streams): every arm completes
               with 15 statements ``ok``, the same command again skips
               all four, ``--report`` writes a row an arm and the
               encoded/raw delta (the raw wire uploads more bytes), each
               arm's ``--gate`` against run A is a finding, the resident
               arm streams nothing and fails no replay and its ratios to
               run A are run B's A-versus-B finding, ``base`` against
               ``resident`` prices the streamed path (a finding), and
               ``python -m nds_tpu_torch.tools.trace_report`` renders the
               base arm's traces;
9. full_bench  first two processes build the kernel library at once (the
               built one set aside) and must both load it; then
               ``python -m nds_tpu_torch.nds_bench`` on a configuration
               under ``.smoke_data/full_bench/`` (the keys of
               ``bench.yml``): SF1, 4 streams (Throughput 1 runs streams
               1 and 2 at once on the card, Throughput 2 stream 3: fewer
               than bench.yml's, for the smoke's time limit), the data
               phase's base data and refresh
               sets, an ``iceberg`` warehouse, ``device: cuda``,
               ``NDS_TPU_CONCURRENT_QUERIES`` unset. The ``full_bench``
               line gives Tld, TPower, Ttt1, Ttt2, Tdm1 and Tdm2 (seconds,
               rounded as the spec rounds them) and the metric, and per
               phase and step its statements, those not ``Completed``,
               host syncs, K1-K3 launches and each stream process's peak
               device memory; it fails on a step's non-zero exit, a
               statement not ``Completed``, a Power or Throughput step
               that launched no K1 or K2, or a missing ``metrics.csv``.
               The ``maintenance_agree`` line runs refresh set 1's 11
               functions on ``cpu`` on the warehouse as it stood before
               Maintenance 1 and holds every snapshot they commit against
               the one the ``cuda`` run committed (exact kinds bit for
               bit, doubles within rel 1e-5), naming the table and
               function of each difference; a last line gives the phase's
               seconds and the card.

It needs a CUDA device and the rest of the repository; without either it
exits non-zero and prints no result. Results that are too long for the
output go to ``chiprun_out/smoke/``; ``phases.jsonl`` there has every
line printed.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import time

T0 = time.time()
REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, ".smoke_data")
OUT = os.path.join(REPO, "chiprun_out", "smoke")

CI_QUERIES = [
    "query3", "query7", "query13", "query15", "query19", "query26",
    "query27", "query36", "query37", "query41", "query42", "query43",
    "query45", "query48", "query50", "query52", "query55", "query62",
    "query68", "query73", "query78", "query84", "query91", "query92",
    "query96",
]
# MIN/MAX of a double: the CI statements aggregate decimals, so this one
# statement puts the float min/max kernel on the main path
MINMAX_SQL = ("select ss_store_sk, min(ss_sales_price / ss_quantity) lo, "
              "max(ss_sales_price / ss_quantity) hi, count(*) n "
              "from store_sales group by ss_store_sk order by ss_store_sk")
SEED = 19620718
SF1_ROWS = 2880404            # store_sales rows at SF1
HBM_BYTES_PER_S = 3.35e12     # H100 SXM published device-memory rate
K1_GROUPS = (1, 16, 256, 1000, 4096, 100000)
K23_GROUPS = (1, 16, 1000, 100000)
COLD_GROUPS = (1, 1000)              # also timed with a cold L2
# the sweeps: group counts across both paths, blocks an SM on the private
# one (14528 groups at 16 B fill a block's 227 KB); K2/K3 also past the
# cap of a count-only K2 launch (4 B a group: 58112 fill a block)
SWEEP_GROUPS = (1, 2, 16, 256, 1000, 4096, 8192, 14528)
K23_SWEEP_GROUPS = (1, 2, 16, 256, 1000, 4096, 8192, 14528, 29056, 58112,
                    100000)
# a cold-L2 time writes this much (more than the H100's 50 MB L2) before
# each launch
L2_FLUSH_BYTES = 128 << 20
# a kernel's own time: raw launches on preallocated outputs, enough of them
# back to back that the host's launch cost hides behind the device's work
KERNEL_REPS = 100
KERNEL_META = {
    "segment_sum_i64": ("nds_tpu/engine/kernels.py:257 "
                        "(_segment_sum_exact_pallas)"),
    "segment_sum_f64": "nds_tpu/engine/kernels.py:108 (_segment_sum_pallas)",
    "segment_minmax_f64": ("nds_tpu/engine/kernels.py:371 "
                           "(_segment_minmax_pallas)"),
    "chunk_scan": "nds_tpu/engine/kernels.py:728 (fused_chunk_scan)",
    "join_probe": "nds_tpu/engine/kernels.py:924 (fused_probe)",
}
KERNEL_SOURCE = {
    "segment_sum_i64": "nds_tpu_torch/csrc/segment_agg.cu",
    "segment_sum_f64": "nds_tpu_torch/csrc/segment_agg.cu",
    "segment_minmax_f64": "nds_tpu_torch/csrc/segment_agg.cu",
    "chunk_scan": "nds_tpu_torch/csrc/chunk_scan.cu",
    "join_probe": "nds_tpu_torch/csrc/join_probe.cu",
}
# the streamed path's chunk (the port's default) and the K5 build sizes:
# a small dimension, SF10 item, and 2^20 rows
SCAN_ROWS = 1 << 22
PROBE_BUILD_ROWS = (1000, 102000, 1 << 20)
PROBE_DUP_ROWS = 102000          # the duplicate-heavy build side
PROBE_SPARSE_ROWS = 1 << 20      # a build side of nulls but 16 rows
# the stream phase: the reference's SF10 run (streaming threshold 1.5e9
# bytes, 2^22-row chunks: store_sales 28,800,501 rows in 7 chunks) cut to
# SF3 for the smoke's time (SF5 until the whole smoke passed 1,200 s on a
# slow host), with the threshold scaled down alike so that the same four
# fact tables stream (store_sales 3 chunks, inventory 18)
STREAM_SCALE = 3
STREAM_CHUNK_ROWS = 1 << 22
STREAM_BYTES = 1.5e8 * STREAM_SCALE
# the CI statements the stream phase runs through the Power Run entry
# (``--stream-ci``: its first N)
STREAM_CI = CI_QUERIES
# the census phase's statements: the first 13 CI statements, for the
# smoke's time limit
CENSUS_QUERIES = CI_QUERIES[:13]
# the A/B statements that join store_sales to store_returns on the item
# alone. At SF10 about 28 returns match each sale, so their joins hold up
# to 8e8 pairs (SF5 about half): more than the card holds, resident or
# streamed (the streamed path bounds the scanned table, not a join's
# output). They run on SF1 instead, streamed above 1.5e8 bytes in
# 2^19-row chunks (store_sales 6 chunks), against SF1 all-resident.
STREAM_AB_FANOUT = (7, 8, 13)
# the raw-wire arm (NDS_TPU_ENCODED=0): these statements again, after
# their encoded runs, in the same process
RAW_WIRE = ("ab0", "ab2", "query37", "ab7")
FANOUT_SCALE = 1
FANOUT_CHUNK_ROWS = 1 << 19
FANOUT_STREAM_BYTES = 1.5e8
# the bench phase: two runs of the port's bench entry at SF1, each held to
# a round budget well inside the smoke's time limit. Run A takes every
# statement of the stream (103); run B, there for the run-to-run spread
# and run as the campaign phase's ``resident`` arm, takes the first 14
# templates (15 statements with query14's two parts), as do the
# campaign's other arms: two whole runs made the smoke pass its time
# limit on a slow host once the shard phase came, and four arms of 28
# statements once the campaign came (a run is mostly first sights,
# records and captures, host work)
BENCH_SCALE = 1
BENCH_BUDGET_S = 300
BENCH_B_TEMPLATES = 14
BENCH_B_QUERIES = [name for i in range(1, BENCH_B_TEMPLATES + 1)
                   for name in ((f"query{i}_part1", f"query{i}_part2")
                                if i in (14, 23, 24) else (f"query{i}",))]
BENCH_STATEMENTS = {"a": 103}
BENCH_KERNELS = ("segment_sum_i64", "segment_sum_f64")


def emit(obj) -> None:
    """One JSON line on stdout, and the same line appended to
    ``chiprun_out/smoke/phases.jsonl`` (the tool keeps only the end of
    stdout) with the seconds since the script started."""
    line = json.dumps(obj)
    print(line, flush=True)
    with open(os.path.join(OUT, "phases.jsonl"), "a") as f:
        # the file's lines also carry the script's seconds so far
        f.write(json.dumps({"t_s": round(time.time() - T0, 3), **obj})
                + "\n")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def cuda_ms(torch, fn, reps=20) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls on the stream
    (CUDA events, after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(torch, fn, reps=20):
    """(ms of ``fn`` with a cold L2, ms of the flush alone): each call
    follows a write of ``L2_FLUSH_BYTES``; the write's own mean time,
    taken alone the same way, is subtracted."""
    buf = torch.empty(L2_FLUSH_BYTES // 8, dtype=torch.int64, device="cuda")
    flush = cuda_ms(torch, buf.zero_, reps)
    both = cuda_ms(torch, lambda: (buf.zero_(), fn()), reps)
    del buf
    return both - flush, flush


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def kernel_inputs(torch, n, G, rng):
    """Group ids with nulls (-1), pads (>= G) and empty groups; int64 values
    with the extremes; float64 values with NaN and signed zeros."""
    import numpy as np
    gids = rng.integers(0, G, size=n, dtype=np.int64)
    if G >= 1000:
        gids = np.where(gids % 10 == 7, (gids + 1) % G, gids)  # empty groups
    u = rng.random(n)
    gids = np.where(u < 0.05, -1, gids)                      # null rows
    gids = np.where((u >= 0.05) & (u < 0.08), G + (gids % 5), gids)  # pads
    ivals = rng.integers(-(1 << 62), 1 << 62, size=n, dtype=np.int64)
    ivals[:4] = [np.iinfo(np.int64).max, np.iinfo(np.int64).min,
                 np.iinfo(np.int64).max, -1]
    fvals = rng.random(n) * 1000.0
    mvals = fvals - 500.0
    mvals[::100003] = np.nan
    mvals[1::7919] = -0.0
    mvals[2::7919] = 0.0
    dev = torch.device("cuda")
    return (torch.from_numpy(gids).to(dev), torch.from_numpy(ivals).to(dev),
            torch.from_numpy(fvals).to(dev), torch.from_numpy(mvals).to(dev))


def bits_equal(torch, a, b) -> bool:
    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return bool(torch.equal(a, b))


def bytes_bound_ms(nbytes) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def kernel_times(torch, G, launch, wrapper, plain, library):
    """A kernel's times at one G: its own (raw launches on preallocated
    outputs), its wrapper's, its plain version's and the library call's;
    at ``COLD_GROUPS`` also the kernel and the library call with a cold
    L2."""
    rec = dict(ms=cuda_ms(torch, launch, reps=KERNEL_REPS),
               wrapper_ms=cuda_ms(torch, wrapper),
               plain_ms=cuda_ms(torch, plain),
               library_ms=cuda_ms(torch, library))
    if G in COLD_GROUPS:
        rec["cold_ms"], rec["flush_ms"] = cold_ms(torch, launch)
        rec["library_cold_ms"], _ = cold_ms(torch, library)
    return rec


def seg_agree(torch, name, got, want):
    """(ok, max_abs_err, max_rel_err) of a K1-K3 result against the plain
    version's: K1, K3 and every count bit for bit, K2 sums within rel
    1e-9 (float atomics add in no fixed order)."""
    a, b = got, want
    if name == "segment_minmax_f64":
        good = bits_equal(torch, a[0], b[0]) and bits_equal(torch, a[1], b[1])
        fin = torch.isfinite(a[0]) & torch.isfinite(b[0])
        err = 0.0 if good or not bool(fin.any()) else float(
            (a[0] - b[0])[fin].abs().max())
        return good, err, 0.0
    counts_ok = bits_equal(torch, a[1], b[1])
    if name == "segment_sum_i64" or a[0].numel() == 0:
        good = counts_ok and bits_equal(torch, a[0], b[0])
        err = 0.0 if good else float((a[0] - b[0]).abs().max().float() +
                                     (a[1] - b[1]).abs().max().float())
        return good, err, 0.0
    rel = float(((a[0] - b[0]).abs() / b[0].abs().clamp(min=1e-300)).max())
    err = float((a[0] - b[0]).abs().max()) + float(
        (a[1] - b[1]).abs().max())
    return counts_ok and rel <= 1e-9, err, rel


def library_call(torch, name, vals, lib_gids, G):
    """(the one PyTorch computation of the same per-group values, its
    name). Out-of-range rows go to a discard slot G. K3 takes two calls
    (min, then max); ``vals`` None is a count-only K2."""
    dev = lib_gids.device
    if name == "segment_sum_i64":
        return (lambda: torch.zeros(G + 1, dtype=torch.int64,
                                    device=dev).index_add_(0, lib_gids,
                                                           vals),
                "index_add_ (int64 sums)")
    if name == "segment_sum_f64" and vals is None:
        return (lambda: torch.bincount(lib_gids, minlength=G + 1),
                "bincount (counts)")
    if name == "segment_sum_f64":
        return (lambda: torch.zeros(G + 1, dtype=torch.float64,
                                    device=dev).index_add_(0, lib_gids,
                                                           vals),
                "index_add_ (float64 sums)")
    return (lambda: (scatter_extreme(torch, "amin", vals, lib_gids, G),
                     scatter_extreme(torch, "amax", vals, lib_gids, G)),
            "scatter_reduce_ amin + amax (2 calls)")


def scatter_extreme(torch, reduce, vals, lib_gids, G):
    """One ``scatter_reduce_`` (``reduce`` "amin" or "amax") of ``vals``
    into G + 1 slots."""
    start = math.inf if reduce == "amin" else -math.inf
    return torch.full((G + 1,), start, dtype=torch.float64,
                      device=lib_gids.device).scatter_reduce_(
                          0, lib_gids, vals, reduce, include_self=True)


def seg_record(torch, K, name, n, G, gids, vals, lib_gids):
    """K1, K2 (``vals`` None: count-only) or K3 against its plain version
    at one G, with its times, its bytes bound and the path its plan
    takes."""
    wrapper = getattr(K, name)
    plain = getattr(K, name + "_plain")
    got = wrapper(vals, gids, G)
    want = plain(vals, gids, G)
    torch.cuda.synchronize()
    good, err, rel = seg_agree(torch, name, got, want)
    count_only = vals is None
    library, call = library_call(torch, name, vals, lib_gids, G)
    nbytes = (8 * n + 8 * G) if count_only else (16 * n + 16 * G)
    rec = dict(
        G=G, n=n, count_only=count_only, ok=good, max_abs_err=err,
        max_rel_err=rel,
        tol="counts exact, sums rel 1e-9" if name == "segment_sum_f64"
        else "bit-exact",
        path=K.segment_plan(n, G, K._sm_count(gids.device),
                            group_bytes=4 if count_only else 16).path,
        **kernel_times(torch, G, K.launcher(name, vals, gids, G),
                lambda: wrapper(vals, gids, G),
                lambda: plain(vals, gids, G), library),
        library_call=call, bound_ms=bytes_bound_ms(nbytes),
        bound_by="bytes", bytes=nbytes)
    if name == "segment_minmax_f64":
        rec["library_amin_ms"] = cuda_ms(torch, lambda: scatter_extreme(
            torch, "amin", vals, lib_gids, G))
        rec["nan_groups"] = int(torch.isnan(got[0]).sum())
        rec["empty_groups"] = int(torch.isinf(got[0]).sum())
    return rec


def lib_gids_of(torch, gids, G):
    """The library yardstick's group ids: out-of-range rows routed to a
    discard slot G, so one library call computes the same per-group
    values."""
    return torch.where((gids >= 0) & (gids < G), gids,
                       torch.full_like(gids, G))


def kernel_phase(torch, K):
    import numpy as np
    rng = np.random.default_rng(SEED)
    n = SF1_ROWS
    records = {name: [] for name in ("segment_sum_i64", "segment_sum_f64",
                                     "segment_minmax_f64")}
    for G in sorted(set(K1_GROUPS + K23_GROUPS)):
        gids, ivals, fvals, mvals = kernel_inputs(torch, n, G, rng)
        lib_gids = lib_gids_of(torch, gids, G)
        cases = [("segment_sum_i64", ivals)]
        if G in K23_GROUPS:
            # K2 with values first: the kernels line reads the first
            # record at G = 1000
            cases += [("segment_sum_f64", fvals), ("segment_sum_f64", None),
                      ("segment_minmax_f64", mvals)]
        for name, vals in cases:
            records[name].append(seg_record(torch, K, name, n, G, gids,
                                            vals, lib_gids))
        del gids, ivals, fvals, mvals, lib_gids
    ok = all(r["ok"] for recs in records.values() for r in recs)
    return ok, records


def sweep_key(plan, sms) -> str:
    return plan.path if plan.path.startswith("global") else \
        f"{plan.path}/{max(plan.grid // sms, 1)}"


def k1_sweep(torch, K):
    """K1 at n = 2,880,404 across ``SWEEP_GROUPS``: every plan of
    ``kernels.segment_plans`` (the private path at 1-4 blocks an SM, as the
    shared memory allows, and the global path), each bit-exact against the
    plain version, with ``index_add_`` beside them. (ok, [records])."""
    import numpy as np
    rng = np.random.default_rng(SEED + 1)
    n, out, ok = SF1_ROWS, [], True
    sms = K._sm_count(torch.device("cuda"))
    for G in SWEEP_GROUPS:
        gids, ivals, _f, _m = kernel_inputs(torch, n, G, rng)
        ps, pc = K.segment_sum_i64_plain(ivals, gids, G)
        times = {}
        for plan in K.segment_plans(n, G, sms):
            launch = K.launcher("segment_sum_i64", ivals, gids, G, plan=plan)
            s, c = launch()
            torch.cuda.synchronize()
            good = bits_equal(torch, s, ps) and bits_equal(torch, c, pc)
            ok = ok and good
            times[sweep_key(plan, sms)] = {
                "ms": cuda_ms(torch, launch, reps=KERNEL_REPS),
                "grid": plan.grid, "ok": good}
        lib_gids = lib_gids_of(torch, gids, G)
        library, _call = library_call(torch, "segment_sum_i64", ivals,
                                      lib_gids, G)
        out.append({"G": G, "n": n, "chosen": K.segment_plan(n, G, sms).path,
                    "plans": times, "library_ms": cuda_ms(torch, library)})
        del gids, ivals, _f, _m, ps, pc, lib_gids
    return ok, out


def k23_sweep(torch, K):
    """K2 (with values and count-only) and K3 at n = 2,880,404 across
    ``K23_SWEEP_GROUPS``: every plan of ``kernels.segment_plans``, each checked
    against the plain version (counts and K3 bit for bit, K2 sums within
    rel 1e-9), with the library call beside them. (ok, [records])."""
    import numpy as np
    rng = np.random.default_rng(SEED + 2)
    n, out, ok = SF1_ROWS, [], True
    sms = K._sm_count(torch.device("cuda"))
    for G in K23_SWEEP_GROUPS:
        gids, _i, fvals, mvals = kernel_inputs(torch, n, G, rng)
        lib_gids = lib_gids_of(torch, gids, G)
        for name, vals in (("segment_sum_f64", fvals),
                           ("segment_sum_f64", None),
                           ("segment_minmax_f64", mvals)):
            count_only = vals is None
            gb = 4 if count_only else 16
            want = getattr(K, name + "_plain")(vals, gids, G)
            times = {}
            for plan in K.segment_plans(n, G, sms, group_bytes=gb):
                launch = K.launcher(name, vals, gids, G, plan=plan)
                got = launch()
                if name == "segment_minmax_f64":
                    got = (got[1][0], got[1][1])
                torch.cuda.synchronize()
                good, _err, rel = seg_agree(torch, name, got, want)
                ok = ok and good
                times[sweep_key(plan, sms)] = {
                    "ms": cuda_ms(torch, launch, reps=KERNEL_REPS),
                    "grid": plan.grid, "ok": good, "max_rel_err": rel}
            library, call = library_call(torch, name, vals, lib_gids, G)
            out.append({"kernel": name, "count_only": count_only, "G": G,
                        "n": n, "chosen": K.segment_plan(
                            n, G, sms, group_bytes=gb).path,
                        "plans": times, "library_ms": cuda_ms(torch, library),
                        "library_call": call})
        del gids, _i, fvals, mvals, lib_gids
    return ok, out


def toolkit_tool(name):
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", name)
    return tool if os.path.exists(tool) else shutil.which(name)


def demangle(names):
    """``names`` demangled by the toolkit's ``cu++filt`` where it has one
    (else as they are)."""
    tool = toolkit_tool("cu++filt")
    if not tool or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else \
        {n: n for n in names}


def build_report(K, text):
    """The ptxas report's spills and each kernel's registers, the atomics
    in the SASS of the grouped-aggregation row kernels (``cuobjdump``,
    where the toolkit has it): shared (ATOMS) and global (ATOM, RED) ones,
    per kernel instance; and K4's 16-byte loads and stores and its
    local-memory loads and stores, per instance."""
    import re
    spills, regs, name = {}, {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name and (int(m.group(1)) or int(m.group(2))):
            spills[name] = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
    atoms = scan = None
    tool = toolkit_tool("cuobjdump")
    if tool:
        out = subprocess.run([tool, "-sass", K.build()], capture_output=True,
                             text=True, timeout=300).stdout
        atoms, scan, fn = {}, {}, None
        for line in out.splitlines():
            m = re.search(r"Function : (\w+)", line)
            if m:
                fn = m.group(1)
            elif fn and "chunk_scan_tiles" in fn:
                # K4: 16-byte loads and stores, local-memory traffic
                m = re.search(r"\b(LDG\.E\.128|STG\.E\.128|LDL|STL)\b",
                              line)
                if m:
                    ops = scan.setdefault(fn, {})
                    ops[m.group(1)] = ops.get(m.group(1), 0) + 1
            elif fn and re.search(r"seg_priv|seg_minmax_kernel|"
                                  r"seg_sum_f64_kernel", fn):
                m = re.search(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[\w.]+)",
                              line)
                if m:
                    atoms.setdefault(fn, set()).add(m.group(1))
        names = demangle(sorted(atoms) + sorted(scan))
        atoms = {names[k]: sorted(v) for k, v in atoms.items()}
        scan = {names[k]: v for k, v in scan.items()}
    names = demangle(sorted(k for k in regs if re.search(
        r"priv|probe|minmax|seg_sum_f64|chunk_scan", k)))
    return {"spills": spills,
            "registers": {v: regs[k] for k, v in names.items()},
            "seg_atomics": atoms, "scan_sass": scan}


def scan_inputs(torch, K, rng):
    """One padded 2^22-row chunk shaped like store_sales' streamed
    columns, and a K4 spec over it: FOR int16 quantity (with nulls), FOR
    int32 decimal price (float lane, /100), an IN-list on an int16 store
    key, a dict-encoded float-lane column, and the routing hash over two
    int32 keys."""
    import numpy as np
    n = SCAN_ROWS
    live = n - 12345                       # a partial trailing chunk
    qty = rng.integers(0, 100, n).astype(np.int16)        # base 1
    qty_v = rng.random(n) > 0.04
    price = rng.integers(0, 20000, n).astype(np.int32)    # base 100
    store = rng.integers(0, 12, n).astype(np.int16)
    store_v = rng.random(n) > 0.04
    disc = rng.integers(0, 64, n).astype(np.int16)        # dict codes
    table = np.unique(rng.integers(0, 10 ** 6, 64)).astype(np.int64)
    item = rng.integers(0, 1 << 17, n).astype(np.int32)
    cust = rng.integers(0, 1 << 20, n).astype(np.int32)
    bufs = (qty, qty_v, price, None, store, store_v, disc, None, item, None,
            cust, None)
    entries = [("irange", 0, 9, 59), ("fge", 1, 12.5), ("flt", 1, 150.25),
               ("iin", 2, (1, 2, 4, 7, 8, 10)), ("flt", 3, 4000.0),
               ("notnull", 2)]
    cols = [(0, 1, "for", 1, -1, 1.0), (2, -1, "for", 100, -1, 100.0),
            (4, 5, "id", 0, -1, 1.0), (6, -1, "dict", 0, 0, 100.0)]
    spec = K.ScanSpec(entries, cols, tables=(table,), key_slots=(8, 10))
    dev = torch.device("cuda")
    flat = tuple(None if b is None else torch.from_numpy(b).to(dev)
                 for b in bufs)
    n_dev = torch.tensor(live, dtype=torch.int64, device=dev)
    return flat, n_dev, spec


def scan_bytes(flat, spec, plen) -> int:
    """The bytes one K4 launch must move: each buffer the spec reads (code
    columns, validity, keys) once, the packed spec once, the mask (1 B a
    row) and the hash (4 B a row, with keys) once."""
    used = {c[0] for c in spec.cols} | {c[1] for c in spec.cols
                                        if c[1] >= 0} | set(spec.key_slots)
    words = spec_words(spec)
    return sum(flat[i].element_size() * plen for i in used) + 8 * words + \
        plen * (1 + (4 if spec.key_slots else 0))


def spec_words(spec) -> int:
    """The packed spec's length in words (the one the launches use)."""
    from nds_tpu_torch.engine import kernels as K
    return K.packed_scan_spec(spec)[1].total


def plan_key(plan) -> str:
    return f"t{plan.threads}/g{plan.grid}"


def k4_record(torch, K, flat, n_dev, spec):
    """K4 against its plain version on one chunk, with its kernel time
    (warm and cold L2), wrapper, plain and bytes-bound times, and every
    plan of ``kernels.scan_plans`` timed in turns (each checked bit for
    bit): the ``k4_sweep``. (record, sweep)."""
    plen = int(flat[spec.cols[0][0]].shape[0])
    m, h = K.chunk_scan(flat, n_dev, spec)
    pm, ph = K.chunk_scan_plain(flat, n_dev, spec)
    torch.cuda.synchronize()
    good = bits_equal(torch, m, pm) and (h is None) == (ph is None) and (
        h is None or bits_equal(torch, h, ph))
    err = 0 if good else int((m != pm).sum()) + (
        0 if h is None or ph is None else int((h != ph).sum()))
    nbytes = scan_bytes(flat, spec, plen)
    bound = bytes_bound_ms(nbytes)
    launch = K.launcher("chunk_scan", flat, n_dev, spec)
    warm = cuda_ms(torch, launch, reps=KERNEL_REPS)
    cold, flush = cold_ms(torch, launch)
    plan = K.scan_plan(plen, spec, K._sm_count(m.device))
    sweep, plans_ok = {}, True
    for p in K.scan_plans(plen, spec, K._sm_count(m.device)):
        pl = K.launcher("chunk_scan", flat, n_dev, spec, plan=p)
        _keep, pmask, phash = pl()
        torch.cuda.synchronize()
        pgood = bits_equal(torch, pmask, pm) and (
            phash is None or bits_equal(torch, phash, ph))
        plans_ok = plans_ok and pgood
        sweep[plan_key(p)] = {"ms": cuda_ms(torch, pl, reps=KERNEL_REPS),
                              "ok": pgood}
        del pl, pmask, phash
    rec = dict(
        n=plen, ok=good and plans_ok, max_abs_err=err, tol="bit-exact",
        survivors=int(m.sum()), entries=len(spec.entries),
        plan=plan_key(plan), staged_words=plan.staged,
        spec_words=spec_words(spec), ms=warm, cold_ms=cold,
        flush_ms=flush,
        wrapper_ms=cuda_ms(torch, lambda: K.chunk_scan(flat, n_dev, spec)),
        plain_ms=cuda_ms(torch, lambda: K.chunk_scan_plain(flat, n_dev,
                                                           spec)),
        library_ms=None, library_call=None, bound_ms=bound,
        bound_by="bytes", bytes=nbytes, bytes_per_row=nbytes / plen,
        share_of_bound=bound / warm, cold_share_of_bound=bound / cold)
    del m, h, pm, ph, launch
    return rec, sweep


def scan_probe_phase(torch, K):
    """K4 and K5 against their plain versions at the streamed path's
    shapes: (ok, {name: [records]}, K4's sweep)."""
    import numpy as np
    from nds_tpu_torch.engine import ops as E
    rng = np.random.default_rng(SEED + 4)
    records = {"chunk_scan": [], "join_probe": []}
    flat, n_dev, spec = scan_inputs(torch, K, rng)
    rec, sweep = k4_record(torch, K, flat, n_dev, spec)
    records["chunk_scan"].append(dict(shape="synthetic", **rec))
    n = SCAN_ROWS
    del flat
    dev = torch.device("cuda")
    cases = [(r, "uniform") for r in PROBE_BUILD_ROWS] + \
        [(PROBE_DUP_ROWS, "duplicates"), (PROBE_SPARSE_ROWS, "sparse")]
    for r, build_kind in cases:
        bvalid = None
        if build_kind == "uniform":
            bkeys = np.arange(1, r + 1, dtype=np.int64)
            keys = rng.integers(1, int(r * 1.1) + 2, n)
        elif build_kind == "sparse":
            # all but 16 build rows null: the directory's widest gaps
            bkeys = np.arange(1, r + 1, dtype=np.int64)
            live = rng.choice(r, 16, replace=False)
            bvalid = np.zeros(r, dtype=bool)
            bvalid[live] = True
            keys = np.where(rng.random(n) < 0.5, rng.choice(bkeys[live], n),
                            rng.integers(1, r + 1, n))
        else:
            # fanout 4 over distinct keys, one key 1,000 times; 70 % of
            # the probe rows draw a build key
            hot = 1000
            bkeys = np.concatenate([np.full(hot, 5, dtype=np.int64),
                                    np.repeat(rng.integers(
                                        10, 1 << 40, (r - hot) // 4), 4)])
            keys = np.where(rng.random(n) < 0.7, rng.choice(bkeys, n),
                            rng.integers(1 << 41, 1 << 42, n))
        keys = torch.from_numpy(keys).to(dev)
        valid = torch.from_numpy(rng.random(n) > 0.04).to(dev)
        excl = torch.from_numpy(rng.random(n) > 0.9).to(dev)
        n_valid = torch.tensor(n - 777, dtype=torch.int64, device=dev)
        build = torch.from_numpy(bkeys).to(dev)
        bvalid = None if bvalid is None else torch.from_numpy(bvalid).to(dev)
        rh = E.unsigned_order(E._key_hash_impl((build,), (bvalid,), 1,
                                               False, r, None))
        rh_sorted = torch.sort(rh).values
        args = ((keys,), (valid,), n_valid, excl, rh_sorted)
        c, lo = K.join_probe(*args)
        pc, plo = K.join_probe_plain(*args)
        torch.cuda.synchronize()
        good = bits_equal(torch, c, pc) and bits_equal(torch, lo, plo)
        lh = E.unsigned_order(E._key_hash_impl((keys,), (valid,), 0, False,
                                               n_valid, excl))
        nbytes = n * (8 + 1 + 1 + 16) + 8 * r
        launch = K.launcher("join_probe", *args)

        def pair():
            return (torch.searchsorted(rh_sorted, lh),
                    torch.searchsorted(rh_sorted, lh, right=True))
        kernel_cold, flush = cold_ms(torch, launch)
        records["join_probe"].append(dict(
            n=n, r=r, build=build_kind, bits=K.probe_bits(r), ok=good,
            max_abs_err=0 if good else int((c - pc).abs().max()),
            tol="bit-exact", matched_rows=int((c > 0).sum()),
            max_count=int(c.max()),
            ms=cuda_ms(torch, launch, reps=KERNEL_REPS),
            cold_ms=kernel_cold, flush_ms=flush,
            wrapper_ms=cuda_ms(torch, lambda: K.join_probe(*args)),
            plain_ms=cuda_ms(torch, lambda: K.join_probe_plain(*args)),
            searchsorted_pair_ms=cuda_ms(torch, pair),
            searchsorted_pair_cold_ms=cold_ms(torch, pair)[0],
            library_ms=None, library_call=None,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            bytes=nbytes))
        del keys, valid, excl, build, bvalid, rh, rh_sorted, c, lo, pc, plo
        del lh
    ok = all(r["ok"] for recs in records.values() for r in recs)
    return ok, records, sweep


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def ndsgen_binary() -> str:
    src = os.path.join(REPO, "native", "ndsgen")
    subprocess.run(["make", "-C", src], check=True, capture_output=True)
    return os.path.join(src, "ndsgen")


# seconds each scale's generation took, for the data and stream records
GEN_S = {}


def gen_data(binary, scale, out_dir, parallel):
    """Raw '|' data at ``scale`` in ``out_dir/<table>/`` directories, with
    ``parallel`` generator children running at once."""
    marker = os.path.join(out_dir, ".complete")
    if os.path.exists(marker):
        return out_dir
    t0 = time.time()
    shutil.rmtree(out_dir, ignore_errors=True)
    tmp = out_dir + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    procs = [subprocess.Popen([binary, "-scale", str(scale), "-dir", tmp,
                               "-parallel", str(parallel), "-child", str(c)])
             for c in range(1, parallel + 1)]
    rcs = [p.wait() for p in procs]
    if any(rcs):
        raise RuntimeError(f"ndsgen failed: {rcs}")
    for fn in os.listdir(tmp):
        if not fn.endswith(".dat"):
            continue
        table = fn[:-4].rsplit("_", 2)[0] if parallel > 1 else fn[:-4]
        os.makedirs(os.path.join(tmp, table), exist_ok=True)
        os.replace(os.path.join(tmp, fn), os.path.join(tmp, table, fn))
    os.replace(tmp, out_dir)
    with open(marker, "w"):
        pass
    GEN_S[str(scale)] = round(time.time() - t0, 3)
    return out_dir


# the background transcode of the stream and shard phases' parquet: its
# seconds and each table's
TRANSCODE = {}


def streamed_data(binary, raw, parallel):
    """SF``STREAM_SCALE``'s raw data, then it and SF``FANOUT_SCALE``'s as
    parquet through the port's ``write_table`` (``bench.transcode``, in a
    child process, so that the phases running meanwhile keep this
    process's interpreter), for the stream and shard phases."""
    gen_data(binary, STREAM_SCALE, raw, parallel)
    t0 = time.time()
    code = ("import json, sys; from nds_tpu_torch.bench import transcode; "
            "print(json.dumps([transcode(sys.argv[1], sys.argv[2]), "
            "transcode(sys.argv[3], sys.argv[4])]))")
    res = subprocess.run(
        [sys.executable, "-c", code, raw,
         os.path.join(DATA, f"sf{STREAM_SCALE}_parquet"),
         os.path.join(DATA, f"sf{FANOUT_SCALE}"),
         os.path.join(DATA, f"sf{FANOUT_SCALE}_parquet")],
        cwd=REPO, capture_output=True, text=True, check=True, timeout=900)
    TRANSCODE["tables"] = json.loads(res.stdout.strip().splitlines()[-1])[0]
    TRANSCODE["s"] = round(time.time() - t0, 3)
    return raw


def stream_file(scale) -> str:
    from nds_tpu_torch.queries import generate_query_streams
    d = os.path.join(DATA, f"stream_sf{scale}")
    generate_query_streams(d, streams=1, rngseed=SEED, scale=float(scale))
    return os.path.join(d, "query_0.sql")


# ---------------------------------------------------------------------------
# stream
# ---------------------------------------------------------------------------

# the 14 streamed A/B statements of tests/test_synccount.py
# (_STREAM_AB_QUERIES; must_stream for every one), kept here so this script
# needs nothing of the test suite
STREAM_AB = [
    """select d_year, i_brand_id, sum(ss_ext_sales_price) s
       from store_sales, date_dim, item
       where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
         and d_moy = 11
       group by d_year, i_brand_id order by d_year, s desc, i_brand_id""",
    """select ss_item_sk, ss_ext_sales_price from store_sales
       where ss_ext_sales_price > 9900 and ss_item_sk < 40
       order by ss_item_sk, ss_ext_sales_price""",
    """select ss_item_sk, count(*) c, sum(ss_ext_sales_price) s
       from store_sales where ss_ext_sales_price > 5000
       group by ss_item_sk order by ss_item_sk""",
    """select count(*) c, sum(ss_ext_sales_price) s from store_sales
       where ss_sold_date_sk in
             (select d_date_sk from date_dim where d_moy = 11)""",
    """select ss_item_sk, ss_ext_sales_price from store_sales
       order by ss_item_sk, ss_ext_sales_price""",
    """select count(*) c, sum(ss_ext_sales_price) s, min(ss_item_sk) m
       from store_sales""",
    """select ss_sold_date_sk, count(*) c from store_sales
       group by ss_sold_date_sk order by ss_sold_date_sk""",
    """select ss_item_sk, count(*) c, sum(sr_return_amt) r
       from store_sales, store_returns
       where ss_item_sk = sr_item_sk and ss_ext_sales_price > 5000
       group by ss_item_sk order by ss_item_sk""",
    """select i_brand_id, sum(sr_return_amt) r, count(*) c
       from store_sales, store_returns, item
       where ss_item_sk = sr_item_sk and ss_item_sk = i_item_sk
         and sr_return_amt > 50
       group by i_brand_id order by i_brand_id""",
    """select ss_item_sk, count(*) c from store_sales
       left join store_returns on ss_item_sk = sr_item_sk
           and ss_ticket_number = sr_ticket_number
       where sr_ticket_number is null
       group by ss_item_sk order by ss_item_sk""",
    """select sr_item_sk, sr_return_amt, ss_ext_sales_price
       from store_returns
       left join store_sales on sr_item_sk = ss_item_sk
           and sr_ticket_number = ss_ticket_number
       order by sr_item_sk, sr_return_amt, ss_ext_sales_price""",
    """select ss_item_sk, count(*) c from store_sales
       where ss_sold_date_sk in
             (select d_date_sk from date_dim where d_moy = 11)
         and ss_ext_sales_price >
             (select avg(ss_ext_sales_price) from store_sales)
       group by ss_item_sk order by ss_item_sk""",
    """select count(*) c, sum(ss_ext_sales_price) s from store_sales
       where ss_item_sk not in
             (select i_item_sk from item where i_brand_id = 1001)""",
    """select count(*) c from store_sales ss1 where exists (
           select * from store_returns sr
           where ss1.ss_item_sk = sr.sr_item_sk
             and ss1.ss_ticket_number <> sr.sr_ticket_number)""",
]
# the fan-out subset (a store_returns equi edge on the streamed scan) that
# runs again at a forced partition count of 2
STREAM_AB_PARTITIONED = (7, 8, 9, 10)
STREAM_SYNC_BUDGET = 6
# the outer-build statement (store_returns LEFT JOIN store_sales ON the
# declared store_sales key): the resident plan gathers ONE match per return
# (it trusts the key), the streamed plan keeps every match, so where the
# generated data repeats a store_sales key the streamed result has one row
# more per extra match (see duplicate_key_matches)
STREAM_AB_OUTER_BUILD = 10


def duplicate_key_matches(pq) -> int:
    """Extra matches of store_returns rows in store_sales beyond the first,
    on (item, ticket): the rows by which statement ab10 streamed exceeds
    ab10 resident. Zero when the generated data keeps the key unique."""
    import numpy as np
    from nds_tpu_torch.io import read_table
    ss = read_table(os.path.join(pq, "store_sales"), "parquet")
    sr = read_table(os.path.join(pq, "store_returns"), "parquet")

    def keys(t, a, b):
        x = t[a].to_numpy(zero_copy_only=False)
        y = t[b].to_numpy(zero_copy_only=False)
        ok = ~(np.isnan(x.astype(float)) | np.isnan(y.astype(float)))
        return x[ok].astype(np.int64) * (1 << 32) + y[ok].astype(np.int64)

    uniq, counts = np.unique(keys(ss, "ss_item_sk", "ss_ticket_number"),
                             return_counts=True)
    ret = keys(sr, "sr_item_sk", "sr_ticket_number")
    pos = np.clip(np.searchsorted(uniq, ret), 0, len(uniq) - 1)
    hit = uniq[pos] == ret
    return int((counts[pos][hit] - 1).sum())


def contains_rows(big, small) -> bool:
    """Every row of ``small`` (with multiplicity) is a row of ``big``."""
    from collections import Counter
    rows = lambda t: Counter(zip(*[t.column(i).to_pylist()  # noqa: E731
                                   for i in range(t.num_columns)]))
    return not (rows(small) - rows(big))


_LOOP_WATCH = []


def watch_chunk_loop(torch, S, PF):
    """Run every step of the streamed pipeline's chunk loop (a replay of
    the captured graph with the copy into its slots; in the eager drive
    the per-chunk program, the K4 pass and the partition routing; the
    ring's fetch) under ``torch.cuda.set_sync_debug_mode("warn")`` and
    collect the synchronizing calls it reports, each with the port's
    frames that made it. The warm-up and the capture of a graph (which
    runs under mode ``error`` itself) and the eager chunk loop are not
    watched. Installed once: a second call returns the first's list."""
    if _LOOP_WATCH:
        return _LOOP_WATCH[0]
    import threading
    import traceback
    import warnings
    found = []
    _LOOP_WATCH.append(found)
    in_pipeline = threading.local()
    in_capture = threading.local()

    def sites():
        frames = traceback.extract_stack()[:-2]
        port = [i for i, f in enumerate(frames)
                if "nds_tpu_torch" in f.filename]
        # from the innermost frame out to the fourth frame of the port
        start = port[-4] if len(port) >= 4 else 0
        return " < ".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                          f":{f.name}" for f in reversed(frames[start:]))

    def wrap(owner, name, always):
        real = getattr(owner, name)

        def inner(*a, **k):
            if getattr(in_capture, "on", False) or not (
                    always or getattr(in_pipeline, "on", False)):
                return real(*a, **k)
            with warnings.catch_warnings():
                warnings.simplefilter("always")

                def show(message, *_a, **_k):
                    # the sync debug mode's own report (other warnings,
                    # such as set_sync_debug_mode's notice, do not count)
                    if "called a synchronizing cuda operation" in \
                            str(message).lower():
                        found.append(sites())
                warnings.showwarning = show
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return real(*a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
        setattr(owner, name, inner)

    real_run = S.StreamPipeline.run

    def run(self, *a, **k):
        in_pipeline.on = True
        try:
            return real_run(self, *a, **k)
        finally:
            in_pipeline.on = False
    S.StreamPipeline.run = run
    real_capture = S.StreamPipeline._capture

    def capture(self, *a, **k):
        in_capture.on = True
        try:
            return real_capture(self, *a, **k)
        finally:
            in_capture.on = False
    S.StreamPipeline._capture = capture
    for owner, name, always in ((S.StreamPipeline, "_step", True),
                                (S.StreamPipeline, "_body", True),
                                (S.StreamPipeline, "_scan", True),
                                (S.StreamPipeline, "_route", True),
                                (S.StreamPipeline, "_sharded_chunk", True),
                                (PF.ChunkRing, "next_chunk", False),
                                (PF._InlineRing, "next_chunk", False)):
        wrap(owner, name, always)
    return found


def memory_line(torch) -> dict:
    """The card's peak and current allocated bytes, and the bytes its CUDA
    graph pools reserve (segments outside the default pool)."""
    pools = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))
    return {"peak_allocated": int(torch.cuda.max_memory_allocated()),
            "allocated": int(torch.cuda.memory_allocated()),
            "graph_pools_reserved": int(pools)}


def pool_breakdown(torch) -> dict:
    """Reserved and allocated bytes of the caching allocator's default
    pool and of the CUDA graph pools together (``memory_snapshot``)."""
    out = {"default": [0, 0], "graph_pools": [0, 0]}
    for seg in torch.cuda.memory_snapshot():
        key = "default" if tuple(seg.get("segment_pool_id", (0, 0))) == \
            (0, 0) else "graph_pools"
        out[key][0] += int(seg["total_size"])
        out[key][1] += int(seg["allocated_size"])
    return {k: {"reserved": r, "allocated": a} for k, (r, a) in out.items()}


def sync_detector_works(torch) -> bool:
    """The loop watch's own check: a known synchronizing call (a
    device-to-host ``item()``) is reported under the same mode and text."""
    import warnings
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            torch.ones(1, device="cuda").item()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return any("called a synchronizing cuda operation" in
               str(w.message).lower() for w in seen)


def stream_phase(torch, K, queries, capture):
    """The streamed path at ``STREAM_SCALE`` against an all-resident
    session; the fan-out A/B statements at ``FANOUT_SCALE``. K4's launches
    count into ``capture`` under the statement that made them."""
    from nds_tpu_torch import power as P
    from nds_tpu_torch.engine import ops as E
    from nds_tpu_torch.engine import prefetch as PF
    from nds_tpu_torch.engine import stream as S
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.engine.table import ChunkedTable
    from nds_tpu_torch.listener import drain_stream_events
    from nds_tpu_torch.power import (run_query_stream, setup_tables,
                                     strip_stream_markers)
    # the parquet of both scales comes from the background transcode
    pq = os.path.join(DATA, f"sf{STREAM_SCALE}_parquet")
    transcode_tables, transcode_s = TRANSCODE["tables"], TRANSCODE["s"]
    pq_fanout = os.path.join(DATA, f"sf{FANOUT_SCALE}_parquet")
    stream_conf = {"stream_bytes": STREAM_BYTES,
                   "stream_chunk_rows": STREAM_CHUNK_ROWS}

    def session(path, conf):
        s = Session(conf, device="cuda")
        setup_tables(s, path, "parquet", True, [])
        return s

    def chunks(s):
        return {k: v.num_chunks() for k, v in s.catalog.items()
                if isinstance(v, ChunkedTable)}

    t0 = time.time()
    resident = session(pq, {"stream_bytes": 1e15})
    streamed = session(pq, dict(stream_conf))
    load_s = time.time() - t0
    chunked = chunks(streamed)
    syncs_in_loop = watch_chunk_loop(torch, S, PF)

    last = {}
    # the pipeline cache's static operands and graph pools against their
    # budget, after every statement: the most held, and each time more
    # than one pipeline held more than the budget
    held = {"max_bytes": 0, "max_pool_bytes": 0, "over_budget": []}

    def timed(s, sql, graph=True):
        """(rows, ms, syncs, stream events) of one statement; its K4/K5
        launches and the synchronizing calls its chunk loops made land in
        ``last``."""
        drain_stream_events()
        before = E.sync_count()
        l0, w0 = dict(K.LAUNCHES), len(syncs_in_loop)
        t = time.perf_counter()
        out = s.sql(sql, graph=graph).to_arrow()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        last.update(launches=kernel_delta(l0),
                    loop_syncs=len(syncs_in_loop) - w0)
        # the budget as the session's statements see it
        with E.on_device(s.device, s.conf):
            rep = S.static_report()
        total = rep["static_bytes"] + rep["pool_bytes"]
        held.update(budget=rep["budget"],
                    max_bytes=max(held["max_bytes"], total),
                    max_pool_bytes=max(held["max_pool_bytes"],
                                       rep["pool_bytes"]))
        if total > rep["budget"] and rep["pipelines"] > 1:
            held["over_budget"].append({**rep, "statement":
                                        capture.context})
        # the first time the card is nearly all reserved: how the
        # allocator's pools share it
        if "near_full" not in held and torch.cuda.memory_reserved() > \
                0.85 * torch.cuda.get_device_properties(0).total_memory:
            held["near_full"] = {"statement": capture.context,
                                 **pool_breakdown(torch)}
        return out, ms, E.sync_count() - before, drain_stream_events()

    def kernel_delta(l0):
        return {k: K.LAUNCHES[k] - l0[k] for k in ("chunk_scan",
                                                    "join_probe")}

    def scans(events):
        return [{"table": e.where, "path": e.path, "chunks": e.chunks,
                 "partitions": e.partitions, "k4": e.scan_launches,
                 "k5": e.probe_launches, "stall_ms": round(
                     e.prefetch_stall_ms, 3), "graph": e.graph[:200],
                 "reason": e.reason[:160]} for e in events]

    def graph_problem(graphs):
        """Why a statement's compiled scans did not run as graphs (None
        when each was captured or replayed)."""
        bad = [g for g in graphs if g not in ("captured", "replayed")]
        return f"graph: {bad}" if bad else None

    def drive_launches(events):
        """K4 and K5 launches of each compiled drive (a first
        execution's record of the program is not a drive)."""
        return [[e.scan_launches, e.probe_launches] for e in events
                if e.path == "compiled"]

    def against_eager_drive(s, sql, got, events):
        """The statement again through the eager drive: (its record,
        problems) — rows equal to ``got``, each drive's K4/K5 launches
        equal to those of ``events`` (the graph run's)."""
        rows, ms, _syncs, eager = timed(s, sql, graph=False)
        why = tables_agree(got, rows)
        rec = {"eager_drive_ms": round(ms, 3),
               "eager_drive_launches": last["launches"],
               "drive_launches": drive_launches(events),
               "eager_drive_drive_launches": drive_launches(eager),
               "equal_to_eager_drive": why is None,
               "eager_drive_graph": sorted({e.graph for e in eager
                                            if e.path == "compiled"})}
        problems = []
        if why:
            problems.append(f"rows differ from the eager drive: {why}")
        if rec["drive_launches"] != rec["eager_drive_drive_launches"]:
            problems.append(f"drive launches {rec['drive_launches']} "
                            "against the eager drive's "
                            f"{rec['eager_drive_drive_launches']}")
        return rec, problems

    dup = duplicate_key_matches(pq)
    emit({"phase": "stream_setup", "scale": STREAM_SCALE,
          "gen_s": GEN_S.get(str(STREAM_SCALE)),
          "transcode_s": round(transcode_s, 3),
          "transcode_table_s": transcode_tables, "load_s": round(load_s, 3),
          "chunked_tables": chunked, "duplicate_key_matches": dup})

    def check(i, got, want, streamed):
        """None when the streamed rows of statement ``i`` are right, else
        why not. ab10 holds the resident rows plus one row per duplicate
        key match, and the eager chunk loop's rows exactly."""
        if i != STREAM_AB_OUTER_BUILD or not dup:
            return tables_agree(got, want)
        if got.num_rows != want.num_rows + dup or \
                not contains_rows(got, want):
            return (f"{got.num_rows} rows, resident {want.num_rows} + "
                    f"{dup} duplicate-key matches")
        streamed.conf["stream_exec"] = "eager"
        try:
            eager = streamed.sql(STREAM_AB[i]).to_arrow()
        finally:
            streamed.conf.pop("stream_exec")
        drain_stream_events()
        why = tables_agree(got, eager)
        return None if why is None else f"eager loop differs: {why}"

    K.reset_launches()
    records, failures = [], []
    # the raw-wire arm's statements as the encoded wire ran them: (session,
    # sql, rows, ms, stream events, K4/K5 launches)
    encoded = {}

    def run_ab(resident, streamed, indices, scale):
        """The A/B statements ``indices``, then those of them in the
        partitioned subset again at 2 partitions."""
        for i in indices:
            capture.context = "resident"
            want, res_ms, _s, _e = timed(resident, STREAM_AB[i])
            capture.context = f"ab{i}"
            got, ms, syncs, events = timed(streamed, STREAM_AB[i])
            graph_launches, loop_syncs = last["launches"], last["loop_syncs"]
            why = check(i, got, want, streamed)
            # the pipeline ran every scan — or ran it, found a bound-sized
            # pair bucket too small for this data (the overflow flag) and
            # reran it through the eager loop, by design; any other path
            # fails
            compiled = bool(events) and all(e.path == "compiled"
                                            for e in events)
            reran = bool(events) and not compiled and all(
                e.path == "compiled" or e.reason == "bound-bucket overflow"
                for e in events)
            graphs = [e.graph for e in events if e.path == "compiled"]
            rec = {"statement": f"ab{i}", "scale": scale,
                   "ms": round(ms, 3), "resident_ms": round(res_ms, 3),
                   "syncs": syncs, "rows": got.num_rows,
                   "scans": scans(events), "equal": why is None,
                   "overflow_rerun": reran, "graph": graphs,
                   "launches": graph_launches,
                   "loop_syncs": loop_syncs}
            capture.context = f"ab{i}/eager-drive"
            more, problems = against_eager_drive(streamed, STREAM_AB[i],
                                                 got, events)
            rec.update(more)
            records.append(rec)
            emit({"phase": "stream", **rec})
            if f"ab{i}" in RAW_WIRE:
                encoded[f"ab{i}"] = (streamed, STREAM_AB[i], got, ms,
                                     events, graph_launches)
            problems += [p for p in (graph_problem(graphs),) if p]
            if why or not (compiled or reran) or problems or \
                    (compiled and syncs > STREAM_SYNC_BUDGET):
                failures.append(f"ab{i}: {why or ''} compiled={compiled} "
                                f"syncs={syncs} {problems}")
        streamed.conf["stream_partitions"] = 2
        for i in (i for i in STREAM_AB_PARTITIONED if i in indices):
            capture.context = "resident"
            want, _ms, _s, _e = timed(resident, STREAM_AB[i])
            capture.context = f"ab{i}/p2"
            got, ms, syncs, events = timed(streamed, STREAM_AB[i])
            graph_launches, loop_syncs = last["launches"], last["loop_syncs"]
            why = check(i, got, want, streamed)
            parts = [e.partitions for e in events]
            reran = [e.reason for e in events] == ["bound-bucket overflow"]
            rows_ok = all(sum(e.part_rows) == e.rows for e in events)
            graphs = [e.graph for e in events if e.path == "compiled"]
            rec = {"statement": f"ab{i}/p2", "scale": scale,
                   "ms": round(ms, 3), "syncs": syncs,
                   "rows": got.num_rows, "scans": scans(events),
                   "equal": why is None, "overflow_rerun": reran,
                   "graph": graphs, "launches": graph_launches,
                   "loop_syncs": loop_syncs}
            capture.context = f"ab{i}/p2/eager-drive"
            more, problems = against_eager_drive(streamed, STREAM_AB[i],
                                                 got, events)
            rec.update(more)
            records.append(rec)
            emit({"phase": "stream", **rec})
            problems += [p for p in (graph_problem(graphs),) if p]
            if why or problems or not (
                    reran or (parts == [2] and rows_ok and
                              syncs <= STREAM_SYNC_BUDGET)):
                failures.append(f"ab{i}/p2: {why or ''} partitions={parts} "
                                f"{problems}")
        streamed.conf.pop("stream_partitions")

    t_phase = time.time()
    marks = {}
    run_ab(resident, streamed, [i for i in range(len(STREAM_AB))
                                if i not in STREAM_AB_FANOUT], STREAM_SCALE)
    fanout_streamed = session(pq_fanout, {
        "stream_bytes": FANOUT_STREAM_BYTES,
        "stream_chunk_rows": FANOUT_CHUNK_ROWS})
    fanout_chunked = chunks(fanout_streamed)
    fanout_resident = session(pq_fanout, {"stream_bytes": 1e15})
    marks["ab_stream_scale_s"] = round(time.time() - t_phase, 3)
    run_ab(fanout_resident, fanout_streamed, STREAM_AB_FANOUT, FANOUT_SCALE)
    marks["ab_fanout_s"] = round(time.time() - t_phase, 3)
    del fanout_resident
    # the 25 CI statements through the Power Run entry, parquet input
    props = os.path.join(OUT, "stream.properties")
    with open(props, "w") as f:
        for k, v in stream_conf.items():
            f.write(f"{k}={v}\n")
    summ = os.path.join(OUT, "stream_json")
    shutil.rmtree(summ, ignore_errors=True)
    real_one = P.run_one_query

    def one_query(session, q_content, query_name, *a, **k):
        capture.context = query_name
        return real_one(session, q_content, query_name, *a, **k)
    P.run_one_query = one_query
    try:
        power_s = run_query_stream(
            pq, props, queries, os.path.join(OUT, "stream_time.csv"),
            sub_queries=STREAM_CI, input_format="parquet",
            json_summary_folder=summ, allow_failure=True, device="cuda")
    finally:
        P.run_one_query = real_one
    drain_stream_events()
    marks["power_run_s"] = round(time.time() - t_phase, 3)
    first = None
    for fn in sorted(os.listdir(summ)):
        with open(os.path.join(summ, fn)) as f:
            js = json.load(f)
        q = js["query"]
        if q == "query37":
            first = ((js.get("trace") or {}).get("phases", {}),
                     js["queryTimes"][-1],
                     max((sc["chunks"] for sc in js.get("streamedScans", [])
                          if sc.get("path") == "compiled"), default=0))
        sql = strip_stream_markers(queries[q])
        capture.context = "resident"
        want, res_ms, _s, _e = timed(resident, sql)
        # the rows to compare: the statement again on the streamed session
        # (its launches count under "<q>/compare"), then through the
        # eager drive
        capture.context = f"{q}/compare"
        got, compare_ms, _syncs, events = timed(power_s, sql)
        graph_launches, loop_syncs = last["launches"], last["loop_syncs"]
        why = tables_agree(got, want)
        first_graphs = [sc.get("graph", "") for sc in
                        js.get("streamedScans", [])
                        if sc.get("path") == "compiled"]
        graphs = [e.graph for e in events if e.path == "compiled"]
        rec = {"statement": q, "scale": STREAM_SCALE,
               "ms": js["queryTimes"][-1], "resident_ms": round(res_ms, 3),
               "syncs": js["hostSyncs"], "status": js["queryStatus"][-1],
               "scans": js.get("streamedScans", []), "equal": why is None,
               "graph": first_graphs, "compare_graph": graphs,
               "compare_ms": round(compare_ms, 3),
               "launches": graph_launches, "loop_syncs": loop_syncs}
        capture.context = f"{q}/eager-drive"
        more, problems = against_eager_drive(power_s, sql, got, events)
        rec.update(more)
        records.append(rec)
        emit({"phase": "stream", **rec})
        if q in RAW_WIRE:
            encoded[q] = (power_s, sql, got, compare_ms, events,
                          graph_launches)
        problems += [p for p in (graph_problem(first_graphs),
                                 graph_problem(graphs)) if p]
        if why or problems or js["queryStatus"][-1] != "Completed":
            failures.append(f"{q}: {why} {js['queryStatus'][-1]} "
                            f"{problems}")
    drain_stream_events()
    marks["ci_s"] = round(time.time() - t_phase, 3)
    raw_line, raw_problems = raw_wire_arm(encoded, timed, last, capture,
                                          scans)
    failures += raw_problems
    encoded.clear()
    del streamed, fanout_streamed
    marks["raw_wire_s"] = round(time.time() - t_phase, 3)
    launches = dict(K.LAUNCHES)
    # the resident session's card memory goes back before the split (its
    # warm-store arms run in a child process, which needs the card too)
    del resident
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    # one streamed chunk's cost, split (query37, over inventory's chunks); its
    # launches stay out of the counts above
    capture.context = None
    split_problems, split = chunk_split(
        torch, power_s, strip_stream_markers(queries["query37"]), "query37",
        first, pq, stream_conf)
    failures += [f"chunk_split: {p}" for p in split_problems]
    # the cached pipelines' static operands and graphs go with them
    S._PIPELINE_CACHE.clear()
    marks["chunk_split_s"] = round(time.time() - t_phase, 3)
    drain_stream_events()
    if not (launches["chunk_scan"] > 0 and launches["join_probe"] > 0):
        failures.append(f"K4/K5 did not launch: {launches}")
    detector_ok = sync_detector_works(torch)
    if syncs_in_loop or not detector_ok:
        failures.append(f"{len(syncs_in_loop)} synchronizing calls inside "
                        f"the chunk loop (detector works: {detector_ok})")
    if held["over_budget"]:
        failures.append(f"pipeline cache past its budget: "
                        f"{held['over_budget'][:3]}")
    return {"phase": "stream", "ok": not failures, "scale": STREAM_SCALE,
            "chunk_rows": STREAM_CHUNK_ROWS, "stream_bytes": STREAM_BYTES,
            "chunked_tables": chunked,
            "fanout": {"statements": [f"ab{i}" for i in STREAM_AB_FANOUT],
                       "scale": FANOUT_SCALE,
                       "chunk_rows": FANOUT_CHUNK_ROWS,
                       "stream_bytes": FANOUT_STREAM_BYTES,
                       "chunked_tables": fanout_chunked},
            "gen_s": GEN_S.get(str(STREAM_SCALE)),
            "transcode_s": round(transcode_s, 3),
            "transcode_table_s": transcode_tables,
            "load_s": round(load_s, 3),
            "duplicate_key_matches": dup,
            "launches": launches,
            "syncs_in_chunk_loop": len(syncs_in_loop),
            "sync_detector_ok": detector_ok,
            "sync_sites": sorted(set(syncs_in_loop))[:40],
            "overflow_reruns": [r["statement"] for r in records
                                if r.get("overflow_rerun")],
            "seconds_since_setup": marks,
            "memory": memory_line(torch),
            "pipeline_budget": {**held,
                                "over_budget": held["over_budget"][:10]},
            "graphs": {
                "statements": sum(1 for r in records if r.get("graph")),
                "captured_or_replayed": sum(
                    1 for r in records if r.get("graph") and all(
                        g in ("captured", "replayed") for g in r["graph"])),
                "refused": {r["statement"]: r["graph"] for r in records
                            if any(g.startswith("refused")
                                   for g in r.get("graph", []))},
                "equal_to_eager_drive": sum(
                    1 for r in records if r.get("equal_to_eager_drive")),
                "loop_syncs": {r["statement"]: r["loop_syncs"]
                               for r in records if r.get("loop_syncs")}},
            "failures": failures[:40], "statements": records,
            "chunk_split": split, "raw_wire": raw_line}


def raw_wire_arm(encoded, timed, last, capture, scans):
    """The ``RAW_WIRE`` statements again under ``NDS_TPU_ENCODED=0``, on
    the sessions that ran them encoded, twice each (the first sight
    builds the plain-width wire plan, records and captures; the second
    replays): rows equal to the encoded run's bit for bit, every scan
    compiled as a graph, at most ``STREAM_SYNC_BUDGET`` syncs, no
    synchronizing call in the chunk loop, and K4/K5 launches equal to the
    encoded run's. (the ``raw_wire`` line, problems)."""
    from nds_tpu_torch.io.columnar import encoded_enabled
    problems, rows = [], []
    os.environ["NDS_TPU_ENCODED"] = "0"
    try:
        assert not encoded_enabled()
        for name in RAW_WIRE:
            if name not in encoded:
                problems.append(f"raw/{name}: no encoded run to hold it to")
                continue
            sess, sql, want, enc_ms, enc_events, enc_launches = \
                encoded[name]
            runs = []
            for sight in ("first", "again"):
                capture.context = f"raw/{name}" + (
                    "" if sight == "first" else "/again")
                got, ms, syncs, events = timed(sess, sql)
                runs.append((got, ms, syncs, events, last["launches"],
                             last["loop_syncs"]))
            (got, ms, syncs, events, launches, loop_syncs), \
                (got2, ms2, syncs2, events2, launches2, loop_syncs2) = runs
            compiled = [e for e in events + events2 if e.path == "compiled"]
            graphs = [e.graph for e in compiled]
            chunks = max((e.chunks for e in events), default=0)
            # query37's encoded rows came from its second sight; the A/B
            # statements' from their first
            held = launches2 if name.startswith("query") else launches
            rec = {
                "statement": name, "rows": got.num_rows,
                "equal_bit_for_bit": got.equals(want) and got2.equals(want),
                "first_ms": round(ms, 3), "again_ms": round(ms2, 3),
                "encoded_ms": round(enc_ms, 3), "chunks": chunks,
                "ms_per_chunk": round(ms2 / max(chunks, 1), 3),
                "encoded_ms_per_chunk": round(enc_ms / max(chunks, 1), 3),
                "h2d_bytes": sum(e.bytes_h2d for e in events2),
                "encoded_h2d_bytes": sum(e.bytes_h2d for e in enc_events),
                "syncs": [syncs, syncs2], "loop_syncs": loop_syncs
                + loop_syncs2, "graph": graphs,
                "launches": [launches, launches2],
                "encoded_launches": enc_launches,
                "scans": scans(events2)}
            rows.append(rec)
            emit({"phase": "raw_wire_statement", **rec})
            why = []
            if not rec["equal_bit_for_bit"]:
                why.append("rows differ from the encoded run")
            if not compiled or len(compiled) != len(events + events2) \
                    or any(g not in ("captured", "replayed")
                           for g in graphs):
                why.append(f"scans {[(e.path, e.graph[:80]) for e in events]}")
            if max(syncs, syncs2) > STREAM_SYNC_BUDGET or rec["loop_syncs"]:
                why.append(f"syncs {rec['syncs']}, loop {rec['loop_syncs']}")
            if held != enc_launches:
                why.append(f"launches {held} against the encoded "
                           f"{enc_launches}")
            if why:
                problems.append(f"raw/{name}: {why}")
    finally:
        os.environ.pop("NDS_TPU_ENCODED", None)
        capture.context = None
    k4 = sum(r["launches"][0]["chunk_scan"] + r["launches"][1]["chunk_scan"]
             for r in rows)
    if not k4:
        problems.append("raw wire: K4 never launched")
    q37 = next((r for r in rows if r["statement"] == "query37"), {})
    line = {"phase": "raw_wire", "ok": not problems, "scale": STREAM_SCALE,
            "statements": [r["statement"] for r in rows], "k4_launches": k4,
            "query37": {k: q37.get(k) for k in (
                "chunks", "h2d_bytes", "encoded_h2d_bytes", "ms_per_chunk",
                "encoded_ms_per_chunk", "first_ms", "again_ms",
                "encoded_ms")},
            "problems": problems}
    emit(line)
    return line, problems


# ---------------------------------------------------------------------------
# shard: the exchange and sharded streaming on the card
# ---------------------------------------------------------------------------

# shard counts of the phase (every shard on this card, inside
# ``exchange.sharing_devices``), the A/B statements at STREAM_SCALE (star join, grouped
# aggregate), the CI statements it streams there, and the fan-out template
# on the SF1 fan-out data, whose chunks cross the shards through the
# exchange (at a forced partition count of 2, as the reference's sharded
# sweep runs it)
SHARD_COUNTS = (2, 4)
SHARD_AB = (0, 2)
SHARD_CI = ("query3", "query7", "query37")
SHARD_AB_EXCHANGE = 7
EXCHANGE_SHARDS = (2, 4, 8)


def _pairs(keys):
    """Pairs an equi-join of ``keys`` with itself matches: the sum over
    the keys of their count squared."""
    import numpy as np
    return sum(int(c) * int(c) for c in np.bincount(keys))


def exchange_checks(torch):
    """``exchange_join_pairs`` on cuda against the same call on cpu (the
    50 % and 95 % dead-row cases and the skewed capacity retry of
    ``tests/test_distributed.py``) at 2, 4 and 8 shards sharing the card,
    exact pair arrays and counts; ``run_distributed_q3`` on cuda against
    its numpy answer. Returns (problems, records)."""
    import numpy as np
    from nds_tpu_torch.parallel import distributed as D
    from nds_tpu_torch.parallel import exchange as X
    problems, recs = [], []
    n = 4096
    cases = {}
    for frac in (0.5, 0.95):
        rng = np.random.default_rng(3)
        keys = rng.integers(0, 200, n)
        dead = rng.random(n) < frac
        ids = np.arange(n, dtype=np.uint64)
        lh = np.where(dead, (ids << 3) | 2, (keys.astype(np.uint64) << 3) | 4)
        rh = np.where(dead, (ids << 3) | 1, (keys.astype(np.uint64) << 3) | 4)
        cases[f"dead{int(frac * 100)}"] = (lh, rh, _pairs(keys[~dead]))
    rng = np.random.default_rng(9)
    keys = np.where(rng.random(1024) < 0.8, 7, rng.integers(0, 50, 1024))
    lh = (keys.astype(np.uint64) << 3) | 4
    cases["skew"] = (lh, lh, _pairs(keys))
    for name, (lh, rh, want) in cases.items():
        rows = torch.arange(lh.shape[0], dtype=torch.int64)
        for shards in EXCHANGE_SHARDS:
            got = {}
            for dev in ("cpu", "cuda"):
                m = X.make_mesh(shards, device=dev, share=True)
                t = time.perf_counter()
                out = X.exchange_join_pairs(
                    torch.from_numpy(lh.view(np.int64)).to(dev),
                    rows.to(dev), torch.from_numpy(rh.view(np.int64)).to(dev),
                    rows.to(dev), m)
                got[dev] = [x.cpu().numpy() for x in out]
                got[dev + "_ms"] = (time.perf_counter() - t) * 1e3
            same = all(np.array_equal(a, b)
                       for a, b in zip(got["cpu"], got["cuda"]))
            pairs = int(got["cuda"][2].sum())
            recs.append({"case": name, "shards": shards, "pairs": pairs,
                         "expected": want, "equal_to_cpu": same,
                         "cuda_ms": round(got["cuda_ms"], 3)})
            if not same or pairs != want:
                problems.append(f"exchange {name}/{shards}: pairs {pairs} "
                                f"of {want}, equal to cpu {same}")
    rng = np.random.default_rng(11)
    ni, nd, nf = 200, 400, 8_001
    item = {"i_item_sk": np.arange(1, ni + 1, dtype=np.int64),
            "i_manufact_id": rng.integers(1, 10, ni).astype(np.int64),
            "i_brand_id": rng.integers(1000, 1020, ni).astype(np.int64)}
    date_dim = {"d_date_sk": np.arange(1, nd + 1, dtype=np.int64),
                "d_moy": rng.integers(1, 13, nd).astype(np.int64),
                "d_year": 1998 + (np.arange(nd, dtype=np.int64) // 100)}
    ss = {"ss_item_sk": rng.integers(1, ni + 50, nf).astype(np.int64),
          "ss_sold_date_sk": rng.integers(1, nd + 30, nf).astype(np.int64),
          "ss_ext_sales_price": rng.integers(1, 10_000, nf).astype(np.int64)}
    want = {}
    for fk, dk, w in zip(ss["ss_item_sk"], ss["ss_sold_date_sk"],
                         ss["ss_ext_sales_price"]):
        if fk > ni or dk > nd or item["i_manufact_id"][fk - 1] != 3 or \
                date_dim["d_moy"][dk - 1] != 11:
            continue
        key = (int(date_dim["d_year"][dk - 1]), int(fk - 1))
        want[key] = want.get(key, 0) + int(w)
    for shards in (2, 8):
        out = D.run_distributed_q3(D.make_mesh(shards, share=True), ss,
                                   date_dim, item, manufact_id=3, moy=11)
        got = {(int(y), int(i)): float(v) for y, i, v in zip(
            out["d_year"], out["item_index"], out["sum_agg"])}
        ok = set(got) == set(want) and all(
            math.isclose(got[k], v, rel_tol=1e-5) for k, v in want.items())
        recs.append({"case": "q3", "shards": shards, "groups": len(got),
                     "expected_groups": len(want), "ok": ok})
        if not ok:
            problems.append(f"q3/{shards}: {len(got)} groups of {len(want)}")
    return problems, recs


def shard_phase(torch, K, queries):
    """The exchange on its own, then sharded streaming on this card: the
    A/B and CI statements of ``SHARD_AB``/``SHARD_CI`` on the stream
    phase's SF3 data and threshold and the fan-out template on the SF1
    fan-out data, at 1 shard and at each of ``SHARD_COUNTS`` (shards
    sharing the card), each twice (the capture, then a replay). Each
    sharded run's rows equal the one-shard run's bit for bit, every
    compiled scan reports the shard count asked for, its shard rows sum
    to its rows, no scan reruns eagerly (a bound-bucket overflow's rerun
    only where the one-shard run overflowed too), syncs stay within 6,
    no synchronizing call in the chunk
    loop, the fan-out template makes at least one all-to-all a chunk,
    and K4 and K5 launch. With two or more cards, the fan-out template
    runs again on shards of distinct cards. Returns (ok, lines)."""
    from nds_tpu_torch.engine import ops as E
    from nds_tpu_torch.engine import prefetch as PF
    from nds_tpu_torch.engine import stream as S
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.listener import drain_stream_events
    from nds_tpu_torch.parallel import exchange as X
    from nds_tpu_torch.power import setup_tables, strip_stream_markers
    t_phase = time.time()
    lines, problems = [], []
    card = smi_line()
    ex_problems, ex_recs = exchange_checks(torch)
    problems += ex_problems
    lines.append({"phase": "shard_exchange", "ok": not ex_problems,
                  "cases": ex_recs, "s": round(time.time() - t_phase, 3)})
    # the parquet of both scales comes from the background transcode
    pq = os.path.join(DATA, f"sf{STREAM_SCALE}_parquet")
    pq_fanout = os.path.join(DATA, f"sf{FANOUT_SCALE}_parquet")
    syncs_in_loop = watch_chunk_loop(torch, S, PF)
    S._PIPELINE_CACHE.clear()

    def session(path, conf):
        s = Session(conf, device="cuda")
        setup_tables(s, path, "parquet", True, [])
        return s

    def run(s, sql, shards, share=True):
        s.conf.update(stream_shards=shards)
        drain_stream_events()
        before, w0 = E.sync_count(), len(syncs_in_loop)
        t = time.perf_counter()
        with X.sharing_devices(share):
            out = s.sql(sql).to_arrow()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        return (out, round(ms, 3), E.sync_count() - before,
                drain_stream_events(), len(syncs_in_loop) - w0)

    t0 = time.time()
    main = session(pq, {"stream_bytes": STREAM_BYTES,
                        "stream_chunk_rows": STREAM_CHUNK_ROWS})
    fan = session(pq_fanout, {"stream_bytes": FANOUT_STREAM_BYTES,
                              "stream_chunk_rows": FANOUT_CHUNK_ROWS,
                              "stream_partitions": 2})
    load_s = round(time.time() - t0, 3)
    todo = [(f"ab{i}", main, STREAM_AB[i]) for i in SHARD_AB] + \
        [(q, main, strip_stream_markers(queries[q])) for q in SHARD_CI] + \
        [(f"ab{SHARD_AB_EXCHANGE}/p2", fan, STREAM_AB[SHARD_AB_EXCHANGE])]
    K.reset_launches()
    records = []
    for name, s, sql in todo:
        rec = {"statement": name, "card": card, "ms": {}, "first_ms": {},
               "syncs": {}, "scans": {}, "loop_syncs": 0}
        want, overflowed = None, False
        for shards in (1, *SHARD_COUNTS):
            got = []
            for _ in range(2):                  # capture, then replay
                got.append(run(s, sql, shards))
            out, ms, syncs, events, loop = got[-1]
            rec["first_ms"][shards], rec["ms"][shards] = got[0][1], ms
            rec["syncs"][shards] = max(g[2] for g in got)
            rec["loop_syncs"] += sum(g[4] for g in got)
            rec["scans"][shards] = [
                {"table": e.where, "path": e.path, "chunks": e.chunks,
                 "shards": e.shards, "shard_rows": list(e.shard_rows),
                 "rows": e.rows, "partitions": e.partitions,
                 "collectives": e.collectives, "bytes_ici": e.bytes_ici,
                 "graph": e.graph[:120], "reason": e.reason[:120]}
                for e in events]
            if shards == 1:
                # a bound-bucket overflow's eager rerun is accepted in a
                # sharded run only where the one-shard run overflowed too
                want = out
                overflowed = any(e.reason == "bound-bucket overflow"
                                 for g in got for e in g[3])
                continue
            why = None if out.equals(want) and got[0][0].equals(want) \
                else (tables_agree(out, want) or "not bit for bit")
            compiled = [e for g in got for e in g[3] if e.path == "compiled"]
            bad = [e.reason for g in got for e in g[3]
                   if e.path != "compiled"
                   and not (overflowed
                            and e.reason == "bound-bucket overflow")]
            wrong = [(e.where, e.shards) for e in compiled
                     if e.shards != shards
                     or sum(e.shard_rows) != e.rows]
            if why or bad or wrong or not compiled or \
                    rec["syncs"][shards] > STREAM_SYNC_BUDGET:
                problems.append(f"{name}/{shards}: {why} eager={bad} "
                                f"shards={wrong} compiled={len(compiled)} "
                                f"syncs={rec['syncs'][shards]}")
            if name.startswith(f"ab{SHARD_AB_EXCHANGE}") and not all(
                    e.collectives >= e.chunks for e in compiled):
                problems.append(f"{name}/{shards}: no all-to-all a chunk")
        if rec["loop_syncs"]:
            problems.append(f"{name}: {rec['loop_syncs']} synchronizing "
                            "calls in the chunk loop")
        records.append(rec)
        lines.append({"phase": "shard", **rec})
    launches = {k: K.LAUNCHES[k] for k in ("chunk_scan", "join_probe")}
    if not (launches["chunk_scan"] > 0 and launches["join_probe"] > 0):
        problems.append(f"K4/K5 did not launch: {launches}")
    distinct = None
    if torch.cuda.device_count() >= 2:
        n = min(torch.cuda.device_count(), 4)
        n = 1 << (n.bit_length() - 1)
        sql = STREAM_AB[SHARD_AB_EXCHANGE]
        want, _ms, _syncs, one, _loop = run(fan, sql, 1)
        out, ms, syncs, events, loop = run(fan, sql, n, share=False)
        overflowed = any(e.reason == "bound-bucket overflow" for e in one)
        distinct = {"shards": n, "ms": ms, "syncs": syncs,
                    "equal": out.equals(want),
                    "graph": [e.graph for e in events],
                    "reason": [e.reason for e in events],
                    "shard_rows": [list(e.shard_rows) for e in events]}
        if not out.equals(want) or any(
                e.shards != n or e.path != "compiled" and not (
                    overflowed and e.reason == "bound-bucket overflow")
                for e in events):
            problems.append(f"distinct cards: {distinct}")
    S._PIPELINE_CACHE.clear()
    del main, fan
    lines.append({"phase": "shard", "ok": not problems,
                  "device_count": torch.cuda.device_count(),
                  "counts": [1, *SHARD_COUNTS], "launches": launches,
                  "syncs_in_chunk_loop": sum(r["loop_syncs"]
                                             for r in records),
                  "distinct_cards": distinct, "load_s": load_s,
                  "smi": card, "problems": problems[:20],
                  "s": round(time.time() - t_phase, 3)})
    return not problems, lines


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

MESH_SHAPES = (2, 4)
# the forced arm: every table row-sharded (NDS_TPU_BROADCAST_BYTES=64), so
# the inner joins of two facts take the repartition join; query37
# (inventory x catalog_sales), query50 (store_sales x store_returns) and
# query84 (customer x customer_demographics) hash-join two row-sharded
# sides
MESH_FORCED = ("query3", "query37", "query50", "query84", "query96")
MESH_FORCED_BYTES = "64"
MESH_REPLAY = ("query3", "query42")
MESH_SKEW_ROWS = 2048           # the skewed join: about 2.7 million pairs
MESH_KERNELS = ("segment_sum_i64", "segment_sum_f64", "segment_minmax_f64",
                "join_probe")


def mesh_phase(torch, K, Session, base, queries):
    """The meshed resident session on this card, its shards sharing it:
    the CI statements at ``mesh_shape`` 2 and 4 at the default 128 MiB
    broadcast threshold (the fact tables past it row-sharded, store_sales
    among them; the dimensions replicated), then ``MESH_FORCED`` with
    every table row-sharded. Every statement's rows are held against the
    unmeshed session ``base`` (exact kinds bit for bit, doubles within
    rel 1e-5, row order exact), each run twice eagerly, the second
    timed. Each arm
    reports the statements equal, the exchange joins engaged, the
    collectives and their bytes, the summed ms against the unmeshed run,
    K1-K3 and K5 launches and the peak device memory. Then a skewed
    repartition join on the session's mesh, whose capacity retries must
    each reach the failure listeners, and ``MESH_REPLAY`` replayed as one
    CUDA graph on a meshed session. Returns (ok, lines)."""
    import numpy as np

    from nds_tpu_torch.engine import sharded as SH
    from nds_tpu_torch.listener import FailureListener
    from nds_tpu_torch.parallel import exchange as X
    from nds_tpu_torch.power import strip_stream_markers
    t_phase = time.time()
    card = smi_line()
    lines, problems = [], []
    sqls = {q: strip_stream_markers(queries[q]) for q in CI_QUERIES}

    def timed(s, sql):
        out = s.sql(sql).to_arrow()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = s.sql(sql).to_arrow()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    os.environ["NDS_TPU_REPLAY"] = "off"        # eager against eager
    try:
        want, plain_ms = {}, {}
        for q, sql in sqls.items():
            want[q], plain_ms[q] = timed(base, sql)
        arms = [(n, None, CI_QUERIES) for n in MESH_SHAPES] + \
            [(n, MESH_FORCED_BYTES, MESH_FORCED) for n in MESH_SHAPES]
        for n, forced, todo in arms:
            if forced:
                os.environ["NDS_TPU_BROADCAST_BYTES"] = forced
            try:
                with X.sharing_devices():
                    m = Session({"mesh_shape": n}, device="cuda")
                for name, t in base.catalog.items():
                    m.create_temp_view(name, t,
                                       base=name in base.base_tables)
            finally:
                os.environ.pop("NDS_TPU_BROADCAST_BYTES", None)
            sharded = sorted(k for k, t in m.catalog.items()
                             if t.spec == "row")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            k0 = {k: K.LAUNCHES[k] for k in MESH_KERNELS}
            ex0, g0, f0 = (SH.COUNTS[k] for k in ("exchange_joins",
                                                  "gathers", "fetches"))
            ms, diffs = {}, {}
            with X.collective_trace() as trace:
                for q in todo:
                    try:
                        got, ms[q] = timed(m, sqls[q])
                    except Exception as e:
                        diffs[q] = f"{type(e).__name__}: {str(e)[:300]}"
                        continue
                    why = tables_agree(got, want[q])
                    if why:
                        diffs[q] = why
            rec = {"phase": "mesh_arm", "mesh_shape": n,
                   "broadcast_bytes": int(forced) if forced else 128 << 20,
                   "row_sharded": sharded, "statements": len(todo),
                   "equal": len(todo) - len(diffs), "diffs": diffs,
                   "exchange_joins": SH.COUNTS["exchange_joins"] - ex0,
                   "gathers": SH.COUNTS["gathers"] - g0,
                   "fetches": SH.COUNTS["fetches"] - f0,
                   "collectives": dict(trace.counts),
                   "ms": round(sum(ms.values()), 3),
                   "unmeshed_ms": round(sum(plain_ms[q] for q in todo), 3),
                   "per_statement_ms": {q: [round(plain_ms[q], 3),
                                            round(v, 3)]
                                        for q, v in ms.items()},
                   "launches": {k: K.LAUNCHES[k] - k0[k]
                                for k in MESH_KERNELS},
                   "peak_gb": round(torch.cuda.max_memory_allocated()
                                    / 1e9, 3),
                   "smi": card}
            lines.append(rec)
            if diffs:
                problems.append(f"mesh {n} forced={forced}: {diffs}")
            if forced and not rec["exchange_joins"]:
                problems.append(f"mesh {n}: the forced arm engaged no "
                                "exchange join")
            if not forced and "store_sales" not in sharded:
                problems.append(f"mesh {n}: row-sharded {sharded}")
            del m
    finally:
        os.environ.pop("NDS_TPU_REPLAY", None)

    # a skewed repartition join: most rows share one key, so a bucket
    # overflows its first capacity and the join retries
    with X.sharing_devices():
        mesh = X.make_mesh(4, device="cuda", share=True)
    rng = np.random.default_rng(SEED)
    keys = np.where(rng.random(MESH_SKEW_ROWS) < 0.8, 7,
                    rng.integers(0, 500, MESH_SKEW_ROWS))
    h = torch.as_tensor((keys.astype(np.int64) << 3) | 4, device="cuda")
    rows = torch.arange(MESH_SKEW_ROWS, dtype=torch.int64, device="cuda")
    listener = FailureListener().register()
    r0 = X.CAPACITY_RETRIES[0]
    try:
        _li, _ri, live = X.exchange_join_pairs(h, rows, h, rows, mesh)
        pairs = int(live.sum())
    finally:
        listener.unregister()
    retries = X.CAPACITY_RETRIES[0] - r0
    reported = sum(f.where == "exchange join capacity retry"
                   for f in listener.failures)
    want_pairs = int(sum(int(c) ** 2 for c in np.bincount(keys)))
    retry = {"phase": "mesh_retry", "retries": retries,
             "reported": reported, "pairs": pairs,
             "expected_pairs": want_pairs}
    lines.append(retry)
    if not retries or reported != retries or pairs != want_pairs:
        problems.append(f"capacity retry: {retry}")

    # replay: shards sharing the card replay as one CUDA graph
    with X.sharing_devices():
        m = Session({"mesh_shape": 2, "replay": "force"}, device="cuda")
    for name, t in base.catalog.items():
        m.create_temp_view(name, t, base=name in base.base_tables)
    tiers = {}
    for q in MESH_REPLAY:
        seen = []
        for _ in range(3):
            got = m.sql(sqls[q]).to_arrow()
            seen.append(m.last_tier)
            why = tables_agree(got, want[q])
            if why:
                problems.append(f"mesh replay {q} ({m.last_tier}): {why}")
        tiers[q] = seen
        if seen != ["eager", "record", "replayed"]:
            problems.append(f"mesh replay {q}: tiers {seen} "
                            f"({m.replay_reason(sqls[q])})")
    del m
    lines.append({"phase": "mesh", "ok": not problems,
                  "replay_tiers": tiers, "problems": problems[:20],
                  "smi": card, "s": round(time.time() - t_phase, 3)})
    return not problems, lines


# ---------------------------------------------------------------------------
# agreement
# ---------------------------------------------------------------------------


SEG_KERNELS = ("segment_sum_i64", "segment_sum_f64", "segment_minmax_f64")


def group_histograms(seg_groups, run="power", scale=1):
    """The ``k1_groups`` and ``k23_groups`` lines from one run's
    launches, keyed (kernel, G, path, count-only)."""
    lines = []
    for phase, names in (("k1_groups", SEG_KERNELS[:1]),
                         ("k23_groups", SEG_KERNELS[1:])):
        by_path, hist = {}, []
        for (name, g, path, count_only), cnt in sorted(seg_groups.items()):
            if name not in names:
                continue
            key = path if phase == "k1_groups" else \
                f"{name}/{path}" + ("/count_only" if count_only else "")
            by_path[key] = by_path.get(key, 0) + cnt
            rec = {"G": g, "path": path, "launches": cnt}
            if phase == "k23_groups":
                rec = {"kernel": name, "count_only": count_only, **rec}
            hist.append(rec)
        lines.append({"phase": phase, "run": run, "scale": scale,
                      "by_path": by_path, "histogram": hist})
    return lines


def count_seg_groups(K, seg_groups):
    """Wrap K1-K3 so that each CUDA launch counts into ``seg_groups`` by
    (kernel, G, the path its plan takes, count-only); returns the function
    that puts the wrappers back."""
    reals = {name: getattr(K, name) for name in SEG_KERNELS}

    def counting(name, real):
        def wrapper(values, gids, ngroups):
            if gids.device.type == "cuda":
                path = K.segment_plan(
                    gids.numel(), ngroups, K._sm_count(gids.device),
                    group_bytes=4 if values is None else 16).path
                key = (name, ngroups, path, values is None)
                seg_groups[key] = seg_groups.get(key, 0) + 1
            return real(values, gids, ngroups)
        return wrapper
    for name, real in reals.items():
        setattr(K, name, counting(name, real))

    def restore():
        for name, real in reals.items():
            setattr(K, name, real)
    return restore


def spec_shape(flat, spec):
    """What K4's cost depends on in one launch: entry kinds, each
    column's dtype, validity and decode, dict table sizes, IN-list
    lengths, key dtypes and plen."""
    def dt(t):
        return str(t.dtype).replace("torch.", "")
    cols = [{"dtype": dt(flat[c[0]]), "valid": c[1] >= 0, "decode": c[2],
             **({"table": len(spec.tables[c[4]])} if c[2] == "dict"
                else {}),
             **({"divisor": c[5]} if c[5] != 1.0 else {})}
            for c in spec.cols]
    entries = []
    for e in spec.entries:
        ent = {"kind": e[0], "col": e[1]}
        if e[0] in ("iin", "inotin", "fin", "fnotin"):
            ent["list"] = len(e[2])
        entries.append(ent)
    return {"entries": entries, "cols": cols,
            "keys": [dt(flat[k]) for k in spec.key_slots],
            "plen": int(flat[spec.cols[0][0]].shape[0])}


class K4Capture:
    """Counts the stream phase's K4 launches by spec shape and by the
    statement that made them (``context``), and keeps each shape's first
    chunk: a device copy of the buffers it reads and its live count,
    taken on the stream with no host read, for the ``k4_real`` timings.
    A captured graph's launches count at each replay, by the shapes its
    capture recorded (a capture itself launches nothing)."""

    def __init__(self, K):
        self.K, self.real = K, K.chunk_scan
        self.context = "setup"     # None: launches are not counted
        self.shapes = {}
        self.capturing = None      # shapes the running capture records
        self.graph_shapes = {}     # id(static operands) -> shape keys

    def count(self, key):
        rec = self.shapes[key]
        rec["launches"] += 1
        by = rec["by_statement"]
        by[self.context] = by.get(self.context, 0) + 1

    def note(self, flat, n_dev, spec):
        """Count one launch (and keep the chunk of a new shape)."""
        import torch
        shape = spec_shape(flat, spec)
        key = json.dumps(shape, sort_keys=True)
        if torch.cuda.is_current_stream_capturing():
            self.capturing.append(key)   # the warm-up kept its chunk
            return
        rec = self.shapes.get(key)
        if rec is None:
            used = {c[0] for c in spec.cols} | set(spec.key_slots) | \
                {c[1] for c in spec.cols if c[1] >= 0}
            rec = self.shapes[key] = {
                "shape": shape, "launches": 0, "by_statement": {},
                "spec": spec, "n_dev": n_dev.clone(),
                "bufs": {i: flat[i].clone() for i in used}}
        self.count(key)

    def __enter__(self):
        from nds_tpu_torch.engine import stream as S

        def scan(flat, n_dev, spec):
            out = self.real(flat, n_dev, spec)
            if flat[spec.cols[0][0]].device.type == "cuda" and \
                    self.context is not None:
                self.note(flat, n_dev, spec)
            return out
        self.K.chunk_scan = scan
        self.S = S
        self.real_capture, self.real_step = S.StreamPipeline._capture, \
            S.StreamPipeline._step

        def capture(pipe, st, *a, **k):
            self.capturing = []
            try:
                return self.real_capture(pipe, st, *a, **k)
            finally:
                self.graph_shapes[id(st)] = self.capturing
                self.capturing = None

        def step(pipe, st, *a, **k):
            out = self.real_step(pipe, st, *a, **k)
            if st.graph is not None and self.context is not None:
                for key in self.graph_shapes.get(id(st), ()):
                    self.count(key)
            return out
        S.StreamPipeline._capture = capture
        S.StreamPipeline._step = step
        return self

    def __exit__(self, *exc):
        self.K.chunk_scan = self.real
        self.S.StreamPipeline._capture = self.real_capture
        self.S.StreamPipeline._step = self.real_step

    def lines(self):
        return [{"shape": r["shape"], "launches": r["launches"],
                 "by_statement": r["by_statement"]}
                for r in self.shapes.values()]


def trace_kernels(folder) -> dict:
    """Per statement, the CUDA kernels in its ``torch.profiler`` trace
    (``<query>.json`` in ``folder``) and how many of them are fills."""
    out = {}
    for fn in sorted(os.listdir(folder)):
        with open(os.path.join(folder, fn)) as f:
            events = json.load(f).get("traceEvents", [])
        names = [e.get("name", "") for e in events
                 if e.get("cat") == "kernel"]
        out[fn[:-len(".json")]] = (len(names),
                                   sum("FillFunctor" in n for n in names))
    return out


# the statement of the watchdog's cost: the CI statement with the most
# host syncs, each a fetch the armed watchdog moves to a helper thread
WATCHDOG_QUERY = "query78"
WATCHDOG_PAIRS = 7
WATCHDOG_DEADLINE_S = "600"


def watchdog_cost(torch, session, sql):
    """What arming the statement watchdog costs one statement: its wall
    with ``NDS_TPU_STATEMENT_DEADLINE_S`` unset and set, in alternating
    pairs (unset first, then set first) after a warm-up of each, with its
    host syncs (equal in both arms)."""
    from nds_tpu_torch.engine import ops as E
    key = "NDS_TPU_STATEMENT_DEADLINE_S"
    prev = os.environ.pop(key, None)
    ms = {"unset": [], "set": []}
    syncs = {"unset": set(), "set": set()}

    def one(arm, record=True):
        if arm == "set":
            os.environ[key] = WATCHDOG_DEADLINE_S
        else:
            os.environ.pop(key, None)
        s0 = E.sync_count()
        t0 = time.perf_counter()
        session.sql(sql).collect()
        torch.cuda.synchronize()
        if record:
            ms[arm].append(round((time.perf_counter() - t0) * 1e3, 3))
            syncs[arm].add(E.sync_count() - s0)

    try:
        one("unset", False)
        one("set", False)
        for i in range(WATCHDOG_PAIRS):
            for arm in (("unset", "set") if i % 2 == 0 else ("set", "unset")):
                one(arm)
    finally:
        os.environ.pop(key, None)
        if prev is not None:
            os.environ[key] = prev
    med = {a: sorted(v)[len(v) // 2] for a, v in ms.items()}
    return {"phase": "watchdog", "query": WATCHDOG_QUERY,
            "deadline_s": float(WATCHDOG_DEADLINE_S),
            "ok": syncs["unset"] == syncs["set"] and len(syncs["set"]) == 1,
            "syncs": sorted(syncs["set"]), "ms": ms, "median_ms": med,
            "median_delta_ms": round(med["set"] - med["unset"], 3)}


def launch_census(torch, sf1, queries, run_query_stream):
    """``CENSUS_QUERIES`` at SF1 through the Power Run entry with
    ``profile_folder``, with the device divisors of ``prim.true_div``
    kept: the device events the profiler summed (kernels, memcpys,
    memsets) and their device ms, the kernels and fill kernels of the
    traces, and the ``true_div`` calls. (ok, line)."""
    from nds_tpu_torch.engine import prim
    kept = prim.true_div
    arms = {}
    for arm in ("kept_divisor",):
        calls = [0]

        def counted(x, d):
            calls[0] += 1
            return kept(x, d)
        summ = os.path.join(OUT, f"census_{arm}")
        traces = os.path.join(DATA, f"census_{arm}")
        for d in (summ, traces):
            shutil.rmtree(d, ignore_errors=True)
        prim.true_div = counted
        try:
            run_query_stream(
                sf1, None, queries, os.path.join(OUT, f"census_{arm}.csv"),
                sub_queries=CENSUS_QUERIES, input_format="raw",
                json_summary_folder=summ, allow_failure=True, device="cuda",
                profile_folder=traces)
            torch.cuda.synchronize()
        finally:
            prim.true_div = kept
        per_q = {}
        for fn in sorted(os.listdir(summ)):
            if fn.endswith(".json"):
                with open(os.path.join(summ, fn)) as f:
                    js = json.load(f)
                per_q[js["query"]] = (js["queryStatus"][-1],
                                      js.get("profile", {}))
        kern = trace_kernels(traces)
        arms[arm] = {
            "completed": sum(st == "Completed" for st, _p in per_q.values()),
            "device_events": sum(p.get("kernelLaunches", 0)
                                 for _st, p in per_q.values()),
            "device_kernel_ms": round(sum(p.get("deviceKernelMs", 0)
                                          for _st, p in per_q.values()), 3),
            "kernels": sum(k for k, _f in kern.values()),
            "fill_kernels": sum(f for _k, f in kern.values()),
            "true_div_calls": calls[0],
            "kernels_by_query": {q: list(v) for q, v in kern.items()}}
    ok = all(a["completed"] == len(CENSUS_QUERIES) and a["kernels"] > 0
             for a in arms.values())
    return ok, {"phase": "census", "scale": 1, "ok": ok,
                "statements": len(CENSUS_QUERIES), **arms}


def k4_real_phase(torch, K, capture):
    """K4 at each spec shape the stream phase launched, on the first
    chunk it saw, repeated to ``SCAN_ROWS`` rows where shorter (the live
    count then covers every row but the last 12,345, as in the synthetic
    chunk): (ok, [records], [sweeps])."""
    records, sweeps, ok = [], [], True
    for rec in capture.shapes.values():
        spec, plen = rec["spec"], rec["shape"]["plen"]
        reps = -(-SCAN_ROWS // plen)
        width = 1 + max(rec["bufs"])
        flat = [None] * width
        for i, t in rec["bufs"].items():
            flat[i] = t if reps == 1 else t.repeat(reps)[:SCAN_ROWS]
        flat = tuple(flat)
        n_dev = rec["n_dev"] if plen == SCAN_ROWS else torch.tensor(
            SCAN_ROWS - 12345, dtype=torch.int64, device=rec["n_dev"].device)
        r, sweep = k4_record(torch, K, flat, n_dev, spec)
        wires = {"raw" if k.startswith("raw/") else "encoded"
                 for k in rec["by_statement"]}
        wire = wires.pop() if len(wires) == 1 else "both"
        r = dict(shape=rec["shape"], wire=wire, chunk_plen=plen,
                 live=int(n_dev), launches=rec["launches"],
                 by_statement=rec["by_statement"], **r)
        ok = ok and r["ok"]
        records.append(r)
        sweeps.append({"shape": rec["shape"], "n": SCAN_ROWS,
                       "plans": sweep})
        del flat
    return ok and bool(records), records, sweeps


def tables_agree(a, b):
    """None when two arrow results agree (exact kinds bit for bit, doubles
    within rel 1e-5), else the first difference."""
    import pyarrow as pa
    if a.num_rows != b.num_rows or a.column_names != b.column_names:
        return f"shape {a.shape}/{b.shape}"
    import numpy as np
    for i in range(a.num_columns):
        ca, cb = a.column(i), b.column(i)
        if ca.type != cb.type:
            return f"col {i} type {ca.type}/{cb.type}"
        if ca.equals(cb):               # exact: values and nulls
            continue
        if pa.types.is_floating(ca.type):
            # NaN equals NaN, and values agree within rel 1e-5 (abs 1e-12),
            # as ``math.isclose`` reads it
            na = np.asarray(ca.is_null().to_numpy(zero_copy_only=False))
            nb = np.asarray(cb.is_null().to_numpy(zero_copy_only=False))
            x = np.asarray(ca.fill_null(0.0).to_numpy(zero_copy_only=False),
                           dtype=np.float64)
            y = np.asarray(cb.fill_null(0.0).to_numpy(zero_copy_only=False),
                           dtype=np.float64)
            with np.errstate(invalid="ignore"):
                close = np.abs(x - y) <= np.maximum(
                    1e-5 * np.maximum(np.abs(x), np.abs(y)), 1e-12)
            ok = (na == nb) & (na | (np.isnan(x) & np.isnan(y)) | close)
            if ok.all():
                continue
            r = int(np.argmin(ok))
            return f"col {i} row {r}: {ca[r].as_py()}/{cb[r].as_py()}"
        la, lb = ca.to_pylist(), cb.to_pylist()
        r = next(r for r, (x, y) in enumerate(zip(la, lb)) if x != y)
        return f"col {i} row {r}: {la[r]!r}/{lb[r]!r}"
    return None


def bench_run(label, raw_dir, queries=None):
    """One ``python -m nds_tpu_torch.bench`` run at ``BENCH_SCALE`` on
    ``raw_dir`` (over ``queries``, default the whole stream), in a fresh
    process, with a fresh ledger; returns (exit code, ledger path, final
    JSON line or None)."""
    ledger = os.path.join(OUT, f"bench_{label}.jsonl")
    if os.path.exists(ledger):
        os.remove(ledger)          # a leftover ledger would be resumed
    env = dict(os.environ, NDS_BENCH_SCALE=str(BENCH_SCALE),
               NDS_BENCH_BUDGET_S=str(BENCH_BUDGET_S),
               NDS_BENCH_RESULTS_JSONL=ledger)
    sub = ["--sub_queries", ",".join(queries)] if queries else []
    res = subprocess.run(
        [sys.executable, "-m", "nds_tpu_torch.bench", "--raw-dir", raw_dir,
         *sub, "--cache-root", os.path.join(DATA, "bench_cache"),
         "--out-dir", os.path.join(OUT, f"bench_{label}")],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=BENCH_BUDGET_S + 60)
    with open(os.path.join(OUT, f"bench_{label}.log"), "w") as f:
        f.write(res.stdout + "\n# stderr\n" + res.stderr)
    final = None
    lines = res.stdout.strip().splitlines()
    if lines:
        try:
            final = json.loads(lines[-1])
        except ValueError:
            pass
    return res.returncode, ledger, final


def replay_tiers(data):
    """A resident bench ledger's replay tiers: (the statements whose
    replay failed, {replayed count, blacklisted statements and reasons}).
    The one blacklist reason a resident bench may show is the eviction of
    a slower replay; any other (a failed capture, a mismatch) is a
    failure."""
    last = {n: (r.get("replayTier") or [""])[-1]
            for n, r in data.queries.items()}
    failed = {n: t for n, t in last.items() if t.startswith(
        "blacklisted: ") and t != "blacklisted: replay slower than eager "
        "twice"}
    return failed, {
        "replayed": sum(t == "replayed" for t in last.values()),
        "blacklisted": {n: t[len("blacklisted: "):] for n, t in last.items()
                        if t.startswith("blacklisted: ")}}


def ratio_finding(a_path, b_path):
    """Ledger B's walls against ledger A's over B's statements: the
    geomean ratio, the spread of the per-statement ratios, the largest,
    and ``bench_compare``'s gate verdict (a finding, never a failure)."""
    from nds_tpu_torch.tools import bench_compare as BC
    a, b = BC.load_round(a_path), BC.load_round(b_path)
    cmp = BC.compare(a, b)
    violations = BC.gate(cmp, b_round=b, allow_missing=True)
    ratios = sorted(((r["ratio"], r["query"]) for r in cmp["rows"]),
                    reverse=True)
    rs = [round(r, 4) for r, _q in reversed(ratios)] or [None]
    return {
        "geomean_ratio": round(cmp.get("geomean_ratio", 0), 4),
        "ratio": {k: rs[min(int(f * len(rs)), len(rs) - 1)]
                  for k, f in (("min", 0), ("p25", 0.25), ("median", 0.5),
                               ("p75", 0.75), ("max", 1.0))},
        "largest_ratios": [[n, round(r, 4)] for r, n in ratios[:10]],
        "gate": {"threshold": 1.10, "per_query_threshold": 1.50,
                 "passed": not violations, "violations": violations[:12]}}


def bench_phase(raw_dir):
    """Run A of the bench entry, its ledger loaded and gated against
    itself (run B's place is the campaign phase's ``resident`` arm).
    Returns (ok, the result line, the seconds line)."""
    import contextlib
    import io
    from nds_tpu_torch.obs.ledger import load_ledger
    from nds_tpu_torch.tools import bench_compare as BC
    t0 = time.time()
    runs = {"a": bench_run("a", raw_dir)}
    problems = []
    geo, launches, counts, tiers = {}, {}, {}, {}
    for label, (rc, ledger, final) in runs.items():
        if rc != 0 or final is None or final.get("metric") != \
                "power_geomean_ms" or final.get("value") is None:
            problems.append(f"{label}: exit {rc}, final line {final}")
        data = load_ledger(ledger)
        statuses = {n: r["status"] for n, r in data.queries.items()}
        counts[label] = len(statuses)
        bad = {n: st for n, st in statuses.items() if st != "ok"}
        if bad or len(statuses) != BENCH_STATEMENTS[label]:
            problems.append(f"{label}: {len(statuses)} statements, not ok: "
                            f"{bad}")
        if data.end is None or data.end.get("status") != "completed":
            problems.append(f"{label}: end record {data.end}")
        if data.meta.get("platform") != "torch-cuda" \
                or not data.meta.get("card") \
                or not data.meta.get("powerLimit"):
            problems.append(f"{label}: meta {data.meta}")
        if any(len(r.get("passMs", ())) != 2
               for r in data.queries.values() if r["status"] == "ok"):
            problems.append(f"{label}: a record without both timed walls")
        # the bench's own launch counts (each child starts at 0), summed
        # over the timed pass of every statement. The stream has no MIN or
        # MAX of a double, so K3 launches only in the power phase's added
        # statement; the stream's SUM/AVG and COUNT launch K1 and K2
        total = {}
        for r in data.queries.values():
            for k, v in (r.get("kernelLaunches") or {}).items():
                total[k] = total.get(k, 0) + v
        launches[label] = total
        failed, tiers[label] = replay_tiers(data)
        if failed:
            problems.append(f"{label}: replays failed: {failed}")
        if not all(total.get(k, 0) > 0 for k in BENCH_KERNELS):
            problems.append(f"{label}: launches {total}")
        geo[label] = final.get("value") if final else None
    led_a = runs["a"][1]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        self_rc = BC.main([led_a, led_a, "--gate"])
        drift_rc = BC.main([led_a, led_a, "--gate", "--inject-drift"])
    drift_ok = drift_rc == 0 and "correctly rejected" in buf.getvalue()
    if self_rc != 0:
        problems.append(f"self gate exit {self_rc}")
    if not drift_ok:
        problems.append("the drift self-test did not reject")
    line = {"phase": "bench", "ok": not problems, "scale": BENCH_SCALE,
            "statements": counts, "geomean_ms": geo,
            "self_gate_rc": self_rc, "drift_rejected": drift_ok,
            "launches": launches, "replay": tiers, "problems": problems}
    seconds = {"phase": "bench_time", "s": round(time.time() - t0, 3),
               "nvidia_smi": smi_line()}
    return not problems, line, seconds


# ---------------------------------------------------------------------------
# whole-statement replay
# ---------------------------------------------------------------------------

REPLAY_REPS = 5
REPLAY_SYNC_BUDGET = 1      # host syncs a replay may make before the fetch


def _launch_delta(K, before):
    return {k: v - before.get(k, 0) for k, v in K.LAUNCHES.items()
            if v != before.get(k, 0)}


def replay_threshold(rows):
    """The lowest first-sight sync count above which every measured
    statement's replay wall is below its eager wall (None when no count
    decides it: the statement with the most syncs replays slower)."""
    pts = sorted((r["first_syncs"], r["replay_ms"] < r["eager_ms"])
                 for r in rows if r.get("replay_ms") is not None)
    for thr in sorted({s for s, _w in pts} | {0}):
        above = [w for s, w in pts if s > thr]
        if above and all(above):
            return thr
    return None


def replay_phase(torch, K, Session, sf1, queries):
    """The SF1 resident session on cuda with ``NDS_TPU_REPLAY=force``, over
    the 25 CI statements and the MIN/MAX-of-double one: per statement
    ``REPLAY_REPS`` warm eager runs with replay off after a cold one
    (median wall with the fetch, launches per kernel), the first sight
    (its syncs before the fetch), the second (record + capture: the two
    spans' ms, the tier or the blacklist reason), one first replay and
    ``REPLAY_REPS`` timed ones (median wall with the fetch, syncs before
    and with the fetch, launches per kernel); each replayed result against
    the eager one (``tables_agree``). Returns (ok, line, rows)."""
    from nds_tpu_torch.engine import ops as E
    from nds_tpu_torch.obs import trace as obs_trace
    from nds_tpu_torch.power import strip_stream_markers
    key = "NDS_TPU_REPLAY"
    prev = os.environ.get(key)
    os.environ[key] = "force"
    try:
        t0 = time.time()
        sess = load_session(Session, sf1, "cuda")
        load_s = time.time() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        todo = [(q, strip_stream_markers(queries[q])) for q in CI_QUERIES]
        todo.append(("minmax", MINMAX_SQL))
        rows, problems = [], []
        smi = smi_line()

        def one(sql):
            torch.cuda.synchronize()
            l0, s0 = dict(K.LAUNCHES), E.sync_count()
            t = time.perf_counter()
            res = sess.sql(sql)
            before_fetch = E.sync_count() - s0
            tab = res.to_arrow()
            ms = (time.perf_counter() - t) * 1e3
            return (tab, ms, before_fetch, E.sync_count() - s0,
                    _launch_delta(K, l0), sess.last_tier)

        for q, sql in todo:
            # the eager wall: the median of REPLAY_REPS warm runs with
            # replay off, after one cold run
            os.environ[key] = "off"
            one(sql)
            eager_runs = sorted((one(sql) for _ in range(REPLAY_REPS)),
                                key=lambda r: r[1])
            eager, e_ms, _s, _a, e_launch, _t = \
                eager_runs[len(eager_runs) // 2]
            os.environ[key] = "force"
            _f, f_ms, e_syncs, _e_all, _fl, _tier = one(sql)  # first sight
            obs_trace.drain_spans()
            _rec, r_ms, _rs, _ra, _rl, tier = one(sql)
            spans = {sp.name: sp.dur_ns / 1e6 for sp in obs_trace.drain_spans()
                     if getattr(sp, "name", "").startswith("replay.")}
            row = {"statement": q, "first_syncs": e_syncs,
                   "eager_ms": round(e_ms, 3),
                   "eager_ms_all": [round(r[1], 3) for r in eager_runs],
                   "first_sight_ms": round(f_ms, 3),
                   "eager_launches": e_launch,
                   "record_pass_ms": round(r_ms, 3),
                   "record_ms": round(spans.get("replay.record", 0), 3),
                   "capture_ms": round(spans.get("replay.compile", 0), 3),
                   "tier": tier, "nvidia_smi": smi}
            if tier != "record":
                # a statement that does not capture fails the phase: its
                # reason is printed, never passed over
                row["reason"] = sess.replay_reason(sql)
                problems.append(f"{q}: not captured: {row['reason']}")
                rows.append(row)
                continue
            first = one(sql)
            walls, syncs, launches, tiers, why = [], set(), [], set(), None
            for _ in range(REPLAY_REPS):
                tab, ms, s_before, s_all, lau, t = one(sql)
                walls.append(ms)
                syncs.add((s_before, s_all))
                launches.append(lau)
                tiers.add(t)
                why = why or tables_agree(tab, eager)
            walls.sort()
            row.update({
                "first_replay_ms": round(first[1], 3),
                "replay_ms": round(walls[len(walls) // 2], 3),
                "replay_ms_all": [round(w, 3) for w in walls],
                "replay_syncs_before_fetch": max(s for s, _a in syncs),
                "replay_syncs_with_fetch": max(a for _s, a in syncs),
                "replay_launches": launches[0],
                "launches_equal": all(x == e_launch for x in launches),
                "tier": sorted(tiers)[0] if len(tiers) == 1 else
                sorted(tiers), "equal": why is None})
            if why:
                problems.append(f"{q}: replayed rows differ: {why}")
            if row["replay_syncs_before_fetch"] > REPLAY_SYNC_BUDGET:
                problems.append(f"{q}: {row['replay_syncs_before_fetch']} "
                                "syncs before the fetch")
            if not row["launches_equal"] or tiers != {"replayed"}:
                problems.append(f"{q}: launches {launches[0]} against "
                                f"eager {e_launch}, tiers {sorted(tiers)}")
            rows.append(row)
        peak = torch.cuda.max_memory_allocated()
        held = torch.cuda.memory_allocated()
        captured = [r for r in rows if r.get("replay_ms") is not None]
        if not captured:
            problems.append("no statement captured")
        line = {
            "phase": "replay", "ok": not problems, "scale": 1,
            "mode": "force", "statements": len(rows),
            "captured": len(captured),
            "blacklisted": {r["statement"]: r.get("reason")
                            for r in rows if r.get("replay_ms") is None},
            "eager_ms_sum": round(sum(r["eager_ms"] for r in captured), 3),
            "replay_ms_sum": round(sum(r["replay_ms"] for r in captured), 3),
            "eager_ms_sum_all": round(sum(r["eager_ms"] for r in rows), 3),
            "captured_over_6_syncs": [r["statement"] for r in captured
                                      if r["first_syncs"] > 6],
            "sync_threshold_from_card": replay_threshold(rows),
            "peak_bytes": int(peak), "held_bytes": int(held),
            "graphs_held": len(sess._replay_cache),
            "load_s": round(load_s, 3), "s": round(time.time() - t0, 3),
            "nvidia_smi": smi, "problems": problems[:30]}
        with open(os.path.join(OUT, "replay.json"), "w") as f:
            json.dump({"line": line, "statements": rows}, f, indent=1)
        del sess
        return not problems, line, rows
    finally:
        if prev is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = prev


# the spans of a streamed statement's chunk loop, and of the set-up its
# first sight spends outside it (engine/stream.py)
LOOP_SPANS = ("stream.drive", "stream.kernel", "stream.partition",
              "stream.prefetch", "stream.materialize")
SETUP_SPANS = {"encode": "stream.encode", "record": "stream.record",
               "capture": "stream.capture", "upload": "stream.upload"}
# the tables query37 reads (the warm-store child loads only these)
SPLIT_TABLES = ("item", "inventory", "date_dim", "catalog_sales")


def _split_of(phases, wall_ms, chunks):
    """Per-chunk host split of one streamed statement from its span
    rollup (``{name: {"ms", "count"}}``): wall, the launch or Python time
    (``stream.drive`` — a graph's copy and replay, or the eager drive's
    program — plus ``stream.kernel`` and ``stream.partition``) and the
    time blocked on the prefetch ring (``stream.prefetch``); then the ms
    outside the chunk loop (the wall less the loop's spans) and its split
    by the set-up spans (codec planning and encoding, record, capture,
    first chunk's upload; ``other`` is the rest: the planner, the parts
    bound whole, the aggregation downstream, the fetch)."""
    ms = {k: v["ms"] for k, v in phases.items()}
    n = max(chunks, 1)
    outside = wall_ms - sum(ms.get(k, 0.0) for k in LOOP_SPANS)
    setup = {k: round(ms.get(sp, 0.0), 3) for k, sp in SETUP_SPANS.items()}
    setup["other"] = round(outside - sum(setup.values()), 3)
    per_chunk = {
        "wall": round(wall_ms / n, 3),
        "launch_or_python": round(sum(ms.get(k, 0.0) for k in (
            "stream.drive", "stream.kernel", "stream.partition")) / n, 3),
        "prefetch_wait": round(ms.get("stream.prefetch", 0.0) / n, 3)}
    return per_chunk, round(outside, 3), setup


def _rollup(spans):
    phases = {}
    for sp in spans:
        nm = getattr(sp, "name", "")
        if nm.startswith("stream."):
            ph = phases.setdefault(nm, {"ms": 0.0, "count": 0})
            ph["ms"] += sp.dur_ns / 1e6
            ph["count"] += 1
    return phases


def _sight(torch, session, sql, graph=True):
    """One run of a streamed statement: (arrow rows, wall ms, span
    rollup, its streamed scans' chunks, their graph statuses)."""
    from nds_tpu_torch.listener import drain_stream_events
    from nds_tpu_torch.obs import trace as obs_trace
    obs_trace.drain_spans()
    drain_stream_events()
    torch.cuda.synchronize()
    t = time.perf_counter()
    rows = session.sql(sql, graph=graph).to_arrow()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    phases = _rollup(obs_trace.drain_spans())
    events = [e for e in drain_stream_events() if e.path == "compiled"]
    return (rows, wall, phases, max((e.chunks for e in events), default=0),
            [e.graph[:200] for e in events])


def split_arm(torch, session, sql, graph):
    """One arm of the split: an unprofiled run (wall, spans) and a run
    under ``torch.profiler`` (device kernel time): (rows, record)."""
    from nds_tpu_torch.power import _profiler, profile_summary
    rows, wall, phases, n, graphs = _sight(torch, session, sql, graph)
    per_chunk, outside, _setup = _split_of(phases, wall, n)
    prof = _profiler(torch.device("cuda"))
    with prof:
        t = time.perf_counter()
        session.sql(sql, graph=graph).collect()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t) * 1e3
    dev_ms = profile_summary(prof)["deviceKernelMs"]
    per_chunk["device"] = round(dev_ms / max(n, 1), 3)
    return rows, {"wall_ms": round(wall, 3), "chunks": n, "graph": graphs,
                  "per_chunk_ms": per_chunk,
                  "outside_chunk_loop_ms": outside,
                  "span_ms": {k: round(v["ms"], 3)
                              for k, v in sorted(phases.items())},
                  "profiled_wall_ms": round(prof_wall, 3),
                  "device_kernel_ms": dev_ms}


def first_sight_record(wall, phases, n, graphs=None):
    per_chunk, outside, setup = _split_of(phases, wall, n)
    rec = {"wall_ms": round(wall, 3), "chunks": n, "per_chunk_ms": per_chunk,
           "outside_chunk_loop_ms": outside, "outside_split_ms": setup,
           "device": "not measured"}
    if graphs is not None:
        rec["graph"] = graphs
    return rec


def chunk_split(torch, session, sql, name, first, pq, conf):
    """One streamed statement's cost a chunk, in four arms: the eager
    drive and the graph, each with the chunk store off (this process,
    the pipeline cached) and with a warm store (a child process, so that
    the first sight is a new process's). Each arm gives per chunk the
    wall, the launch or Python time, the prefetch wait and the device
    time (a second run under ``torch.profiler``). The first sights (the
    Power Run's, store off, and the child's, warm store) split their time
    outside the chunk loop by span. Returns (problems, line)."""
    import subprocess
    problems = []
    arms = {}
    g_rows, arms["graph/store_off"] = split_arm(torch, session, sql, True)
    e_rows, arms["eager/store_off"] = split_arm(torch, session, sql, False)
    why = tables_agree(g_rows, e_rows)
    if why:
        problems.append(f"graph rows differ from the eager drive: {why}")
    # warm the store in this process (the wire plan is saved once), then
    # read it in a child
    store = os.path.join(DATA, "chunk_store")
    shutil.rmtree(store, ignore_errors=True)
    os.environ["NDS_TPU_CHUNK_STORE"] = store
    try:
        t = time.perf_counter()
        cold_rows = session.sql(sql).to_arrow()
        cold_ms = (time.perf_counter() - t) * 1e3
    finally:
        os.environ.pop("NDS_TPU_CHUNK_STORE", None)
    entries = sorted(d for d in os.listdir(store) if not d.startswith("."))
    if tables_agree(cold_rows, g_rows) or not entries:
        problems.append(f"cold store run: entries {entries}")
    # the child needs the card: this process's cached pipelines (their
    # static operands and graphs) and cached blocks go back first
    import gc
    from nds_tpu_torch.engine import stream as S
    S._PIPELINE_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    spec = os.path.join(OUT, "chunk_split_child.json")
    with open(spec, "w") as f:
        json.dump({"pq": pq, "conf": conf, "sql": sql,
                   "tables": list(SPLIT_TABLES)}, f)
    t = time.time()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--chunk-split-child",
         spec], capture_output=True, text=True, timeout=900,
        env=dict(os.environ, NDS_TPU_CHUNK_STORE=store))
    child_s = round(time.time() - t, 3)
    child = None
    if proc.returncode == 0 and proc.stdout.strip():
        child = json.loads(proc.stdout.strip().splitlines()[-1])
    if child is None:
        problems.append(f"warm-store child failed ({proc.returncode}): "
                        f"{proc.stderr[-1500:]}")
    else:
        arms.update(child["arms"])
        if child["rows"] != json.loads(json.dumps(
                [list(r.values()) for r in g_rows.to_pylist()],
                default=str)):
            problems.append("warm-store rows differ from the store-off rows")
        if child["wire_plans_built"]:
            problems.append(f"the warm store re-encoded "
                            f"{child['wire_plans_built']} column sets")
    for arm, rec in arms.items():
        # a pipeline whose parts are bound anew by each execution (query37
        # binds catalog_sales whole) records and captures at each
        want = ("eager drive",) if arm.startswith("eager") else \
            ("captured", "replayed")
        if len(rec["graph"]) != 1 or rec["graph"][0] not in want:
            problems.append(f"{arm}: graph {rec['graph']}, not {want}")
    line = {"phase": "chunk_split", "statement": name, "ok": not problems,
            "scale": STREAM_SCALE, "arms": arms,
            "store": {"entries": len(entries), "cold_run_ms": round(cold_ms, 3),
                      "child_s": child_s},
            "problems": problems}
    if first is not None:
        f_phases, f_wall, f_n = first
        line["first_sight"] = {
            "store_off": first_sight_record(f_wall, f_phases, f_n)}
        if child is not None:
            line["first_sight"]["store_warm"] = child["first_sight"]
    line["nvidia_smi"] = smi_line()
    return problems, line


def chunk_split_child(spec_path) -> int:
    """The warm-store arms of ``chunk_split`` in a fresh process: a cuda
    session over ``SPLIT_TABLES`` only, the first sight (its time outside
    the loop split by span), then the graph and eager-drive arms. Prints
    one JSON line."""
    import torch
    sys.path.insert(0, REPO)
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.engine.table import ChunkedTable
    from nds_tpu_torch.schema import get_schemas
    with open(spec_path) as f:
        spec = json.load(f)
    built = []
    real = ChunkedTable._build_wire_plan

    def building(self):
        built.append(tuple(self.column_names))
        return real(self)
    ChunkedTable._build_wire_plan = building
    s = Session(spec["conf"], device="cuda")
    schemas = get_schemas(use_decimal=True)
    t = time.time()
    for tname in spec["tables"]:
        s.read_columnar_view(tname, os.path.join(spec["pq"], tname),
                             "parquet", {fl.name: str(fl.type)
                                         for fl in schemas[tname]})
    load_s = round(time.time() - t, 3)
    rows, wall, phases, n, graphs = _sight(torch, s, spec["sql"])
    first = first_sight_record(wall, phases, n, graphs)
    first["load_s"] = load_s
    arms = {}
    _r, arms["graph/store_warm"] = split_arm(torch, s, spec["sql"], True)
    _r, arms["eager/store_warm"] = split_arm(torch, s, spec["sql"], False)
    print(json.dumps({"rows": [list(r.values()) for r in rows.to_pylist()],
                      "first_sight": first, "arms": arms,
                      "wire_plans_built": len(built)}, default=str))
    return 0


# the full_bench phase: the whole NDS pipeline through the port's
# orchestrator at SF1 with 4 streams (Throughput 1 runs streams 1 and 2 at
# once on the card, Throughput 2 stream 3; refresh sets 1-3: fewer
# streams than bench.yml's, for the smoke's time limit), every step a
# subprocess on the card
FULL_SCALE = 1
FULL_STREAMS = 4
FULL_REFRESH_SETS = range(1, FULL_STREAMS)
FULL_TIMEOUT_S = 900
FULL_STATEMENTS = 103          # a generated stream's statements
FULL_DM_FUNCTIONS = 11
FULL_KERNELS = ("segment_sum_i64", "segment_sum_f64", "segment_minmax_f64")
# the orchestrator's steps by phase, in the order they run
FULL_STEPS = {
    "Power": ["power"],
    "Throughput 1": ["throughput_1", "throughput_2"],
    "Maintenance 1": ["maintenance_1", "maintenance_2"],
    "Throughput 2": ["throughput_3"],
    "Maintenance 2": ["maintenance_3"],
}


def gen_refresh_sets(scale, parallel):
    """Refresh sets ``FULL_REFRESH_SETS`` at ``scale`` beside its base
    data, where the
    orchestrator's data step puts them (``<raw>_<i>``), through the port's
    data generation."""
    import argparse
    from nds_tpu_torch import datagen
    raw = os.path.join(DATA, f"sf{scale}")
    for i in FULL_REFRESH_SETS:
        out = f"{raw}_{i}"
        marker = os.path.join(out, ".complete")
        if os.path.exists(marker):
            continue
        t0 = time.time()
        shutil.rmtree(out, ignore_errors=True)
        datagen.generate_data(argparse.Namespace(
            type="local", scale=str(scale), parallel=max(parallel, 2),
            data_dir=out, range=None, overwrite_output=True, update=str(i),
            rngseed=None))
        with open(marker, "w"):
            pass
        GEN_S[f"{scale}_refresh_{i}"] = round(time.time() - t0, 3)


def full_bench_config(root):
    """The orchestrator's configuration: the keys of the repo's
    ``bench.yml``, the data step skipped (the data phase wrote base data
    and refresh sets), every other step run."""
    raw = os.path.join(DATA, f"sf{FULL_SCALE}")
    return {
        "device": "cuda",
        "data_gen": {"scale_factor": FULL_SCALE, "parallel": 2,
                     "raw_data_path": raw, "local_or_dist": "local",
                     "skip": True},
        "load_test": {"output_path": os.path.join(root, "warehouse"),
                      "warehouse_type": "iceberg",
                      "report_path": os.path.join(root, "load_test.txt"),
                      "skip": False},
        "generate_query_stream": {
            "num_streams": FULL_STREAMS, "query_template_dir": None,
            "stream_output_path": os.path.join(root, "streams"),
            "skip": False},
        "power_test": {"report_path": os.path.join(root, "power.csv"),
                       "property_path": None, "output_path": None,
                       "skip": False},
        "throughput_test": {
            "report_base_path": os.path.join(root, "throughput"),
            "skip": False},
        "maintenance_test": {
            "query_dir": os.path.join(REPO, "data_maintenance"),
            "maintenance_report_base_path": os.path.join(root,
                                                         "maintenance"),
            "skip": False},
        "metrics_report_path": os.path.join(root, "metrics.csv"),
        "json_summary_folder": os.path.join(root, "summaries"),
    }


def concurrent_first_build(K):
    """Two processes that find no built kernel library build it at once:
    each links to its own temporary file and renames it into place, so
    both must load. Returns the line's fields."""
    lib = os.path.join(K.build_dir(), "libnds_kernels.so")
    aside = lib + ".aside"
    os.replace(lib, aside)
    t0 = time.time()
    code = ("from nds_tpu_torch.engine import kernels as K; K._lib(); "
            "print('loaded')")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if os.path.exists(lib):
            os.remove(aside)
        else:
            os.replace(aside, lib)
    loaded = [p.returncode == 0 and "loaded" in o for p, (o, _e) in
              zip(procs, outs)]
    return {"ok": all(loaded), "loaded": loaded,
            "s": round(time.time() - t0, 3),
            "errors": [e[-500:] for (_o, e), ok in zip(outs, loaded)
                       if not ok]}


def step_evidence(folder):
    """One step's JSON summaries: statements, those not Completed, host
    syncs, K1-K3 launches and the process's peak device memory."""
    docs = []
    for fn in sorted(os.listdir(folder)):
        with open(os.path.join(folder, fn)) as f:
            docs.append(json.load(f))
    launches = {k: sum(d.get("kernelLaunches", {}).get(k, 0) for d in docs)
                for k in FULL_KERNELS}
    peak = max((d.get("peakHbmCumulativeBytes", 0) for d in docs),
               default=0)
    return {"statements": sum(d.get("statements", 1) for d in docs),
            "units": len(docs),
            "not_completed": sorted(d["query"] for d in docs
                                    if d["queryStatus"] != ["Completed"]),
            "host_syncs": sum(d.get("hostSyncs", 0) for d in docs),
            "launches": launches, "peak_device_bytes": peak or None}


def maintenance_agree(root):
    """Refresh set 1's 11 functions on ``cpu``, on the warehouse as it
    stood before Maintenance 1 (each table's first snapshot, hard-linked),
    each committed snapshot held against the one the ``cuda`` run
    committed: exact kinds bit for bit, doubles within rel 1e-5."""
    from nds_tpu_torch import maintenance as M
    from nds_tpu_torch.warehouse import Warehouse
    t0 = time.time()
    src = Warehouse(os.path.join(root, "warehouse"))
    dst = os.path.join(root, "agree_cpu")
    shutil.rmtree(dst, ignore_errors=True)
    for t in src.tables():
        first = src.snapshots(t)[0]
        os.makedirs(os.path.join(dst, t))
        shutil.copytree(os.path.join(src.root, t, first["file"]),
                        os.path.join(dst, t, first["file"]),
                        copy_function=os.link)
        with open(os.path.join(dst, t, "metadata.json"), "w") as f:
            json.dump({"snapshots": [first]}, f, indent=1)
    commits, current = [], {}
    real_commit, real_run = Warehouse._commit, M.run_dm_query

    def committing(self, table, arrow, meta):
        real_commit(self, table, arrow, meta)
        commits.append((table, meta["snapshots"][-1]["id"], current["fn"]))

    def running(session, query_list, query_name):
        current["fn"] = query_name
        return real_run(session, query_list, query_name)
    Warehouse._commit, M.run_dm_query = committing, running
    try:
        _session, failed = M.run_maintenance(
            dst, os.path.join(DATA, f"sf{FULL_SCALE}_1"),
            os.path.join(REPO, "data_maintenance"),
            os.path.join(root, "agree_cpu.csv"), device="cpu")
    finally:
        Warehouse._commit, M.run_dm_query = real_commit, real_run
    del _session
    cpu = Warehouse(dst)
    diffs = []
    for table, sid, fn in commits:
        try:
            a, b = src.read(table, sid), cpu.read(table, sid)
            why = "schema" if a.schema != b.schema else tables_agree(a, b)
        except Exception as e:
            why = f"{type(e).__name__}: {e}"[:300]
        if why:
            diffs.append({"table": table, "function": fn, "snapshot": sid,
                          "diff": why})
    functions = sorted({fn for _t, _s, fn in commits})
    return {"phase": "maintenance_agree", "refresh_set": 1,
            "ok": not diffs and not failed and
            len(functions) == FULL_DM_FUNCTIONS,
            "functions": len(functions), "snapshots": len(commits),
            "failed": failed, "diffs": diffs,
            "s": round(time.time() - t0, 3)}


def full_bench_phase(K):
    """The whole benchmark through ``python -m nds_tpu_torch.nds_bench``
    at SF1 on cuda, then the cpu agreement of refresh set 1. Returns (ok,
    [lines])."""
    t0 = time.time()
    root = os.path.join(DATA, "full_bench")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    lines = []
    build = concurrent_first_build(K)
    lines.append({"phase": "full_bench_build", **build})
    cfg_path = os.path.join(root, "bench.yml")
    with open(cfg_path, "w") as f:
        json.dump(full_bench_config(root), f, indent=1)   # JSON is YAML
    env = {k: v for k, v in os.environ.items()
           if k not in ("NDS_TPU_CONCURRENT_QUERIES", "NDS_TPU_REPLAY")}
    t1 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "nds_tpu_torch.nds_bench", cfg_path],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=FULL_TIMEOUT_S)
    bench_s = round(time.time() - t1, 3)
    with open(os.path.join(OUT, "full_bench.log"), "w") as f:
        f.write(res.stdout + "\n# stderr\n" + res.stderr)
    problems = []
    if res.returncode != 0:
        problems.append(f"nds_bench exit {res.returncode}: "
                        f"{res.stderr.strip()[-1500:]}")
    metrics = {}
    mpath = os.path.join(root, "metrics.csv")
    if os.path.exists(mpath):
        with open(mpath) as f:
            metrics = dict(ln.strip().split(",", 1) for ln in f
                           if "," in ln)
    if not metrics.get("perf_metric"):
        problems.append("metrics.csv missing or empty")
    phases = {}
    sums = os.path.join(root, "summaries")
    for phase, steps in FULL_STEPS.items():
        rec = {}
        for step in steps:
            folder = os.path.join(sums, step)
            if not os.path.isdir(folder):
                problems.append(f"{step}: no summaries")
                continue
            ev = step_evidence(folder)
            want = FULL_DM_FUNCTIONS if phase.startswith("Maintenance") \
                else FULL_STATEMENTS
            if ev["units"] != want or ev["not_completed"]:
                problems.append(f"{step}: {ev['units']} of {want} ran, not "
                                f"Completed: {ev['not_completed']}")
            if not phase.startswith("Maintenance") and not all(
                    ev["launches"][k] > 0 for k in FULL_KERNELS[:2]):
                problems.append(f"{step}: K1/K2 not launched "
                                f"{ev['launches']}")
            rec[step] = ev
        phases[phase] = rec
    times = {k: float(metrics[k]) for k in ("Tld", "TPower", "Ttt1", "Ttt2",
                                            "Tdm1", "Tdm2") if k in metrics}
    lines.append({"phase": "full_bench", "scale": FULL_SCALE,
                  "streams": FULL_STREAMS, "device": "cuda",
                  "ok": not problems and build["ok"], "problems": problems,
                  "times_s": times,
                  "perf_metric": int(metrics["perf_metric"])
                  if metrics.get("perf_metric") else None,
                  "bench_s": bench_s, "phases": phases})
    agree = {"phase": "maintenance_agree", "ok": False,
             "error": "not run: the benchmark did not complete"}
    if res.returncode == 0:
        import gc
        import torch
        gc.collect()
        torch.cuda.empty_cache()
        try:
            agree = maintenance_agree(root)
        except Exception:
            import traceback
            agree["error"] = traceback.format_exc()[-2000:]
    lines.append(agree)
    lines.append({"phase": "full_bench_seconds",
                  "s": round(time.time() - t0, 3), "nvidia_smi": smi_line()})
    return (not problems and build["ok"] and agree["ok"]), lines


# ---------------------------------------------------------------------------
# validate: the card's Power Run outputs against the CPU's at SF1
# ---------------------------------------------------------------------------

VALIDATE_QUERIES = CI_QUERIES
VALIDATE_PERTURB = 1e-3            # the relative change the validator catches
VALIDATE_TIMEOUT_S = 600


def _unmatched(stdout):
    """The validator's unmatched list, from its last summary line."""
    import ast
    for ln in reversed(stdout.splitlines()):
        if ln.startswith("=== Unmatch Queries: "):
            return ast.literal_eval(ln[len("=== Unmatch Queries: "):-4])
    return []


def _statuses(folder) -> dict:
    out = {}
    for fn in os.listdir(folder):
        with open(os.path.join(folder, fn)) as f:
            js = json.load(f)
        out[js["query"]] = (js.get("queryValidationStatus") or [None])[0]
    return out


def perturb_one_double(src, dst, queries):
    """Copy the output folder ``src`` to ``dst`` and multiply the first
    finite non-zero double of the first statement that has one by
    1 + ``VALIDATE_PERTURB``; returns that statement."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from nds_tpu_torch.io.columnar import read_table
    shutil.copytree(src, dst)
    for q in queries:
        path = os.path.join(dst, q)
        if not os.path.isdir(path):
            continue
        table = read_table(path)
        for name in table.column_names:
            if table.schema.field(name).type != pa.float64():
                continue
            vals = table.column(name).to_pylist()
            hit = next((i for i, v in enumerate(vals) if v is not None
                        and math.isfinite(v) and v != 0), None)
            if hit is None:
                continue
            vals[hit] *= 1 + VALIDATE_PERTURB
            table = table.set_column(table.schema.get_field_index(name),
                                     name, pa.array(vals, pa.float64()))
            shutil.rmtree(path)
            os.makedirs(path)
            pq.write_table(table, os.path.join(path, "part-0.parquet"))
            return q
    raise RuntimeError("no statement output holds a finite double")


def start_validation_runs(sf1):
    """The CI statements at SF1 through ``python -m nds_tpu_torch.power``
    on cuda and on cpu, a process each in the background, started before
    the shard phase (the shard and agreement phases run meanwhile):
    returns the handle :func:`validate_phase` waits on."""
    root = os.path.join(OUT, "validate")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    stream, subset = stream_file(1), ",".join(VALIDATE_QUERIES)
    handle = {"t0": time.time(), "root": root, "stream": stream,
              "subset": subset, "procs": {}}
    procs = handle["procs"]
    for dev in ("cpu", "cuda"):
        log = open(os.path.join(root, f"{dev}.log"), "w")
        procs[dev] = (time.time(), log, subprocess.Popen(
            [sys.executable, "-m", "nds_tpu_torch.power", sf1, stream,
             os.path.join(root, f"{dev}_time.csv"), "--input_format", "raw",
             "--device", dev, "--output_prefix",
             os.path.join(root, f"{dev}_out"), "--json_summary_folder",
             os.path.join(root, f"{dev}_json"), "--sub_queries", subset],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
    return handle


def stop_validation_runs(handle):
    """Kill what :func:`start_validation_runs` left running."""
    for _t, log, p in handle["procs"].values():
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


def validate_phase(handle):
    """Waits for the two Power Runs of :func:`start_validation_runs`,
    holds them against each other with ``python -m
    nds_tpu_torch.validate``, then a copy of the cuda output with one
    double changed by ``VALIDATE_PERTURB`` relative, which the validator
    must catch. (ok, line)."""
    from nds_tpu_torch.io.columnar import read_table
    t0, root = handle["t0"], handle["root"]
    stream, subset, procs = handle["stream"], handle["subset"], \
        handle["procs"]
    run_s, problems = {}, []
    for dev, (t, log, p) in procs.items():
        try:
            rc = p.wait(timeout=max(VALIDATE_TIMEOUT_S
                                    - (time.time() - t0), 1))
        except subprocess.TimeoutExpired:
            p.kill()
            rc = p.wait()
        log.close()
        run_s[dev] = round(time.time() - t, 3)
        if rc != 0:
            problems.append(f"{dev} Power Run exit {rc}")
    cpu_out, cuda_out = (os.path.join(root, f"{d}_out")
                         for d in ("cpu", "cuda"))

    def validate(actual, summaries, label):
        res = subprocess.run(
            [sys.executable, "-m", "nds_tpu_torch.validate", cpu_out,
             actual, stream, "--json_summary_folder", summaries,
             "--sub_queries", subset],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        with open(os.path.join(root, f"validate_{label}.log"), "w") as f:
            f.write(res.stdout + "\n# stderr\n" + res.stderr)
        return res.returncode, _unmatched(res.stdout), _statuses(summaries)

    rows = 0
    line = {"phase": "validate", "scale": 1,
            "statements": len(VALIDATE_QUERIES), "run_s": run_s}
    if not problems:
        rows = sum(read_table(os.path.join(cpu_out, q)).num_rows
                   for q in VALIDATE_QUERIES)
        rc, unmatched, statuses = validate(
            cuda_out, os.path.join(root, "cuda_json"), "cuda")
        not_pass = {q: st for q, st in statuses.items() if st != "Pass"}
        if rc != 0 or unmatched or not_pass or \
                len(statuses) != len(VALIDATE_QUERIES):
            problems.append(f"cuda against cpu: exit {rc}, unmatched "
                            f"{unmatched}, not Pass {not_pass}")
        pert_json = os.path.join(root, "perturbed_json")
        shutil.copytree(os.path.join(root, "cuda_json"), pert_json)
        changed = perturb_one_double(cuda_out, os.path.join(
            root, "perturbed_out"), VALIDATE_QUERIES)
        prc, punmatched, pstatuses = validate(
            os.path.join(root, "perturbed_out"), pert_json, "perturbed")
        fails = sorted(q for q, st in pstatuses.items() if st != "Pass")
        if prc != 1 or punmatched != [changed] or fails != [changed] or \
                pstatuses.get(changed) != "Fail":
            problems.append(f"perturbed {changed}: exit {prc}, unmatched "
                            f"{punmatched}, not Pass {fails}")
        line.update(rows=rows, validator_rc=rc, unmatched=unmatched,
                    statuses=sorted(set(statuses.values()), key=str),
                    perturbed={"statement": changed,
                               "relative": VALIDATE_PERTURB,
                               "validator_rc": prc,
                               "unmatched": punmatched,
                               "status": pstatuses.get(changed)})
    line.update(ok=not problems, problems=problems,
                s=round(time.time() - t0, 3), nvidia_smi=smi_line())
    return not problems, line


# ---------------------------------------------------------------------------
# campaign: three arms of the bench entry through the campaign CLI
# ---------------------------------------------------------------------------

# the streamed arms, then ``resident`` (the streaming threshold unset:
# every table resident, the statements replayed), which is run B: the
# same statements as run A's first 15 in a fresh process
CAMPAIGN_ARMS = (("base", {}), ("encoded-off", {"NDS_TPU_ENCODED": "0"}),
                 ("prefetch-off", {"NDS_TPU_PREFETCH_DEPTH": "0"}),
                 ("resident", {"NDS_TPU_STREAM_BYTES": ""}))
# store_sales, catalog_sales and inventory past it at SF1 (the stream
# phase's 1.5e8 a scale unit)
CAMPAIGN_STREAM_BYTES = "1.5e8"


def campaign_phase(sf1, baseline):
    """``python -m nds_tpu_torch.tools.campaign`` over ``CAMPAIGN_ARMS``
    (the bench entry on ``BENCH_B_QUERIES`` at SF1, the facts streamed
    but in ``resident``): every arm completes; the same command again
    skips every arm; the report has a row an arm and the encoded/raw
    delta; each arm's gate against ``baseline`` (the bench phase's run A)
    is a finding; ``resident`` streams nothing and its replays are sound,
    and its ratios to run A are the A-versus-B finding; ``base`` against
    ``resident`` is the streamed path's cost; the trace report renders
    ``base``'s traces. (ok, line)."""
    import shlex
    from nds_tpu_torch.obs.campaign import load_manifest
    from nds_tpu_torch.obs.ledger import load_ledger
    from nds_tpu_torch.tools import bench_compare as BC
    t0 = time.time()
    d = os.path.join(OUT, "campaign")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    matrix = os.path.join(OUT, "campaign_matrix.json")
    with open(matrix, "w") as f:
        json.dump({"v": 1, "env": {
            "NDS_BENCH_SCALE": str(BENCH_SCALE),
            "NDS_BENCH_BUDGET_S": str(BENCH_BUDGET_S),
            "NDS_TPU_STREAM_BYTES": CAMPAIGN_STREAM_BYTES},
            "arms": [{"name": n, "env": e} for n, e in CAMPAIGN_ARMS]}, f)
    bench = " ".join(shlex.quote(x) for x in (
        sys.executable, "-m", "nds_tpu_torch.bench", "--raw-dir", sf1,
        "--cache-root", os.path.join(DATA, "bench_cache"), "--out-dir",
        os.path.join(d, "bench_out"), "--sub_queries",
        ",".join(BENCH_B_QUERIES)))
    base_cmd = [sys.executable, "-m", "nds_tpu_torch.tools.campaign",
                "--matrix", matrix, "--dir", d]

    def cli(label, *extra):
        res = subprocess.run(
            base_cmd + list(extra), cwd=REPO, capture_output=True,
            text=True, timeout=len(CAMPAIGN_ARMS) * (BENCH_BUDGET_S + 90))
        with open(os.path.join(OUT, f"campaign_{label}.log"), "w") as f:
            f.write(res.stdout + "\n# stderr\n" + res.stderr)
        return res
    problems, marks = [], {}
    run = cli("run", "--bench-cmd", bench)
    marks["run_s"] = round(time.time() - t0, 3)
    manifest = load_manifest(d) or {"arms": []}
    statuses = {a["name"]: a["status"] for a in manifest["arms"]}
    if run.returncode != 0 or set(statuses.values()) != {"completed"}:
        problems.append(f"run: exit {run.returncode}, arms {statuses}")
    again = cli("again", "--bench-cmd", bench)
    marks["again_s"] = round(time.time() - t0 - marks["run_s"], 3)
    again_st = {a["name"]: a["status"]
                for a in (load_manifest(d) or {"arms": []})["arms"]}
    skipped = again.stderr.count("already completed")
    if again.returncode != 0 or skipped != len(CAMPAIGN_ARMS) or \
            set(again_st.values()) != {"done"}:
        problems.append(f"rerun: exit {again.returncode}, {skipped} "
                        f"skipped, arms {again_st}")
    gate_args = ["--gate", baseline, "--allow-missing"] \
        if baseline and os.path.exists(baseline) else []
    rep = cli("report", "--report", *gate_args)
    report = []
    if os.path.exists(os.path.join(d, "report.md")):
        with open(os.path.join(d, "report.md")) as f:
            report = f.read().splitlines()
    rows = {n: any(ln.startswith(f"| {n} | ") for ln in report)
            for n, _e in CAMPAIGN_ARMS}
    delta = next((ln for ln in report
                  if ln.startswith("# encoded-vs-raw wire delta")), None)
    if not all(rows.values()) or delta is None:
        problems.append(f"report: rows {rows}, encoded/raw delta {delta}")
    gates = {}
    for block in rep.stdout.split("## gate: ")[1:]:
        gates[block.split()[0]] = {
            "passed": "# gate: no regressions" in block,
            "violations": [ln.strip() for ln in block.splitlines()
                           if ln.strip().startswith("REGRESSION")][:8]}
    arms = {}
    for name, _e in CAMPAIGN_ARMS:
        ledger = os.path.join(d, name, "ledger.jsonl")
        if not os.path.exists(ledger):
            arms[name] = None
            continue
        data, r = load_ledger(ledger), BC.load_round(ledger)
        launches = {}
        for rec in data.queries.values():
            for k, v in (rec.get("kernelLaunches") or {}).items():
                launches[k] = launches.get(k, 0) + v
        failed_replays, tiers = replay_tiers(data)
        arms[name] = {
            "statements": len(data.queries),
            "replayed": tiers["replayed"],
            "blacklisted": len(tiers["blacklisted"]),
            "not_ok": sorted(n for n, q in data.queries.items()
                             if q["status"] != "ok"),
            "streamed": sum(1 for q in data.queries.values()
                            if q.get("streamedScans")),
            "geomean_ms": round(BC._geomean(list(r["times"].values())), 3)
            if r["times"] else None,
            "h2d_bytes": sum(e.get("bytesH2d", 0)
                             for e in r["evidence"].values()),
            "launches": launches,
            "end": (data.end or {}).get("status"),
            "wall_s": next((a.get("wallS") for a in manifest["arms"]
                            if a["name"] == name), None)}
        if arms[name]["not_ok"] or arms[name]["statements"] != \
                len(BENCH_B_QUERIES) or arms[name]["end"] != "completed":
            problems.append(f"arm {name}: {arms[name]}")
        if name == "resident" and (arms[name]["streamed"] or
                                   failed_replays):
            problems.append(f"resident arm: {arms[name]['streamed']} "
                            "statements streamed, replays failed: "
                            f"{failed_replays}")
    # run B's A-versus-B finding, from the resident arm (run A's first 15
    # statements, resident, in a fresh process), and the streamed path's
    # cost, base against resident (both fresh processes, the same
    # statements)
    run_b = None
    if gate_args and arms.get("resident"):
        run_b = ratio_finding(baseline, os.path.join(d, "resident",
                                                     "ledger.jsonl"))
    streamed_vs_resident = None
    if arms.get("base") and arms.get("resident"):
        streamed_vs_resident = ratio_finding(
            os.path.join(d, "resident", "ledger.jsonl"),
            os.path.join(d, "base", "ledger.jsonl"))
    if arms.get("base") and arms.get("encoded-off") and not (
            arms["encoded-off"]["h2d_bytes"] > arms["base"]["h2d_bytes"]
            > 0):
        problems.append("the raw wire did not upload more bytes than the "
                        "encoded one")
    tr = subprocess.run(
        [sys.executable, "-m", "nds_tpu_torch.tools.trace_report",
         os.path.join(d, "base", "traces")], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    with open(os.path.join(OUT, "campaign_trace_report.txt"), "w") as f:
        f.write(tr.stdout + "\n# stderr\n" + tr.stderr)
    tr_lines = tr.stdout.splitlines()
    if tr.returncode != 0 or not tr_lines or \
            not tr_lines[0].startswith("# trace report: "):
        problems.append(f"trace report: exit {tr.returncode}, "
                        f"{tr_lines[:1]}")
    line = {"phase": "campaign", "ok": not problems, "scale": BENCH_SCALE,
            "statements": len(BENCH_B_QUERIES),
            "stream_bytes": CAMPAIGN_STREAM_BYTES, "arms": arms,
            "resume_skipped": skipped, "report_rows": rows,
            "encoded_vs_raw": delta, "gate_baseline": baseline
            if gate_args else None, "gates": gates,
            "resident_against_run_a": run_b,
            "streamed_against_resident": streamed_vs_resident,
            "trace_report": {"head": tr_lines[:1], "columns":
                             tr_lines[2] if len(tr_lines) > 2 else None,
                             "bottleneck": next(
                                 (tr_lines[i + 1].strip() for i, ln in
                                  enumerate(tr_lines[:-1]) if
                                  ln.startswith("# next bottleneck")),
                                 None)},
            "seconds": marks, "problems": problems,
            "s": round(time.time() - t0, 3), "nvidia_smi": smi_line()}
    return not problems, line


class _Skipped(Exception):
    """A phase left out by ``--only``."""


def load_session(Session, data_dir, device):
    from nds_tpu_torch.schema import get_schemas
    s = Session(device=device)
    for tname, fields in get_schemas(use_decimal=True).items():
        s.read_raw_view(tname, os.path.join(data_dir, tname), fields)
    return s


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


PHASES = ("kernels", "power", "mesh", "census", "replay", "stream",
          "shard", "agreement", "validate", "bench", "campaign",
          "full_bench")


def main(argv=None) -> int:
    global STREAM_SCALE, STREAM_BYTES, STREAM_CI
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the port on "
                                 "one GPU (every phase by default).")
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run, of "
                    f"{', '.join(PHASES)} (device, build and data always "
                    "run); a partial run ends without the final ok line")
    ap.add_argument("--chunk-split-child", help=argparse.SUPPRESS)
    ap.add_argument("--stream-scale", type=int, default=STREAM_SCALE,
                    help="scale factor of the stream and shard phases "
                    f"(default {STREAM_SCALE}; 10 is the reference's SF10 "
                    "setting: tables above 1.5e9 bytes stream)")
    ap.add_argument("--stream-ci", type=int, default=len(CI_QUERIES),
                    help="run the stream phase's first N CI statements "
                    f"(default all {len(CI_QUERIES)})")
    args = ap.parse_args(argv)
    if args.stream_scale != STREAM_SCALE:
        STREAM_SCALE = args.stream_scale
        STREAM_BYTES = 1.5e8 * STREAM_SCALE
    STREAM_CI = CI_QUERIES[:args.stream_ci]
    if args.chunk_split_child:
        return chunk_split_child(args.chunk_split_child)
    only = set(args.only.split(","))
    if not only <= set(PHASES):
        ap.error(f"unknown phase(s) {sorted(only - set(PHASES))}")

    def runs(phase):
        return phase in only

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from nds_tpu_torch.engine import kernels as K
        from nds_tpu_torch.engine.session import Session
        from nds_tpu_torch.power import (gen_sql_from_stream,
                                         run_query_stream,
                                         strip_stream_markers)
    except ImportError as e:
        print(f"chip_smoke: the nds_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 3
    os.makedirs(OUT, exist_ok=True)
    os.makedirs(DATA, exist_ok=True)
    if os.path.exists(os.path.join(OUT, "phases.jsonl")):
        os.remove(os.path.join(OUT, "phases.jsonl"))
    t_all = time.time()
    failed = []
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # data generation runs in the background while the kernels build/test
    ndsgen = ndsgen_binary()
    import concurrent.futures as cf
    pool = cf.ThreadPoolExecutor(max_workers=1)
    cpus = os.cpu_count() or 4
    data_f = pool.submit(lambda: (
        gen_data(ndsgen, "0.01", os.path.join(DATA, "sf0.01"), 1),
        gen_data(ndsgen, 1, os.path.join(DATA, "sf1"), max(cpus - 2, 1)),
        runs("full_bench") and gen_refresh_sets(FULL_SCALE, cpus - 2)))
    stream_raw = os.path.join(DATA, f"sf{STREAM_SCALE}")
    if runs("stream") or runs("shard"):
        stream_f = pool.submit(streamed_data, ndsgen, stream_raw,
                               max(cpus - 2, 1))

    # 2. build
    t0 = time.time()
    try:
        import contextlib
        import io
        ptxas = io.StringIO()
        with contextlib.redirect_stdout(ptxas):
            K.build(verbose=True)
        build_s = round(time.time() - t0, 3)
        with open(os.path.join(OUT, "ptxas.txt"), "w") as f:
            f.write(ptxas.getvalue())
        report = build_report(K, ptxas.getvalue())
        emit({"phase": "build", "ok": True, "s": build_s,
              "sources": sorted(set(KERNEL_SOURCE.values())), **report})
    except Exception as e:
        emit({"phase": "build", "ok": False, "error": str(e)[-2000:]})
        return 1

    # 3. kernels vs plain versions
    records = {}
    kernel_phases = runs("kernels")
    try:
        if not kernel_phases:
            raise _Skipped
        ok, records = kernel_phase(torch, K)
        for name, recs in records.items():
            emit({"phase": "kernel", "name": name, "ok": all(
                r["ok"] for r in recs), "cases": recs})
        if not ok:
            failed.append("kernels")
    except _Skipped:
        pass
    except Exception as e:
        emit({"phase": "kernel", "ok": False, "error": repr(e)[:2000]})
        failed.append("kernels")
    try:
        if not kernel_phases:
            raise _Skipped
        ok, sweep = k1_sweep(torch, K)
        for rec in sweep:
            emit({"phase": "k1_sweep", **rec})
        if not ok:
            failed.append("k1_sweep")
    except _Skipped:
        pass
    except Exception:
        import traceback
        emit({"phase": "k1_sweep", "ok": False,
              "error": traceback.format_exc()[-2000:]})
        failed.append("k1_sweep")
    try:
        if not kernel_phases:
            raise _Skipped
        ok, sweep = k23_sweep(torch, K)
        for rec in sweep:
            emit({"phase": "k23_sweep", **rec})
        if not ok:
            failed.append("k23_sweep")
    except _Skipped:
        pass
    except Exception:
        import traceback
        emit({"phase": "k23_sweep", "ok": False,
              "error": traceback.format_exc()[-2000:]})
        failed.append("k23_sweep")
    try:
        if not kernel_phases:
            raise _Skipped
        ok, more, sweep = scan_probe_phase(torch, K)
        records.update(more)
        emit({"phase": "k4_sweep", "shape": "synthetic", "n": SCAN_ROWS,
              "plans": sweep})
        for name, recs in more.items():
            emit({"phase": "kernel", "name": name, "ok": all(
                r["ok"] for r in recs), "cases": recs})
        if not ok:
            failed.append("scan_probe_kernels")
    except _Skipped:
        pass
    except Exception:
        import traceback
        emit({"phase": "kernel", "name": "chunk_scan/join_probe",
              "ok": False, "error": traceback.format_exc()[-2000:]})
        failed.append("scan_probe_kernels")

    # 4. data
    t0 = time.time()
    try:
        data_f.result()
        emit({"phase": "data", "ok": True, "wait_s": round(time.time() - t0,
                                                           3),
              "gen_s": dict(GEN_S)})
    except Exception as e:
        emit({"phase": "data", "ok": False, "error": repr(e)[:2000]})
        return 1

    # 5. Power Run at SF1 on cuda through the port's Power Run entry
    launches = {}
    sf1 = os.path.join(DATA, "sf1")
    session = None
    try:
        if not runs("power"):
            raise _Skipped
        queries = gen_sql_from_stream(stream_file(1))
        summ = os.path.join(OUT, "power_json")
        shutil.rmtree(summ, ignore_errors=True)
        # K1-K3's group counts on the main path, by the path each launch's
        # plan takes (and, for K2, whether it is count-only)
        seg_groups = {}
        restore = count_seg_groups(K, seg_groups)
        K.reset_launches()
        t0 = time.time()
        try:
            session = run_query_stream(
                sf1, None, queries, os.path.join(OUT, "power_time.csv"),
                sub_queries=CI_QUERIES, input_format="raw",
                json_summary_folder=summ, allow_failure=True, device="cuda")
            mm = session.sql(MINMAX_SQL).collect()
            torch.cuda.synchronize()
        finally:
            restore()
        launches = dict(K.LAUNCHES)
        for line in group_histograms(seg_groups):
            emit(line)
        wall = time.time() - t0
        per_q = {}
        for fn in sorted(os.listdir(summ)):
            with open(os.path.join(summ, fn)) as f:
                js = json.load(f)
            per_q[js["query"]] = {
                "ms": js["queryTimes"][-1], "syncs": js["hostSyncs"],
                "status": js["queryStatus"][-1],
                "launches": js["kernelLaunches"]}
        statuses_ok = len(per_q) == len(CI_QUERIES) and all(
            v["status"] == "Completed" for v in per_q.values())
        mm_ok = len(mm) > 0 and all(
            r[1] is not None and math.isfinite(r[1]) and r[1] <= r[2]
            for r in mm if r[0] is not None)
        counts_ok = all(launches[k] > 0 for k in (
            "segment_sum_i64", "segment_sum_f64", "segment_minmax_f64"))
        total_ms = sum(v["ms"] for v in per_q.values())
        emit({"phase": "power", "scale": 1, "device": "cuda",
              "ok": statuses_ok and mm_ok and counts_ok,
              "queries": per_q, "total_query_ms": total_ms,
              "wall_s_with_load": round(wall, 3),
              "minmax_rows": len(mm), "launches": launches})
        if not (statuses_ok and mm_ok and counts_ok):
            failed.append("power")
        # the watchdog arms blocking reads, which only an eager run
        # makes: replay off, so that query78 stays eager in both arms
        os.environ["NDS_TPU_REPLAY"] = "off"
        try:
            line = watchdog_cost(torch, session, strip_stream_markers(
                queries[WATCHDOG_QUERY]))
        finally:
            os.environ.pop("NDS_TPU_REPLAY", None)
        emit(line)
        if not line["ok"]:
            failed.append("watchdog")
    except _Skipped:
        pass
    except Exception:
        import traceback
        emit({"phase": "power", "ok": False,
              "error": traceback.format_exc()[-2000:]})
        failed.append("power")
    # the meshed resident session on this card's shards, over the power
    # phase's SF1 session
    mesh_launches = {}
    try:
        if not runs("mesh"):
            raise _Skipped
        if session is None:
            session = load_session(Session, sf1, "cuda")
        ok, lines = mesh_phase(torch, K, Session, session,
                               gen_sql_from_stream(stream_file(1)))
        for line in lines:
            emit(line)
        mesh_launches = {k: sum(x["launches"][k] for x in lines
                                if x["phase"] == "mesh_arm")
                         for k in MESH_KERNELS}
        with open(os.path.join(OUT, "mesh.json"), "w") as f:
            json.dump(lines, f, indent=1)
        if not ok:
            failed.append("mesh")
    except _Skipped:
        pass
    except Exception:
        import traceback
        emit({"phase": "mesh", "ok": False,
              "error": traceback.format_exc()[-3000:]})
        failed.append("mesh")
    session = None
    try:
        if not runs("census"):
            raise _Skipped
        ok, line = launch_census(torch, os.path.join(DATA, "sf1"),
                                 gen_sql_from_stream(stream_file(1)),
                                 run_query_stream)
        emit(line)
        if not ok:
            failed.append("census")
    except _Skipped:
        pass
    except Exception:
        import traceback
        emit({"phase": "census", "ok": False,
              "error": traceback.format_exc()[-2000:]})
        failed.append("census")

    # whole-statement replay: each statement captured as one CUDA graph
    try:
        if not runs("replay"):
            raise _Skipped
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        ok, line, rows = replay_phase(torch, K, Session, sf1,
                                      gen_sql_from_stream(stream_file(1)))
        for row in rows:
            emit({"phase": "replay_statement", **row})
        emit(line)
        if not ok:
            failed.append("replay")
    except _Skipped:
        pass
    except Exception:
        import traceback
        emit({"phase": "replay", "ok": False,
              "error": traceback.format_exc()[-3000:]})
        failed.append("replay")

    campaign_launches = {}
    # 6. the streamed path at STREAM_SCALE, against all-resident; K4's
    # launches by spec shape and statement, K1-K3's by group count
    capture = K4Capture(K)
    try:
        if not runs("stream"):
            raise _Skipped
        t0 = time.time()
        stream_f.result()
        wait_s = round(time.time() - t0, 3)
        K.reset_launches()
        stream_groups = {}
        restore = count_seg_groups(K, stream_groups)
        try:
            with capture:
                res = stream_phase(
                    torch, K, gen_sql_from_stream(stream_file(STREAM_SCALE)),
                    capture)
        finally:
            restore()
        res["data_wait_s"] = wait_s
        res["k4_specs"] = capture.lines()
        for k in ("chunk_scan", "join_probe"):
            launches[k] = res["launches"][k]
        with open(os.path.join(OUT, "stream.json"), "w") as f:
            json.dump(res, f, indent=1)
        emit({k: v for k, v in res.items()
              if k not in ("statements", "k4_specs", "chunk_split",
                           "raw_wire")})
        emit({"phase": "k4_specs", "launches": res["launches"]["chunk_scan"],
              "counted": sum(r["launches"] for r in res["k4_specs"]),
              "specs": res["k4_specs"]})
        for line in group_histograms(stream_groups, run="stream",
                                     scale=f"{STREAM_SCALE} (ab7, ab8, "
                                     f"ab13 at {FANOUT_SCALE})"):
            emit(line)
        emit(res["chunk_split"])
        if not res["ok"]:
            failed.append("stream")
    except _Skipped:
        pass
    except Exception:
        import traceback
        emit({"phase": "stream", "ok": False,
              "error": traceback.format_exc()[-3000:]})
        failed.append("stream")

    # K4 at each real spec shape of the stream phase
    try:
        if not runs("stream"):
            raise _Skipped
        ok, real, sweeps = k4_real_phase(torch, K, capture)
        records["chunk_scan"] = records.get("chunk_scan", []) + real
        for rec in real:
            emit({"phase": "k4_real", **rec})
        for rec in sweeps:
            emit({"phase": "k4_sweep", **rec})
        if not ok:
            failed.append("k4_real")
    except _Skipped:
        pass
    except Exception:
        import traceback
        emit({"phase": "k4_real", "ok": False,
              "error": traceback.format_exc()[-3000:]})
        failed.append("k4_real")
    capture.shapes.clear()

    # the validate phase's two Power Runs, in the background from here
    validation = None
    if runs("validate"):
        try:
            validation = start_validation_runs(os.path.join(DATA, "sf1"))
        except Exception:
            import traceback
            emit({"phase": "validate", "ok": False,
                  "error": traceback.format_exc()[-3000:]})
            failed.append("validate")

    # sharded streaming and the exchange, on this card's shards
    shard_launches = {}
    try:
        if not runs("shard"):
            raise _Skipped
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        stream_f.result()
        ok, lines = shard_phase(
            torch, K, gen_sql_from_stream(stream_file(STREAM_SCALE)))
        for line in lines:
            emit(line)
        shard_launches = lines[-1]["launches"]
        with open(os.path.join(OUT, "shard.json"), "w") as f:
            json.dump(lines, f, indent=1)
        if not ok:
            failed.append("shard")
    except _Skipped:
        pass
    except Exception:
        import traceback
        emit({"phase": "shard", "ok": False,
              "error": traceback.format_exc()[-3000:]})
        failed.append("shard")

    # 7. agreement at SF0.01: cuda vs cpu, every statement of the stream
    try:
        if not runs("agreement"):
            raise _Skipped
        t0 = time.time()
        small = os.path.join(DATA, "sf0.01")
        queries = gen_sql_from_stream(stream_file("0.01"))
        sc = load_session(Session, small, "cuda")
        sh = load_session(Session, small, "cpu")
        load_s = time.time() - t0
        diffs, rows = {}, 0
        todo = [(q, strip_stream_markers(sql)) for q, sql in queries.items()]
        for q, sql in todo + [("minmax", MINMAX_SQL)]:
            try:
                got = sc.sql(sql).to_arrow()
            except Exception as e:                 # a cuda-side failure
                diffs[q] = f"cuda: {type(e).__name__}: {str(e)[:300]}"
                continue
            want = sh.sql(sql).to_arrow()
            rows += want.num_rows
            why = tables_agree(got, want)
            if why:
                diffs[q] = why
        emit({"phase": "agreement", "scale": 0.01, "ok": not diffs,
              "statements": len(todo) + 1, "rows": rows, "diffs": diffs,
              "load_s": round(load_s, 3),
              "s": round(time.time() - t0, 3)})
        if diffs or len(todo) != 103:
            failed.append("agreement")
        del sc, sh
    except _Skipped:
        pass
    except Exception:
        import traceback
        emit({"phase": "agreement", "ok": False,
              "error": traceback.format_exc()[-2000:]})
        failed.append("agreement")

    # the CI statements' outputs at SF1, cuda against cpu (the two Power
    # Runs started before the shard phase)
    try:
        if validation is None:
            raise _Skipped
        ok, line = validate_phase(validation)
        emit(line)
        if not ok:
            failed.append("validate")
    except _Skipped:
        pass
    except Exception:
        import traceback
        emit({"phase": "validate", "ok": False,
              "error": traceback.format_exc()[-3000:]})
        failed.append("validate")
    finally:
        if validation is not None:
            stop_validation_runs(validation)

    # 8. the bench entry, twice, at SF1
    try:
        if not runs("bench"):
            raise _Skipped
        import gc
        gc.collect()
        torch.cuda.empty_cache()       # the children need the card's memory
        ok, line, seconds = bench_phase(os.path.join(DATA, "sf1"))
        emit(line)
        emit(seconds)
        if not ok:
            failed.append("bench")
    except _Skipped:
        pass
    except Exception:
        import traceback
        emit({"phase": "bench", "ok": False,
              "error": traceback.format_exc()[-3000:]})
        failed.append("bench")

    # the campaign CLI: three arms of the bench entry, the facts streamed
    try:
        if not runs("campaign"):
            raise _Skipped
        import gc
        gc.collect()
        torch.cuda.empty_cache()       # the children need the card's memory
        ok, line = campaign_phase(os.path.join(DATA, "sf1"),
                                  os.path.join(OUT, "bench_a.jsonl"))
        emit(line)
        campaign_launches = {k: sum((a or {}).get("launches", {}).get(k, 0)
                                    for a in line["arms"].values())
                             for k in KERNEL_META}
        if not ok:
            failed.append("campaign")
    except _Skipped:
        pass
    except Exception:
        import traceback
        emit({"phase": "campaign", "ok": False,
              "error": traceback.format_exc()[-3000:]})
        failed.append("campaign")

    # 9. the whole NDS benchmark through the port's orchestrator at SF1
    try:
        if not runs("full_bench"):
            raise _Skipped
        import gc
        gc.collect()
        torch.cuda.empty_cache()       # the children need the card's memory
        ok, lines = full_bench_phase(K)
        for line in lines:
            emit(line)
        if not ok:
            failed.append("full_bench")
    except _Skipped:
        pass
    except Exception:
        import traceback
        emit({"phase": "full_bench", "ok": False,
              "error": traceback.format_exc()[-3000:]})
        failed.append("full_bench")

    # the kernels line: K1-K3 at G = 1000, K5 at r = 102000; launches from
    # the main-path runs (the power phase for K1-K3, the stream phase for
    # K4/K5)
    line = []
    for name, replaces in KERNEL_META.items():
        recs = records.get(name) or [{}]
        r = next((x for x in recs if x.get("G") == 1000
                  or x.get("r") == 102000), recs[0])
        extra = {}
        co = next((x for x in recs if x.get("G") == 1000
                   and x.get("count_only")), None)
        if co:
            extra["count_only"] = {k: co.get(k) for k in (
                "ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")}
        if "library_amin_ms" in r:
            extra["library_amin_ms"] = r["library_amin_ms"]
        if name == "chunk_scan":
            # the synthetic spec's record, then each real shape's
            extra["real_shapes"] = [{
                "entries": [e["kind"] for e in x["shape"]["entries"]],
                "cols": [c["dtype"] for c in x["shape"]["cols"]],
                "keys": x["shape"]["keys"], "wire": x["wire"],
                "launches": x["launches"],
                "ms": x["ms"], "cold_ms": x["cold_ms"],
                "bound_ms": x["bound_ms"], "plain_ms": x["plain_ms"],
                "max_abs_err": x["max_abs_err"]}
                for x in recs if "launches" in x]
            extra["max_abs_err_all_shapes"] = max(
                (x.get("max_abs_err") or 0) for x in recs)
        if name in shard_launches:
            extra["shard_launches"] = shard_launches[name]
        if name in mesh_launches:
            extra["mesh_launches"] = mesh_launches[name]
        if campaign_launches.get(name):
            extra["campaign_launches"] = campaign_launches[name]
        line.append({"name": name, "route": "cuda",
                     "source": KERNEL_SOURCE[name],
                     "replaces": replaces, "launches": launches.get(name, 0),
                     "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
                     "wrapper_ms": r.get("wrapper_ms"),
                     "plain_ms": r.get("plain_ms"),
                     "bound_ms": r.get("bound_ms"),
                     "bound_by": r.get("bound_by", "bytes"),
                     "library_ms": r.get("library_ms"),
                     "cold_ms": r.get("cold_ms"),
                     "n": r.get("n"), "G": r.get("G"), "r": r.get("r"),
                     **extra})
    emit({"kernels": line})
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump({"smi": smi, "kernels": line, "records": records,
                   "failed": failed,
                   "seconds": round(time.time() - t_all, 3)}, f, indent=1)
    print(smi, flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    if only != set(PHASES):
        print(f"chip_smoke: partial run of {sorted(only)}", file=sys.stderr)
        return 0
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
