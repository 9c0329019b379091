# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Coverage sweep: run every query template through the port on tiny data.

Prints a PASS/FAIL line a statement and groups the failures by their first
error line, so planner gaps can be burned down in frequency order (the
port of the reference's ``tools/coverage_sweep.py``). ``--mesh N`` also
runs every statement on a meshed session (``conf={"mesh_shape": N}``, its
shards sharing the session's device) and requires the same rows, in any
order. ``--update-lst`` rewrites the port's own
``nds_tpu_torch/queries/templates/supported.lst`` with the templates none
of whose statements failed (the ratchet).

Run: ``python -m nds_tpu_torch.tools.coverage_sweep [--queries q3,q7]
[--mesh 2] [--update-lst] [--device cpu]``. The data is
``native/ndsgen`` at ``NDS_SWEEP_SCALE`` (default 0.01) under
``.bench_cache/sf<scale>``, the stream ``.bench_cache/sweep_stream``
(generator seed 19620718), both made on first use. The device defaults to
cuda and the sweep refuses to run without a GPU unless given ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NDSGEN = os.path.join(REPO, "native", "ndsgen", "ndsgen")
SWEEP_SEED = 19620718


def scale() -> str:
    return os.environ.get("NDS_SWEEP_SCALE", "0.01")


def ensure_data() -> str:
    """The sweep's raw data directory, generated once by ``native/ndsgen``
    (built first when missing)."""
    cache = os.path.join(REPO, ".bench_cache", f"sf{scale()}")
    if not os.path.exists(NDSGEN):
        subprocess.run(["make", "-C", os.path.dirname(NDSGEN)], check=True)
    marker = os.path.join(cache, ".complete")
    if not os.path.exists(marker):
        os.makedirs(cache, exist_ok=True)
        subprocess.run([NDSGEN, "-scale", scale(), "-dir", cache],
                       check=True)
        with open(marker, "w"):
            pass
    return cache


def sweep_stream(regenerate: bool = False) -> str:
    """The sweep's query stream (every template, seed 19620718, at the
    sweep's scale), generated when missing or asked for."""
    from nds_tpu_torch.queries import generate_query_streams
    stream_dir = os.path.join(REPO, ".bench_cache", "sweep_stream")
    path = os.path.join(stream_dir, "query_0.sql")
    if regenerate or not os.path.exists(path):
        os.makedirs(stream_dir, exist_ok=True)
        generate_query_streams(stream_dir, streams=1, rngseed=SWEEP_SEED,
                               scale=float(scale()))
    return path


def load_session(data_dir: str, device, conf=None):
    """A session over every raw table of ``data_dir`` (``<table>`` or
    ``<table>.dat``)."""
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.schema import get_schemas
    session = Session(conf=conf, device=device)
    for tname, fields in get_schemas(use_decimal=True).items():
        for path in (os.path.join(data_dir, tname),
                     os.path.join(data_dir, tname + ".dat")):
            if os.path.exists(path):
                session.read_raw_view(tname, path, fields)
                break
    return session


def sweep(session, queries, mesh_session=None, mesh=0, full_trace=False,
          out=print):
    """Run ``queries`` ({name: sql}); returns (passed [(name, ms)],
    failed {first error line: [names]})."""
    passed, failed = [], {}
    for qname, qtext in queries.items():
        t0 = time.perf_counter()
        try:
            res = session.sql(qtext)
            rows = res.collect()
            ms = (time.perf_counter() - t0) * 1000
            if mesh_session is not None:
                mrows = mesh_session.sql(qtext).collect()
                if mrows != rows:
                    # unordered parity: ORDER BY keys can tie, and tied-row
                    # order is implementation-defined (the validation
                    # driver has --ignore_ordering for the same reason)
                    if sorted(map(repr, mrows)) != sorted(map(repr, rows)):
                        raise AssertionError(
                            f"mesh({mesh}) results diverge: "
                            f"{len(mrows)} vs {len(rows)} rows")
            passed.append((qname, ms))
            out(f"PASS {qname:22s} {ms:8.1f} ms  rows={res.num_rows}")
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
            first = err.splitlines()[0][:110]
            failed.setdefault(first, []).append(qname)
            out(f"FAIL {qname:22s} {first}")
            if full_trace:
                traceback.print_exc()
    return passed, failed


def summary(passed, failed) -> list:
    """The closing lines: the totals, then each failure group, largest
    first."""
    total = len(passed) + sum(len(v) for v in failed.values())
    lines = [f"\n=== {len(passed)} passed / {total} total ==="]
    for err, qs in sorted(failed.items(), key=lambda kv: -len(kv[1])):
        lines.append(f"[{len(qs):2d}] {err}\n     {' '.join(qs)}")
    return lines


def supported_names(passed, failed) -> list:
    """The templates to list as supported: a template counts only if no
    part of it failed (query14 with a failing _part2 must not enter the
    ratchet through a passing _part1)."""
    failed_tpls = {q.split("_part")[0] for qs in failed.values() for q in qs}
    return sorted({q.split("_part")[0] for q, _ in passed} - failed_tpls,
                  key=lambda s: int(s.replace("query", "")))


def write_lst(path: str, names) -> None:
    with open(path, "w") as f:
        f.write("# queries the engine executes end-to-end (coverage "
                "ratchet)\n")
        for n in names:
            f.write(n + ".tpl\n")  # template filenames, ready for streams


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="run every query template through the port on tiny "
        "data")
    ap.add_argument("--queries", help="comma list like query5,query14_part1")
    ap.add_argument("--update-lst", action="store_true")
    ap.add_argument("--full-trace", action="store_true")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="also run every query on an N-shard meshed session "
                         "(its shards sharing the device) and require "
                         "row-for-row parity with the unmeshed one")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from nds_tpu_torch import resolve_device
    from nds_tpu_torch.parallel.exchange import sharing_devices
    from nds_tpu_torch.power import gen_sql_from_stream

    device = resolve_device(args.device)
    data_dir = ensure_data()
    queries = gen_sql_from_stream(sweep_stream(regenerate=True))
    if args.queries:
        want = {x.strip() for x in args.queries.split(",")}
        queries = {k: v for k, v in queries.items() if k in want}
    session = load_session(data_dir, device)
    mesh_session = None
    if args.mesh:
        with sharing_devices():
            mesh_session = load_session(data_dir, device,
                                        {"mesh_shape": args.mesh})
    passed, failed = sweep(session, queries, mesh_session, args.mesh,
                           args.full_trace,
                           out=lambda line: print(line, flush=True))
    for line in summary(passed, failed):
        print(line)
    if args.update_lst and passed:
        lst = os.path.join(REPO, "nds_tpu_torch", "queries", "templates",
                           "supported.lst")
        names = supported_names(passed, failed)
        write_lst(lst, names)
        print(f"wrote {lst}: {len(names)} templates")
    return 0


if __name__ == "__main__":
    sys.exit(main())
