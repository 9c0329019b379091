# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Stream-concurrency scaling sweep (the port of the reference's
``tools/throughput_sweep.py``).

Runs the port's Throughput Test (``python -m nds_tpu_torch.throughput``:
one Power Run process a stream, all sharing the card) at 1, 2, 4 and 8
concurrent streams, and at each stream count over a set of admission-slot
values (``NDS_TPU_CONCURRENT_QUERIES``, ``parallel/admission.py``; 0 is
unlimited), against one dataset, and writes one JSON document with the
spec's Ttt per configuration: max(stream end) - min(stream start).

Each stream process imports torch and registers every table before its
first statement, so at a small scale Ttt is mostly start-up: each
stream's ``register_s`` (the sum of its time log's ``CreateTempView``
rows) stands beside its wall so that the reading stays honest. A stream
whose log has a ``Power Start Time`` and no ``Power End Time`` (it died
in between) is recorded as ``{"error": "missing end marker"}`` and the
sweep goes on.

Usage::

    python -m nds_tpu_torch.tools.throughput_sweep <data_dir> <stream_dir>
        <out.json> [--streams 1,2,4,8] [--admission 0,1,2]
        [--sub_queries q1,q2,...] [--input_format parquet] [--device cpu]

Streams are ``query_1.sql`` .. ``query_N.sql`` under ``stream_dir``
(``query_0`` is the Power stream by convention). Every configuration has
its own admission slot directory. The device defaults to cuda (each
stream process refuses to run without a GPU unless given ``--device
cpu``).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import tempfile
import time


def stream_bounds(path):
    """(Power Start Time, Power End Time, statements, registration
    seconds) of one stream's time log; a missing marker is None."""
    start = end = None
    n = 0
    register_ms = 0
    with open(path) as f:
        for row in csv.reader(f):
            if len(row) < 3 or not row[2].strip().isdigit():
                continue
            if row[1] == "Power Start Time":
                start = int(row[2])
            elif row[1] == "Power End Time":
                end = int(row[2])
            elif row[1].startswith("query"):
                n += 1
            elif row[1].startswith("CreateTempView "):
                register_ms += int(row[2])
    return start, end, n, register_ms / 1000


def run_config(n_streams, admission, data_dir, stream_dir, work_dir,
               sub_queries, input_format, device="cuda"):
    """One configuration's Throughput Test; returns its record."""
    streams = ",".join(str(i) for i in range(1, n_streams + 1))
    from nds_tpu_torch.throughput import child_env
    base = os.path.join(work_dir, f"s{n_streams}_a{admission}")
    env = child_env()
    if admission:
        env["NDS_TPU_CONCURRENT_QUERIES"] = str(admission)
        env["NDS_TPU_ADMISSION_DIR"] = base + "_slots"
    else:
        env.pop("NDS_TPU_CONCURRENT_QUERIES", None)
    cmd = [sys.executable, "-m", "nds_tpu_torch.throughput", streams,
           data_dir, os.path.join(stream_dir, "query_{}.sql"),
           base + "_{}.csv", "--input_format", input_format,
           "--device", device]
    if sub_queries:
        cmd += ["--sub_queries", sub_queries]
    t0 = time.time()
    r = subprocess.run(cmd, env=env, capture_output=True, text=True)
    wall = time.time() - t0
    info = {"n_streams": n_streams, "admission_slots": admission,
            "launcher_wall_s": round(wall, 1), "rc": r.returncode,
            "streams": {}}
    starts, ends, total_q = [], [], 0
    for i in range(1, n_streams + 1):
        p = f"{base}_{i}.csv"
        if not os.path.exists(p):
            info["streams"][i] = {"error": "no report"}
            continue
        st, en, nq, reg = stream_bounds(p)
        if st is None:
            info["streams"][i] = {"error": "missing markers",
                                  "register_s": reg}
            continue
        if en is None:
            # the stream died between 'Power Start Time' and 'Power End
            # Time': record it and go on with the other configurations
            info["streams"][i] = {"error": "missing end marker",
                                  "queries": nq, "register_s": reg}
            continue
        starts.append(st)
        ends.append(en)
        total_q += nq
        info["streams"][i] = {"wall_s": en - st, "queries": nq,
                              "register_s": reg}
    if starts:
        info["Ttt_s"] = max(ends) - min(starts)
        info["total_queries"] = total_q
        info["queries_per_s"] = round(total_q / max(info["Ttt_s"], 1), 3)
    if r.returncode != 0:
        info["stderr_tail"] = r.stderr[-800:]
    return info


def sweep(data_dir, stream_dir, out, streams="1,2,4,8", admission="0",
          sub_queries=None, input_format="parquet", work_dir=None,
          device="cuda", log=print) -> list:
    """Every (stream count, admission slots) configuration in turn; the
    document is rewritten to ``out`` after each. Returns the records."""
    work_dir = work_dir or tempfile.mkdtemp(prefix="nds_tt_sweep_")
    os.makedirs(work_dir, exist_ok=True)
    configs = [(n, a) for n in (int(x) for x in streams.split(","))
               for a in (int(x) for x in admission.split(","))]
    results = []
    for n, a in configs:
        log(f"# sweep: {n} streams, admission={a or 'unlimited'}")
        info = run_config(n, a, data_dir, stream_dir, work_dir,
                          sub_queries, input_format, device)
        results.append(info)
        log(json.dumps({k: v for k, v in info.items() if k != "streams"}))
        with open(out, "w") as out_f:
            json.dump({"note": (
                "Stream-concurrency scaling on one card: spec Ttt = "
                "max(stream end) - min(stream start) per configuration; "
                "admission_slots is the NDS_TPU_CONCURRENT_QUERIES "
                "device-sharing knob (0 = unlimited interleaving); each "
                "stream's register_s is its table registration, inside "
                "its wall."),
                "sub_queries": sub_queries or "full streams",
                "configs": results}, out_f, indent=1)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Throughput Test at several stream counts and "
        "admission-slot values")
    ap.add_argument("data_dir")
    ap.add_argument("stream_dir")
    ap.add_argument("out")
    ap.add_argument("--streams", default="1,2,4,8")
    ap.add_argument("--admission", default="0",
                    help="admission slot values to sweep at EACH stream "
                    "count; 0 = unlimited")
    ap.add_argument("--sub_queries")
    ap.add_argument("--input_format", default="parquet")
    ap.add_argument("--work_dir", help="time logs and slot directories "
                    "(default: a new temporary directory)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    results = sweep(args.data_dir, args.stream_dir, args.out, args.streams,
                    args.admission, args.sub_queries, args.input_format,
                    args.work_dir, args.device,
                    log=lambda line: print(line, flush=True))
    print(f"# wrote {args.out} ({len(results)} configs)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
