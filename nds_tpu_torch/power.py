# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Power Run on the torch engine: stream parsing, table registration, the
query loop, and its command line.

Every query runs under a BenchReport (JSON summary + status taxonomy),
per-query times land in a CSV time log (header
``application_id,query,time/milliseconds``), and the process exits non-zero
when any query failed. Usage::

    python -m nds_tpu_torch.power <input_prefix> <query_stream_file> \\
        [time_log] [--input_format raw|parquet|...] [--device cuda|cpu] \\
        [--json_summary_folder DIR] [--sub_queries q1,q2] [--trace-dir DIR]
        [--profile DIR] [--ledger FILE]

The engine runs on ``cuda`` unless ``--device cpu`` is given. ``--ledger``
(or ``NDS_TPU_LEDGER``) appends every query to the evidence ledger
(:mod:`nds_tpu_torch.obs.ledger`).
"""

from __future__ import annotations

import contextlib
import csv
import os
import sys
import time
from collections import OrderedDict

from nds_tpu_torch.check import (check_json_summary_folder,
                                 check_query_subset_exists)
from nds_tpu_torch.engine.faults import drain_fault_events, fault_event_json
from nds_tpu_torch.listener import drain_stream_events, stream_event_json
from nds_tpu_torch.queries import split_special_query
from nds_tpu_torch.report import BenchReport
from nds_tpu_torch.schema import get_schemas


def gen_sql_from_stream(query_stream_file_path: str) -> "OrderedDict[str, str]":
    """Split a generated query stream into an ordered {name: sql} dict,
    splitting the two-statement queries 14/23/24/39 into _part1/_part2."""
    with open(query_stream_file_path) as f:
        stream = f.read()
    all_queries = stream.split("-- start")[1:]
    extended = OrderedDict()
    for q in all_queries:
        query_name = q[q.find("template") + 9: q.find(".tpl")]
        if "select" in q.split(";")[1]:
            part_1, part_2 = split_special_query(q)
            extended[query_name + "_part1"] = part_1
            extended[query_name + "_part2"] = part_2
        else:
            extended[query_name] = q
    for name, content in extended.items():
        extended[name] = "-- start" + content
    return extended


def get_query_subset(query_dict: "OrderedDict", subset) -> "OrderedDict":
    """Select a subset of queries from the stream, preserving order."""
    check_query_subset_exists(query_dict, subset)
    return OrderedDict((name, query_dict[name]) for name in subset)


def strip_stream_markers(sql: str) -> str:
    """Remove the '-- start/-- end' marker lines and trailing ';' so the
    bare statement can be handed to the engine parser."""
    lines = [ln for ln in sql.splitlines()
             if not ln.strip().startswith("-- start")
             and not ln.strip().startswith("-- end")]
    text = "\n".join(lines).strip()
    if text.endswith(";"):
        text = text[:-1]
    return text


def setup_tables(session, input_prefix: str, input_format: str,
                 use_decimal: bool, execution_time_list: list) -> list:
    """Register the 24 source tables as engine views, timing each."""
    schemas = get_schemas(use_decimal=use_decimal)
    for table_name, fields in schemas.items():
        start = time.time()
        if input_format in ("csv", "raw"):
            path = os.path.join(input_prefix, f"{table_name}.dat")
            if not os.path.exists(path):
                path = os.path.join(input_prefix, table_name)
            session.read_raw_view(table_name, path, fields)
        else:
            path = os.path.join(input_prefix, table_name)
            canonical = {f.name: str(f.type) for f in fields}
            session.read_columnar_view(table_name, path, input_format,
                                       canonical)
        end = time.time()
        print(f"====== Creating TempView for table {table_name} ======")
        print(f"Time taken: {end - start} s for table {table_name}")
        execution_time_list.append(
            (session.app_id, f"CreateTempView {table_name}",
             int((end - start) * 1000)))
    return execution_time_list


def ensure_valid_column_names(result):
    """Rename spec-format backtick-quoted aggregate names that a columnar
    writer would reject."""
    import re
    arrow = result.to_arrow()
    renames = {}
    for name in arrow.column_names:
        clean = re.sub(r"[ ,;{}()\n\t=]", "_", name)
        if clean != name:
            renames[name] = clean
    if renames:
        arrow = arrow.rename_columns(
            [renames.get(n, n) for n in arrow.column_names])
    return arrow


def run_one_query(session, query: str, query_name: str,
                  output_path: str | None, output_format: str) -> None:
    """Execute one query; collect() to host or write to the output prefix."""
    result = session.sql(strip_stream_markers(query))
    if not output_path:
        result.collect()
    else:
        from nds_tpu_torch.io.columnar import write_table
        write_table(ensure_valid_column_names(result),
                    os.path.join(output_path, query_name), output_format)


def run_query_stream(input_prefix: str,
                     property_file: str | None,
                     query_dict: "OrderedDict",
                     time_log_output_path: str,
                     extra_time_log_output_path: str | None = None,
                     sub_queries=None,
                     input_format: str = "parquet",
                     use_decimal: bool = True,
                     output_path: str | None = None,
                     output_format: str = "parquet",
                     json_summary_folder: str | None = None,
                     allow_failure: bool = False,
                     trace_dir: str | None = None,
                     device=None,
                     profile_folder: str | None = None,
                     ledger_path: str | None = None):
    """The Power Run loop. ``device`` is ``cuda`` (the default) or ``cpu``.
    Each query's JSON summary carries its host syncs, blocked wait, fetched
    bytes and kernel launches beside the wall time; ``trace_dir`` writes
    one Chrome ``trace_event`` JSON per query. ``profile_folder`` runs
    each query under ``torch.profiler`` (device activity on cuda), writes
    its trace there as ``<query>.json`` and adds the device's kernel time
    and top kernels to the summary (``profile``).

    ``ledger_path`` (or ``NDS_TPU_LEDGER``) appends one validated record
    per query to the evidence ledger — wall, syncs, phase rollup,
    streamed-scan and fault evidence — flushed as it lands, a ``metrics``
    rollup after each query and for the stream, and a terminal ``end``
    record. Returns the Session."""
    from nds_tpu_torch.engine import kernels as _K
    from nds_tpu_torch.engine import ops as _ops
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.obs import export as _obs_export
    from nds_tpu_torch.obs import metrics as _obs_metrics
    from nds_tpu_torch.obs import trace as _obs_trace

    queries_reports = []
    execution_time_list: list = []
    total_time_start = time.time()
    if len(query_dict) == 1:
        app_name = "NDS - " + list(query_dict.keys())[0]
    else:
        app_name = "NDS - Power Run"

    conf = load_properties(property_file) if property_file else {}
    session = Session(conf, device=device)
    session.app_name = app_name
    execution_time_list = setup_tables(
        session, input_prefix, input_format, use_decimal,
        execution_time_list)

    check_json_summary_folder(json_summary_folder)
    if sub_queries:
        query_dict = get_query_subset(query_dict, sub_queries)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
    if profile_folder:
        os.makedirs(profile_folder, exist_ok=True)

    # live metrics: reset at stream start so the stream record covers
    # exactly this pass; fed only at the per-query drain below
    metrics_reg = _obs_metrics.default()
    metrics_reg.reset()
    ledger = None
    ledger_path = ledger_path or os.environ.get("NDS_TPU_LEDGER")
    if ledger_path:
        from nds_tpu_torch.obs.ledger import Ledger
        ledger = Ledger(ledger_path, driver="power",
                        platform=f"torch-{session.device.type}",
                        app=app_name, format=input_format)

    power_start = int(time.time())
    # float twin of power_start: the stream record's wall must not round
    # a sub-second pass to zero
    power_start_f = time.time()
    for query_name, q_content in query_dict.items():
        print(f"====== Run {query_name} ======")
        q_report = BenchReport(session)
        _obs_trace.drain_spans()  # setup leftovers must not charge query 1
        drain_stream_events()
        drain_fault_events()
        syncs_before = _ops.sync_count()
        wait_before = _ops.sync_wait_ns()
        fetch_before = _ops.fetch_bytes()
        compile_before = _ops.compile_ns()
        launches_before = dict(_K.LAUNCHES)
        prof = _profiler(session.device) if profile_folder else None
        with prof if prof is not None else contextlib.nullcontext():
            with _obs_trace.span("query", query=query_name):
                elapsed = q_report.report_on(run_one_query, session,
                                             q_content, query_name,
                                             output_path, output_format)
        if prof is not None:
            prof.export_chrome_trace(
                os.path.join(profile_folder, f"{query_name}.json"))
            q_report.summary["profile"] = profile_summary(prof)
        q_report.summary["hostSyncs"] = _ops.sync_count() - syncs_before
        sync_ms = (_ops.sync_wait_ns() - wait_before) / 1e6
        q_report.summary["syncWaitMs"] = round(sync_ms, 3)
        q_report.summary["fetchBytes"] = _ops.fetch_bytes() - fetch_before
        compile_ms = (_ops.compile_ns() - compile_before) / 1e6
        q_report.summary["compileMs"] = round(compile_ms, 1)
        q_report.summary["kernelLaunches"] = {
            k: v - launches_before.get(k, 0) for k, v in _K.LAUNCHES.items()}
        q_report.summary["device"] = str(session.device)
        # the replay tier that served the statement (engine/replay.py):
        # eager, record, replayed or "blacklisted: <reason>"
        q_report.summary["replayTier"] = session.last_tier
        # streamed scans (engine/stream.py): which path served each
        # ChunkedTable-bound scan — the chunk pipeline or the eager loop —
        # with its chunks, partitions, syncs and K4/K5 launches
        stream_events = drain_stream_events()
        if stream_events:
            q_report.summary["streamedScans"] = [
                stream_event_json(e) for e in stream_events]
        # fault evidence (engine/faults.py): retries, ladder steps and
        # watchdog timeouts this query went through
        fault_events = drain_fault_events()
        if fault_events:
            q_report.summary["faultEvents"] = [
                fault_event_json(e) for e in fault_events]
        trace_records = _obs_trace.drain_spans()
        if trace_records:
            roll = _obs_export.rollup(trace_records)
            q_report.summary["trace"] = roll
            if trace_dir:
                _obs_export.write_chrome_trace(
                    os.path.join(trace_dir, f"{query_name}.trace.json"),
                    trace_records, query=query_name, roll=roll)
        scan_bytes = sum(getattr(session, "last_scanned", {}).values())
        q_report.summary["scanBytes"] = scan_bytes
        print(f"Time taken: [{elapsed}] millis for {query_name}")
        execution_time_list.append((session.app_id, query_name, elapsed,
                                    round(compile_ms, 1)))
        q_report.summary["query"] = query_name
        q_report.summary["phase"] = "Power"
        status = "ok" if q_report.is_success() else "error"
        if status == "error" and any(e.action == "timeout"
                                     for e in fault_events):
            status = "timeout"       # the statement watchdog fired
        metrics_reg.inc("queries.total")
        metrics_reg.inc(f"queries.{status}")
        metrics_reg.observe(_obs_metrics.QUERY_WALL, elapsed)
        metrics_reg.observe(_obs_metrics.SYNC_WAIT, sync_ms)
        for s in q_report.summary.get("streamedScans", ()):
            if s.get("prefetchStallMs", 0.0) > 0:
                metrics_reg.observe(_obs_metrics.STALL,
                                    s["prefetchStallMs"])
        if fault_events:
            metrics_reg.inc("faults.total", len(fault_events))
        if ledger is not None:
            # the durable slice of the summary; the ledger derives the
            # evidence aggregate from streamedScans
            rec = {"ms": elapsed, "phase": "Power"}
            for k in ("hostSyncs", "syncWaitMs", "scanBytes", "compileMs",
                      "kernelLaunches", "replayTier", "streamedScans",
                      "faultEvents"):
                if k in q_report.summary:
                    rec[k] = q_report.summary[k]
            if "trace" in q_report.summary:
                rec["tracePhases"] = q_report.summary["trace"]
            if status != "ok" and q_report.summary["exceptions"]:
                rec["error"] = str(q_report.summary["exceptions"][-1])[:300]
            ledger.query(query_name, status=status, **rec)
            ledger.metrics(scope="query", query=query_name,
                           **metrics_reg.query_rollup())
        queries_reports.append(q_report)
        _obs_metrics.export_live(
            registry=metrics_reg,
            extra={"driver": "power", "app": app_name, "query": query_name,
                   "done": len(queries_reports), "total": len(query_dict),
                   "phase": "Power"})
        if json_summary_folder:
            if property_file:
                summary_prefix = os.path.join(
                    json_summary_folder,
                    os.path.basename(property_file).split(".")[0])
            else:
                summary_prefix = os.path.join(json_summary_folder, "")
            q_report.write_summary(query_name, prefix=summary_prefix)
    power_end = int(time.time())
    power_elapse = int((power_end - power_start) * 1000)
    total_elapse = int((time.time() - total_time_start) * 1000)
    print(f"====== Power Test Time: {power_elapse} milliseconds ======")
    print(f"====== Total Time: {total_elapse} milliseconds ======")
    execution_time_list.append(
        (session.app_id, "Power Start Time", power_start))
    execution_time_list.append(
        (session.app_id, "Power End Time", power_end))
    execution_time_list.append(
        (session.app_id, "Power Test Time", power_elapse))
    execution_time_list.append((session.app_id, "Total Time", total_elapse))
    if ledger is not None:
        ledger.metrics(scope="stream", app=app_name, phase="Power",
                       **metrics_reg.stream_rollup(
                           time.time() - power_start_f))
        ledger.close("completed", queries=len(queries_reports),
                     wallS=round(total_elapse / 1e3, 1))

    header = ["application_id", "query", "time/milliseconds",
              "compile/milliseconds"]
    print(header)
    for row in execution_time_list:
        print(row)
    for path in (time_log_output_path,
                 extra_time_log_output_path and os.path.join(
                     extra_time_log_output_path, "part-0.csv")):
        if not path:
            continue
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="UTF8") as f:
            writer = csv.writer(f)
            writer.writerow(header)
            writer.writerows(execution_time_list)

    exit_code = 0
    for q in queries_reports:
        if not q.is_success():
            if exit_code == 0:
                print("====== Queries with failure ======")
            print("{} status: {}".format(q.summary["query"],
                                         q.summary["queryStatus"]))
            exit_code = 1
    if exit_code:
        print("Above queries failed or completed with failed tasks. "
              "Please check the logs for the detailed reason.")
    if not allow_failure and exit_code:
        sys.exit(exit_code)
    return session


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def profile_summary(prof, top: int = 5) -> dict:
    """Device kernel time of one profiled query (ms, summed over the
    device-side events) and its ``top`` kernels by that time."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return {"deviceKernelMs": round(sum(r[1] for r in rows), 3),
            "kernelLaunches": sum(r[2] for r in rows),
            "topKernels": [{"name": k[:120], "ms": round(ms, 3), "count": c}
                           for k, ms, c in rows[:top]]}


def load_properties(filename: str) -> dict:
    """java-properties overlay file -> dict."""
    myvars = {}
    with open(filename) as myfile:
        for line in myfile:
            if line.strip().startswith("#") or "=" not in line:
                continue
            name, var = line.partition("=")[::2]
            myvars[name.strip()] = var.strip()
    return myvars


def main(argv=None) -> None:
    import argparse
    parser = argparse.ArgumentParser(prog="python -m nds_tpu_torch.power")
    parser.add_argument("input_prefix",
                        help="directory holding the 24 tables")
    parser.add_argument("query_stream_file",
                        help="query stream file that contains NDS queries in "
                        "specific order.")
    parser.add_argument("time_log", nargs="?", default="",
                        help="path to execution time log.")
    parser.add_argument("--input_format", default="parquet",
                        choices=["parquet", "orc", "avro", "csv", "json",
                                 "raw"],
                        help="type of the input data ('raw' and 'csv' read "
                        "the '|'-delimited generator output).")
    parser.add_argument("--output_prefix",
                        help="text to prepend to every output file.")
    parser.add_argument("--output_format", default="parquet",
                        help="type of query output.")
    parser.add_argument("--property_file",
                        help="property file for engine configuration.")
    parser.add_argument("--floats", action="store_true",
                        help="use double instead of decimal for monetary "
                        "columns when loading text data.")
    parser.add_argument("--json_summary_folder",
                        help="empty folder/path to save JSON summary files.")
    parser.add_argument("--extra_time_log",
                        help="extra path to save time log.")
    parser.add_argument("--sub_queries",
                        type=lambda s: [x.strip() for x in s.split(",")],
                        help="comma separated list of queries to run.")
    parser.add_argument("--allow_failure", action="store_true",
                        help="do not exit non-zero when a query fails.")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="execution device (default cuda; raises when no "
                        "GPU is present).")
    parser.add_argument("--profile",
                        help="folder for per-query torch.profiler traces; "
                        "the device's kernel time lands in each summary.")
    parser.add_argument("--trace-dir",
                        help="folder for per-query Chrome trace_event JSON "
                        "files from the engine's span tracer.")
    parser.add_argument("--ledger",
                        help="evidence ledger JSONL to append every query "
                        "to (default: NDS_TPU_LEDGER).")
    args = parser.parse_args(argv)
    query_dict = gen_sql_from_stream(args.query_stream_file)
    run_query_stream(args.input_prefix, args.property_file, query_dict,
                     args.time_log, args.extra_time_log, args.sub_queries,
                     args.input_format, not args.floats, args.output_prefix,
                     args.output_format, args.json_summary_folder,
                     args.allow_failure, trace_dir=args.trace_dir,
                     device=args.device, profile_folder=args.profile,
                     ledger_path=args.ledger)


if __name__ == "__main__":
    main()
