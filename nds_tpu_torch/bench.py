# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Bench entry of the port: the Power Run's geomean statement time on one
GPU.

    python -m nds_tpu_torch.bench [--cache-root DIR] [--raw-dir DIR]
        [--out-dir DIR] [--baseline FILE] [--device cuda|cpu]
        [--sub_queries q1,q2]

Data comes from ``native/ndsgen`` at ``NDS_BENCH_SCALE`` (default 1) into
``<cache-root>/sf<scale>/`` (or from ``--raw-dir``, raw data already
generated), transcoded once to parquet by the port's ``write_table`` into
``<cache-root>/sf<scale>_torch_parquet/``. The statements are the stream
that ``generate_query_streams`` makes with rngseed 0 (103 statements).
Every statement runs a warm-up pass, then two timed passes; its record
holds both timed walls (``passMs``) and their minimum (``ms``). The last
line of standard output is

    {"metric": "power_geomean_ms", "value": N, "unit": "ms",
     "vs_baseline": N, "n_queries": N}

Execution model: ONE persistent child process (``--serve``) loads the
tables into a ``Session`` on the device once and serves statement names
over a line protocol (stdin: a name; stdout: one JSON result line). The
parent never imports torch. It enforces a per-statement deadline: a
wedged or crashed child costs that statement, is killed and restarted
(with a jittered backoff; two setup failures in a row trip a circuit
breaker). A SIGTERM or SIGINT still prints the final line for what was
measured.

Evidence: ``NDS_BENCH_RESULTS_JSONL`` names the ledger
(:mod:`nds_tpu_torch.obs.ledger`): a ``meta`` record with the platform
(``torch-cuda``), the card's name and power limit (``nvidia-smi``) and the
scale, one ``query`` and one ``metrics`` record per statement, flushed as
they land, heartbeat ``progress`` records (``NDS_BENCH_HEARTBEAT_S``), and
a terminal ``end`` record. The same file resumes an interrupted run: its
``ok`` statements are not measured again. Every record carries the
campaign stamp (:func:`nds_tpu_torch.obs.campaign.campaign_stamp`).

Budgets: each statement's deadline is its wall in the port's own baseline
file (``--baseline``) times ``NDS_BENCH_BUDGET_HEADROOM`` (default 25),
within [``NDS_BENCH_BUDGET_FLOOR_S`` (90), ``NDS_BENCH_QUERY_TIMEOUT_S``
(420)]; the whole run gets ``NDS_BENCH_BUDGET_S`` (3000). The baseline file
records the card, its power limit and the scale; a file of another card or
scale counts as missing, and then every statement gets the cap and
``vs_baseline`` is 0.0. ``NDS_BENCH_SEED_BASELINE=1`` starts a missing
file. The per-statement table goes to ``<out-dir>/perf_table.md``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import queue
import shutil
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass

from nds_tpu_torch.engine import faults as _F
from nds_tpu_torch.obs import campaign as _C
from nds_tpu_torch.obs import ledger as _L
from nds_tpu_torch.obs import metrics as _M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NDSGEN = os.path.join(REPO, "native", "ndsgen", "ndsgen")
# tables transcoded at once (pyarrow releases the GIL while it parses and
# writes)
TRANSCODE_THREADS = 4

# per-statement result fields kept beside the wall time, in the live loop
# and by the resume loader alike
PERF_KEYS = ("passMs", "hostSyncs", "syncWaitMs", "scanBytes", "scanGBps",
             "warmS", "compileS", "kernelLaunches", "hbmBytesInUse",
             "peakHbmBytes", "streamedScans", "tracePhases", "evidence",
             "faultEvents", "replayTier")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return float(default)


@dataclass
class Config:
    """One bench run's settings: the command line, with paths made
    absolute (the child runs from the repository root), and the
    ``NDS_BENCH_*`` environment read once."""

    scale: str = "1"
    cache_root: str = os.path.join(REPO, ".bench_cache")
    raw_dir: str | None = None
    out_dir: str | None = None
    baseline: str | None = None
    device: str = "cuda"
    sub_queries: list | None = None
    query_timeout_s: float = 420.0
    setup_timeout_s: float = 300.0
    budget_s: float = 3000.0
    heartbeat_s: float = 15.0
    ledger: str | None = None
    trace_dir: str | None = None

    @classmethod
    def from_args(cls, args) -> "Config":
        ab = lambda p: os.path.abspath(p) if p else None  # noqa: E731
        env = os.environ
        return cls(
            scale=env.get("NDS_BENCH_SCALE", "1"),
            cache_root=ab(args.cache_root),
            raw_dir=ab(args.raw_dir),
            out_dir=ab(args.out_dir),
            baseline=ab(args.baseline),
            device=args.device,
            sub_queries=args.sub_queries,
            query_timeout_s=_env_float("NDS_BENCH_QUERY_TIMEOUT_S", 420),
            setup_timeout_s=_env_float("NDS_BENCH_SETUP_TIMEOUT_S", 300),
            budget_s=_env_float("NDS_BENCH_BUDGET_S", 3000),
            heartbeat_s=_env_float("NDS_BENCH_HEARTBEAT_S", 15),
            ledger=env.get("NDS_BENCH_RESULTS_JSONL") or None,
            trace_dir=env.get("NDS_BENCH_TRACE_DIR") or None)

    def child_args(self) -> list:
        """The command-line arguments that rebuild this config in the
        serving child (the environment is inherited)."""
        out = ["--cache-root", self.cache_root, "--device", self.device]
        if self.raw_dir:
            out += ["--raw-dir", self.raw_dir]
        if self.sub_queries:
            out += ["--sub_queries", ",".join(self.sub_queries)]
        return out

    @property
    def perf_dir(self) -> str:
        return self.out_dir or os.path.join(self.cache_root,
                                            f"bench_sf{self.scale}_torch")


# ---------------------------------------------------------------------------
# data and statements
# ---------------------------------------------------------------------------


def card_stamp(device: str) -> dict:
    """The card the run measures: ``nvidia-smi``'s name and power limit of
    the first GPU on cuda, ``cpu`` on the host. Runs without torch."""
    if device == "cpu":
        return {"card": "cpu", "powerLimit": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    line = out.strip().splitlines()[0] if out.strip() else ""
    name, _, limit = line.partition(",")
    return {"card": name.strip() or "unknown",
            "powerLimit": limit.strip() or None}


def transcode(raw_dir: str, out_dir: str, threads: int = TRANSCODE_THREADS):
    """The raw tables as parquet through the port's ``write_table``, one
    directory per table, ``threads`` tables at once, largest first.
    Returns the seconds each table took."""
    import concurrent.futures as cf

    from nds_tpu_torch.io import read_raw_table
    from nds_tpu_torch.io.columnar import write_table
    from nds_tpu_torch.schema import get_schemas
    shutil.rmtree(out_dir, ignore_errors=True)

    def raw_path(tname):
        path = os.path.join(raw_dir, tname)
        return path if os.path.exists(path) else path + ".dat"

    def size(path):
        if not os.path.exists(path):
            return 0
        if os.path.isfile(path):
            return os.path.getsize(path)
        return sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))

    def one(tname, fields):
        t = time.time()
        arrow = read_raw_table(raw_path(tname), fields)
        write_table(arrow, os.path.join(out_dir, tname), "parquet")
        return round(time.time() - t, 3)

    schemas = sorted(((t, f) for t, f in
                      get_schemas(use_decimal=True).items()
                      if os.path.exists(raw_path(t))),
                     key=lambda kv: -size(raw_path(kv[0])))
    with cf.ThreadPoolExecutor(threads) as pool:
        futs = {t: pool.submit(one, t, f) for t, f in schemas}
        return {t: f.result() for t, f in futs.items()}


def ensure_data(cfg: Config) -> str:
    """The parquet directory of the run's data: generated by
    ``native/ndsgen`` unless ``cfg.raw_dir`` names raw data, transcoded
    once. The transcode is redone when the raw data is newer or another
    directory's."""
    raw = cfg.raw_dir
    if raw is None:
        raw = os.path.join(cfg.cache_root, f"sf{cfg.scale}")
        if not os.path.exists(os.path.join(raw, ".complete")):
            if not os.path.exists(NDSGEN):
                subprocess.run(["make", "-C", os.path.dirname(NDSGEN)],
                               check=True, capture_output=True)
            os.makedirs(raw, exist_ok=True)
            subprocess.run([NDSGEN, "-scale", cfg.scale, "-dir", raw],
                           check=True)
            with open(os.path.join(raw, ".complete"), "w"):
                pass
    pq_dir = os.path.join(cfg.cache_root, f"sf{cfg.scale}_torch_parquet")
    marker = os.path.join(pq_dir, ".complete")
    raw_marker = os.path.join(raw, ".complete")
    fresh = False
    if os.path.exists(marker):
        with open(marker) as f:
            fresh = f.read() == os.path.abspath(raw)
        if fresh and os.path.exists(raw_marker):
            fresh = os.path.getmtime(marker) >= os.path.getmtime(raw_marker)
    if not fresh:
        transcode(raw, pq_dir)
        with open(marker, "w") as f:
            f.write(os.path.abspath(raw))
    return pq_dir


def bench_queries(cfg: Config) -> list:
    """``[(name, sql)]``: the supported templates' stream (rngseed 0) at the
    run's scale, cached under the cache root; ``cfg.sub_queries`` picks a
    subset in stream order."""
    from nds_tpu_torch.power import gen_sql_from_stream, get_query_subset
    from nds_tpu_torch.queries import (SUPPORTED_QUERIES,
                                       generate_query_streams)
    qdir = os.path.join(cfg.cache_root,
                        f"stream_sf{cfg.scale}_n{len(SUPPORTED_QUERIES)}"
                        "_torch")
    stream_file = os.path.join(qdir, "query_0.sql")
    if not os.path.exists(stream_file):
        generate_query_streams(qdir, streams=1, rngseed=0,
                               templates=SUPPORTED_QUERIES,
                               scale=float(cfg.scale))
    queries = gen_sql_from_stream(stream_file)
    if cfg.sub_queries:
        queries = get_query_subset(queries, cfg.sub_queries)
    return list(queries.items())


# ---------------------------------------------------------------------------
# the port's baseline: this card, this scale
# ---------------------------------------------------------------------------


def read_baseline(baseline_file, stamp: dict, scale: str):
    """The baseline document when it exists, parses, and was recorded on
    this card at this power limit and scale; else None (a file of another
    card or scale counts as missing)."""
    if not baseline_file or not os.path.exists(baseline_file):
        return None
    try:
        with open(baseline_file) as f:
            base = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(base, dict):
        return None
    if (base.get("card"), base.get("powerLimit"), str(base.get("scale"))) \
            != (stamp.get("card"), stamp.get("powerLimit"), str(scale)):
        return None
    return base


def order_by_history(names, base):
    """Cheapest first by the baseline's walls; unmeasured statements go
    last. When the budget runs out mid-run this maximizes the number of
    measured statements."""
    hist = (base or {}).get("times") or {}
    known = sorted((n for n in names if n in hist), key=lambda n: hist[n])
    return known + [n for n in names if n not in hist]


def derive_budgets(names, base, cap_s, headroom=None, floor_s=None):
    """Per-statement deadlines (seconds): the baseline's wall x
    ``headroom`` within [``floor_s``, ``cap_s``]; a statement without
    history, or any statement when there is no baseline for this card and
    scale, gets the cap."""
    if headroom is None:
        headroom = _env_float("NDS_BENCH_BUDGET_HEADROOM", 25)
    if floor_s is None:
        floor_s = _env_float("NDS_BENCH_BUDGET_FLOOR_S", 90)
    hist = (base or {}).get("times") or {}
    return {n: min(max(hist[n] / 1e3 * headroom, floor_s), cap_s)
            if n in hist else cap_s for n in names}


def _geomean(vals):
    return math.exp(sum(math.log(max(v, 1e-3)) for v in vals) / len(vals))


def resolve_baseline(baseline_file, times, stamp: dict, scale: str) -> float:
    """vs_baseline: the geomean ratio (baseline / this run) over the
    statements both have. The file keeps each statement's FIRST recorded
    wall: a run fills in what it lacks and never overwrites. No file, or
    one of another card or scale, gives 0.0 and is not written, unless
    ``NDS_BENCH_SEED_BASELINE`` starts a missing one."""
    base = read_baseline(baseline_file, stamp, scale)
    if base is None:
        seed = (baseline_file and not os.path.exists(baseline_file)
                and os.environ.get("NDS_BENCH_SEED_BASELINE"))
        if not seed:
            print(f"# baseline {baseline_file or '(none given)'} missing or "
                  f"not of {stamp.get('card')} / {stamp.get('powerLimit')} "
                  f"/ scale {scale}: vs_baseline reported as 0.0",
                  file=sys.stderr)
            return 0.0
    base_times = (base or {}).get("times") or {}
    common = sorted(set(times) & set(base_times))
    vs = (_geomean([base_times[q] for q in common]) /
          _geomean([times[q] for q in common])) if common else 1.0
    merged = dict(base_times)
    for q, t in times.items():
        merged.setdefault(q, t)
    if merged != base_times:
        out = {"metric": "power_geomean_ms",
               "value": _geomean(list(merged.values())),
               "n_queries": len(merged), "times": merged,
               "card": stamp.get("card"),
               "powerLimit": stamp.get("powerLimit"), "scale": str(scale)}
        with open(baseline_file, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
    return vs


# ---------------------------------------------------------------------------
# the serving child
# ---------------------------------------------------------------------------


def error_result(name, exc):
    """The serving loop's failure line: the classified status and THIS
    statement's fault evidence (left in the ring, it would be charged to
    the next statement)."""
    out = {"name": name, "error": f"{type(exc).__name__}: {exc}"[:300]}
    events = _F.drain_fault_events()
    if events:
        out["faultEvents"] = [_F.fault_event_json(e) for e in events]
    if isinstance(exc, _F.StatementTimeout):
        out["timeout"] = True          # the watchdog fired: `timeout`
    return out


def run_server(cfg: Config) -> None:
    """Persistent child: load the tables once, then serve statement names
    from stdin, one JSON result line on stdout each."""
    import torch

    from nds_tpu_torch.engine import kernels as K
    from nds_tpu_torch.engine import ops as E
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.listener import (drain_stream_events,
                                        stream_event_json, stream_evidence)
    from nds_tpu_torch.obs import export as obs_export
    from nds_tpu_torch.obs import trace as obs_trace
    from nds_tpu_torch.power import strip_stream_markers
    from nds_tpu_torch.schema import get_schemas

    data_dir = ensure_data(cfg)
    wanted = {n: strip_stream_markers(q) for n, q in bench_queries(cfg)}
    sess = Session(device=cfg.device)
    for table, fields in get_schemas(use_decimal=True).items():
        path = os.path.join(data_dir, table)
        if os.path.exists(path):
            sess.read_columnar_view(table, path, "parquet",
                                    {f.name: str(f.type) for f in fields})
    cuda = sess.device.type == "cuda"
    ready = {"ready": True, "platform": f"torch-{sess.device.type}"}
    if cuda:
        ready["device"] = torch.cuda.get_device_name(sess.device)
    print(json.dumps(ready), flush=True)

    for line in sys.stdin:
        name = line.strip()
        if not name:
            break
        try:
            sql = wanted[name]
            if cuda:
                torch.cuda.reset_peak_memory_stats(sess.device)
            c0 = E.compile_ns()
            tw = time.perf_counter()
            sess.sql(sql).collect()                    # warm-up pass
            # replay ('auto' on cuda): a high-sync statement goes eager ->
            # record + capture -> first replay over its next sights; fold
            # those into warm-up so that the timed passes below measure
            # the steady state
            for _ in range(3):
                if not sess.replay_pending(sql):
                    break
                sess.sql(sql).collect()
            t0 = time.perf_counter()
            sess.sql(sql).collect()
            t1 = time.perf_counter()
            tiers = [sess.last_tier]
            # evidence of the final timed pass only
            drain_stream_events()
            obs_trace.drain_spans()
            _F.drain_fault_events()
            s0, w0 = E.sync_count(), E.sync_wait_ns()
            launches0 = dict(K.LAUNCHES)
            sess.sql(sql).collect()
            t2 = time.perf_counter()
            tiers.append(sess.last_tier)
            stream_events = drain_stream_events()
            trace_records = obs_trace.drain_spans()
            passes = [round((t1 - t0) * 1e3, 3), round((t2 - t1) * 1e3, 3)]
            scan = sum(getattr(sess, "last_scanned", {}).values())
            result = {
                "name": name, "ms": min(passes), "passMs": passes,
                "hostSyncs": E.sync_count() - s0,
                "syncWaitMs": round((E.sync_wait_ns() - w0) / 1e6, 3),
                "scanBytes": scan,
                "scanGBps": round(scan / max(t2 - t1, 1e-9) / 1e9, 3),
                "warmS": round(t0 - tw, 3),
                # kernel builds (nvcc) and graph captures the warm-up
                # passes paid
                "compileS": round((E.compile_ns() - c0) / 1e9, 3),
                "kernelLaunches": {k: v - launches0.get(k, 0)
                                   for k, v in K.LAUNCHES.items()},
                # the replay tier that served each timed pass: eager,
                # record, replayed or "blacklisted: <reason>"
                "replayTier": tiers}
            if stream_events:
                result["streamedScans"] = [stream_event_json(e)
                                           for e in stream_events]
                result["evidence"] = stream_evidence(stream_events)
            fault_events = _F.drain_fault_events()
            if fault_events:
                result["faultEvents"] = [_F.fault_event_json(e)
                                         for e in fault_events]
            if trace_records:
                roll = obs_export.rollup(trace_records)
                result["tracePhases"] = roll
                if cfg.trace_dir:
                    os.makedirs(cfg.trace_dir, exist_ok=True)
                    obs_export.write_chrome_trace(
                        os.path.join(cfg.trace_dir, f"{name}.trace.json"),
                        trace_records, query=name, roll=roll)
            if cuda:
                result["hbmBytesInUse"] = int(
                    torch.cuda.memory_allocated(sess.device))
                result["peakHbmBytes"] = int(
                    torch.cuda.max_memory_allocated(sess.device))
            print(f"# {name}: warm {result['warmS']:.2f}s (build "
                  f"{result['compileS']:.2f}s) timed {passes} ms "
                  f"syncs {result['hostSyncs']} tier {tiers[-1]}",
                  file=sys.stderr)
            print(json.dumps(result), flush=True)
        except Exception as e:                          # keep serving
            print(json.dumps(error_result(name, e)), flush=True)


class ChildServer:
    """Supervises the persistent serving child with per-request
    deadlines."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.proc = None
        self.lines = None

    def _reader(self, proc, q):
        for line in proc.stdout:
            q.put(line)
        q.put(None)

    def start(self, deadline_left):
        self.stop()
        try:
            # bench-child seam: an injected start fault takes the path of
            # a real setup failure (backoff and circuit breaker)
            _F.fault_point("bench-child")
        except _F.FaultInjected as exc:
            _F.record_fault_event("bench-child", "degrade",
                                  detail=str(exc)[:200])
            return None
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "nds_tpu_torch.bench", "--serve"]
            + self.cfg.child_args(), cwd=REPO,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.lines = queue.Queue()
        threading.Thread(target=self._reader,
                         args=(self.proc, self.lines), daemon=True).start()
        msg = self._next_json(min(self.cfg.setup_timeout_s, deadline_left))
        if not (msg and msg.get("ready")):
            # a late "ready" line would be read as a statement's result
            self.stop()
            return None
        return msg

    def _next_json(self, timeout):
        end = time.perf_counter() + timeout
        while True:
            left = end - time.perf_counter()
            if left <= 0:
                return None
            try:
                line = self.lines.get(timeout=left)
            except queue.Empty:
                return None
            if line is None:
                return None
            try:
                return json.loads(line)
            except ValueError:
                continue                          # stray non-JSON output

    def run_query(self, name, timeout):
        try:
            self.proc.stdin.write(name + "\n")
            self.proc.stdin.flush()
        except (BrokenPipeError, OSError):
            return None
        return self._next_json(timeout)

    def alive(self):
        return self.proc is not None and self.proc.poll() is None

    def stop(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        self.proc = None


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


def restart_backoff_s(restart_n: int) -> float:
    """Backoff before child start ``restart_n`` (the 2nd onwards):
    exponential in ``NDS_BENCH_RESTART_BACKOFF_S`` (default 1.0) with a
    jitter fraction derived from the restart index, so co-scheduled runs
    do not restart in lockstep and the value is deterministic."""
    base = _env_float("NDS_BENCH_RESTART_BACKOFF_S", 1.0)
    if base <= 0 or restart_n <= 1:
        return 0.0
    raw = base * (2 ** min(restart_n - 2, 4))
    jitter = ((restart_n * 2654435761) % 1000) / 1000.0  # [0, 1)
    return min(raw * (1.0 + 0.5 * jitter), 30.0)


def drain_parent_faults(ledger):
    """Drain this process's fault ring (the ``bench-child`` seam records
    here) into ledger progress notes; returns the events."""
    events = _F.drain_fault_events()
    if ledger is not None:
        for e in events:
            ledger.progress(note="fault-event", **_F.fault_event_json(e))
    return events


def perf_text(times, perf, platform="unknown", scale=None, card=None):
    """The per-statement table as text, deterministic in its inputs
    (sorted statements, no clocks), so one ledger always renders the same
    document."""
    rows = sorted(times)
    tot_sync = sum(p.get("syncWaitMs", 0) for p in perf.values())
    tot_ms = sum(times.values())
    streamed = [e for p in perf.values()
                for e in p.get("streamedScans", [])]
    out = ["# Power Run statement table", "",
           f"Scale factor {scale}; min of two timed passes after a warm-up; "
           f"platform: {platform}; card: {card or 'unknown'}.",
           f"Aggregate: {len(times)} statements, "
           f"{tot_sync / max(tot_ms, 1e-9) * 100:.1f}% of summed wall "
           "time blocked on device->host reads."]
    if streamed:
        n_comp = sum(1 for e in streamed if e["path"] == "compiled")
        out.append(f"Streamed scans: {len(streamed)} "
                   f"({n_comp} chunk pipeline, "
                   f"{len(streamed) - n_comp} eager loop).")
    out.append("")
    out.append("| query | wall ms | passes ms | tier | warm s | "
               "build + capture s | host syncs | sync wait ms | scan MB | "
               "scan GB/s |")
    out.append("|---|---|---|---|---|---|---|---|---|---|")
    for q in rows:
        p = perf.get(q, {})
        passes = "/".join(f"{x:.1f}" for x in p.get("passMs", ())) or "-"
        tier = (p.get("replayTier") or ["-"])[-1]
        out.append(f"| {q} | {times[q]:.1f} | {passes} | {tier} | "
                   f"{p.get('warmS', '-')} | {p.get('compileS', '-')} | "
                   f"{p.get('hostSyncs', '-')} | "
                   f"{p.get('syncWaitMs', '-')} | "
                   f"{p.get('scanBytes', 0) / 1e6:.1f} | "
                   f"{p.get('scanGBps', '-')} |")
    return "\n".join(out) + "\n"


class _Run:
    """What one parent run has measured, and its one-shot outputs: the
    final line is printed once, whether the loop ends or a signal ends
    it."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.times: dict = {}
        self.perf: dict = {}
        self.n_total = 0
        self.platform = "unknown"
        self.stamp = card_stamp(cfg.device)
        self.ledger = None
        self._emitted = False

    def emit(self, aborted=None) -> None:
        """Print the one JSON metric line (idempotent)."""
        if self._emitted:
            return
        self._emitted = True
        out = {"metric": "power_geomean_ms", "value": None, "unit": "ms",
               "vs_baseline": 0.0, "n_queries": len(self.times)}
        if self.times:
            try:
                vs = resolve_baseline(self.cfg.baseline, self.times,
                                      self.stamp, self.cfg.scale)
            except OSError as exc:
                # the metric line must survive a baseline-write failure
                print(f"# baseline update failed: {exc}", file=sys.stderr)
                vs = 0.0
            out.update(value=round(_geomean(list(self.times.values())), 3),
                       vs_baseline=round(vs, 4))
        if aborted:
            out["aborted"] = aborted
        print(json.dumps(out), flush=True)

    def finalize(self, aborted=None, wall_s=None, end_reason=None):
        """The table, the metric line and the ledger's terminal record,
        each isolated from the others' failures. Runs at the normal end
        and from the signal handler."""
        if self.perf:
            try:
                os.makedirs(self.cfg.perf_dir, exist_ok=True)
                with open(os.path.join(self.cfg.perf_dir, "perf_table.md"),
                          "w") as f:
                    f.write(perf_text(self.times, self.perf, self.platform,
                                      self.cfg.scale,
                                      self.stamp.get("card")))
            except OSError as exc:
                print(f"# table write failed: {exc}", file=sys.stderr)
        self.emit(aborted)
        if self.ledger is not None:
            reason = end_reason or aborted
            fields = {"queries": len(self.times), "total": self.n_total,
                      "platform": self.platform}
            if wall_s is not None:
                fields["wallS"] = round(wall_s, 1)
            if reason:
                fields["reason"] = reason
            try:
                self.ledger.close("aborted" if reason else "completed",
                                  **fields)
            except (OSError, ValueError) as exc:
                print(f"# ledger terminal write failed: {exc}",
                      file=sys.stderr)


def load_resume(path, times, perf):
    """Fill ``times``/``perf`` from an earlier run's ledger so an
    interrupted run resumes: only ``ok`` records count (a ``timeout`` or
    ``error`` statement runs again), a torn final line is dropped, and a
    ledger stamped under other knobs is refused. Returns the platform the
    earlier run recorded, or None."""
    if not path or not os.path.exists(path):
        return None
    data = _L.load_ledger(path)
    _C.check_resume_fingerprint(data.meta.get("envFingerprint"),
                                _C.env_fingerprint(), path)
    if data.torn:
        print("# resume ledger: torn final line (in-flight statement of "
              "a kill) dropped", file=sys.stderr)
    for name, rec in data.queries.items():
        if rec["status"] == "ok" and "ms" in rec:
            times[name] = rec["ms"]
            perf[name] = {k: rec[k] for k in PERF_KEYS if k in rec}
    return data.platform


def run_parent(cfg: Config, t_entry: float) -> None:
    margin_s = 20.0          # the final line and ledger always beat a kill
    run = _Run(cfg)
    times, perf = run.times, run.perf
    names = []
    child = ChildServer(cfg)
    resume_platform = load_resume(cfg.ledger, times, perf)
    if cfg.ledger:
        run.ledger = _L.Ledger(cfg.ledger, driver="bench", scale=cfg.scale,
                               device=cfg.device, **run.stamp,
                               stamp=_C.campaign_stamp())
    run.platform = resume_platform or "unknown"
    live = {"query": None, "done": len(times), "total": 0}
    metrics_reg = _M.default()
    metrics_reg.reset()

    def on_signal(signum, frame):
        # an external kill: flush what was measured before the grace ends
        run.finalize(wall_s=time.perf_counter() - t_entry,
                     end_reason="signal")
        child.stop()
        os._exit(0)

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)

    ensure_data(cfg)                                 # once, before the child
    names = [n for n, _ in bench_queries(cfg)]
    run.n_total = live["total"] = len(names)
    base = read_baseline(cfg.baseline, run.stamp, cfg.scale)
    ordered = order_by_history(names, base)
    budgets = derive_budgets(names, base, cfg.query_timeout_s)
    restarts = 0

    def left():
        return cfg.budget_s - margin_s - (time.perf_counter() - t_entry)

    pending = [n for n in ordered if n not in times]
    if times:
        print(f"# resume: {len(times)} statements pre-loaded from "
              f"{os.path.basename(cfg.ledger)}", file=sys.stderr)
    heartbeat = None
    if cfg.heartbeat_s > 0:
        heartbeat = _L.Heartbeat(
            cfg.heartbeat_s, ledger=run.ledger,
            status=lambda: {**{k: v for k, v in live.items()
                               if v is not None},
                            **metrics_reg.heartbeat_rollup()}).start()
    attempts = {}
    aborted = None
    setup_fails = 0
    try:
        while pending and left() > 0:
            if not child.alive():
                if restarts > 6:                     # crash-looping backend
                    break
                restarts += 1
                back = min(restart_backoff_s(restarts), max(left(), 0.0))
                if back > 0:
                    print(f"# child restart {restarts}: backing off "
                          f"{back:.1f}s", file=sys.stderr)
                    time.sleep(back)
                ready = child.start(left())
                drain_parent_faults(run.ledger)
                if ready is None:
                    # circuit breaker: after two setup failures in a row
                    # stop paying and emit the labeled partial result
                    setup_fails += 1
                    if setup_fails >= 2:
                        aborted = "child-setup-failure"
                        print(f"# {setup_fails} consecutive child-setup "
                              "failures: failing fast with a partial "
                              "result", file=sys.stderr)
                        break
                    continue
                setup_fails = 0
                new_plat = ready.get("platform", "unknown")
                if new_plat != run.platform:
                    run.platform = new_plat
                    if run.ledger is not None:
                        run.ledger.meta(driver="bench", platform=new_plat,
                                        **({"deviceName": ready["device"]}
                                           if ready.get("device") else {}))
            name = pending.pop(0)
            attempts[name] = attempts.get(name, 0) + 1
            live["query"] = name
            per_q = budgets.get(name, cfg.query_timeout_s)
            deadline = min(per_q, left())
            msg = child.run_query(name, deadline)
            if msg is None:                           # wedged or crashed
                if child.alive():
                    status = "timeout"
                    limiter = "budget" if deadline >= per_q \
                        else "round-budget"
                    cause = f"timeout after {deadline:.0f}s ({limiter})"
                else:
                    status = "error"
                    cause = (f"child crashed (exit "
                             f"{child.proc.returncode})")
                print(f"# {name} aborted ({cause}); restarting child",
                      file=sys.stderr)
                metrics_reg.inc("queries.total")
                metrics_reg.inc(f"queries.{status}")
                child.stop()
                if run.ledger is not None:
                    rec = {"error": cause, "budgetS": round(deadline, 1),
                           "attempt": attempts[name]}
                    if status == "timeout":
                        rec["limiter"] = limiter
                    run.ledger.query(name, status=status, **rec)
                if attempts[name] < 2:                # one retry, at the end
                    pending.append(name)
                continue
            if "ms" in msg:
                times[msg["name"]] = msg["ms"]
                perf[msg["name"]] = {k: msg[k]
                                     for k in PERF_KEYS if k in msg}
                live["done"] = len(times)
                metrics_reg.inc("queries.total")
                metrics_reg.inc("queries.ok")
                metrics_reg.observe(_M.QUERY_WALL, msg["ms"])
                if msg.get("syncWaitMs"):
                    metrics_reg.observe(_M.SYNC_WAIT, msg["syncWaitMs"])
                if msg.get("faultEvents"):
                    metrics_reg.inc("faults.total", len(msg["faultEvents"]))
                if run.ledger is not None:
                    run.ledger.query(msg["name"], status="ok",
                                     **{k: v for k, v in msg.items()
                                        if k != "name"})
                    run.ledger.metrics(scope="query", query=msg["name"],
                                       **metrics_reg.query_rollup())
            else:
                print(f"# {name} failed: {msg.get('error')}",
                      file=sys.stderr)
                status = "timeout" if msg.get("timeout") else "error"
                metrics_reg.inc("queries.total")
                metrics_reg.inc(f"queries.{status}")
                if run.ledger is not None:
                    rec = {"error": str(msg.get("error"))[:300],
                           "attempt": attempts[name]}
                    if msg.get("faultEvents"):
                        rec["faultEvents"] = msg["faultEvents"]
                    run.ledger.query(name, status=status, **rec)
    finally:
        child.stop()
        if heartbeat is not None:
            heartbeat.stop()

    if times and len(times) < len(names):
        print(f"# measured {len(times)}/{len(names)} statements",
              file=sys.stderr)
    if run.ledger is not None:
        run.ledger.metrics(scope="stream", **metrics_reg.stream_rollup(
            time.perf_counter() - t_entry))
    # work left and no abort label: the budget ran out (or the child
    # crash-looped); the terminal record says so
    end_reason = None if aborted else ("incomplete" if pending else None)
    run.finalize(aborted, wall_s=time.perf_counter() - t_entry,
                 end_reason=end_reason)
    if not times:
        sys.exit(1)


def main(argv=None) -> None:
    t_entry = time.perf_counter()
    ap = argparse.ArgumentParser(prog="python -m nds_tpu_torch.bench")
    ap.add_argument("--serve", action="store_true",
                    help="persistent child: serve statements over stdin")
    ap.add_argument("--cache-root", default=os.path.join(REPO, ".bench_cache"),
                    help="directory of the generated data, its parquet "
                    "and the statement stream (default .bench_cache)")
    ap.add_argument("--raw-dir",
                    help="raw '|' data already generated at the scale; "
                    "skips the generator")
    ap.add_argument("--out-dir",
                    help="directory of the per-statement table (default "
                    "under the cache root)")
    ap.add_argument("--baseline",
                    help="the port's baseline file (card, power limit, "
                    "scale, first walls) for budgets and vs_baseline")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--sub_queries",
                    type=lambda s: [x.strip() for x in s.split(",")],
                    help="comma separated statements to run (stream "
                    "order)")
    args = ap.parse_args(argv)
    cfg = Config.from_args(args)
    if args.serve:
        run_server(cfg)
    else:
        run_parent(cfg, t_entry)


if __name__ == "__main__":
    main()
