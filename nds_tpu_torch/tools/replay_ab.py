# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Per-statement eager-against-replayed A/B on the attached device (the
port of the reference's ``tools/replay_ab.py``).

For each statement of the bench stream: the eager path once to warm and
once timed (the session with replay off, which runs the planner directly
and takes no replay tier), then the replay tiers under
``NDS_TPU_REPLAY=force``: the first sight, the record and capture (one
CUDA graph on cuda), the first replay (timed apart: it still runs the
graph's first launch) and a timed steady replay. One JSON line a
statement and a closing aggregate with the reference's keys, so that the
session's default replay policy (``auto`` on cuda) can be checked
statement by statement on this card.

Every timing ends on the device: an eager run waits on the card's
stream through the port's sync choke point (``ops.host_read``) before
the clock stops, and a replay blocks on its graph and fetches its rows.

Run: ``python -m nds_tpu_torch.tools.replay_ab [--queries q3,q9]
[--out REPLAY.json] [--device cpu]``. ``NDS_BENCH_SCALE`` (default 0.05)
picks the bench entry's data (``nds_tpu_torch.bench.ensure_data``) and
stream. The device defaults to cuda and the tool refuses to run without a
GPU unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@contextlib.contextmanager
def replay_policy(mode: str):
    """``NDS_TPU_REPLAY`` set to ``mode`` for the block."""
    old = os.environ.get("NDS_TPU_REPLAY")
    os.environ["NDS_TPU_REPLAY"] = mode
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("NDS_TPU_REPLAY", None)
        else:
            os.environ["NDS_TPU_REPLAY"] = old


def timed_run(sess):
    """The default ``run`` of :func:`measure`: ``(result, seconds)`` of
    one execution. The eager stage stops the clock when the card's
    stream is idle (the reference's ``block_until_ready``), the others
    after the rows are fetched (``collect``)."""
    from nds_tpu_torch.engine import ops as E

    def run(stage, sql):
        t0 = time.perf_counter()
        res = sess.sql(sql)
        if stage == "eager":
            if sess.device.type == "cuda":
                import torch
                E.host_read("replay_ab.eager_wait",
                            lambda: torch.cuda.synchronize(sess.device))
            out = res
        else:
            out = res.collect()
        return out, time.perf_counter() - t0
    return run


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def measure(sess, sql, reps: int = 1, run=None):
    """One statement's A/B on ``sess``: ``(row, runs)``. The row has the
    reference's keys (``eager_s``, ``record_compile_s``, ``compiled``,
    ``segmented``, ``replay_first_s``, ``replay_s``, ``speedup``, or
    ``blacklisted``); a timed stage runs ``reps`` times and reports its
    median. ``runs`` lists ``(stage, result, seconds)`` of every
    execution in order. ``run(stage, sql) -> (result, seconds)`` executes
    one stage (default :func:`timed_run`); a caller that keeps more
    evidence an execution passes its own. The session's replay state is
    left as the statement made it (:func:`reset` clears it)."""
    run = run or timed_run(sess)
    runs = []

    def go(stage):
        res, s = run(stage, sql)
        runs.append((stage, res, s))
        return s

    row = {}
    with replay_policy("off"):
        go("eager")                                   # warm
        row["eager_s"] = round(_median([go("eager") for _ in range(reps)]),
                               4)
    with replay_policy("force"):
        go("seen")                                    # tier 1
        row["record_compile_s"] = round(go("record"), 4)
        hits = [cq for (text, _v), cq in sess._replay_cache.items()
                if text == sql]
        row["compiled"] = bool(hits)
        if hits:
            # the port captures a whole statement as one graph: never
            # segmented
            row["segmented"] = len(getattr(hits[-1], "segments", None)
                                   or [])
            row["replay_first_s"] = round(go("replay_first"), 4)
            row["replay_s"] = round(
                _median([go("replay") for _ in range(reps)]), 4)
            row["speedup"] = round(row["eager_s"] /
                                   max(row["replay_s"], 1e-9), 2)
        else:
            row["blacklisted"] = True
    return row, runs


def reset(sess) -> None:
    """Forget every compiled statement of ``sess`` and, on cuda, its
    graph pool, so a sweep holds one statement's graphs at a time."""
    sess._replay_cache.clear()
    sess._replay_seen.clear()
    sess._replay_blacklist.clear()
    sess._replay_syncs.clear()
    if sess.device.type == "cuda":
        import torch
        sess._pool = sess._pool_keeper = None
        torch.cuda.empty_cache()


def geomean(vals):
    if not vals:
        return None
    return round(math.exp(sum(math.log(max(v, 1e-4)) for v in vals)
                          / len(vals)), 4)


def aggregate(results, backend: str, scale: str) -> dict:
    """The closing aggregate over the per-statement rows (the
    reference's keys)."""
    ok = [r for r in results if "replay_s" in r]
    return {
        "backend": backend,
        "scale": scale,
        "n_queries": len(results),
        "n_replayed": len(ok),
        "n_segmented": sum(1 for r in ok if r.get("segmented")),
        "geomean_eager_s": geomean([r["eager_s"] for r in ok]),
        "geomean_replay_s": geomean([r["replay_s"] for r in ok]),
        "note": ("Per-query eager-vs-replayed wall on this attachment; "
                 "the session replay policy (session._replay_on) should "
                 "be ON where geomean_replay_s < geomean_eager_s."),
        "results": results,
    }


def sweep(sess, queries, names, budget_s=600.0, out=print) -> list:
    """:func:`measure` each of ``names`` in ``queries`` ({name: sql}),
    resetting the session's replay state after each; returns the rows."""
    results = []
    for name in names:
        sql = queries.get(name)
        if sql is None:
            continue
        row = {"query": name}
        t_start = time.perf_counter()
        try:
            got, _runs = measure(sess, sql)
            row.update(got)
        except Exception as e:
            row["error"] = f"{type(e).__name__}: {e}"[:200]
        finally:
            reset(sess)
        row["wall_s"] = round(time.perf_counter() - t_start, 1)
        results.append(row)
        out(json.dumps(row))
        if time.perf_counter() - t_start > budget_s:
            print(f"# {name} exceeded budget; continuing", file=sys.stderr)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="per-statement eager against replayed walls")
    ap.add_argument("--queries", help="comma list; default = whole stream")
    ap.add_argument("--out", default=os.path.join(REPO, "REPLAY.json"))
    ap.add_argument("--per_query_budget_s", type=float, default=600.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from nds_tpu_torch import bench as B
    from nds_tpu_torch import resolve_device
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.schema import get_schemas

    device = resolve_device(args.device)
    scale = os.environ.get("NDS_BENCH_SCALE", "0.05")
    cfg = B.Config(scale=scale)
    data_dir = B.ensure_data(cfg)
    queries = dict(B.bench_queries(cfg))
    want = [q.strip() for q in args.queries.split(",")] if args.queries \
        else list(queries)
    sess = Session(device=device)
    for table, fields in get_schemas(use_decimal=True).items():
        path = os.path.join(data_dir, table)
        if os.path.exists(path):
            sess.read_columnar_view(table, path, "parquet",
                                    {f.name: str(f.type) for f in fields})
    results = sweep(sess, queries, want, args.per_query_budget_s,
                    out=lambda line: print(line, flush=True))
    agg = aggregate(results, device.type, scale)
    with open(args.out, "w") as f:
        json.dump(agg, f, indent=1)
    print(f"# wrote {args.out}: {agg['n_replayed']}/{len(results)} "
          f"replayed, eager {agg['geomean_eager_s']}s vs replay "
          f"{agg['geomean_replay_s']}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
