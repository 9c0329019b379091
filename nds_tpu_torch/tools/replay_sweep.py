# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Replay-parity sweep: every statement runs eager, then recorded and
captured, then replayed; the three row sets must match (the port of the
reference's ``tools/replay_sweep.py``, in its words).

Run: ``python -m nds_tpu_torch.tools.replay_sweep [q3,q7,...]
[--device cpu]``. The data and the stream are the coverage sweep's
(``nds_tpu_torch.tools.coverage_sweep``: ``NDS_SWEEP_SCALE``, default
0.01). Replay runs under ``NDS_TPU_REPLAY=force``: on cuda the third sight
of a statement is one captured CUDA graph, on cpu the planner again from
the recorded log. Exits 1 when a statement fails. The device defaults to
cuda and the sweep refuses to run without a GPU unless given ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time


def rows_eq(a, b) -> bool:
    """Order-insensitive with the validation driver's float epsilon: a
    replayed program may reduce doubles in another order, shifting the
    last ulp as the reference's CPU and GPU plans do (ref:
    nds/nds_validate.py epsilon rationale)."""
    from nds_tpu_torch.validate import compare
    if len(a) != len(b):
        return False

    def key(r):
        return tuple((x is None, round(x, 3) if isinstance(x, float)
                      else str(x)) for x in r)

    for ra, rb in zip(sorted(a, key=key), sorted(b, key=key)):
        if len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if not compare(x, y, 1e-9):
                return False
    return True


def parity(session, queries, out=print):
    """Each statement of ``queries`` ({name: sql}) eager, recorded and
    replayed on ``session`` under ``NDS_TPU_REPLAY=force``; prints a
    PASS/FAIL line each and the closing ``=== replay parity`` line.
    Returns (passed, failed, fallbacks): the names passed, failed and
    passed without a compiled replay."""
    from nds_tpu_torch.tools.replay_ab import replay_policy
    passed, failed, nocompile = [], [], []
    with replay_policy("force"):
        for q, sql in queries.items():
            t0 = time.perf_counter()
            try:
                r1 = session.sql(sql).collect()       # eager
                r2 = session.sql(sql).collect()       # record + capture
                compiled = any(k[0] == sql for k in session._replay_cache)
                r3 = session.sql(sql).collect()       # replayed
                if not compiled:
                    nocompile.append(q)
                if rows_eq(r1, r2) and rows_eq(r1, r3):
                    passed.append(q)
                    ms = (time.perf_counter() - t0) * 1000
                    out(f"PASS {q:16s} rows={len(r1)} "
                        f"{'replayed' if compiled else 'EAGER-FALLBACK'} "
                        f"{ms:7.0f}ms")
                else:
                    failed.append(q)
                    out(f"FAIL {q:16s} replay rows diverge "
                        f"({len(r1)}/{len(r2)}/{len(r3)})")
            except Exception as e:
                failed.append(q)
                out(f"FAIL {q:16s} {type(e).__name__}: {str(e)[:90]}")
    out(f"\n=== replay parity: {len(passed)} passed, {len(failed)} failed; "
        f"{len(nocompile)} fell back eager ===")
    if nocompile:
        out("fallbacks: " + " ".join(nocompile))
    return passed, failed, nocompile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="every statement eager, recorded and replayed: the "
        "three row sets must match")
    ap.add_argument("queries", nargs="?",
                    help="comma list of statements (default: all)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from nds_tpu_torch import resolve_device
    from nds_tpu_torch.power import gen_sql_from_stream
    from nds_tpu_torch.tools import coverage_sweep as C
    device = resolve_device(args.device)
    data_dir = C.ensure_data()
    queries = gen_sql_from_stream(C.sweep_stream())
    if args.queries:
        want = args.queries.split(",")
        queries = {k: v for k, v in queries.items() if k in want}
    session = C.load_session(data_dir, device)
    _p, failed, _n = parity(session, queries,
                            out=lambda line: print(line, flush=True))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
