# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Differential check of the static cost model against the engine.

The cost model (``analysis/perf_audit.py``) claims equalities: the compiled
drive pads every chunk to one capacity and ships a validity byte a column,
so ``bytes_h2d = chunks x chunk_cap x sum(width + 1)``, and the sharded
exchange moves bytes the model computes from the same shapes. This
harness holds those claims against ``StreamEvent`` evidence:

* the 14 streamed A/B statements (``AB_QUERIES``, those of the
  reference's ``tests/test_synccount.py``) run on the chunked toy star
  session (store_sales streamed in 2,048-row chunks; the reference's
  tables from the same seed), cold, warm and through the eager drive
  (``Session.sql(..., graph=False)``); on the card the cold sight captures
  the per-chunk graph, the warm one replays it;
* the predictions come from a :class:`PerfAuditor` built under the
  session's settings, with the session's real row counts and chunk rows
  and the live wire widths of the streamed table
  (:func:`perf_audit.wire_column_widths`);
* every sight's uploaded bytes must equal the prediction of each compiled
  scan (per statement, as sorted multisets), and the warm sight and the
  eager drive must upload what the cold one did; the sharded arm's
  collective bytes must equal the exchange-and-reduce arithmetic (or
  reach it, where outer-build bitmaps ride the reduce, a lower bound);
* on a CUDA device each scan's K4 and K5 launches must lie in the static
  band ``[K4 x chunks x S, (K4 + K5 x P) x chunks x S]`` and the arm's
  total must be nonzero. On the CPU the wrappers run their plain versions
  and count no launch: the harness says so on a line of its own and
  checks no band.

Arms: ``base`` (all 14, partitions forced to 2), ``sharded`` (ab0, ab2,
ab7 at 2 shards sharing the device, inside
``parallel.exchange.sharing_devices()``) and ``encoded-off`` (ab0, ab2,
ab7, ab11 under ``NDS_TPU_ENCODED=0``: plain widths). Each statement's
line gives its static roofline ms at the H100 rates beside its measured
warm ms.

``--inject-drift`` zeroes every prediction before comparing; the harness
must then fail (exit 0 means it did).

Run: ``python -m nds_tpu_torch.tools.perf_audit_diff [--device cpu]
[--inject-drift]``. The device defaults to cuda and the harness refuses to
run without a GPU unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

CHUNK_ROWS = 2048
PARTITIONS = 2
SHARDS = 2

# the streamed A/B statements of tests/test_synccount.py (every one
# must stream), kept here so the port's tools need nothing of the tests
AB_QUERIES = (
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
)

# (name, session settings, shards share the device, NDS_TPU_ENCODED,
#  statements): the flagship star join, the grouped aggregate and the
# partitioned fan-out go through the exchange; the raw wire re-checks a
# scan, a join, the fan-out and the two-pipeline scalar-subquery chain
ARMS = (
    ("base", {"stream_partitions": PARTITIONS}, False, None,
     tuple(range(len(AB_QUERIES)))),
    ("sharded", {"stream_partitions": PARTITIONS, "stream_shards": SHARDS},
     True, None, (0, 2, 7)),
    ("encoded-off", {"stream_partitions": PARTITIONS}, False, "0",
     (0, 2, 7, 11)),
)

SIGHTS = ("cold", "warm", "eager-drive")


@contextlib.contextmanager
def _env(**kv):
    """Set environment variables for one arm, restoring them after."""
    old = {k: os.environ.get(k) for k in kv}
    try:
        for k, v in kv.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def star_tables(seed: int = 42) -> dict:
    """The toy star schema of tests/test_synccount._chunked_star_session:
    the same tables from the same seed, draws in the same order."""
    import numpy as np
    import pyarrow as pa
    rng = np.random.default_rng(seed)
    n_fact, n_dim = 20_000, 365
    date_dim = pa.table({
        "d_date_sk": pa.array(np.arange(1, n_dim + 1), pa.int64()),
        "d_year": pa.array(1998 + np.arange(n_dim) // 120, pa.int64()),
        "d_moy": pa.array(1 + (np.arange(n_dim) // 30) % 12, pa.int64()),
    })
    item = pa.table({
        "i_item_sk": pa.array(np.arange(1, 201), pa.int64()),
        "i_brand_id": pa.array(rng.integers(1000, 1020, 200), pa.int64()),
    })
    store_returns = pa.table({
        "sr_item_sk": pa.array(np.repeat(np.arange(1, 201), 3), pa.int64()),
        "sr_ticket_number": pa.array(np.arange(600), pa.int64()),
        "sr_return_amt": pa.array(rng.integers(1, 100, 600), pa.int64()),
    })
    store_sales = pa.table({
        "ss_sold_date_sk": pa.array(
            rng.integers(1, n_dim + 40, n_fact), pa.int64()),
        "ss_item_sk": pa.array(rng.integers(1, 230, n_fact), pa.int64()),
        "ss_ticket_number": pa.array(np.arange(n_fact) % 1200, pa.int64()),
        "ss_ext_sales_price": pa.array(
            rng.integers(1, 10_000, n_fact), pa.int64()),
    })
    return {"date_dim": date_dim, "item": item,
            "store_returns": store_returns, "store_sales": store_sales}


def star_session(tables, device, conf):
    """A session over ``tables`` with store_sales streamed in
    :data:`CHUNK_ROWS`-row chunks."""
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.engine.table import ChunkedTable
    s = Session(conf=dict(conf), device=device)
    for name, tbl in tables.items():
        if name == "store_sales":
            s.create_temp_view(name, ChunkedTable(tbl, chunk_rows=CHUNK_ROWS),
                               base=True)
        else:
            s.create_temp_view(name, tbl, base=True)
    return s


def predict(session, indices):
    """PerfReports of the statements ``indices`` under the session's
    device and settings, its real row counts and chunk rows and the live
    wire widths of store_sales."""
    from nds_tpu_torch.analysis.mem_audit import MemModel
    from nds_tpu_torch.analysis.perf_audit import (PerfAuditor,
                                                   wire_column_widths)
    from nds_tpu_torch.engine import ops as E
    store = session.catalog["store_sales"]
    bounds = {name: int(t.nrows) for name, t in session.catalog.items()}
    with E.on_device(session.device, conf=session.conf):
        model = MemModel(row_bounds=bounds, chunk_rows=store.chunk_rows)
        auditor = PerfAuditor(
            streamed={"store_sales"}, model=model,
            wire_cols={"store_sales": wire_column_widths(store)})
        return {i: auditor.audit_sql(AB_QUERIES[i], query=f"ab{i}")
                for i in indices}


def run_sweep(session, indices):
    """Per statement and sight: the uploaded bytes, collective bytes,
    K4+K5 launches and chunks of every compiled scan, and the wall ms."""
    import torch

    from nds_tpu_torch.listener import drain_stream_events
    drain_stream_events()
    out = {}
    for i in indices:
        runs = {}
        for sight in SIGHTS:
            t0 = time.perf_counter()
            session.sql(AB_QUERIES[i], graph=sight != "eager-drive") \
                .collect()
            if session.device.type == "cuda":
                torch.cuda.synchronize(session.device)
            ms = (time.perf_counter() - t0) * 1e3
            comp = [e for e in drain_stream_events() if e.path == "compiled"]
            runs[sight] = {
                "ms": ms, "graphs": [e.graph for e in comp],
                "h2d": sorted((e.bytes_h2d for e in comp), reverse=True),
                "ici": sorted((e.bytes_ici for e in comp if e.shards > 1),
                              reverse=True),
                "launches": sorted((e.scan_launches + e.probe_launches
                                    for e in comp), reverse=True),
                "chunks": [e.chunks for e in comp]}
        out[i] = runs
    return out


def compare(arm, reports, evidence, launches_counted, inject=False):
    """Every check of one arm: ``(ok, lines, record)``."""
    ok, lines = True, []
    rec = {"arm": arm, "statements": 0, "h2d": [0, 0], "ici": [0, 0],
           "launches": 0, "band": [0, 0], "walls": {}}
    for i, runs in evidence.items():
        rep = reports[i]
        comp = [c for c in rep.scans if c.compiled]
        preds = sorted(((c.bytes_h2d, c.bytes_h2d_min, c.h2d_exact)
                        for c in comp), reverse=True)
        ici = sorted(((c.bytes_ici, c.ici_exact) for c in comp
                      if c.shards > 1), reverse=True)
        bands = sorted(((c.kernel_min, c.kernel_max) for c in comp),
                       reverse=True)
        if inject:
            preds = [(0, 0, True) for _ in preds]
            ici = [(0, True) for _ in ici]
            bands = [(0, 0) for _ in bands]
        problems = []
        if not inject and not rep.h2d_exact:
            problems.append("prediction not exact despite live wire widths")
        for sight in SIGHTS:
            got = runs[sight]
            if len(got["h2d"]) != len(preds):
                problems.append(f"{sight}: {len(got['h2d'])} compiled scans "
                                f"reported, {len(preds)} priced")
                continue
            for (pred, pmin, exact), g in zip(preds, got["h2d"]):
                if (exact and g != pred) or not (pmin <= g <= pred):
                    problems.append(f"{sight}: uploaded {g} bytes, static "
                                    f"{pred}" + ("" if exact else
                                                 f" (band from {pmin})"))
            if len(got["ici"]) != len(ici):
                problems.append(f"{sight}: {len(got['ici'])} sharded scans "
                                f"reported, {len(ici)} priced")
            for (pred, exact), g in zip(ici, got["ici"]):
                if (exact and g != pred) or g < pred:
                    problems.append(f"{sight}: collective bytes {g}, static "
                                    f"{pred}" + ("" if exact else
                                                 " (lower bound)"))
            if launches_counted:
                for (kmin, kmax), g in zip(bands, got["launches"]):
                    if not kmin <= g <= kmax:
                        problems.append(f"{sight}: {g} K4/K5 launches "
                                        f"outside the band [{kmin}, {kmax}]")
        for sight in ("warm", "eager-drive"):
            if runs[sight]["h2d"] != runs["cold"]["h2d"]:
                problems.append(f"{sight} uploaded {runs[sight]['h2d']}, "
                                f"cold {runs['cold']['h2d']}")
        warm = runs["warm"]
        rec["statements"] += 1
        rec["h2d"][0] += sum(warm["h2d"])
        rec["h2d"][1] += sum(p for p, _m, _e in preds)
        rec["ici"][0] += sum(warm["ici"])
        rec["ici"][1] += sum(p for p, _e in ici)
        rec["launches"] += sum(sum(runs[s]["launches"]) for s in SIGHTS)
        rec["band"][0] += len(SIGHTS) * sum(b[0] for b in bands)
        rec["band"][1] += len(SIGHTS) * sum(b[1] for b in bands)
        rec["walls"][f"ab{i}"] = {"static_ms": rep.roofline_ms,
                                  "bound": rep.bound, "ms": warm["ms"]}
        head = (f"[ab{i} {arm}] h2d {warm['h2d']} static "
                f"{[p for p, _m, _e in preds]}"
                + (f", ici {warm['ici']} static {[p for p, _e in ici]}"
                   if ici else "")
                + (f", launches {warm['launches']} band {bands}"
                   if launches_counted else "")
                + f"; static roofline {rep.roofline_ms:.6f} ms "
                f"({rep.bound}) against {warm['ms']:.3f} ms measured")
        if problems:
            ok = False
            lines.append(f"MISMATCH {head}")
            lines.extend(f"    {p}" for p in problems)
        else:
            lines.append(f"ok {head}")
    if launches_counted and not inject and rec["launches"] == 0:
        ok = False
        lines.append(f"MISMATCH [{arm}] no K4/K5 launch in the arm: the "
                     "band is vacuous")
    return ok, lines, rec


def collect(device="cuda", tables=None) -> list:
    """Every arm's predictions and evidence: ``[(name, reports, evidence,
    launches counted)]``."""
    from nds_tpu_torch.parallel.exchange import sharing_devices
    tables = tables or star_tables()
    out = []
    for name, conf, share, encoded, indices in ARMS:
        with _env(NDS_TPU_ENCODED=encoded), sharing_devices(share):
            session = star_session(tables, device, conf)
            reports = predict(session, indices)
            evidence = run_sweep(session, indices)
        out.append((name, reports, evidence,
                    session.device.type == "cuda"))
    return out


def check(collected, inject=False):
    """Every arm's checks: ``(ok, lines, records)``. With ``inject`` every
    prediction is zeroed first and ``ok`` must come out False."""
    ok, lines, records = True, [], []
    if not all(counted for *_x, counted in collected):
        lines.append("# launches not counted: on the CPU the K4/K5 "
                     "wrappers run their plain versions, so the launch "
                     "band is not checked here (it is on a CUDA device)")
    for name, reports, evidence, counted in collected:
        aok, alines, rec = compare(name, reports, evidence, counted,
                                   inject=inject)
        ok = ok and aok
        lines.append(f"# arm {name}: {rec['statements']} statements, h2d "
                     f"{rec['h2d'][0]} against {rec['h2d'][1]} static, "
                     f"collective {rec['ici'][0]} against {rec['ici'][1]}"
                     + (f", K4/K5 launches {rec['launches']} in "
                        f"[{rec['band'][0]}, {rec['band'][1]}]"
                        if counted else ""))
        lines.extend(alines)
        records.append(rec)
    return ok, lines, records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nds_tpu_torch.tools.perf_audit_diff",
        description="the static cost model's byte and launch predictions "
        "against the streamed pipeline's StreamEvent evidence")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="execution device (default cuda; refused when no "
                    "GPU is present)")
    ap.add_argument("--inject-drift", action="store_true",
                    help="zero every prediction: the harness must fail "
                    "(exit 0 iff it did)")
    args = ap.parse_args(argv)
    from nds_tpu_torch import resolve_device
    resolve_device(args.device)
    ok, lines, _records = check(collect(args.device),
                                inject=args.inject_drift)
    print("\n".join(lines))
    if args.inject_drift:
        if ok:
            print("# drift fixture NOT rejected: the harness cannot see a "
                  "drifted cost model")
            return 1
        print("# drift fixture correctly rejected (the harness is live)")
        return 0
    print("# perf-audit-diff: every measured byte count matches its static "
          "prediction" if ok else
          "# perf-audit-diff FAILED: the cost model and the engine "
          "disagree (analysis/perf_audit.py)")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
