# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure makes the exit code non-zero
and suppresses the final ``ok`` line):

1. device      the card's name and power limit (nvidia-smi);
2. build       the CUDA kernels of ``nds_tpu_torch/csrc`` (nvcc, sm_90a);
3. kernels     each grouped-aggregation kernel against its plain PyTorch
               version at n = 2,880,404 rows (SF1 store_sales) and
               G in {1, 1000, 100000}, with int64 extremes, NaN, signed
               zeros, empty groups, null (-1) and pad (>= G) group ids;
               the kernel's own time (raw launches on preallocated
               outputs), the wrapper's, the plain version's and the
               library call's, and the bytes bound;
4. data        builds ``native/ndsgen`` and writes SF1 (parallel children)
               and SF0.01 raw data under ``.smoke_data/``;
5. power       the 25 CI statements at SF1 through the port's Power Run
               entry on ``cuda``, plus one MIN/MAX-of-double statement;
               per-query ms, syncs and kernel launches;
6. agreement   the same statements at SF0.01 on ``cuda`` and on ``cpu``:
               exact kinds bit for bit, doubles within rel 1e-5.

It needs a CUDA device and the rest of the repository; without either it
exits non-zero and prints no result. Results that are too long for the
output go to ``chiprun_out/smoke/``.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import time

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
KERNEL_GROUPS = (1, 1000, 100000)
# a kernel's own time: raw launches on preallocated outputs, enough of them
# back to back that the host's launch cost hides behind the device's work
KERNEL_REPS = 100
KERNEL_META = {
    "segment_sum_i64": ("nds_tpu/engine/kernels.py:257 "
                        "(_segment_sum_exact_pallas)"),
    "segment_sum_f64": "nds_tpu/engine/kernels.py:108 (_segment_sum_pallas)",
    "segment_minmax_f64": ("nds_tpu/engine/kernels.py:371 "
                           "(_segment_minmax_pallas)"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def kernel_phase(torch, K):
    import numpy as np
    rng = np.random.default_rng(SEED)
    n = SF1_ROWS
    records = {name: [] for name in KERNEL_META}
    ok = True
    for G in KERNEL_GROUPS:
        gids, ivals, fvals, mvals = kernel_inputs(torch, n, G, rng)
        # library yardstick input: out-of-range rows routed to a discard
        # slot G, so one library call computes the same per-group values
        lib_gids = torch.where((gids >= 0) & (gids < G), gids,
                               torch.full_like(gids, G))
        bytes_moved = 16 * n + 16 * G       # values + gids in, 2 x G out
        bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3

        # K1: exact int64 sum + count
        s, c = K.segment_sum_i64(ivals, gids, G)
        ps, pc = K.segment_sum_i64_plain(ivals, gids, G)
        torch.cuda.synchronize()
        good = bits_equal(torch, s, ps) and bits_equal(torch, c, pc)
        err = 0.0 if good else float((s - ps).abs().max())
        records["segment_sum_i64"].append(dict(
            G=G, n=n, ok=good, max_abs_err=err, tol="bit-exact",
            ms=cuda_ms(torch, K.launcher("segment_sum_i64", ivals, gids,
                                         G), reps=KERNEL_REPS),
            wrapper_ms=cuda_ms(torch, lambda: K.segment_sum_i64(
                ivals, gids, G)),
            plain_ms=cuda_ms(torch, lambda: K.segment_sum_i64_plain(
                ivals, gids, G)),
            library_ms=cuda_ms(torch, lambda: torch.zeros(
                G + 1, dtype=torch.int64, device=gids.device).index_add_(
                    0, lib_gids, ivals)),
            library_call="index_add_ (int64 sums)",
            bound_ms=bound_ms, bound_by="bytes"))

        # K2: f64 sum + int64 count
        s, c = K.segment_sum_f64(fvals, gids, G)
        ps, pc = K.segment_sum_f64_plain(fvals, gids, G)
        torch.cuda.synchronize()
        rel = ((s - ps).abs() / ps.abs().clamp(min=1e-300)).max()
        err = float((s - ps).abs().max())
        good = bits_equal(torch, c, pc) and float(rel) <= 1e-9
        records["segment_sum_f64"].append(dict(
            G=G, n=n, ok=good, max_abs_err=err, max_rel_err=float(rel),
            tol="counts exact, sums rel 1e-9",
            ms=cuda_ms(torch, K.launcher("segment_sum_f64", fvals, gids,
                                         G), reps=KERNEL_REPS),
            wrapper_ms=cuda_ms(torch, lambda: K.segment_sum_f64(
                fvals, gids, G)),
            plain_ms=cuda_ms(torch, lambda: K.segment_sum_f64_plain(
                fvals, gids, G)),
            library_ms=cuda_ms(torch, lambda: torch.zeros(
                G + 1, dtype=torch.float64, device=gids.device).index_add_(
                    0, lib_gids, fvals)),
            library_call="index_add_ (float64 sums)",
            bound_ms=bound_ms, bound_by="bytes"))

        # K3: f64 min + max
        mn, mx = K.segment_minmax_f64(mvals, gids, G)
        pmn, pmx = K.segment_minmax_f64_plain(mvals, gids, G)
        torch.cuda.synchronize()
        good = bits_equal(torch, mn, pmn) and bits_equal(torch, mx, pmx)
        fin = torch.isfinite(mn) & torch.isfinite(pmn)
        err = 0.0 if good else float((mn - pmn)[fin].abs().max())
        records["segment_minmax_f64"].append(dict(
            G=G, n=n, ok=good, max_abs_err=err, tol="bit-exact",
            nan_groups=int(torch.isnan(mn).sum()),
            empty_groups=int(torch.isinf(mn).sum()),
            ms=cuda_ms(torch, K.launcher("segment_minmax_f64", mvals, gids,
                                         G), reps=KERNEL_REPS),
            wrapper_ms=cuda_ms(torch, lambda: K.segment_minmax_f64(
                mvals, gids, G)),
            plain_ms=cuda_ms(torch, lambda: K.segment_minmax_f64_plain(
                mvals, gids, G)),
            library_ms=cuda_ms(torch, lambda: torch.full(
                (G + 1,), float("inf"), dtype=torch.float64,
                device=gids.device).scatter_reduce_(
                    0, lib_gids, mvals, "amin", include_self=True)),
            library_call="scatter_reduce_ amin (float64 mins)",
            bound_ms=bound_ms, bound_by="bytes"))
        ok = ok and all(r[-1]["ok"] for r in records.values())
        del gids, ivals, fvals, mvals, lib_gids
    return ok, records


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def ndsgen_binary() -> str:
    src = os.path.join(REPO, "native", "ndsgen")
    subprocess.run(["make", "-C", src], check=True, capture_output=True)
    return os.path.join(src, "ndsgen")


def gen_data(binary, scale, out_dir, parallel):
    """Raw '|' data at ``scale`` in ``out_dir/<table>/`` directories, with
    ``parallel`` generator children running at once."""
    marker = os.path.join(out_dir, ".complete")
    if os.path.exists(marker):
        return out_dir
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
    return out_dir


def stream_file(scale) -> str:
    from nds_tpu_torch.queries import generate_query_streams
    d = os.path.join(DATA, f"stream_sf{scale}")
    generate_query_streams(d, streams=1, rngseed=SEED, scale=float(scale))
    return os.path.join(d, "query_0.sql")


# ---------------------------------------------------------------------------
# agreement
# ---------------------------------------------------------------------------


def tables_agree(a, b):
    """None when two arrow results agree (exact kinds bit for bit, doubles
    within rel 1e-5), else the first difference."""
    import pyarrow as pa
    if a.num_rows != b.num_rows or a.column_names != b.column_names:
        return f"shape {a.shape}/{b.shape}"
    for i in range(a.num_columns):
        ca, cb = a.column(i), b.column(i)
        if ca.type != cb.type:
            return f"col {i} type {ca.type}/{cb.type}"
        la, lb = ca.to_pylist(), cb.to_pylist()
        if pa.types.is_floating(ca.type):
            for r, (x, y) in enumerate(zip(la, lb)):
                if (x is None) != (y is None):
                    return f"col {i} row {r}: {x}/{y}"
                if x is None or (math.isnan(x) and math.isnan(y)):
                    continue
                if not math.isclose(x, y, rel_tol=1e-5, abs_tol=1e-12):
                    return f"col {i} row {r}: {x}/{y}"
        elif la != lb:
            r = next(r for r, (x, y) in enumerate(zip(la, lb)) if x != y)
            return f"col {i} row {r}: {la[r]!r}/{lb[r]!r}"
    return None


def load_session(Session, data_dir, device):
    from nds_tpu_torch.schema import get_schemas
    s = Session(device=device)
    for tname, fields in get_schemas(use_decimal=True).items():
        s.read_raw_view(tname, os.path.join(data_dir, tname), fields)
    return s


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main() -> int:
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
        gen_data(ndsgen, 1, os.path.join(DATA, "sf1"), max(cpus - 2, 1))))

    # 2. build
    t0 = time.time()
    try:
        K.build(verbose=True)
        emit({"phase": "build", "ok": True, "s": round(time.time() - t0, 3),
              "sources": ["nds_tpu_torch/csrc/segment_agg.cu"]})
    except Exception as e:
        emit({"phase": "build", "ok": False, "error": str(e)[-2000:]})
        return 1

    # 3. kernels vs plain versions
    records = {}
    try:
        ok, records = kernel_phase(torch, K)
        for name, recs in records.items():
            emit({"phase": "kernel", "name": name, "ok": all(
                r["ok"] for r in recs), "cases": recs})
        if not ok:
            failed.append("kernels")
    except Exception as e:
        emit({"phase": "kernel", "ok": False, "error": repr(e)[:2000]})
        failed.append("kernels")

    # 4. data
    t0 = time.time()
    try:
        data_f.result()
        emit({"phase": "data", "ok": True, "wait_s": round(time.time() - t0,
                                                           3)})
    except Exception as e:
        emit({"phase": "data", "ok": False, "error": repr(e)[:2000]})
        return 1

    # 5. Power Run at SF1 on cuda through the port's Power Run entry
    launches = {}
    try:
        sf1 = os.path.join(DATA, "sf1")
        queries = gen_sql_from_stream(stream_file(1))
        summ = os.path.join(OUT, "power_json")
        shutil.rmtree(summ, ignore_errors=True)
        K.reset_launches()
        t0 = time.time()
        session = run_query_stream(
            sf1, None, queries, os.path.join(OUT, "power_time.csv"),
            sub_queries=CI_QUERIES, input_format="raw",
            json_summary_folder=summ, allow_failure=True, device="cuda")
        mm = session.sql(MINMAX_SQL).collect()
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
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
        counts_ok = all(launches[k] > 0 for k in KERNEL_META)
        total_ms = sum(v["ms"] for v in per_q.values())
        emit({"phase": "power", "scale": 1, "device": "cuda",
              "ok": statuses_ok and mm_ok and counts_ok,
              "queries": per_q, "total_query_ms": total_ms,
              "wall_s_with_load": round(wall, 3),
              "minmax_rows": len(mm), "launches": launches})
        if not (statuses_ok and mm_ok and counts_ok):
            failed.append("power")
        del session
    except Exception as e:
        import traceback
        emit({"phase": "power", "ok": False,
              "error": traceback.format_exc()[-2000:]})
        failed.append("power")

    # 6. agreement at SF0.01: cuda vs cpu
    try:
        small = os.path.join(DATA, "sf0.01")
        queries = gen_sql_from_stream(stream_file("0.01"))
        sc = load_session(Session, small, "cuda")
        sh = load_session(Session, small, "cpu")
        diffs = {}
        for q in CI_QUERIES:
            sql = strip_stream_markers(queries[q])
            why = tables_agree(sc.sql(sql).to_arrow(), sh.sql(sql).to_arrow())
            if why:
                diffs[q] = why
        why = tables_agree(sc.sql(MINMAX_SQL).to_arrow(),
                           sh.sql(MINMAX_SQL).to_arrow())
        if why:
            diffs["minmax"] = why
        emit({"phase": "agreement", "scale": 0.01, "ok": not diffs,
              "statements": len(CI_QUERIES) + 1, "diffs": diffs})
        if diffs:
            failed.append("agreement")
    except Exception as e:
        import traceback
        emit({"phase": "agreement", "ok": False,
              "error": traceback.format_exc()[-2000:]})
        failed.append("agreement")

    # the kernels line: G = 1000 case, launches from the main-path run
    src = "nds_tpu_torch/csrc/segment_agg.cu"
    line = []
    for name, replaces in KERNEL_META.items():
        recs = records.get(name) or [{}]
        r = next((x for x in recs if x.get("G") == 1000), recs[0])
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches.get(name, 0),
                     "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
                     "wrapper_ms": r.get("wrapper_ms"),
                     "plain_ms": r.get("plain_ms"),
                     "bound_ms": r.get("bound_ms"),
                     "bound_by": r.get("bound_by", "bytes"),
                     "library_ms": r.get("library_ms"),
                     "n": r.get("n"), "G": r.get("G")})
    emit({"kernels": line})
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump({"smi": smi, "kernels": line, "records": records,
                   "failed": failed,
                   "seconds": round(time.time() - t_all, 3)}, f, indent=1)
    print(smi, flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
