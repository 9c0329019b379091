# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Parameterization differential harness: one pipeline build, many
parameter vectors, bit for bit — the static bindability proof
(``analysis/param_audit.py``) held against the engine.

* Bindable templates run over K=4 parameter vectors (the stream
  generator's ``uniform(0,100)`` quantity range with its edges; a
  decimal(7,2) price pair one cent under its extreme) in one warm session:
  exactly one pipeline build per template and arm (one new cache key, one
  miss, K-1 hits) and, on the card, exactly one graph capture; the rows
  equal a fresh recording of each vector (``NDS_TPU_PARAM_BIND=0``, the
  pipeline cache cleared before every vector) and the resident
  plain-width eager run (``NDS_TPU_ENCODED=0``, nothing streamed).
* The fold-required template (IN-list members, which the in-list
  evaluation and the K4 lowering read on the host) takes K distinct keys.
* :class:`ParamAuditor` over the same statements agrees with the runtime
  (bindable templates' slot counts, an empty signature for the fold one).
* The sweep repeats under the ``partitioned`` arm (``stream_partitions``
  2) and the ``sharded`` arm (``stream_shards`` 2, the shards sharing the
  one device inside ``parallel.exchange.sharing_devices()``).

``--inject-drift`` (``NDS_TPU_PARAM_DRIFT=1``) is the must-fail self-test:
the shared rule treats IN-list members as bindable, and the harness must
reject both directions — A, wrong rows (the skeleton collapses the K
in-list vectors onto one pipeline whose K4 entries hold the first
vector's members, never rewritten); B, key variance (the fold slots stop
changing the key). It exits 0 only when both are rejected.

Run: ``python -m nds_tpu_torch.tools.param_audit_diff [--device cpu]
[--inject-drift]``. The device defaults to cuda and the harness refuses
to run without a GPU unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import os

N_FACT = 8192                 # 4 chunks at 2048
CHUNK_ROWS = 2048
N_ITEMS = 100
HOT_ITEM = 7                  # hot key: in-list vectors holding it count
#                               very differently


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


def toy_tables(rng):
    """A small fact and one dimension under real catalog names (so the
    static auditor classifies them with the production streamed set);
    the same draws, in the same order, as the reference's harness."""
    from decimal import Decimal

    import numpy as np
    import pyarrow as pa

    n = N_FACT
    item_sk = rng.integers(1, N_ITEMS + 1, n)
    item_sk[: n // 4] = HOT_ITEM         # hot key, then shuffled
    rng.shuffle(item_sk)
    cents = rng.integers(0, 10 ** 6, n)
    cents[0] = 10 ** 7 - 1               # the dec(7,2) extreme kept live
    store_sales = pa.table({
        "ss_item_sk": pa.array(item_sk, pa.int64()),
        "ss_quantity": pa.array(rng.integers(0, 101, n), pa.int64()),
        "ss_ext_sales_price": pa.array(
            [Decimal(int(c)) / 100 for c in cents], pa.decimal128(7, 2)),
    })
    item = pa.table({
        "i_item_sk": pa.array(np.arange(1, N_ITEMS + 1), pa.int64()),
        "i_brand_id": pa.array(1 + np.arange(N_ITEMS) % 7, pa.int64()),
    })
    return {"store_sales": store_sales, "item": item}


# K=4 vectors per template, as SQL fragments so a decimal's scale is pinned
# (its typetag "dec:2" is part of the slot signature: "100.0" and "100.00"
# are different skeletons)
TEMPLATES = (
    {"name": "scan-i64", "bindable": True, "slots": 1,
     "sql": lambda v: ("select count(*) c, sum(ss_quantity) q "
                       f"from store_sales where ss_quantity > {v[0]}"),
     "vectors": (("0",), ("37",), ("80",), ("100",))},
    {"name": "join-dec-between", "bindable": True, "slots": 2,
     "sql": lambda v: (
         "select i_brand_id, count(*) c, sum(ss_ext_sales_price) s "
         "from store_sales, item where ss_item_sk = i_item_sk "
         f"and ss_ext_sales_price between {v[0]} and {v[1]} "
         "group by i_brand_id order by i_brand_id"),
     "vectors": (("0.01", "9999.99"), ("100.00", "5000.00"),
                 ("2500.50", "7500.50"), ("99999.97", "99999.98"))},
    {"name": "fold-inlist", "bindable": False, "slots": 0,
     "sql": lambda v: ("select count(*) c from store_sales "
                       f"where ss_item_sk in ({v[0]}, {v[1]})"),
     "vectors": ((str(HOT_ITEM), "9"), ("5", "11"), ("2", "88"),
                 ("40", "41"))},
)

# (name, session settings, shards share the device)
ARMS = (
    ("base", {}, False),
    ("partitioned", {"stream_partitions": 2}, False),
    ("sharded", {"stream_shards": 2}, True),
)


def make_session(tables, device, chunked, conf=None):
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.engine.table import ChunkedTable
    s = Session(conf=dict(conf or {}), device=device)
    for name, tbl in tables.items():
        if chunked and name == "store_sales":
            s.create_temp_view(name, ChunkedTable(tbl, chunk_rows=CHUNK_ROWS),
                               base=True, arrow=tbl)
        else:
            s.create_temp_view(name, tbl, base=True)
    return s


def reference(tables, device):
    """Plain-width eager reference: resident tables, encoding off."""
    with _env(NDS_TPU_ENCODED="0", NDS_TPU_PARAM_BIND="0"):
        s = make_session(tables, device, chunked=False)
        return {t["name"]: [s.sql(t["sql"](v)).collect()
                            for v in t["vectors"]]
                for t in TEMPLATES}


def fresh_recording(tables, device):
    """Per-value fresh recording: binding off and the pipeline cache
    cleared before every vector, so each vector builds its own pipeline
    (every literal baked)."""
    from nds_tpu_torch.engine import stream as S
    out = {}
    with _env(NDS_TPU_PARAM_BIND="0"):
        s = make_session(tables, device, chunked=True)
        for t in TEMPLATES:
            rows = []
            for v in t["vectors"]:
                S._PIPELINE_CACHE.clear()
                rows.append(s.sql(t["sql"](v)).collect())
            out[t["name"]] = rows
    return out


def run_bind_arm(name, conf, share, tables, device):
    """One bind-mode arm: per template, every vector against one warm
    session; its rows, stream-event paths and graphs, the new cache keys,
    the misses and hits."""
    from nds_tpu_torch.engine import stream as S
    from nds_tpu_torch.listener import drain_stream_events
    from nds_tpu_torch.obs import metrics as M
    from nds_tpu_torch.parallel.exchange import sharing_devices
    out = {"name": name, "templates": {}}
    with sharing_devices(share):
        s = make_session(tables, device, chunked=True, conf=conf)
    for t in TEMPLATES:
        S._PIPELINE_CACHE.clear()
        reg = M.default()
        h0, m0 = reg.counter(M.PIPE_HIT), reg.counter(M.PIPE_MISS)
        drain_stream_events()
        rows, events, keys = [], [], set()
        with sharing_devices(share):
            for v in t["vectors"]:
                rows.append(s.sql(t["sql"](v)).collect())
                events.extend(drain_stream_events())
                keys |= set(S._PIPELINE_CACHE)
        out["templates"][t["name"]] = {
            "rows": rows, "paths": [e.path for e in events],
            "graphs": [e.graph for e in events],
            "shards": [e.shards for e in events],
            "n_keys": len(keys),
            "hits": reg.counter(M.PIPE_HIT) - h0,
            "misses": reg.counter(M.PIPE_MISS) - m0,
        }
    return out


def static_reports():
    """The ParamAuditor half: one report per template statement."""
    from nds_tpu_torch.analysis.param_audit import ParamAuditor
    auditor = ParamAuditor()
    return {t["name"]: auditor.audit_sql(t["sql"](t["vectors"][0]),
                                         file="param_audit_diff",
                                         query=t["name"])
            for t in TEMPLATES}


def compare(expect, fresh, arm, reports, device, lines=None, drift=False):
    """Every assertion for one bind arm: ``(ok, lines)``."""
    ok = True
    lines = [] if lines is None else lines
    K = len(TEMPLATES[0]["vectors"])
    for t in TEMPLATES:
        got = arm["templates"][t["name"]]
        tag = f"{t['name']} [{arm['name']}]"
        if any(p != "compiled" for p in got["paths"]) or \
                len(got["paths"]) < K:
            ok = False
            lines.append(f"MISMATCH: {tag} not every vector took the "
                         f"compiled stream path: {got['paths']}")
            continue
        if arm["name"] == "sharded" and any(n != 2 for n in got["shards"]):
            ok = False
            lines.append(f"MISMATCH: {tag} ran on shards {got['shards']}")
        for i, v in enumerate(t["vectors"]):
            if got["rows"][i] != fresh[t["name"]][i] or \
                    got["rows"][i] != expect[t["name"]][i]:
                ok = False
                lines.append(f"MISMATCH: {tag} vector {v} diverges "
                             "from per-value fresh recording")
            else:
                lines.append(f"ok: {tag} vector {v} bit-identical "
                             "to fresh recording + eager reference")
        rep = reports[t["name"]]
        if t["bindable"]:
            if got["n_keys"] != 1 or got["misses"] != 1 or \
                    got["hits"] != K - 1:
                ok = False
                lines.append(f"MISMATCH: {tag} expected ONE pipeline "
                             f"build for {K} vectors, got "
                             f"{got['n_keys']} keys / {got['misses']} "
                             f"miss / {got['hits']} hit")
            else:
                lines.append(f"ok: {tag} ONE pipeline build served {K} "
                             "parameter vectors")
            if device == "cuda":
                caps = sum(1 for g in got["graphs"] if g == "captured")
                if caps != 1:
                    ok = False
                    lines.append(f"MISMATCH: {tag} {caps} graph captures "
                                 f"for {K} vectors: {got['graphs']}")
                else:
                    lines.append(f"ok: {tag} ONE graph capture")
            if rep.n_bindable != t["slots"]:
                ok = False
                lines.append(f"MISMATCH: {tag} static signature has "
                             f"{rep.n_bindable} slots, runtime bound "
                             f"{t['slots']}")
            else:
                lines.append(f"ok: {tag} static signature "
                             f"[{rep.signature()}] matches the "
                             f"{t['slots']} runtime slots")
        else:
            if got["n_keys"] != K:
                ok = False
                lines.append(f"MISMATCH: {tag} fold-required template "
                             f"expected {K} distinct cache keys, got "
                             f"{got['n_keys']} (a fold slot stopped "
                             "changing the key)")
            else:
                lines.append(f"ok: {tag} fold-required slots changed "
                             f"the key ({K} shapes for {K} vectors)")
            if not drift and rep.n_bindable != 0:
                ok = False
                lines.append(f"MISMATCH: {tag} static signature claims "
                             f"{rep.n_bindable} bindable slots on a "
                             "fold-required template")
    return ok, lines


def statement_vectors(name: str, k: int = 4, seeds=range(1, 33)):
    """``(sql, slots, texts)``: template ``name`` instantiated at the
    audit seed, its bindable slots (:class:`ParamSlot`, with spans) and
    ``k`` texts that differ from it only in those slots (``texts[0]`` is
    ``sql``). A slot the generator substitutes takes the values other
    seeds' instantiations give it (the generator's own range); a template
    constant takes the edges of its safe domain that SQL text can write
    (vector 1: a low bound or a compare at the low edge, a high bound at
    the high edge; vector 3 the other way round), or its value plus one
    (vector 2). A negative number parses as a negation, which is no
    comparand, so the low edge is 0. Edge values are offset by the slot's
    index, so OR branches that differed stay different (equal branches
    would factor into another skeleton)."""
    from decimal import Decimal

    import numpy as np

    from nds_tpu_torch.analysis.param_audit import (_AUDIT_SEED,
                                                    ParamAuditor,
                                                    safe_domain,
                                                    substitute_slots)
    from nds_tpu_torch.queries import instantiate_template, load_template
    auditor = ParamAuditor()
    text = load_template(f"{name}.tpl")

    def inst(seed):
        sql = instantiate_template(text, np.random.default_rng(seed))
        return sql, auditor.audit_sql(sql, query=name).slots
    sql, slots = inst(_AUDIT_SEED)
    tags = [s.typetag for s in slots]
    others = []
    for seed in seeds:
        got = inst(seed)[1]
        if [s.typetag for s in got] == tags:
            others.append([s.value for s in got])
    base = [s.value for s in slots]
    varied = [any(o[i] != base[i] for o in others)
              for i in range(len(slots))]

    def edge(i, s, high):
        hi = safe_domain(s.typetag)[1]
        v = (1e300 if hi is None else hi) - i if high else i
        return Decimal(v) if s.typetag.startswith("dec") else v

    texts = [sql]
    for j in range(1, k):
        vals = []
        for i, s in enumerate(slots):
            if varied[i]:
                pick = [o[i] for o in others if o[i] != base[i]]
                vals.append(pick[(j - 1) % len(pick)])
            elif j == 2:
                vals.append(base[i] + 1)
            else:
                high = s.path[-1] == "high"
                vals.append(edge(i, s, high if j == 1 else not high))
        texts.append(substitute_slots(sql, slots, vals))
    return sql, slots, texts


def run_diff(device="cuda", inject_drift=False, tables=None):
    """The whole harness. Normal mode: ``(ok, lines)``. Inject mode: the
    shared rule drifts, and ``ok`` means both directions were rejected."""
    import numpy as np
    tables = tables or toy_tables(np.random.default_rng(20260117))
    expect = reference(tables, device)
    fresh = fresh_recording(tables, device)
    if not inject_drift:
        reports = static_reports()
        ok, lines = True, []
        for name, conf, share in ARMS:
            arm = run_bind_arm(name, conf, share, tables, device)
            aok, lines = compare(expect, fresh, arm, reports, device, lines)
            ok = ok and aok
        return ok, lines
    with _env(NDS_TPU_PARAM_DRIFT="1"):
        drift_arm = run_bind_arm("base+drift", {}, False, tables, device)
        drift_reports = static_reports()
    _ok, lines_d = compare(expect, fresh, drift_arm, drift_reports, device,
                           drift=True)
    fold = drift_arm["templates"]["fold-inlist"]
    # A: the drifted slot binds and the key collapses, but the in-list is
    # never rewritten, so a hit serves the first vector's members
    rejected_a = any("diverges" in ln and "fold-inlist" in ln
                     for ln in lines_d)
    # B: the fold-required K-distinct-keys assertion fires
    rejected_b = fold["n_keys"] != len(TEMPLATES[0]["vectors"]) and \
        any("stopped changing the key" in ln for ln in lines_d)
    lines = [
        "inject-drift A (bound fold slot serves baked in-list values): "
        + ("correctly rejected" if rejected_a else "NOT DETECTED"),
        "inject-drift B (fold slot stopped changing the cache key): "
        + ("correctly rejected" if rejected_b else "NOT DETECTED"),
    ]
    return rejected_a and rejected_b, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="execution device (default cuda; refused when no "
                         "GPU is present)")
    ap.add_argument("--inject-drift", action="store_true",
                    help="self-test: misclassify IN-list members as "
                         "bindable (NDS_TPU_PARAM_DRIFT=1); the harness "
                         "must reject both the wrong-rows and the "
                         "key-variance direction")
    args = ap.parse_args(argv)
    from nds_tpu_torch import resolve_device
    resolve_device(args.device)
    ok, lines = run_diff(args.device, inject_drift=args.inject_drift)
    print("\n".join(lines))
    if args.inject_drift:
        print("inject-drift: both directions rejected" if ok
              else "inject-drift: a drifted binding survived")
        return 0 if ok else 1
    print("param-audit-diff: one build served every parameter vector "
          "bit-for-bit" if ok else "param-audit-diff: DRIFT")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
