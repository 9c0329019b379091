# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The port's static analysis gate on the CPU: ``analysis/torch_lint.py``
rule by rule (the reference lint cases of ``tests/test_analysis.py`` in
torch idiom: a rule that fires, one that must not, suppression, one level
down; and the two port-only rules), the port's tree clean against its
baseline, and ``python -m nds_tpu_torch.tools.lint`` (exit codes, ``--format
json`` with its ``absent`` list, ``--update-baseline`` round trip, a fixture
tree with one new finding for each rule). Also the H6 repair the lint
found: the ROLLUP path's AVG descales through ``prim.true_div``."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from nds_tpu_torch.analysis import (Finding, diff_against_baseline,
                                    load_baseline)
from nds_tpu_torch.analysis.torch_lint import lint_file, lint_tree
from nds_tpu_torch.tools import lint as LINT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lint_snippet(tmp_path, code, rel="nds_tpu_torch/engine/ops.py"):
    p = tmp_path / "snippet.py"
    p.write_text(textwrap.dedent(code))
    return lint_file(str(p), rel)


def rules(fs):
    return sorted(f.rule for f in fs)


# ------------------------------------------------------ host-sync-in-loop


def test_host_sync_in_loop(tmp_path):
    fs = lint_snippet(tmp_path, """
        import numpy as np
        import torch
        def drain(cols):
            out = []
            for c in cols:
                out.append(c.total.item())
                out.append(np.asarray(c.data))
                out.append(c.mask.cpu())
                out.append(int(c.data.sum()))
                torch.cuda.synchronize()
            return out
    """)
    assert rules(fs) == ["host-sync-in-loop"] * 5
    assert all(f.severity == "warning" for f in fs)


def test_host_sync_in_loop_scoping(tmp_path):
    # the same reads outside the hot-path modules, outside a loop, or a
    # host int() of a Python value, are no finding; a counted read is
    # one finding, not one per primitive inside its fetch
    fs = lint_snippet(tmp_path, """
        def drain(cols):
            return [c.total.item() for c in cols]
    """, rel="nds_tpu_torch/report.py")
    assert not fs
    fs = lint_snippet(tmp_path, """
        from nds_tpu_torch.engine import ops as E
        def fine(t, cols):
            n = t.total.item()
            for c in cols:
                k = int(len(c))
                v = E.host_read("tag", lambda: c.data.cpu().tolist())
            return n, k, v
    """)
    assert [f.message.split()[0] for f in fs] == ["host_read()"]


# --------------------------------------------------- capture-body rules


def test_tensor_if_and_time_in_capture(tmp_path):
    fs = lint_snippet(tmp_path, """
        import time
        import torch
        class P:
            def _capture(self, graph, st, x):
                graph.capture_begin(pool=None)
                try:
                    self._program(st, x)
                finally:
                    graph.capture_end()
            def _program(self, st, x):
                t0 = time.time()
                if self.flag:            # the object, not an operand: fine
                    x = x + 1
                if x > 0:                # an operand: a host read
                    return x
                return x - t0
    """, rel="nds_tpu_torch/engine/stream.py")
    assert rules(fs) == ["tensor-if-in-capture", "time-in-capture"]
    assert all(f.severity == "error" for f in fs)


def test_graph_context_and_nested_helper(tmp_path):
    # ``with torch.cuda.graph(...)`` makes a capture body too; a helper
    # nested in it closes over the body's operands, and a host read one
    # level down is a finding at the call site
    fs = lint_snippet(tmp_path, """
        import torch
        class Q:
            def _count(self, t):
                return t.total.item()
            def _capture(self, g):
                with torch.cuda.graph(g):
                    out = self._replay(self.arg)
                return out
            def _replay(self, x):
                def inner():
                    if x.any():
                        return x + 1
                    return x
                n = self._count(x)
                return inner()
    """, rel="nds_tpu_torch/engine/replay.py")
    assert rules(fs) == ["tensor-if-in-capture"] * 2
    assert "_count()" in fs[1].message and ".item()" in fs[1].message
    # a nested helper's own parameters shadow the body's operands
    fs = lint_snippet(tmp_path, """
        import torch
        class Q:
            def _capture(self, g):
                with torch.cuda.graph(g):
                    return self._replay(self.arg)
            def _replay(self, x):
                def clamp(x):
                    if x is None:
                        return 0
                    return x
                return clamp(3)
    """, rel="nds_tpu_torch/engine/replay.py")
    assert not fs, "\n".join(str(f) for f in fs)


def test_metadata_and_identity_tests_ok(tmp_path):
    fs = lint_snippet(tmp_path, """
        import torch
        def _program(x, valid):
            if valid is None:
                valid = torch.ones(x.shape[0], dtype=torch.bool)
            if x.dtype == torch.float64 and x.device.type == "cuda":
                x = x.float()
            if isinstance(x, tuple) or len(valid) > 3:
                pass
            return x, valid
        def capture(g, x):
            g.capture_begin()
            _program(x, None)
            g.capture_end()
    """, rel="nds_tpu_torch/engine/stream.py")
    assert not fs, "\n".join(str(f) for f in fs)


def test_span_in_capture(tmp_path):
    fs = lint_snippet(tmp_path, """
        from nds_tpu_torch.obs import trace as _obs
        from nds_tpu_torch.obs.trace import span
        def body(x):
            with _obs.span("drive"):
                y = x + 1
            with span("bare"):
                y = y * 2
            def helper():
                with _obs.span("nested"):
                    return y
            return helper()
        def capture(g, x):
            g.capture_begin()
            body(x)
            g.capture_end()
    """, rel="nds_tpu_torch/engine/stream.py")
    assert rules(fs) == ["span-in-capture"] * 3
    assert all(f.severity == "error" for f in fs)


def test_span_outside_capture_and_unrelated_spans_ok(tmp_path):
    fs = lint_snippet(tmp_path, """
        import re
        from nds_tpu_torch.obs import trace as _obs
        def body(x):
            m = re.match("a+", "aaa")
            a, b = m.span()
            def span(v):
                return v + a
            return span(x) + b
        def capture(g, x):
            g.capture_begin()
            body(x)
            g.capture_end()
        def drive(g):
            with _obs.span("drive", chunk=0):
                g.replay()
    """, rel="nds_tpu_torch/engine/stream.py")
    assert not fs, "\n".join(str(f) for f in fs)


def test_span_import_alias_flagged(tmp_path):
    fs = lint_snippet(tmp_path, """
        import nds_tpu_torch.obs.trace as tr
        from nds_tpu_torch.obs.trace import span as mark
        def body(x):
            with tr.span("a"):
                x = x + 1
            with mark("b"):
                x = x * 2
            return x
        def capture(g, x):
            g.capture_begin()
            body(x)
            g.capture_end()
    """, rel="nds_tpu_torch/engine/stream.py")
    assert rules(fs) == ["span-in-capture"] * 2


# ---------------------------------------------------------- shard bodies


def test_host_sync_in_shard_body(tmp_path):
    fs = lint_snippet(tmp_path, """
        from nds_tpu_torch.engine import ops as E
        from nds_tpu_torch.obs import trace as _obs

        def _helper(x):
            return E.count_int(x.nrows)

        def local(x, n):
            with _obs.span("inner"):
                pass
            E.host_read("tag", lambda: 1)
            n.to_int()
            _helper(x)
            return x

        def run(parts, devices):
            out = []
            for p, dev in zip(parts, devices):
                with E.device_scope(dev):
                    out.append(local(p, p.nrows))
                    k = p.total.item()
            return out
    """, rel="nds_tpu_torch/engine/sharded.py")
    assert rules(fs) == ["host-sync-in-shard-body"] * 5, fs
    assert all(f.severity == "error" for f in fs)
    # a clean body, and reads outside any device scope
    fs = lint_snippet(tmp_path, """
        from nds_tpu_torch.engine import ops as E
        def local(x):
            return x + 1
        def run(parts, devices):
            n = E.count_int(parts[0].nrows)
            out = []
            for p, dev in zip(parts, devices):
                with E.device_scope(dev):
                    out.append(local(p))
            return out, n
    """, rel="nds_tpu_torch/engine/sharded.py")
    assert not fs, "\n".join(str(f) for f in fs)


# ----------------------------------------------------- kernel wrappers


def test_host_read_in_kernel_wrapper(tmp_path):
    fs = lint_snippet(tmp_path, """
        LAUNCHES = {"k": 0}
        def k_plain(x):
            return x.sum().item()          # the CPU branch: no launch path
        def _k_args(x):
            n = int(x.sum())               # a host read on the launch path
            return (n,)
        def _sizes(x):
            return x.max().item()
        def k(x):
            if x.device.type == "cpu":
                return k_plain(x)
            args = _k_args(x)
            m = _sizes(x)
            LAUNCHES["k"] += 1
            return args, m
        def wrapper(x):
            return k(x)
    """, rel="nds_tpu_torch/engine/kernels.py")
    # _sizes is on the launch path itself (k calls it): its own read is
    # the finding, not the call
    assert rules(fs) == ["host-read-in-kernel-wrapper"] * 2
    assert {f.query for f in fs} == {"_k_args", "_sizes"}
    fs = lint_snippet(tmp_path, """
        LAUNCHES = {"k": 0}
        def _blob(x):
            return x.max().item()
        def _k_args(x):
            return (_blob(x),)
        def k(x):
            args = _k_args(x)
            LAUNCHES["k"] += 1
            return args
    """, rel="nds_tpu_torch/engine/kernels.py")
    assert rules(fs) == ["host-read-in-kernel-wrapper"]
    assert "_blob()" in fs[0].message and ".item()" in fs[0].message


# ------------------------------------------------------- prefetch worker


def test_host_sync_in_prefetch_worker(tmp_path):
    fs = lint_snippet(tmp_path, """
        from nds_tpu_torch.engine import prefetch as PF
        from nds_tpu_torch.obs import trace as _obs
        class S:
            def _ring(self, src, dev):
                def prepare(hc):
                    n = hc.live.item()
                    with _obs.span("upload"):
                        return hc
                return PF.chunk_ring(src, prepare=prepare)
            def fine(self, x):
                return x.item()
    """, rel="nds_tpu_torch/engine/stream.py")
    assert rules(fs) == ["host-sync-in-prefetch-worker"] * 2


# ---------------------------------------------------------- cache rules


def test_cache_through_parameter_alias(tmp_path):
    fs = lint_snippet(tmp_path, """
        _ALIAS_CACHE: dict = {}
        class P:
            def outer(self, cols):
                return self._run(_ALIAS_CACHE, cols)
            def _run(self, cache, cols):
                cache[(len(cols), [c.kind for c in cols])] = cols
                return cols
    """)
    assert rules(fs) == ["cache-key-list", "unbounded-cache"]
    assert all("_ALIAS_CACHE" in f.message for f in fs)
    fs = lint_snippet(tmp_path, """
        _ALIAS_CACHE: dict = {}
        def outer(cols):
            return _run(_ALIAS_CACHE, cols, 16)
        def _run(cache, cols, cap):
            if len(cache) >= cap:
                cache.pop(next(iter(cache)))
            cache[len(cols)] = cols
            return cache[len(cols)]
    """)
    assert not fs, "\n".join(str(f) for f in fs)


def test_cache_rules_and_setdefault(tmp_path):
    fs = lint_snippet(tmp_path, """
        _GROW_CACHE: dict = {}
        _BOUND_CACHE: dict = {}
        _MAX = 16
        def remember(key, cols, val):
            _GROW_CACHE[(key, [c.kind for c in cols])] = val
            if len(_BOUND_CACHE) >= _MAX:
                _BOUND_CACHE.pop(next(iter(_BOUND_CACHE)))
            _BOUND_CACHE[key] = val
    """)
    assert rules(fs) == ["cache-key-list", "unbounded-cache"]
    assert all("_GROW_CACHE" in f.message for f in fs)
    fs = lint_snippet(tmp_path, """
        _MISS_CACHE: dict = {}
        def remember(k, cols, v):
            return _MISS_CACHE.setdefault((k, [c.kind for c in cols]), v)
    """)
    assert rules(fs) == ["cache-key-list", "unbounded-cache"]
    fs = lint_snippet(tmp_path, """
        _MISS_CACHE: dict = {}
        def remember(k, v):
            if len(_MISS_CACHE) >= 16:
                _MISS_CACHE.popitem()
            return _MISS_CACHE.setdefault(k, v)
    """)
    assert not fs, "\n".join(str(f) for f in fs)


def test_cache_write_in_capture_or_chunk_loop(tmp_path):
    fs = lint_snippet(tmp_path, """
        _PLAN_CACHE: dict = {}
        def body(key, x):
            if len(_PLAN_CACHE) > 8:
                _PLAN_CACHE.clear()
            _PLAN_CACHE[key] = x
            return x
        def capture(g, x):
            g.capture_begin()
            body("k", x)
            g.capture_end()
        def loop(table, dev):
            for chunk in table.host_chunks():
                _PLAN_CACHE.setdefault(chunk.live, chunk)
    """, rel="nds_tpu_torch/engine/stream.py")
    assert rules(fs) == ["cache-write-in-capture"] * 2
    assert all(f.severity == "error" for f in fs)
    # a staging() check before the write guards it (prim.true_div's shape)
    fs = lint_snippet(tmp_path, """
        from nds_tpu_torch.engine.ops import staging
        _PLAN_CACHE: dict = {}
        def body(key, x):
            if staging():
                return x
            if len(_PLAN_CACHE) > 8:
                _PLAN_CACHE.clear()
            _PLAN_CACHE[key] = x
            return x
        def capture(g, x):
            g.capture_begin()
            body("k", x)
            g.capture_end()
    """, rel="nds_tpu_torch/engine/stream.py")
    assert not fs, "\n".join(str(f) for f in fs)


# ------------------------------------------------------- swallowed-fault


def test_swallowed_fault(tmp_path):
    fs = lint_snippet(tmp_path, """
        from nds_tpu_torch.engine import faults as _F
        def recover(fn):
            try:
                return fn()
            except _F.FaultInjected:
                return None
        def recover2(fn):
            try:
                return fn()
            except (OSError, _F.FaultError) as exc:
                log(exc)
        def recover3(fn):
            try:
                return fn()
            except FaultInjected:
                pass
    """, rel="nds_tpu_torch/engine/stream.py")
    assert rules(fs) == ["swallowed-fault"] * 3
    assert all(f.severity == "error" for f in fs)


def test_swallowed_fault_compliant_and_suppressed(tmp_path):
    fs = lint_snippet(tmp_path, """
        from nds_tpu_torch.engine import faults as _F
        def recover(fn):
            try:
                return fn()
            except _F.FaultInjected as exc:
                _F.record_fault_event(exc.seam, "degrade")
                return None
        def reraise(fn):
            try:
                return fn()
            except _F.StatementTimeout:
                raise
        def unrelated(fn):
            try:
                return fn()
            except ValueError:
                return None
        def quiet(fn):
            try:
                return fn()
            # nds-lint: ignore[swallowed-fault]
            except _F.FaultInjected:
                return None
    """, rel="nds_tpu_torch/engine/stream.py")
    assert not fs, "\n".join(str(f) for f in fs)
    assert not [f for f in lint_tree() if f.rule == "swallowed-fault"]


# --------------------------------------------------- chunk-loop-host-sync


def test_chunk_loop_host_sync(tmp_path):
    fs = lint_snippet(tmp_path, """
        import numpy as np
        from nds_tpu_torch.engine import ops as E
        def eager(table, dev):
            outs = []
            for chunk in table.device_chunks(dev):
                n = E.count_int(chunk.nrows)
                outs.append(np.asarray(chunk.data))
                m = chunk.nrows.to_int()
                k = chunk.total.item()
            for hc in table.host_chunks():
                E.resolve_counts()
            return outs
    """, rel="nds_tpu_torch/report.py")
    assert rules(fs) == ["chunk-loop-host-sync"] * 5
    assert all(f.severity == "warning" for f in fs)


def test_chunk_loop_scoping(tmp_path):
    fs = lint_snippet(tmp_path, """
        from nds_tpu_torch.engine import ops as E
        def _shape(chunk):
            return chunk.plen
        def fine(table, items, dev):
            n = E.count_int(table.nrows)
            for x in items:
                y = E.count_int(x.nrows)
            outs = []
            for chunk in table.device_chunks(dev):
                outs.append(_shape(chunk))
                outs.append(E.bucket_len(4))
            return outs
    """, rel="nds_tpu_torch/report.py")
    assert not fs, "\n".join(str(f) for f in fs)


def test_chunk_loop_helper_sync_and_class_scope(tmp_path):
    fs = lint_snippet(tmp_path, """
        from nds_tpu_torch.engine import ops as E
        def _resolve(chunk):
            return E.count_int(chunk.nrows)
        class P:
            def _peek(self, chunk):
                return chunk.total.item()
            def run(self, table, dev):
                outs = []
                for chunk in table.device_chunks(dev):
                    n = _resolve(chunk)
                    m = self._peek(chunk)
                return outs
    """, rel="nds_tpu_torch/report.py")
    assert rules(fs) == ["chunk-loop-host-sync"] * 2
    assert "_resolve" in fs[0].message and "count_int()" in fs[0].message
    assert "_peek" in fs[1].message and ".item()" in fs[1].message
    # self.method resolves only against the enclosing class
    fs = lint_snippet(tmp_path, """
        class A:
            def _peek(self):
                return self.total.item()
        class B:
            def _peek(self, chunk):
                return chunk.plen
            def run(self, table, dev):
                return [self._peek(c) for c in table.device_chunks(dev)]
    """, rel="nds_tpu_torch/report.py")
    assert not fs, "\n".join(str(f) for f in fs)


# ------------------------------------------------------- host-scalar-div


def test_host_scalar_div(tmp_path):
    fs = lint_snippet(tmp_path, """
        import torch
        def decode(col, s, d):
            a = col.data / 100.0
            b = col.data / (10.0 ** s)
            c = col.data / float(d)
            return a, b, c
    """, rel="nds_tpu_torch/sql/planner.py")
    assert rules(fs) == ["host-scalar-div"] * 3
    assert all(f.severity == "warning" and "true_div" in f.message
               for f in fs)
    # through prim.true_div, a tensor divisor, floor division, a constant
    # numerator, or outside engine/ and sql/: no finding
    fs = lint_snippet(tmp_path, """
        from nds_tpu_torch.engine import prim
        def decode(col, s, div):
            a = prim.true_div(col.data, 10.0 ** s)
            b = col.data / div
            c = col.data // 100
            d = 1 / 3
            return a, b, c, d
    """, rel="nds_tpu_torch/engine/column.py")
    assert not fs, "\n".join(str(f) for f in fs)
    assert not lint_snippet(tmp_path, "def f(ns):\n    return ns / 1e6\n",
                            rel="nds_tpu_torch/tools/report.py")


def test_rollup_avg_of_a_decimal_descales_through_true_div(monkeypatch):
    """The one H6 site the lint found: the ROLLUP path's AVG descale
    divided by the host float ``10.0 ** scale``; it goes through
    ``prim.true_div`` (on the card one IEEE division, its twin in
    tests/test_torch_gpu.py), with the CPU's doubles unchanged."""
    from decimal import Decimal

    import numpy as np
    import pyarrow as pa

    from nds_tpu_torch.engine import prim
    from nds_tpu_torch.engine.session import Session
    calls = []
    real = prim.true_div

    def spy(x, d):
        calls.append(d)
        return real(x, d)
    monkeypatch.setattr(prim, "true_div", spy)
    rng = np.random.default_rng(11)
    cents = rng.integers(1, 10 ** 6, 500)
    g = rng.integers(0, 3, 500)
    s = Session(device="cpu")
    s.create_temp_view("t", pa.table({
        "g": pa.array(g, pa.int64()),
        "p": pa.array([Decimal(int(c)) / 100 for c in cents],
                      pa.decimal128(7, 2))}))
    rows = s.sql("select g, avg(p) a from t group by rollup(g) "
                 "order by g").collect()
    assert 100.0 in calls
    want = {k: float(np.float64(cents[g == k].sum()) / 100.0 / (g == k).sum())
            for k in range(3)}
    want[None] = float(np.float64(cents.sum()) / 100.0 / len(cents))
    assert {k: a for k, a in rows} == pytest.approx(want, rel=0, abs=0)


def test_suppression_honored(tmp_path):
    fs = lint_snippet(tmp_path, """
        def drain(cols):
            out = []
            for c in cols:
                # nds-lint: ignore[host-sync-in-loop]
                out.append(c.total.item())
                v = c.n.item()  # nds-lint: ignore[host-sync-in-loop]
                w = c.m.item()  # nds-lint: ignore[span-in-capture]
            return out, v, w
    """)
    assert len(fs) == 1 and fs[0].rule == "host-sync-in-loop"


# --------------------------------------------------------- the gate


def test_tree_clean_against_its_baseline():
    """Every finding of the port's tree is accepted in the baseline, each
    with its reason, and every accepted key still occurs."""
    fs = lint_tree()
    baseline = load_baseline()
    assert diff_against_baseline(fs, baseline) == []
    assert {f.key() for f in fs} == set(baseline)
    with open(LINT.BASELINE_PATH) as f:
        doc = json.load(f)
    assert set(doc["why"]) == set(doc["keys"])
    assert all(k.startswith("nds_tpu_torch/") for k in doc["keys"])


def test_baseline_absorbs_counts():
    f = Finding("a.py", "f", "host-sync-in-loop", "warning", "m", 3)
    assert diff_against_baseline([f, f], {f.key(): 1}) == [f]
    assert diff_against_baseline([f], {f.key(): 2}) == []


def test_gate_cli_on_the_tree():
    """The real gate: exit 0 against the baseline, the findings JSON on
    stdout with every pass counted and the four absent passes listed,
    and ``--num-report`` refused."""
    res = subprocess.run(
        [sys.executable, "-m", "nds_tpu_torch.tools.lint", "--format",
         "json"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    doc = json.loads(res.stdout)
    assert doc["new"] == 0
    assert set(doc["pass_counts"]) == {"exec-audit", "mem-audit",
                                       "perf-audit", "param-audit",
                                       "torch-lint"}
    assert doc["absent"] == ["conc-audit", "driver-audit", "num-audit",
                             "plan-audit"]
    assert all(f["baselined"] for f in doc["findings"])
    assert "passes not ported yet" in res.stderr
    assert LINT.main(["--num-report"]) == 2


# one new finding for each rule of the mapping table and each port rule
_FIXTURE = {
    "engine/ops.py": """
        import numpy as np
        from nds_tpu_torch.engine import faults as _F
        _GROW_CACHE: dict = {}
        def drain(cols):
            for c in cols:
                c.total.item()
        def remember(cols, v):
            _GROW_CACHE[[c for c in cols][0]] = v
        def recover(fn):
            try:
                return fn()
            except _F.FaultInjected:
                return None
        def scale(col):
            return col.data / 100.0
        def eager(table, dev):
            for chunk in table.device_chunks(dev):
                chunk.total.item()
        def run(parts, devs):
            for p, d in zip(parts, devs):
                with device_scope(d):
                    p.total.item()
    """,
    "engine/stream.py": """
        import time
        from nds_tpu_torch.engine import prefetch as PF
        from nds_tpu_torch.obs import trace as _obs
        _PLAN_CACHE: dict = {}
        class P:
            def _program(self, x):
                t0 = time.time()
                with _obs.span("in"):
                    pass
                if len(_PLAN_CACHE) > 2:
                    _PLAN_CACHE.clear()
                _PLAN_CACHE[0] = x
                if x > 0:
                    return x
                return t0
            def _capture(self, g, x):
                g.capture_begin()
                self._program(x)
                g.capture_end()
            def _ring(self, src):
                def prepare(hc):
                    return hc.live.item()
                return PF.chunk_ring(src, prepare=prepare)
    """,
    "engine/kernels.py": """
        LAUNCHES = {"k": 0}
        def k(x):
            n = x.max().item()
            LAUNCHES["k"] += 1
            return n
    """,
}
_FIXTURE_RULES = {
    "host-sync-in-loop", "tensor-if-in-capture", "cache-key-list",
    "unbounded-cache", "time-in-capture", "span-in-capture",
    "host-sync-in-shard-body", "host-read-in-kernel-wrapper",
    "host-sync-in-prefetch-worker", "swallowed-fault",
    "chunk-loop-host-sync", "host-scalar-div", "cache-write-in-capture"}


def test_gate_cli_fails_a_fixture_tree_and_round_trips(tmp_path,
                                                      monkeypatch, capsys):
    """A fixture tree with one new finding for each rule makes the gate
    exit nonzero, with every rule named; ``--update-baseline`` accepts
    them and the gate then exits 0; ``--no-baseline`` fails again. The
    corpus passes are stubbed (they are held in
    tests/test_torch_perf_audit.py)."""
    for name in ("audit_exec_corpus", "audit_mem_corpus",
                 "audit_perf_corpus", "audit_param_corpus"):
        monkeypatch.setattr(LINT, name, lambda _d=None: [])
    root = tmp_path / "nds_tpu_torch"
    for rel, code in _FIXTURE.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(code))
    base = str(tmp_path / "baseline.json")
    args = ["--root", str(root), "--baseline", base]
    assert LINT.main(args + ["--format", "json"]) == 2
    doc = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in doc["findings"]} == _FIXTURE_RULES
    assert doc["new"] == len(doc["findings"]) >= len(_FIXTURE_RULES)
    assert not any(f["baselined"] for f in doc["findings"])
    assert LINT.main(args + ["--update-baseline"]) == 0
    capsys.readouterr()
    assert LINT.main(args) == 0
    assert "0 new" in capsys.readouterr().out
    assert LINT.main(args + ["--no-baseline"]) == 2
    assert "gate FAILED" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        LINT.main(["--root", str(root), "--update-baseline"])
