# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""``python -m nds_tpu_torch.validate`` against the root ``nds_validate.py``.

One CPU Power Run of the port at SF0.01 (query3, query65, query67, query78
and query96, ``--floats`` so that the monetary columns are doubles) writes
the outputs and JSON summaries; copies of them are then changed: a double
off by 1e-7 relative (passes) and by 1e-3 (fails), query78's rounded ratio
off by 0.01 (passes), a row dropped, rows reordered, a NaN on both sides,
and a summary whose status is ``Failed`` (its statement ``NotAttempted``).
Both validators run over the same folders under several flag sets
(``--floats``, ``--epsilon``, ``--max_errors``, ``--ignore_ordering``,
``--sub_queries``): their exit codes, unmatched lists and the
``queryValidationStatus`` of every summary must be equal. ``compare`` is
held against the reference's ``compare`` value by value.

The reference finds query78's ratio column by splitting the select list at
every ", ", which miscounts this repository's query78 (its
``coalesce(ws_qty, 0)`` holds one) and raises; the port splits at the
commas outside parentheses. The parity runs read a copy of the stream with
no space after a comma inside parentheses, on which both count alike."""

import functools
import glob
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
from decimal import Decimal

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from nds_tpu_torch import validate as V
from nds_tpu_torch.io.columnar import read_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERIES = ("query3", "query65", "query67", "query78", "query96")


@functools.lru_cache(maxsize=None)
def _reference_validate():
    spec = importlib.util.spec_from_file_location(
        "_ref_nds_validate", os.path.join(REPO, "nds_validate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rewrite(folder, query, fn):
    """Replace ``folder/query`` by ``fn(rows, column names)`` of its
    rows, keeping the schema."""
    path = os.path.join(folder, query)
    table = read_table(path)
    rows = fn(table.to_pylist(), table.column_names)
    shutil.rmtree(path)
    os.makedirs(path)
    pq.write_table(pa.Table.from_pylist(rows, schema=table.schema),
                   os.path.join(path, "part-0.parquet"))


def _tight_commas(sql):
    """``sql`` without the blanks after each comma inside parentheses."""
    out, depth, i = [], 0, 0
    while i < len(sql):
        ch = sql[i]
        depth += (ch == "(") - (ch == ")")
        out.append(ch)
        i += 1
        if ch == "," and depth > 0:
            while i < len(sql) and sql[i] in " \n":
                i += 1
    return "".join(out)


def _scale(col, factor):
    def fn(rows, _names):
        return [{**r, col: None if r[col] is None else r[col] * factor}
                for r in rows]
    return fn


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """``{name: (output folder, summary folder)}`` of the base run and its
    changed copies, and the stream file."""
    from tools.coverage_sweep import ensure_data

    from nds_tpu_torch.queries import generate_query_streams
    root = tmp_path_factory.mktemp("validate")
    generate_query_streams(str(root), streams=1, rngseed=19620718,
                           scale=0.01)
    stream = str(root / "query_0.sql")
    base_out, base_js = str(root / "base_out"), str(root / "base_js")
    res = subprocess.run(
        [sys.executable, "-m", "nds_tpu_torch.power", ensure_data(), stream,
         str(root / "t.csv"), "--input_format", "raw", "--device", "cpu",
         "--floats", "--output_prefix", base_out, "--json_summary_folder",
         base_js, "--sub_queries", ",".join(QUERIES)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    with open(stream) as f:
        tight = _tight_commas(f.read())
    stream = str(root / "query_0_tight.sql")
    with open(stream, "w") as f:
        f.write(tight)
    dirs = {}

    def copy(name):
        out = str(root / f"{name}_out")
        shutil.copytree(base_out, out)
        dirs[name] = out
        return out

    def nan_cell(rows, _names):
        rows = [dict(r) for r in rows]
        rows[0]["store_sales_price"] = float("nan")
        return rows

    # "a": the expected side, a NaN in a double of query78
    _rewrite(copy("a"), "query78", nan_cell)
    # "b1": the same NaN; query3 off by 1e-7, query78's ratio off by 0.01,
    # query67's rows reversed, query96's row dropped, query65 off by 1e-3
    b1 = copy("b1")
    _rewrite(b1, "query78", lambda rows, names: [
        {**r, "ratio": None if r["ratio"] is None else r["ratio"] + 0.01}
        for r in nan_cell(rows, names)])
    _rewrite(b1, "query3", _scale("sum_agg", 1 + 1e-7))
    _rewrite(b1, "query67", lambda rows, _n: rows[::-1])
    _rewrite(b1, "query96", lambda rows, _n: rows[:-1])
    _rewrite(b1, "query65", _scale(
        read_table(os.path.join(b1, "query65")).column_names[2], 1 + 1e-3))
    # "b2": the same NaN; query3 off by 1e-3, query78's rows reversed
    b2 = copy("b2")
    _rewrite(b2, "query78", lambda rows, names: nan_cell(rows, names)[::-1])
    _rewrite(b2, "query3", _scale("sum_agg", 1 + 1e-3))
    # a summary folder whose query3 did not complete
    failed_js = str(root / "failed_js")
    shutil.copytree(base_js, failed_js)
    [q3] = glob.glob(os.path.join(failed_js, "*query3-*.json"))
    with open(q3) as f:
        summary = json.load(f)
    summary["queryStatus"] = ["Failed"]
    with open(q3, "w") as f:
        json.dump(summary, f)
    return dirs, {"base": base_js, "failed": failed_js}, stream


ALL = ["--sub_queries", ",".join(QUERIES)]
# (expected side, actual side, summaries, flags)
RUNS = {
    "default": ("a", "b1", "base", ALL),
    "floats_sorted": ("a", "b1", "base",
                      ALL + ["--floats", "--ignore_ordering",
                             "--max_errors", "1"]),
    "epsilon_subset": ("a", "b2", "base",
                       ["--epsilon", "0.01", "--ignore_ordering",
                        "--sub_queries", "query3,query78"]),
    "far": ("a", "b2", "base", ALL),
    "not_attempted": ("a", "b2", "failed", ALL + ["--use_iterator"]),
}


def _unmatched(stdout):
    m = re.search(r"=== Unmatch Queries: (\[.*\]) ===", stdout)
    return None if m is None else m.group(1)


@pytest.fixture(scope="module")
def verdicts(outputs, tmp_path_factory):
    """``{run: {impl: (exit code, unmatched list, statuses)}}``: both
    validators over the same folders, all runs started at once."""
    dirs, summaries, stream = outputs
    root = tmp_path_factory.mktemp("verdicts")
    procs = {}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for run, (a, b, js, flags) in RUNS.items():
        for impl, cmd in (("port", ["-m", "nds_tpu_torch.validate"]),
                          ("reference", ["nds_validate.py"])):
            folder = str(root / f"{run}_{impl}")
            shutil.copytree(summaries[js], folder)
            procs[run, impl] = (folder, subprocess.Popen(
                [sys.executable, *cmd, dirs[a], dirs[b], stream,
                 "--json_summary_folder", folder, *flags],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
    got = {}
    for (run, impl), (folder, p) in procs.items():
        out, err = p.communicate(timeout=240)
        statuses = {}
        for fn in glob.glob(os.path.join(folder, "*.json")):
            with open(fn) as f:
                js = json.load(f)
            statuses[js["query"]] = js.get("queryValidationStatus")
        got.setdefault(run, {})[impl] = (p.returncode, _unmatched(out),
                                         statuses, err[-2000:])
    return got


# what each run must give (the port's own expectation, beside parity)
EXPECTED = {
    "default": (1, "['query67', 'query96']",
                {"query3": "Pass", "query65": "Pass", "query67": "Fail",
                 "query78": "Pass", "query96": "Fail"}),
    "floats_sorted": (1, "['query96']",
                      {"query3": "Pass", "query65": "Pass",
                       "query67": "Pass", "query78": "Pass",
                       "query96": "Fail"}),
    "epsilon_subset": (0, None, {"query3": "Pass", "query78": "Pass"}),
    "far": (1, "['query3', 'query78']",
            {"query3": "Fail", "query65": "Pass", "query67": "Pass",
             "query78": "Fail", "query96": "Pass"}),
    "not_attempted": (1, "['query3', 'query78']",
                      {"query3": "NotAttempted", "query65": "Pass",
                       "query67": "Pass", "query78": "Fail",
                       "query96": "Pass"}),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_port_and_reference_agree(verdicts, run):
    port, ref = verdicts[run]["port"], verdicts[run]["reference"]
    assert port[:3] == ref[:3], (port, ref)
    rc, unmatched, statuses = EXPECTED[run]
    assert port[0] == rc, port[3]
    assert port[1] == unmatched
    # a --sub_queries run writes only its statements' summaries
    assert {q: s[0] for q, s in port[2].items() if s} == statuses


def test_unmatched_statement_without_output(outputs, tmp_path, capsys):
    dirs, _summaries, stream = outputs
    partial = str(tmp_path / "partial")
    shutil.copytree(dirs["a"], partial)
    shutil.rmtree(os.path.join(partial, "query96"))
    rc = V.main([dirs["a"], partial, stream,
                 "--sub_queries", "query3,query96"])
    assert rc == 1
    assert "Missing output for query96" in capsys.readouterr().out


def test_q78_ratio_column_found_in_the_stream(outputs):
    ref = _reference_validate()
    from nds_tpu_torch.power import gen_sql_from_stream
    _dirs, _summaries, tight = outputs
    root = os.path.dirname(tight)
    sql = gen_sql_from_stream(os.path.join(root, "query_0.sql"))["query78"]
    assert V.check_nth_col_problematic_q78(sql) == 4
    with pytest.raises(Exception, match="should be 2nd or 4th"):
        ref.rowEqual((), (), 1e-5, True,
                     ref.check_nth_col_problematic_q78(sql))
    sql = gen_sql_from_stream(tight)["query78"]
    assert V.check_nth_col_problematic_q78(sql) == \
        ref.check_nth_col_problematic_q78(sql) == 4


_NAN = float("nan")
COMPARE_CASES = [
    (1.0, 1.0), (1.0, 1.0 + 1e-7), (1.0, 1.0 + 1e-3), (1.0, 1.0001),
    (0.0, 0.0), (0.0, 1e-300), (-0.0, 0.0), (_NAN, _NAN), (_NAN, 1.0),
    (1.0, _NAN), (math.inf, math.inf), (math.inf, -math.inf),
    ("a", "a"), ("a", "b"), ("", None), (None, None), (None, 0),
    (0, None), (1, 1), (1, 2), (2**62, 2**62 + 1),
    (Decimal("1.00"), Decimal("1.00")),
    (Decimal("1.00000"), Decimal("1.00001")),
    (Decimal("1.00"), Decimal("1.01")), (Decimal("1.5"), 1.5),
    (1.5, Decimal("1.5000001")), (Decimal("2"), 2), (2, 2.0),
    (2, 2.00001), (2.0, 3), (Decimal("NaN"), _NAN), (True, 1),
    ("1", 1), (1.0, "1.0"),
]


@pytest.mark.parametrize("epsilon", [0.00001, 0.01])
@pytest.mark.parametrize("pair", COMPARE_CASES, ids=repr)
def test_compare_matches_the_reference(pair, epsilon):
    ref = _reference_validate()
    a, b = pair
    assert V.compare(a, b, epsilon) == ref.compare(a, b, epsilon)


@pytest.mark.parametrize("rows", [
    ((1, 0.06, 2.0), (1, 0.07, 2.0)), ((1, 0.06, 2.0), (1, 0.08, 2.0)),
    ((1, None, 2.0), (1, None, 2.0)), ((1, None, 2.0), (1, 0.06, 2.0)),
    ((1, 0.06, 2.0), (1, 0.06, 2.1)),
])
def test_row_equal_q78_matches_the_reference(rows):
    ref = _reference_validate()
    a, b = rows
    assert V.rowEqual(a, b, 1e-5, True, 2) == ref.rowEqual(a, b, 1e-5,
                                                            True, 2)
    assert V.rowEqual(a, b, 1e-5, False, 2) == ref.rowEqual(a, b, 1e-5,
                                                             False, 2)
