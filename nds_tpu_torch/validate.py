# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Validation: row-level parity check between two Power Run outputs.

    python -m nds_tpu_torch.validate input1 input2 query_stream_file
        [--input1_format F] [--input2_format F] [--max_errors N]
        [--epsilon E] [--ignore_ordering] [--use_iterator] [--floats]
        [--json_summary_folder DIR] [--sub_queries q1,q2,...]

The inputs are the ``--output_prefix`` folders of two runs of
``python -m nds_tpu_torch.power`` (for example one on ``cuda``, one on
``cpu``). For each statement of the stream it loads both outputs, compares
row counts, optionally sorts (non-float columns first, float columns
last), then compares row by row: NaN equals NaN, None equals None, floats
and Decimals within ``rel_tol=epsilon`` (mixed Decimal/float in float
space), everything else exactly; query78's rounded ratio column (found in
the statement's text) within 0.01; query65 is never compared and query67
not under ``--floats``. With ``--json_summary_folder`` it writes ``queryValidationStatus`` (Pass, Fail
or NotAttempted) into each statement's JSON summary. It exits 1 when any
statement is unmatched (ref: nds/nds_validate.py). Nothing here touches a
device: it compares files.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import sys
from decimal import Decimal

from nds_tpu_torch.check import check_version


def _load_rows(path: str, fmt: str, ignore_ordering: bool) -> list:
    """A query output folder as a list of row tuples, sorted by its
    non-float columns, then its float ones, when ``ignore_ordering``."""
    import pyarrow as pa
    import pyarrow.compute as pc

    from nds_tpu_torch.io.columnar import read_table
    table = read_table(path, fmt)
    if ignore_ordering and table.num_rows:
        floats = (pa.float32(), pa.float64())
        keys = [f.name for f in table.schema if f.type not in floats] + \
            [f.name for f in table.schema if f.type in floats]
        table = table.take(pc.sort_indices(
            table, sort_keys=[(k, "ascending") for k in keys]))
    cols = [table.column(i).to_pylist() for i in range(table.num_columns)]
    return list(zip(*cols)) if cols else []


def compare(expected, actual, epsilon: float = 0.00001) -> bool:
    """One value against another (ref: nds/nds_validate.py:194-215)."""
    if isinstance(expected, float) and isinstance(actual, float):
        if math.isnan(expected) and math.isnan(actual):
            return True
        return math.isclose(expected, actual, rel_tol=epsilon)
    if isinstance(expected, str) and isinstance(actual, str):
        return expected == actual
    if expected is None and actual is None:
        return True
    if (expected is None) != (actual is None):
        return False
    if isinstance(expected, Decimal) and isinstance(actual, Decimal):
        return math.isclose(expected, actual, rel_tol=epsilon)
    # a Decimal run against a --floats run: compared in float space; two
    # ints stay exact through the == below
    numeric = (Decimal, float)
    if isinstance(expected, numeric) and \
            isinstance(actual, (int, *numeric)) or \
            isinstance(actual, numeric) and \
            isinstance(expected, (int, *numeric)):
        e, a = float(expected), float(actual)
        if math.isnan(e) and math.isnan(a):
            return True
        return math.isclose(e, a, rel_tol=epsilon)
    return expected == actual


def rowEqual(row1, row2, epsilon, is_q78, q78_problematic_col) -> bool:
    """One row against another, query78's rounded ratio column within
    0.01 (ref: nds/nds_validate.py:166-192)."""
    if is_q78:
        if q78_problematic_col not in (2, 4):
            raise Exception("q78 problematic column should be 2nd or 4th, "
                            f"but get {q78_problematic_col}")
        row1, row2 = list(row1), list(row2)
        v1 = row1.pop(q78_problematic_col - 1)
        v2 = row2.pop(q78_problematic_col - 1)
        if v1 is not None and v2 is not None:
            # the ratio is round(x, 2): a difference of one unit passes
            eq = abs(float(v1) - float(v2)) <= 0.01001
        else:
            eq = v1 is None and v2 is None
        return eq and all(compare(a, b, epsilon) for a, b in zip(row1, row2))
    return all(compare(a, b, epsilon) for a, b in zip(row1, row2))


def _top_level_items(select_list: str) -> list:
    """The items of a select list: split at the commas outside
    parentheses."""
    items, depth, start = [], 0, 0
    for i, ch in enumerate(select_list):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(select_list[start:i])
            start = i + 1
    return items + [select_list[start:]]


def check_nth_col_problematic_q78(q78_content: str) -> int:
    """The 1-based index of the rounded ratio column in query78's text
    (ref: nds/nds_validate.py:146-164). The reference splits the select
    list at every ", " and so miscounts this repository's query78, whose
    ``coalesce(ws_qty, 0)`` holds one; the items here are split at the
    commas outside parentheses, which gives the reference's index
    wherever the reference gets it right."""
    last_between = q78_content.split("select")[-1].split("from")[0]
    nth = -1
    for index, string in enumerate(_top_level_items(last_between)):
        if "ratio" in string:
            nth = index
    if nth == -1:
        raise Exception("Cannot find the problematic column in the query78 "
                        f"content. Please check the content.\n{q78_content}")
    return nth + 1


def compare_results(input1, input2, input1_format, input2_format,
                    ignore_ordering, is_q78, q78_problematic_col,
                    max_errors=10, epsilon=0.00001) -> bool:
    """Row-by-row parity of two query output folders
    (ref: nds/nds_validate.py:48-114)."""
    rows1 = _load_rows(input1, input1_format, ignore_ordering)
    rows2 = _load_rows(input2, input2_format, ignore_ordering)
    if len(rows1) != len(rows2):
        print(f"Row counts do not match: {len(rows1)} != {len(rows2)}")
        return False
    errors = 0
    i = 0
    for lhs, rhs in zip(rows1, rows2):
        if errors >= max_errors:
            break
        if not rowEqual(list(lhs), list(rhs), epsilon, is_q78,
                        q78_problematic_col):
            print(f"Row {i}: \n{list(lhs)}\n{list(rhs)}\n")
            errors += 1
        i += 1
    print(f"Processed {i} rows")
    if errors == max_errors:
        print(f"Aborting comparison after reaching maximum of {max_errors} "
              "errors")
        return False
    if errors == 0:
        print("Results match")
        return True
    print(f"There were {errors} errors")
    return False


def iterate_queries(input1, input2, input1_format, input2_format,
                    ignore_ordering, query_dict, max_errors=10,
                    epsilon=0.00001, is_float=False) -> list:
    """Every statement of the stream compared; returns the unmatched ones
    (ref: nds/nds_validate.py:217-260, the query65 and query67 skips
    included)."""
    unmatch_queries = []
    for query_name in query_dict:
        if query_name == "query65":
            continue
        if query_name == "query67" and is_float:
            continue
        sub_input1 = os.path.join(input1, query_name)
        sub_input2 = os.path.join(input2, query_name)
        print(f"=== Comparing Query: {query_name} ===")
        problematic_col = 2
        if query_name == "query78":
            problematic_col = check_nth_col_problematic_q78(
                query_dict[query_name])
        if not os.path.exists(sub_input1) or not os.path.exists(sub_input2):
            print(f"Missing output for {query_name}")
            unmatch_queries.append(query_name)
            continue
        if not compare_results(sub_input1, sub_input2, input1_format,
                               input2_format, ignore_ordering,
                               query_name == "query78", problematic_col,
                               max_errors=max_errors, epsilon=epsilon):
            unmatch_queries.append(query_name)
    if unmatch_queries:
        print(f"=== Unmatch Queries: {unmatch_queries} ===")
    return unmatch_queries


def update_summary(prefix, unmatch_queries, query_dict) -> None:
    """Write ``queryValidationStatus`` into the one JSON summary of each
    statement (ref: nds/nds_validate.py:262-296)."""
    if not os.path.exists(prefix):
        raise Exception("The json summary folder doesn't exist.")
    print(f"Updating queryValidationStatus in folder {prefix}.")
    for query_name in query_dict:
        file_glob = glob.glob(os.path.join(prefix, f"*{query_name}-*.json"))
        if len(file_glob) > 1:
            raise Exception(f"More than one summary file found for query "
                            f"{query_name} in folder {prefix}.")
        if len(file_glob) == 0:
            raise Exception(f"No summary file found for query {query_name} "
                            f"in folder {prefix}.")
        for filename in file_glob:
            with open(filename) as f:
                summary = json.load(f)
            if query_name in unmatch_queries:
                if "Completed" in summary["queryStatus"] or \
                        "CompletedWithTaskFailures" in summary["queryStatus"]:
                    summary["queryValidationStatus"] = ["Fail"]
                else:
                    summary["queryValidationStatus"] = ["NotAttempted"]
            else:
                summary["queryValidationStatus"] = ["Pass"]
            with open(filename, "w") as f:
                json.dump(summary, f, indent=2)


def main(argv=None) -> int:
    check_version()
    from nds_tpu_torch.power import gen_sql_from_stream, get_query_subset
    parser = argparse.ArgumentParser(prog="python -m nds_tpu_torch.validate")
    parser.add_argument("input1", help="path of the first input data")
    parser.add_argument("input2", help="path of the second input data")
    parser.add_argument("query_stream_file",
                        help="query stream file that contains NDS queries in "
                        "specific order")
    parser.add_argument("--input1_format", default="parquet",
                        help="data source format for input1, e.g. parquet, "
                        "orc")
    parser.add_argument("--input2_format", default="parquet",
                        help="data source format for input2, e.g. parquet, "
                        "orc")
    parser.add_argument("--max_errors", type=int, default=10,
                        help="maximum number of differences to report")
    parser.add_argument("--epsilon", type=float, default=0.00001,
                        help="allowed relative difference when comparing "
                        "floating point values")
    parser.add_argument("--ignore_ordering", action="store_true",
                        help="sort the rows of each output before comparing "
                        "them")
    parser.add_argument("--use_iterator", action="store_true",
                        help="kept for the reference's command line; outputs "
                        "are read through arrow either way")
    parser.add_argument("--floats", action="store_true",
                        help="the input data requires float/double handling "
                        "(skips query67)")
    parser.add_argument("--json_summary_folder",
                        help="path of a folder that contains json summary "
                        "files to patch with validation status")
    parser.add_argument("--sub_queries",
                        type=lambda s: [x.strip() for x in s.split(",")],
                        help="comma separated list of queries to validate")
    args = parser.parse_args(argv)
    query_dict = gen_sql_from_stream(args.query_stream_file)
    if args.sub_queries:
        query_dict = get_query_subset(query_dict, args.sub_queries)
    unmatch = iterate_queries(args.input1, args.input2, args.input1_format,
                              args.input2_format, args.ignore_ordering,
                              query_dict, max_errors=args.max_errors,
                              epsilon=args.epsilon, is_float=args.floats)
    if args.json_summary_folder:
        update_summary(args.json_summary_folder, unmatch, query_dict)
    return 1 if unmatch else 0


if __name__ == "__main__":
    sys.exit(main())
