# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Fail-fast precondition gates of the entries: the interpreter version,
output-folder protection, query-subset checks, argument types and the
native data generator (ref: nds/check.py)."""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

MIN_PYTHON = (3, 8)


def check_version(min_version=MIN_PYTHON) -> None:
    """Abort on interpreters older than the entries support
    (ref: nds/check.py:38-44)."""
    if sys.version_info < min_version:
        raise RuntimeError(
            f"Python {min_version[0]}.{min_version[1]}+ required, "
            f"found {sys.version_info.major}.{sys.version_info.minor}")


def repo_root() -> Path:
    return Path(__file__).resolve().parent.parent


def check_build_ndsgen() -> Path:
    """Locate the native data generator, building it from the checked-in
    source on demand (ref: nds/check.py:47-66); a user-supplied TPC-DS
    toolkit under $TPCDS_HOME serves where it cannot be built."""
    native = repo_root() / "native" / "ndsgen" / "ndsgen"
    if not native.is_file():
        import subprocess
        try:
            build = subprocess.run(["make", "-C", str(native.parent)],
                                   capture_output=True, text=True)
            if build.returncode:
                # never run whatever a failed build left behind
                print(f"ndsgen build failed (make exited "
                      f"{build.returncode}):\n{build.stderr.strip()}")
                native = native / "unbuilt"       # guaranteed not a file
        except OSError:
            pass
    if native.is_file() and os.access(native, os.X_OK):
        return native
    tpcds_home = os.environ.get("TPCDS_HOME")
    if tpcds_home:
        dsdgen = Path(tpcds_home) / "tools" / "dsdgen"
        if dsdgen.is_file():
            return dsdgen
    raise RuntimeError(
        "native data generator not built. Run `make -C native/ndsgen` "
        "(or set $TPCDS_HOME to a patched TPC-DS v3.2.0 toolkit).")


def get_abs_path(p: str) -> str:
    """Entry arguments may be relative; subprocess work uses absolute
    paths (ref: nds/check.py:69-78)."""
    return str(Path(p).expanduser().resolve())


def valid_range(range_str: str, parallel: int):
    """Validate ``--range a,b`` against ``--parallel``
    (ref: nds/check.py:88-106)."""
    try:
        start, end = map(int, range_str.split(","))
    except Exception:
        raise argparse.ArgumentTypeError(
            f"invalid range: {range_str!r}; expected 'start,end'")
    if not (1 <= start <= end <= parallel):
        raise argparse.ArgumentTypeError(
            f"range {range_str!r} out of bounds for parallel={parallel}")
    return start, end


def parallel_value(v: str) -> int:
    """argparse type for ``--parallel`` (ref: nds/check.py:109-118)."""
    try:
        n = int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(f"{v!r} is not an int")
    if n < 2:
        raise argparse.ArgumentTypeError("parallel must be >= 2")
    return n


def get_dir_size(d: str) -> int:
    """Recursive byte size of a directory (ref: nds/check.py:121-133)."""
    total = 0
    for root, _dirs, files in os.walk(d):
        for f in files:
            fp = os.path.join(root, f)
            if not os.path.islink(fp):
                total += os.path.getsize(fp)
    return total


def check_json_summary_folder(folder: str | None) -> None:
    """Refuse to mix new JSON summaries into a non-empty folder
    (ref: nds/check.py:136-145)."""
    if folder is None:
        return
    if os.path.exists(folder):
        if os.listdir(folder):
            raise RuntimeError(
                f"json_summary_folder {folder!r} is not empty. "
                "Use a clean folder per run."
            )
    else:
        os.makedirs(folder)


def check_query_subset_exists(query_dict, subset) -> bool:
    """Every requested --sub_queries name must exist in the parsed stream
    (ref: nds/check.py:147-152)."""
    for q in subset:
        if q not in query_dict:
            raise RuntimeError(f"query {q!r} not found in query stream")
    return True
