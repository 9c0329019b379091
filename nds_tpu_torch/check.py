# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Fail-fast precondition gates of the Power Run driver: output-folder
protection and query-subset checks (ref: nds/check.py:127-152)."""

from __future__ import annotations

import os


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
