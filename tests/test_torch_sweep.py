# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""One pass over all 103 statements of the SF0.01 stream through the
reference and the torch port on the CPU. Rows must agree in order, exact
kinds bit for bit, doubles within rel 1e-5. It is marked ``slow``: the
tier-1 command deselects it with ``-m 'not slow'``, and a plain
``pytest tests/`` runs it.

    python -m pytest tests/test_torch_sweep.py -m slow
"""

import pytest

from tests.test_torch_slice import slice_setup, tables_agree  # noqa: F401


@pytest.mark.slow
def test_all_statements_match_reference(slice_setup):  # noqa: F811
    ref, port, queries = slice_setup
    assert len(queries) == 103
    diffs = {}
    for name, sql in queries.items():
        try:
            why = tables_agree(ref.sql(sql).to_arrow(),
                               port.sql(sql).to_arrow())
        except Exception as e:                       # port-side failure
            why = f"{type(e).__name__}: {e}"
        if why:
            diffs[name] = why
    assert not diffs, diffs
