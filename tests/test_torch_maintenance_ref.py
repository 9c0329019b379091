# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The seven refresh functions that ``tests/test_torch_maintenance.py``
runs on the port alone (LF_CR, LF_CS, LF_SR, LF_WR, LF_WS, DF_CS, DF_WS),
held snapshot for snapshot against the JAX reference's
``nds_maintenance.py`` at SF0.01 (``device="cpu"``): one case a function,
each on its own copies of the base warehouse with refresh set 1; every
table has the same snapshots on both, the function's target tables are
the ones that moved, and every snapshot of theirs agrees (exact kinds bit
for bit, doubles within rel 1e-5). A file of its own, so
that the reference's compilation has a worker of its own under xdist's
``--dist loadfile``."""

import pytest
import torch

from tests.test_torch_maintenance import DM_DIR, PORT_ONLY, _copy, \
    _dm_statements, dm_data  # noqa: F401  (dm_data is a fixture)
from tests.test_torch_warehouse import snapshots_agree

torch.set_num_threads(1)


@pytest.mark.parametrize("func", PORT_ONLY)
def test_function_against_reference(dm_data, tmp_path, func):  # noqa: F811
    import nds_maintenance as ref_dm
    from nds_tpu.engine.session import Session as RefSession
    from nds_tpu.warehouse import Warehouse as RefWarehouse
    from nds_tpu_torch.maintenance import run_maintenance
    from nds_tpu_torch.warehouse import Warehouse
    _raw, refresh, base = dm_data
    port_wh = _copy(base, tmp_path / "port")
    ref_wh = _copy(base, tmp_path / "ref")
    _s, failed = run_maintenance(port_wh, refresh, DM_DIR,
                                 str(tmp_path / "port.csv"), [func],
                                 device="cpu")
    assert failed == []
    ref = RefSession()
    rw = RefWarehouse(ref_wh)
    ref_dm.register_warehouse_tables(ref, rw)
    ref_dm.register_temp_views(ref, refresh)
    ref_dm.run_query(ref, ref_dm.get_maintenance_queries(
        ref, DM_DIR, [func]), str(tmp_path / "ref.csv"), None, None)
    pw = Warehouse(port_wh)
    assert pw.tables() == rw.tables()
    _views, targets = _dm_statements(func)
    changed = []
    for table in pw.tables():
        ids = [s["id"] for s in pw.snapshots(table)]
        assert ids == [s["id"] for s in rw.snapshots(table)], table
        if len(ids) > 1:
            changed.append(table)
            assert snapshots_agree(pw, rw, table) is None
    # every other table keeps only the base snapshot both copies share
    assert changed == sorted(set(targets))
