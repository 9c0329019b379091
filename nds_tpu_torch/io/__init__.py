# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""IO layer: raw '|'-delimited CSV ingest and columnar (Parquet/ORC) IO."""

from nds_tpu_torch.io.csv import read_raw_table  # noqa: F401
from nds_tpu_torch.io.columnar import read_table, write_table  # noqa: F401
