# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Observability: nestable spans with sync/wait counters bridged from
:mod:`nds_tpu_torch.engine.ops` (``trace``) and their Chrome trace_event
export and per-query rollup (``export``)."""
