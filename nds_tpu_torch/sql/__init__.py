# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""SQL frontend: lexer, parser, and planner lowering Spark-dialect SQL (the
dialect the query templates generate) onto the torch engine."""

from nds_tpu_torch.sql.parser import parse  # noqa: F401
