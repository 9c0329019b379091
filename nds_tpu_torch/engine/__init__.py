# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Columnar execution engine on torch tensors.

One tensor per column plus a validity mask; strings are dictionary-encoded
(int32 codes on device, values on host); decimals are int64 scaled fixed
point; dates are int32 days since the epoch. Relational operators are built
from sorts, segment reductions, searchsorted probes and gathers, and the
grouped aggregations run on the hand-written kernels of ``kernels.py``.

The package itself imports nothing, so the torch-free modules here
(``faults``) load without torch.
"""
