# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Lifting recorded host-read logs into device operands.

A recorded log (``ops.recording``) holds the host values of every read.
Some of them are arrays the replayed program only hands back to the device
(``torch.as_tensor(value, device=...)`` and elementwise math); replaying
those from host memory would upload them again on every chunk. Lifting
uploads each such array ONCE, when the streamed pipeline is built, and
leaves an :class:`ops.ArgRef` in the log that the replay resolves to the
device tensor. Entries whose values drive HOST decisions (sync counts,
chunk spans, key ranges) stay literal.

Whole-query replay (recording a device-resident statement once and
replaying it) is not part of this package yet.
"""

from __future__ import annotations

import numpy as np
import torch

from nds_tpu_torch.engine import ops as E

# tag -> indices of liftable tuple elements (None = the whole value is one
# array)
_LIFTABLE = {
    "cast_str": (0,),          # (inv codes, dictionary)
    "concat": (0,),
    "date_part": None,
    "month_arith": None,
    "dense_dim": (1,),         # (base, position map) — may be None
}
# every liftable array lifts, however small: a replayed array that stayed
# on the host would cost a blocking host-to-device copy per chunk
_LIFT_MIN_ELEMS = 0


def _lift_log(log, device):
    """Split a recorded log into (log-with-ArgRefs, operand tensors on
    ``device``)."""
    out_log, operands = [], []

    def lift(arr):
        operands.append(E.upload(arr, device))
        return E.ArgRef(len(operands) - 1)

    def liftable(x):
        return isinstance(x, np.ndarray) and x.size >= _LIFT_MIN_ELEMS

    for tag, val in log:
        idxs = _LIFTABLE.get(tag, ())
        if idxs is None and liftable(val):
            val = lift(val)
        elif idxs and isinstance(val, tuple):
            val = tuple(lift(x) if (i in idxs and liftable(x)) else x
                        for i, x in enumerate(val))
        out_log.append((tag, val))
    return out_log, operands
