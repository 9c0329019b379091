# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""nds-tpu on PyTorch: the device-resident Power Run on CUDA.

A self-contained counterpart of the ``nds_tpu`` package: its own copy of
the SQL front end, schema, query templates and IO, an engine whose columns
are torch tensors, and hand-written CUDA kernels for the grouped
aggregations (``engine/kernels.py``, ``csrc/``).

Dtype policy: torch makes float32 from Python floats and has no global
64-bit switch, so every int64 and float64 tensor in this package names its
dtype explicitly.

Device policy: entry points run on ``cuda`` unless the caller asks for
``cpu``; asking for ``cuda`` without a GPU raises instead of quietly
running on the host.
"""

__version__ = "0.1.0"


def resolve_device(device=None):
    """``torch.device`` for an entry point's ``device`` argument (default
    ``cuda``). Raises when CUDA is asked for and no GPU is present."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nds_tpu_torch: device 'cuda' requested but no CUDA device is "
            "available; pass device='cpu' to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
