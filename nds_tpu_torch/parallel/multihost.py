# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Multihost federation: one process per host (or per group of cards),
joined into one ``torch.distributed`` process group.

After :func:`maybe_initialize` a meshed session
(``Session(conf={"mesh_shape": n})``) lays its shards over every process:
the shards are ordered by rank, then by local shard, each process holds
its own, and the collectives of ``parallel/exchange.py`` cross processes
through the group (the all-to-all of the repartition join, the
all-gathers of the gathered operators, the reductions).

Environment contract (the launch templates' variables):

    NDS_TPU_MULTIHOST=1         opt in
    NDS_COORDINATOR=host:port   the rendezvous (rank 0 listens there);
                                without it the group reads torch's own
                                ``env://`` variables (MASTER_ADDR, ...)
    NDS_NUM_PROCESSES=N         process count (world size)
    NDS_PROCESS_ID=i            this process's rank

The backend follows the session's device: ``gloo`` for the CPU and
``nccl`` for cuda. NCCL refuses two ranks on one card, so each process
of a cuda federation needs cards of its own (``CUDA_VISIBLE_DEVICES``).
"""

from __future__ import annotations

import os

_initialized = False


def backend_for(device) -> str:
    """The process-group backend of a device kind."""
    import torch
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_initialize(device="cpu") -> bool:
    """Join the federation when the environment opts in; idempotent.
    Returns True in a federation, False in single-process mode. Called
    from ``Session`` construction before any use of the device.

    The attach sits behind the ``peer`` fault seam: an injected or real
    failure raises a classified error at once (no retry: a half-formed
    federation must never run a collective), and under
    ``NDS_TPU_STATEMENT_DEADLINE_S`` a stuck attach raises
    ``StatementTimeout``."""
    global _initialized
    if _initialized:
        return True
    if not os.environ.get("NDS_TPU_MULTIHOST"):
        return False
    from nds_tpu_torch.engine import faults as _F
    try:
        _F.fault_point("peer")
    except _F.FaultInjected as exc:
        _F.record_fault_event("peer", "fatal", detail=str(exc)[:200])
        raise
    import torch
    import torch.distributed as dist
    kwargs = {"backend": backend_for(device)}
    if kwargs["backend"] == "nccl":
        # the group's collectives run on the process's first card
        dev = torch.device(device)
        torch.cuda.set_device(dev.index if dev.index is not None else 0)
    coord = os.environ.get("NDS_COORDINATOR")
    kwargs["init_method"] = f"tcp://{coord}" if coord else "env://"
    if os.environ.get("NDS_NUM_PROCESSES"):
        kwargs["world_size"] = int(os.environ["NDS_NUM_PROCESSES"])
    if os.environ.get("NDS_PROCESS_ID"):
        kwargs["rank"] = int(os.environ["NDS_PROCESS_ID"])

    def attach():
        try:
            dist.init_process_group(**kwargs)
        except Exception as exc:
            _F.record_fault_event("peer", "fatal",
                                  detail=f"{type(exc).__name__}: "
                                  f"{str(exc)[:160]}")
            raise _F.FaultError(
                "peer", f"federation attach failed ({kwargs['init_method']}"
                f"): {type(exc).__name__}: {exc}") from exc

    _F.bounded_call("peer", attach)
    _initialized = True
    return True


def process_info():
    """(rank, world size); (0, 1) without a federation."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard_range(n: int, process_index: int | None = None,
                     process_count: int | None = None) -> tuple[int, int]:
    """[start, end) of the rows or chunks this process owns out of ``n``:
    the per-process split of data loading and generation."""
    if process_index is None or process_count is None:
        process_index, process_count = process_info()
    per = (n + process_count - 1) // process_count
    start = min(process_index * per, n)
    return start, min(start + per, n)
