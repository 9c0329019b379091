# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The streamed path's settings, the calling statement's conf and the
bucketed shape rule.

Torch-free, so that the host-only static models (``analysis/mem_audit.py``
and the cost model behind the trace and campaign reports) read the same
settings and shapes without loading the engine. ``ops.on_device`` sets the
calling thread's conf around every statement; outside a statement the
defaults (and the environment's overrides) answer."""

from __future__ import annotations

import os
import threading

# rows per streamed chunk (the ``stream_chunk_rows`` session setting
# overrides it per table)
CHUNK_ROWS = 1 << 22

# the bucket floor: the smallest physical length of any column
MIN_BUCKET = 16


def bucket_len(n: int) -> int:
    """Smallest power-of-two capacity >= n (floor :data:`MIN_BUCKET`)."""
    if n <= MIN_BUCKET:
        return MIN_BUCKET
    return 1 << (int(n) - 1).bit_length()

# The streamed path's settings: ``Session(conf=...)`` keys and their
# defaults. Read per statement through :func:`setting`; the two in
# :data:`SETTING_ENV` are also campaign arms, and their variable, when set,
# overrides the session's value (as ``NDS_TPU_REPLAY`` does the replay
# policy).
STREAM_DEFAULTS = {
    # "compiled": the chunk pipeline (engine/stream.py); "eager": the
    # per-chunk planner loop only
    "stream_exec": "compiled",
    # pin the partition count of partitionable graphs (None: the proof
    # chooses; <= 1 disables)
    "stream_partitions": None,
    # hard per-partition survivor-accumulator ceiling (None: proof-sized)
    "stream_acc_rows": None,
    # stream-bounds join pair-bucket allowance (power of two)
    "stream_fanout": 4,
    # hash-skew safety factor of the per-partition bound
    "stream_skew": 2,
    # chunks the prefetch worker may run ahead of the driver (0: inline)
    "prefetch_depth": 2,
    # device-memory capacity model in bytes (None: the card's own memory
    # on cuda, the reference's 16 GiB on the CPU)
    "hbm_bytes": None,
    # shard count of a streamed pipeline (rounded up to a power of two;
    # <= 1, or fewer local devices than shards: unsharded)
    "stream_shards": 1,
}


# settings a campaign arm sets from the environment: the prefetch ring's
# depth, read when the ring is built, and the shard count, read when a
# pipeline is built (the reference's variables)
SETTING_ENV = {
    "prefetch_depth": "NDS_TPU_PREFETCH_DEPTH",
    "stream_shards": "NDS_TPU_STREAM_SHARDS",
}

_tls = threading.local()


def statement_conf():
    """The calling thread's statement conf (None outside a statement)."""
    return getattr(_tls, "conf", None)


def use_conf(conf) -> None:
    """Make ``conf`` the calling thread's statement conf (None: none)."""
    _tls.conf = conf


def setting(name: str):
    """The calling statement's value of a streamed-path setting (a string
    from a property file or the environment is read as the default's
    type)."""
    conf = statement_conf() or {}
    default = STREAM_DEFAULTS[name]
    env = SETTING_ENV.get(name)
    v = os.environ.get(env) if env else None
    if not v:
        v = conf.get(name, default)
    if not isinstance(v, str) or isinstance(default, str):
        return v
    if isinstance(default, bool):
        return v.strip().lower() in ("1", "true", "yes")
    return int(float(v))
