# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Hand-written CUDA kernels of the grouped aggregations, with their plain
PyTorch versions and launch counters.

Every GROUP BY on the device-resident path ends in one of three grouped
reductions; each is a CUDA C++ kernel in ``csrc/segment_agg.cu``:

=====================  ================================================  ===========================
wrapper                replaces (``nds_tpu/engine/kernels.py``)          computes per group
=====================  ================================================  ===========================
segment_sum_i64        ``_segment_sum_exact_pallas`` (K1)                exact int64 sum (wraps), count
segment_sum_f64        ``_segment_sum_pallas`` (K2)                      float64 sum, int64 count
segment_minmax_f64     ``_segment_minmax_pallas`` (K3)                   float64 min and max
=====================  ================================================  ===========================

A row takes part when ``0 <= gid < ngroups``; null or filtered rows carry
gid -1 and pad rows a gid at or past ``ngroups``, and both are dropped.

What bounds them on an H100: one read of each row's value and group id
(16 bytes a row) against device-memory bandwidth, plus the global atomics
(see the note at the top of the CUDA source). The design is one thread per
row in a grid-stride loop with global atomics; privatised shared-memory
histograms and warp-aggregated atomics are later work.

Each wrapper launches its kernel for a CUDA tensor (or raises) and takes
the plain PyTorch version only for a tensor on the CPU. ``LAUNCHES`` counts
kernel launches per wrapper, and only those: the launches of
:func:`launcher`, which times a kernel alone, are not counted.

The shared library is built at first use with ``nvcc`` from the sources in
``csrc/`` into ``_build/<source hash>/`` beside this package (listed in
``.gitignore``) and bound with ctypes; nothing is compiled on import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

I64 = torch.int64
F64 = torch.float64

# launches per kernel (plain integers; chip_smoke.py zeroes and reads them)
LAUNCHES = {"segment_sum_i64": 0, "segment_sum_f64": 0,
            "segment_minmax_f64": 0}

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_SOURCES = ("segment_agg.cu",)
_LIB = None
_LIB_LOCK = threading.Lock()

_KEY_MAX = (1 << 63) - 1
_KEY_MIN = -(1 << 63)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME)")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "_build", source_hash())


def build(verbose: bool = False) -> str:
    """Compile ``csrc/*.cu`` into the shared library (once per source
    hash) and return its path. ``verbose`` adds ``-Xptxas -v`` and returns
    with the compiler's report printed."""
    out_dir = build_dir()
    lib = os.path.join(out_dir, "libnds_segagg.so")
    if os.path.exists(lib) and not verbose:
        return lib
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-o", tmp] + [os.path.join(_CSRC, s) for s in _SOURCES]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    t0 = time.perf_counter_ns()
    res = subprocess.run(cmd, capture_output=True, text=True)
    from nds_tpu_torch.engine.ops import add_compile_ns
    add_compile_ns(time.perf_counter_ns() - t0)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr.strip())
    os.replace(tmp, lib)
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(build())
                vp, ll = ctypes.c_void_p, ctypes.c_longlong
                for name in ("nds_seg_sum_i64", "nds_seg_sum_f64"):
                    fn = getattr(lib, name)
                    fn.argtypes = [vp, vp, ll, ll, vp, vp, vp]
                    fn.restype = ctypes.c_int
                lib.nds_seg_minmax_f64.argtypes = [vp, vp, ll, ll, vp, vp,
                                                   vp, vp, vp]
                lib.nds_seg_minmax_f64.restype = ctypes.c_int
                _LIB = lib
    return _LIB


def _check(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _check_inputs(name, values, gids, dtype):
    if gids.device.type != "cuda":
        raise ValueError(f"{name}: kernel needs CUDA tensors, got "
                         f"{gids.device}")
    if gids.dtype != I64 or gids.dim() != 1:
        raise ValueError(f"{name}: gids must be 1-D int64")
    if values is not None and (values.dtype != dtype or values.dim() != 1
                               or values.shape != gids.shape
                               or values.device != gids.device):
        raise ValueError(f"{name}: values must be 1-D {dtype} matching "
                         f"gids on {gids.device}")


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _in_range(gids, ngroups):
    return (gids >= 0) & (gids < ngroups)


# ---------------------------------------------------------------------------
# K1: exact int64 sum + count
# ---------------------------------------------------------------------------


def segment_sum_i64_plain(values, gids, ngroups):
    """Plain version of :func:`segment_sum_i64`."""
    ok = _in_range(gids, ngroups)
    g = gids[ok]
    sums = torch.zeros(ngroups, dtype=I64, device=gids.device)
    counts = torch.zeros(ngroups, dtype=I64, device=gids.device)
    sums.index_add_(0, g, values[ok])
    counts.index_add_(0, g, torch.ones_like(g))
    return sums, counts


def segment_sum_i64(values: torch.Tensor, gids: torch.Tensor, ngroups: int):
    """Per group: the exact int64 sum of ``values`` (wrapping mod 2^64) and
    the row count, over rows with ``0 <= gid < ngroups``."""
    if gids.device.type == "cpu":
        return segment_sum_i64_plain(values, gids, ngroups)
    _check_inputs("segment_sum_i64", values, gids, I64)
    values, gids = values.contiguous(), gids.contiguous()
    sums = torch.zeros(ngroups, dtype=I64, device=gids.device)
    counts = torch.zeros(ngroups, dtype=I64, device=gids.device)
    rc = _lib().nds_seg_sum_i64(_ptr(values), _ptr(gids), gids.numel(),
                                ngroups, _ptr(sums), _ptr(counts),
                                _stream(gids))
    _check("segment_sum_i64", rc)
    LAUNCHES["segment_sum_i64"] += 1
    return sums, counts


# ---------------------------------------------------------------------------
# K2: float64 sum + int64 count
# ---------------------------------------------------------------------------


def segment_sum_f64_plain(values, gids, ngroups):
    """Plain version of :func:`segment_sum_f64`."""
    ok = _in_range(gids, ngroups)
    g = gids[ok]
    sums = torch.zeros(ngroups, dtype=F64, device=gids.device)
    counts = torch.zeros(ngroups, dtype=I64, device=gids.device)
    if values is not None:
        sums.index_add_(0, g, values[ok])
    counts.index_add_(0, g, torch.ones_like(g))
    return sums, counts


def segment_sum_f64(values, gids: torch.Tensor, ngroups: int):
    """Per group: the float64 sum of ``values`` (zeros when ``values`` is
    None: a count-only launch) and the int64 row count, over rows with
    ``0 <= gid < ngroups``."""
    if gids.device.type == "cpu":
        return segment_sum_f64_plain(values, gids, ngroups)
    _check_inputs("segment_sum_f64", values, gids, F64)
    gids = gids.contiguous()
    if values is not None:
        values = values.contiguous()
    sums = torch.zeros(ngroups, dtype=F64, device=gids.device)
    counts = torch.zeros(ngroups, dtype=I64, device=gids.device)
    rc = _lib().nds_seg_sum_f64(
        None if values is None else _ptr(values), _ptr(gids), gids.numel(),
        ngroups, _ptr(sums), _ptr(counts), _stream(gids))
    _check("segment_sum_f64", rc)
    LAUNCHES["segment_sum_f64"] += 1
    return sums, counts


# ---------------------------------------------------------------------------
# K3: float64 min + max
# ---------------------------------------------------------------------------


def _f64_key(x):
    """Order-preserving int64 key of non-NaN doubles (-0.0 < +0.0)."""
    b = x.view(I64)
    return torch.where(b >= 0, b, b ^ _KEY_MAX)


def _key_f64(k):
    return torch.where(k >= 0, k, k ^ _KEY_MAX).view(F64)


def segment_minmax_f64_plain(values, gids, ngroups):
    """Plain version of :func:`segment_minmax_f64`."""
    dev = gids.device
    ok = _in_range(gids, ngroups)
    g = gids[ok]
    v = values[ok]
    nan = torch.isnan(v)
    key = _f64_key(torch.where(nan, torch.zeros((), dtype=F64, device=dev),
                               v))
    lo = torch.where(nan, torch.full((), _KEY_MIN, dtype=I64, device=dev),
                     key)
    hi = torch.where(nan, torch.full((), _KEY_MAX, dtype=I64, device=dev),
                     key)
    kmin = torch.full((ngroups,), _KEY_MAX, dtype=I64, device=dev)
    kmax = torch.full((ngroups,), _KEY_MIN, dtype=I64, device=dev)
    kmin = kmin.scatter_reduce(0, g, lo, "amin", include_self=True)
    kmax = kmax.scatter_reduce(0, g, hi, "amax", include_self=True)
    inf = torch.full((), float("inf"), dtype=F64, device=dev)
    nanv = torch.full((), float("nan"), dtype=F64, device=dev)
    mins = torch.where(kmin == _KEY_MAX, inf,
                       torch.where(kmin == _KEY_MIN, nanv, _key_f64(kmin)))
    maxs = torch.where(kmax == _KEY_MIN, -inf,
                       torch.where(kmax == _KEY_MAX, nanv, _key_f64(kmax)))
    return mins, maxs


def segment_minmax_f64(values: torch.Tensor, gids: torch.Tensor,
                       ngroups: int):
    """Per group: the float64 min and max of ``values`` over rows with
    ``0 <= gid < ngroups``. Empty groups give +inf / -inf; a NaN in a group
    gives NaN; -0.0 orders below +0.0."""
    if gids.device.type == "cpu":
        return segment_minmax_f64_plain(values, gids, ngroups)
    _check_inputs("segment_minmax_f64", values, gids, F64)
    values, gids = values.contiguous(), gids.contiguous()
    dev = gids.device
    keys = torch.empty((2, ngroups), dtype=I64, device=dev)
    out = torch.empty((2, ngroups), dtype=F64, device=dev)
    rc = _lib().nds_seg_minmax_f64(
        _ptr(values), _ptr(gids), gids.numel(), ngroups, _ptr(keys[0]),
        _ptr(keys[1]), _ptr(out[0]), _ptr(out[1]), _stream(gids))
    _check("segment_minmax_f64", rc)
    LAUNCHES["segment_minmax_f64"] += 1
    return out[0], out[1]


# ---------------------------------------------------------------------------
# device-time measurement
# ---------------------------------------------------------------------------


def launcher(name: str, values, gids: torch.Tensor, ngroups: int):
    """A function that launches kernel ``name`` (a key of ``LAUNCHES``)
    once on outputs allocated here, with no input check, allocation or
    count per call: what a measurement of the kernel's own device time
    calls in a loop. Sums accumulate across calls; nothing reads them."""
    _check_inputs(name, values, gids, F64 if name.endswith("f64") else I64)
    values, gids = values.contiguous(), gids.contiguous()
    dev, n = gids.device, gids.numel()
    if name == "segment_minmax_f64":
        keys = torch.empty((2, ngroups), dtype=I64, device=dev)
        out = torch.empty((2, ngroups), dtype=F64, device=dev)
        outs = (keys, out)
        args = (_ptr(values), _ptr(gids), n, ngroups, _ptr(keys[0]),
                _ptr(keys[1]), _ptr(out[0]), _ptr(out[1]), _stream(gids))
        fn = _lib().nds_seg_minmax_f64
    else:
        sums = torch.zeros(ngroups, dtype=values.dtype, device=dev)
        counts = torch.zeros(ngroups, dtype=I64, device=dev)
        outs = (sums, counts)
        args = (_ptr(values), _ptr(gids), n, ngroups, _ptr(sums),
                _ptr(counts), _stream(gids))
        fn = {"segment_sum_i64": _lib().nds_seg_sum_i64,
              "segment_sum_f64": _lib().nds_seg_sum_f64}[name]

    def launch():
        _check(name, fn(*args))
        return outs
    return launch
