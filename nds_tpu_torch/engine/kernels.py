# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Hand-written CUDA kernels, with their plain PyTorch versions and launch
counters.

Every GROUP BY ends in one of three grouped reductions; each is a CUDA C++
kernel in ``csrc/segment_agg.cu``:

=====================  ================================================  ===========================
wrapper                replaces (``nds_tpu/engine/kernels.py``)          computes per group
=====================  ================================================  ===========================
segment_sum_i64        ``_segment_sum_exact_pallas`` (K1)                exact int64 sum (wraps), count
segment_sum_f64        ``_segment_sum_pallas`` (K2)                      float64 sum, int64 count
segment_minmax_f64     ``_segment_minmax_pallas`` (K3)                   float64 min and max
=====================  ================================================  ===========================

A row takes part when ``0 <= gid < ngroups``; null or filtered rows carry
gid -1 and pad rows a gid at or past ``ngroups``, and both are dropped.

The streamed chunk pipeline (``engine/stream.py``) adds two per-chunk
kernels:

=====================  ================================================  ===========================
wrapper                replaces (``nds_tpu/engine/kernels.py``)          computes per row
=====================  ================================================  ===========================
chunk_scan             ``fused_chunk_scan`` (K4), ``csrc/chunk_scan.cu``  survivor mask of the lowered
                                                                         WHERE entries, routing hash
join_probe             ``fused_probe`` (K5), ``csrc/join_probe.cu``       probe hash, candidate count
                                                                         and start in the build table
=====================  ================================================  ===========================

What bounds them on an H100: one read of each row's value and group id
(16 bytes a row; 8 for a count-only ``segment_sum_f64``) against
device-memory bandwidth; global atomics on few groups serialise. So each
of K1-K3 has two kernels, chosen by :func:`segment_plan` from ``ngroups``
and the shared-memory bytes a group takes (16, or 4 for a count-only
``segment_sum_f64``): block-private shared-memory partials for as many groups as a block's
shared memory holds, one global atomic a row above that.
``chunk_scan`` is bound by the bytes of the columns its spec reads: the
spec is packed once per pipeline into int64 words (:func:`pack_scan_spec`),
and each block stages what of it fits 48 KB, less the kernel's static
records, in shared memory (:func:`scan_staged_words`); each thread then
takes a tile of 16 consecutive rows and runs the entries over it one at a
time, with vector loads, one decode per column and the mask bits in a
register, under the plan :func:`scan_plan` gives (threads a block, a
persistent grid of two blocks an SM). ``join_probe`` builds a radix
directory over the build side on each call and searches only the probe
hash's bucket (:func:`probe_bits`, :func:`probe_directory_plain`). The notes at the top of each CUDA source
say more.

Each wrapper launches its kernel for a CUDA tensor (or raises) and takes
the plain PyTorch version only for a tensor on the CPU. ``LAUNCHES`` counts
kernel launches per wrapper, and only those: the launches of
:func:`launcher`, which times a kernel alone, are not counted. A statement
captured as a CUDA graph (engine/replay.py) launches its kernels without
their wrappers: the capture's counts are taken back out (a capture runs
nothing) and each replay of the graph adds them again.

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
from typing import NamedTuple

import numpy as np
import torch

from nds_tpu_torch.engine.prim import true_div

I64 = torch.int64
F64 = torch.float64

# launches per kernel (plain integers; chip_smoke.py zeroes and reads them)
LAUNCHES = {"segment_sum_i64": 0, "segment_sum_f64": 0,
            "segment_minmax_f64": 0, "chunk_scan": 0, "join_probe": 0}

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_SOURCES = ("segment_agg.cu", "chunk_scan.cu", "join_probe.cu")
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
    hash) and return its path: one ``nvcc -c`` per source, all started
    together, then one link. ``verbose`` adds ``-Xptxas -v`` and returns
    with the compiler's report printed. No source is built with fast math
    (K4 divides by 10^scale as IEEE does)."""
    out_dir = build_dir()
    lib = os.path.join(out_dir, "libnds_kernels.so")
    if os.path.exists(lib) and not verbose:
        return lib
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    nvcc = _nvcc()
    arch = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
    t0 = time.perf_counter_ns()
    procs, objs = [], []
    for src in _SOURCES:
        obj = os.path.join(out_dir, f"{src}.{tag}.o")
        cmd = [nvcc] + arch + ["-Xcompiler", "-fPIC", "-c", "-o", obj,
                               os.path.join(_CSRC, src)]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
        objs.append(obj)
    errors, reports = [], []
    for src, proc in procs:
        _out, err = proc.communicate()
        reports.append(err.strip())
        if proc.returncode != 0:
            errors.append(f"{src} ({proc.returncode}):\n{err}")
    tmp = f"{lib}.{tag}.tmp"
    if not errors:
        res = subprocess.run([nvcc] + arch[:2] + ["-shared", "-o", tmp]
                             + objs, capture_output=True, text=True)
        if res.returncode != 0:
            errors.append(f"link ({res.returncode}):\n{res.stderr}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    from nds_tpu_torch.engine.ops import add_compile_ns
    add_compile_ns(time.perf_counter_ns() - t0)
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    if verbose:
        print("\n".join(r for r in reports if r))
    os.replace(tmp, lib)
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(build())
                vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
                # values, gids, n, G, outputs, then path, grid, smem, stream
                for name, outs in (("nds_seg_sum_i64", 2),
                                   ("nds_seg_sum_f64", 2),
                                   ("nds_seg_minmax_f64", 4)):
                    getattr(lib, name).argtypes = [vp, vp, ll, ll] + \
                        [vp] * outs + [ci, ci, ci, vp]
                for name in ("nds_seg_sum_i64", "nds_seg_sum_f64",
                             "nds_seg_minmax_f64"):
                    getattr(lib, name).restype = ctypes.c_int
                for name, struct in (("nds_chunk_scan", _ScanArgs),
                                     ("nds_join_probe", _ProbeArgs)):
                    fn = getattr(lib, name)
                    fn.argtypes = [ctypes.POINTER(struct), vp]
                    fn.restype = ctypes.c_int
                    size = getattr(lib, name + "_sizeof")
                    size.restype = ctypes.c_int
                    if size() != ctypes.sizeof(struct):
                        raise RuntimeError(
                            f"{name}: argument block is {size()} bytes in "
                            f"CUDA, {ctypes.sizeof(struct)} in Python")
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
    return ctypes.c_void_p(None if t is None else t.data_ptr())


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


# The private path keeps a group's partials in a block's shared memory
# (16 B a group for K1, K2 with values and K3; 4 B, a 32-bit count, for a
# count-only K2 launch) and runs a persistent grid of at most PRIV_PER_SM
# blocks of PRIV_THREADS threads an SM (fewer where the shared memory runs
# out); each block folds its non-empty groups into global memory at the
# end. It runs up to as many groups as a block's
# shared memory holds (G_PRIV at 16 B a group); above that each row makes
# its own global atomics ("global"). The sweeps behind these numbers are
# chip_smoke.py's k1_sweep and k23_sweep (PERF.md section 6).
SMEM_BLOCK_CAP = 232448          # 227 KB: a block's dynamic shared memory
SMEM_SM = 233472                 # 228 KB: an SM's, shared by its blocks
SMEM_RESERVED = 1024             # the runtime's own share of each block
G_PRIV = SMEM_BLOCK_CAP // 16    # 14,528 groups at 16 B a group
PRIV_THREADS = 512
PRIV_PER_SM = 2
GLOBAL_THREADS = 256             # csrc/segment_agg.cu kThreads
# path codes shared with csrc/segment_agg.cu
_SEG_PATHS = {"empty": 0, "private": 1, "global": 2}
_SEG_ENTRY = {"segment_sum_i64": "nds_seg_sum_i64",
              "segment_sum_f64": "nds_seg_sum_f64",
              "segment_minmax_f64": "nds_seg_minmax_f64"}


class SegmentPlan(NamedTuple):
    """How one K1-K3 launch runs: ``path`` ("empty" launches no row
    kernel, "private" or "global"), the ``grid`` in blocks
    and the dynamic shared-memory ``smem`` in bytes."""
    path: str
    grid: int
    smem: int


def segment_plan(n: int, ngroups: int, sms: int = 132,
                 g_priv: int | None = None, per_sm: int = PRIV_PER_SM,
                 group_bytes: int = 16) -> SegmentPlan:
    """The path for ``n`` rows into ``ngroups`` groups on a card of ``sms``
    SMs, for a kernel that keeps ``group_bytes`` of shared memory a group:
    block-private partials as long as a block's shared memory holds them
    (and ``ngroups <= g_priv`` where given), global atomics above."""
    if n <= 0 or ngroups <= 0:
        return SegmentPlan("empty", 0, 0)
    smem = group_bytes * ngroups
    if (g_priv is None or ngroups <= g_priv) and smem <= SMEM_BLOCK_CAP:
        fit = SMEM_SM // (smem + SMEM_RESERVED)
        blocks = sms * max(1, min(per_sm, fit))
        pairs = (n + 1) // 2
        grid = max(1, min(blocks, -(-pairs // PRIV_THREADS)))
        return SegmentPlan("private", grid, smem)
    grid = max(1, min(-(-n // GLOBAL_THREADS), sms * 64))
    return SegmentPlan("global", grid, 0)


def segment_plans(n: int, ngroups: int, sms: int, group_bytes: int = 16,
                  per_sm=(1, 2, 3, 4)) -> list[SegmentPlan]:
    """Every plan a sweep times for ``n`` rows into ``ngroups`` groups: the
    private path at each of ``per_sm`` blocks an SM, as far as the shared
    memory allows (none above its cap), then the global path."""
    private = sorted(set(
        p for p in (segment_plan(n, ngroups, sms, per_sm=q,
                                 group_bytes=group_bytes) for q in per_sm)
        if p.path == "private"))
    return private + [segment_plan(n, ngroups, sms, g_priv=0)]


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _seg_inputs(name, values, gids):
    """A K1-K3 launch's inputs, checked and contiguous (values may be None
    for ``segment_sum_f64``)."""
    _check_inputs(name, values, gids, I64 if name == "segment_sum_i64"
                  else F64)
    return None if values is None else values.contiguous(), \
        gids.contiguous()


def _seg_args(name, values, gids, ngroups, plan=None):
    """The C entry's arguments of one K1-K3 launch and its outputs
    (zeroed sums and counts; for K3 the key scratch and the doubles);
    ``plan`` defaults to :func:`segment_plan` on this card, at 4 bytes a
    group for a count-only launch (32-bit counts) and 16 otherwise."""
    dev, n = gids.device, gids.numel()
    if plan is None:
        plan = segment_plan(n, ngroups, _sm_count(dev),
                            group_bytes=4 if values is None else 16)
    if name == "segment_minmax_f64":
        keys = torch.empty((2, ngroups), dtype=I64, device=dev)
        out = torch.empty((2, ngroups), dtype=F64, device=dev)
        outs = (keys, out)
        ptrs = (_ptr(keys[0]), _ptr(keys[1]), _ptr(out[0]), _ptr(out[1]))
    else:
        sums = torch.zeros(ngroups, dtype=I64 if name == "segment_sum_i64"
                           else F64, device=dev)
        counts = torch.zeros(ngroups, dtype=I64, device=dev)
        outs = (sums, counts)
        ptrs = (_ptr(sums), _ptr(counts))
    args = (_ptr(values), _ptr(gids), n, ngroups, *ptrs,
            _SEG_PATHS[plan.path], plan.grid, plan.smem, _stream(gids))
    return args, outs


def _segment_launch(name, values, gids, ngroups):
    """Check, launch and count one K1-K3 wrapper call: its outputs."""
    values, gids = _seg_inputs(name, values, gids)
    args, outs = _seg_args(name, values, gids, ngroups)
    _check(name, getattr(_lib(), _SEG_ENTRY[name])(*args))
    LAUNCHES[name] += 1
    return outs


def segment_sum_i64(values: torch.Tensor, gids: torch.Tensor, ngroups: int):
    """Per group: the exact int64 sum of ``values`` (wrapping mod 2^64) and
    the row count, over rows with ``0 <= gid < ngroups``."""
    if gids.device.type == "cpu":
        return segment_sum_i64_plain(values, gids, ngroups)
    return _segment_launch("segment_sum_i64", values, gids, ngroups)


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
    return _segment_launch("segment_sum_f64", values, gids, ngroups)


# ---------------------------------------------------------------------------
# K3: float64 min + max
# ---------------------------------------------------------------------------


def _f64_key(x):
    """Order-preserving int64 key of non-NaN doubles (-0.0 < +0.0)."""
    b = x.view(I64)
    return torch.where(b >= 0, b, b ^ _KEY_MAX)


def _key_f64(k):
    return torch.where(k >= 0, k, k ^ _KEY_MAX).view(F64)


def minmax_keys_plain(values, gids, ngroups):
    """Per group, K3's (min, max) int64 keys before decoding: the
    order-preserving key of each in-range row's double (a NaN takes
    ``_KEY_MIN`` for the min and ``_KEY_MAX`` for the max, so it wins
    both), reduced; an empty group keeps the identities ``_KEY_MAX`` and
    ``_KEY_MIN``."""
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
    return kmin, kmax


def decode_minmax_keys(kmin, kmax):
    """K3's last step: keys to doubles (empty groups +inf / -inf, a NaN
    key NaN)."""
    dev = kmin.device
    inf = torch.full((), float("inf"), dtype=F64, device=dev)
    nanv = torch.full((), float("nan"), dtype=F64, device=dev)
    mins = torch.where(kmin == _KEY_MAX, inf,
                       torch.where(kmin == _KEY_MIN, nanv, _key_f64(kmin)))
    maxs = torch.where(kmax == _KEY_MIN, -inf,
                       torch.where(kmax == _KEY_MAX, nanv, _key_f64(kmax)))
    return mins, maxs


def segment_minmax_f64_plain(values, gids, ngroups):
    """Plain version of :func:`segment_minmax_f64`."""
    return decode_minmax_keys(*minmax_keys_plain(values, gids, ngroups))


def segment_minmax_f64(values: torch.Tensor, gids: torch.Tensor,
                       ngroups: int):
    """Per group: the float64 min and max of ``values`` over rows with
    ``0 <= gid < ngroups``. Empty groups give +inf / -inf; a NaN in a group
    gives NaN; -0.0 orders below +0.0."""
    if gids.device.type == "cpu":
        return segment_minmax_f64_plain(values, gids, ngroups)
    _keys, out = _segment_launch("segment_minmax_f64", values, gids, ngroups)
    return out[0], out[1]


# ---------------------------------------------------------------------------
# K4: fused chunk scan (lowered WHERE entries + routing hash)
# ---------------------------------------------------------------------------
#
# Entry opcodes (one or two entries per lowered conjunct; thresholds already
# in STORED space — analysis/kernel_spec.py does the exact rational math):
#
#   ("ieq"|"ine"|"ile"|"ige", ci, T)     int lane, raw stored codes
#   ("irange"|"nrange", ci, lo, hi)      BETWEEN (negated: "nrange")
#   ("iin"|"inotin", ci, values)         IN-list membership
#   ("isnull"|"notnull", ci)             validity only
#   ("true"|"false", ci)                 constant contribution (& valid)
#   ("feq"|"fne"|"flt"|"fle"|"fgt"|"fge", ci, L)
#                                        float lane: decode per column meta,
#                                        compare float64
#   ("fin"|"fnotin", ci, values)         float-lane IN-list membership
#   ("frange"|"fnrange", ci, lo, hi)     float-lane BETWEEN

# opcode numbers shared with csrc/chunk_scan.cu
_SCAN_OPS = {"false": 0, "true": 1, "isnull": 2, "notnull": 3, "ieq": 4,
             "ine": 5, "ile": 6, "ige": 7, "irange": 8, "nrange": 9,
             "iin": 10, "inotin": 11, "feq": 12, "fne": 13, "flt": 14,
             "fle": 15, "fgt": 16, "fge": 17, "fin": 18, "fnotin": 19,
             "frange": 20, "fnrange": 21}
_FMODES = {"id": 0, "for": 1, "dict": 2}
# dtype tags shared with csrc/chunk_scan.cu and csrc/join_probe.cu
_TAGS = {torch.int8: 1, torch.int16: 2, torch.int32: 3, torch.int64: 4,
         torch.float32: 5, torch.float64: 6, torch.uint8: 7, torch.bool: 7}
_SCAN_MAX_COLS, _SCAN_MAX_KEYS = 16, 8


class ScanSpec:
    """Chunk-invariant description of one fused scan pass.

    ``cols`` holds per-referenced-column metadata
    ``(data_slot, valid_slot, fmode, base, tbl_idx, sdiv)`` — slots index
    the pipeline's flattened chunk buffers (valid_slot -1 = no mask);
    ``fmode``/``base``/``tbl_idx``/``sdiv`` describe the float-lane decode
    ("id" | "for" | "dict", FOR base, dict table index, the 10**scale
    divisor). ``tables`` are the sorted dict value tables the float lane
    gathers (host arrays). ``key_slots`` are the chunk buffers the
    partition hash folds (empty = no hash output). ``binds`` are the
    fields that bound parameter slots feed: ``(entry, field, slot, map)``,
    ``map`` taking the slot's literal value to the entry's field
    (``engine/exprs.lower_scan_spec``); :func:`bind_scan_entries` and
    :func:`bind_scan_words` give one execution's entries and words."""

    __slots__ = ("entries", "n_conjuncts", "cols", "tables", "key_slots",
                 "binds", "_blobs")

    def __init__(self, entries, cols, tables=(), key_slots=(),
                 n_conjuncts=None, binds=()):
        self.entries = tuple(entries)
        # a conjunct may lower to SEVERAL entries (mixed-lane BETWEEN), so
        # the stage count tracks CONJUNCTS
        self.n_conjuncts = len(self.entries) if n_conjuncts is None \
            else n_conjuncts
        self.cols = tuple(cols)
        self.tables = tuple(tables)
        self.key_slots = tuple(key_slots)
        self.binds = tuple(binds)
        self._blobs = {}

    def stages(self) -> int:
        """Fused stage count of one launch: one per lowered conjunct plus
        the hash stage."""
        return self.n_conjuncts + (1 if self.key_slots else 0)


_M32 = 0xFFFFFFFF


def _bits64(data: torch.Tensor) -> torch.Tensor:
    """A key buffer as int64 bits: integers sign-extend, float64 keeps its
    bit pattern, float32 sign-extends its bits through int32."""
    if data.dtype == F64:
        return data.view(I64)
    if data.dtype == torch.float32:
        return data.view(torch.int32).to(I64)
    return data.to(I64)


def hash_mix(h: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Fold one key column into the per-row partition hash — THE
    partition routing hash (the K4 kernel computes the same bits). ``h``
    holds uint32 values in int64; low ``log2(P)`` bits pick the
    partition."""
    x = _bits64(data)
    lo = x & _M32
    hi = (x >> 32) & _M32
    h = ((h ^ lo) * 2654435761) & _M32
    h = h ^ (h >> 16)
    h = ((h ^ hi) * 2246822519) & _M32
    return h ^ (h >> 13)


def fold_hash(keybufs) -> torch.Tensor:
    """The routing hash over ``keybufs`` as int32 holding the uint32 bits
    (the dtype the K4 kernel writes)."""
    h = torch.full(keybufs[0].shape, 2166136261, dtype=I64,
                   device=keybufs[0].device)
    for kb in keybufs:
        h = hash_mix(h, kb)
    return torch.where(h >= (1 << 31), h - (1 << 32), h).to(torch.int32)


def _eval_entries(spec: ScanSpec, datas, valids, tables, entries=None):
    """Survivor mask: AND of every lowered conjunct's contribution (the
    plain version of the K4 kernel body; all boolean logic mirrors the
    eager engine's ``mask & data & valid_mask`` WHERE contract).
    ``entries``: one execution's bound entries (default the spec's)."""
    shape, dev = datas[0].shape, datas[0].device
    m = torch.ones(shape, dtype=torch.bool, device=dev)

    def vmask(ci):
        v = valids[ci]
        return torch.ones(shape, dtype=torch.bool, device=dev) \
            if v is None else v

    for e in spec.entries if entries is None else entries:
        kind, ci = e[0], e[1]
        if kind == "false":
            m = torch.zeros(shape, dtype=torch.bool, device=dev)
            continue
        if kind in ("true", "notnull"):
            m = m & vmask(ci)
            continue
        if kind == "isnull":
            m = m & ~vmask(ci)
            continue
        if kind[0] == "i" or kind == "nrange":
            x = datas[ci].to(I64)
            if kind not in ("iin", "inotin"):
                # thresholds clamped to int64 as the packed words hold
                # them (a literal scaled past int64 selects all or none)
                e = (*e[:2], *(_clamp_i64(v) for v in e[2:]))
            if kind == "ieq":
                c = x == e[2]
            elif kind == "ine":
                c = x != e[2]
            elif kind == "ile":
                c = x <= e[2]
            elif kind == "ige":
                c = x >= e[2]
            elif kind == "irange":
                c = (x >= e[2]) & (x <= e[3])
            elif kind == "nrange":
                c = ~((x >= e[2]) & (x <= e[3]))
            elif kind == "iin":
                c = torch.zeros(shape, dtype=torch.bool, device=dev)
                for v in e[2]:
                    c = c | (x == _clamp_i64(v))
            elif kind == "inotin":
                c = torch.ones(shape, dtype=torch.bool, device=dev)
                for v in e[2]:
                    c = c & (x != _clamp_i64(v))
            else:
                raise ValueError(f"unknown scan entry {kind!r}")
            m = m & c & vmask(ci)
            continue
        if kind[0] == "f":
            _ds, _vs, fmode, base, tbl, sdiv = spec.cols[ci]
            d = datas[ci]
            if fmode == "for":
                val = (d.to(I64) + base).to(F64)
            elif fmode == "dict":
                t = tables[tbl]
                val = t[d.to(I64).clamp(0, t.shape[0] - 1)].to(F64)
            else:
                val = d.to(F64)
            if sdiv != 1.0:
                val = true_div(val, sdiv)
            if kind in ("fin", "fnotin"):
                c = torch.zeros(shape, dtype=torch.bool, device=dev)
                for v in e[2]:
                    c = c | (val == v)
                if kind == "fnotin":
                    c = ~c
            elif kind in ("frange", "fnrange"):
                c = (val >= e[2]) & (val <= e[3])
                if kind == "fnrange":
                    c = ~c
            elif kind == "feq":
                c = val == e[2]
            elif kind == "fne":
                c = val != e[2]
            elif kind == "flt":
                c = val < e[2]
            elif kind == "fle":
                c = val <= e[2]
            elif kind == "fgt":
                c = val > e[2]
            elif kind == "fge":
                c = val >= e[2]
            else:
                raise ValueError(f"unknown scan entry {kind!r}")
            m = m & c & vmask(ci)
            continue
        raise ValueError(f"unknown scan entry {kind!r}")
    return m


def _scan_inputs(chunk_flat, spec: ScanSpec):
    datas = [chunk_flat[c[0]] for c in spec.cols]
    valids = [None if c[1] < 0 else chunk_flat[c[1]] for c in spec.cols]
    keybufs = [chunk_flat[s] for s in spec.key_slots]
    return datas, valids, keybufs


def chunk_scan_plain(chunk_flat, n_dev, spec: ScanSpec, entries=None):
    """Plain version of :func:`chunk_scan` (``entries``: one execution's
    bound entries, :func:`bind_scan_entries`)."""
    datas, valids, keybufs = _scan_inputs(chunk_flat, spec)
    dev = datas[0].device
    tables = [torch.as_tensor(np.asarray(t, dtype=np.int64), device=dev)
              for t in spec.tables]
    mask = _eval_entries(spec, datas, valids, tables, entries)
    mask = mask & (torch.arange(datas[0].shape[0], device=dev) < n_dev)
    return mask, (fold_hash(keybufs) if keybufs else None)


# The packed spec (csrc/chunk_scan.cu reads it, a block stages it in shared
# memory): int64 words in five regions, in this order
#   entries  SCAN_ENT_WORDS a row: op, column, a, b, fa bits, fb bits, IN-list
#            offset (from its region), IN-list length
#   columns  SCAN_COL_WORDS a row: fmode, FOR base, 10^scale divisor bits,
#            dict table offset (from the table region), table length
#   ivals    int IN-list values
#   fvals    float IN-list values (bits)
#   tables   dict value tables, concatenated
SCAN_ENT_WORDS, SCAN_COL_WORDS = 8, 5
# the kernel's static shared memory: 16 column and 8 key records
# (csrc/chunk_scan.cu kStaticSmem)
SCAN_STATIC_SMEM = 16 * 64 + 8 * 16
# a block stages the longest prefix of whole regions that fits this budget
# (48 KB, the static and dynamic shared memory a block takes without
# raising its limit, less the static records), and reads what does not fit
# from global memory
SCAN_SMEM_BUDGET = 48 * 1024 - SCAN_STATIC_SMEM
# rows a thread's tile (csrc/chunk_scan.cu R)
SCAN_ROWS = 16
# the plan: threads a block, blocks an SM (a persistent grid;
# chip_smoke.py's k4 sweep, PERF.md section 6)
SCAN_THREADS = 256
SCAN_PER_SM = 2
SCAN_MAX_THREADS = 256          # csrc/chunk_scan.cu kMaxThreads


class ScanLayout(NamedTuple):
    """The entry and column counts of a packed spec, where each of its
    regions starts and its total length, in words (``off_cols`` is also
    where the entries end)."""
    nentries: int
    ncols: int
    off_cols: int
    off_ivals: int
    off_fvals: int
    off_tables: int
    total: int


def _f64_bits(x) -> int:
    return int(np.asarray(float(x), dtype=np.float64).view(np.int64))


def pack_scan_spec(spec: ScanSpec):
    """``(words, layout)``: the spec as the int64 words the K4 kernel
    reads (the region layout above) and where its regions start
    (:func:`packed_scan_spec` keeps one per spec)."""
    ent, ivals, fvals = [], [], []
    for e in spec.entries:
        kind, ci = e[0], e[1]
        a = b = off = ln = 0
        fa = fb = 0.0
        if kind in ("iin", "inotin"):
            off, ln = len(ivals), len(e[2])
            ivals.extend(_clamp_i64(v) for v in e[2])
        elif kind in ("fin", "fnotin"):
            off, ln = len(fvals), len(e[2])
            fvals.extend(_f64_bits(v) for v in e[2])
        elif kind in ("frange", "fnrange"):
            fa, fb = float(e[2]), float(e[3])
        elif kind in ("feq", "fne", "flt", "fle", "fgt", "fge"):
            fa = float(e[2])
        elif kind in ("irange", "nrange"):
            a, b = _clamp_i64(e[2]), _clamp_i64(e[3])
        elif kind in ("ieq", "ine", "ile", "ige"):
            a = _clamp_i64(e[2])
        ent.extend((_SCAN_OPS[kind], ci, a, b, _f64_bits(fa), _f64_bits(fb),
                    off, ln))
    tables, toff = [], []
    for t in spec.tables:
        toff.append(len(tables))
        tables.extend(int(v) for v in np.asarray(t, dtype=np.int64))
    cols = []
    for (_ds, _vs, fmode, base, tbl, sd) in spec.cols:
        has_tbl = fmode == "dict"
        cols.extend((_FMODES[fmode], int(base), _f64_bits(sd),
                     toff[tbl] if has_tbl else 0,
                     len(spec.tables[tbl]) if has_tbl else 0))
    words = ent + cols + ivals + fvals + tables
    o_cols = len(ent)
    o_iv = o_cols + len(cols)
    o_fv = o_iv + len(ivals)
    o_tb = o_fv + len(fvals)
    layout = ScanLayout(len(spec.entries), len(spec.cols), o_cols, o_iv,
                        o_fv, o_tb, len(words))
    return np.asarray(words, dtype=np.int64), layout


def bind_scan_entries(spec: ScanSpec, values) -> tuple:
    """One execution's entries: the spec's, every bound field recomputed
    from ``values`` (literal values, by parameter slot). Kinds and the
    entry count stay the spec's."""
    ents = [list(e) for e in spec.entries]
    for (i, f, k, fn) in spec.binds:
        ents[i][f] = fn(values[k])
    return tuple(tuple(e) for e in ents)


def bind_scan_words(spec: ScanSpec, entries) -> np.ndarray:
    """The entry region of the packed spec (its first ``off_cols`` words)
    for one execution's ``entries`` (:func:`bind_scan_entries`): the
    spec's packed words with each bound field's word rewritten — int
    fields at ``a``/``b``, float fields at their bits. Layout, opcodes and
    word count stay those of :func:`packed_scan_spec`."""
    words, lay = packed_scan_spec(spec)
    out = words[:lay.off_cols].copy()
    for (i, f, _k, _fn) in spec.binds:
        v = entries[i][f]
        if entries[i][0][0] == "f":
            out[SCAN_ENT_WORDS * i + f + 2] = _f64_bits(v)
        else:
            out[SCAN_ENT_WORDS * i + f] = _clamp_i64(v)
    return out


def scan_staged_words(layout: ScanLayout,
                      budget: int = SCAN_SMEM_BUDGET) -> int:
    """The words of a packed spec a block copies to shared memory: the
    longest prefix of whole regions (entries, columns, int IN-lists, float
    IN-lists, dict tables) within ``budget`` bytes. The kernel reads each
    region that lies past it from global memory."""
    staged = 0
    for end in (layout.off_cols, layout.off_ivals, layout.off_fvals,
                layout.off_tables, layout.total):
        if 8 * end > budget:
            break
        staged = end
    return staged


class ScanPlan(NamedTuple):
    """How one K4 launch runs: ``threads`` a block, ``grid`` blocks,
    ``smem`` bytes of staged spec (``staged`` words)."""
    threads: int
    grid: int
    smem: int
    staged: int


def packed_scan_spec(spec: ScanSpec):
    """:func:`pack_scan_spec` of ``spec``, packed once and kept with it
    (chunk-invariant)."""
    got = spec._blobs.get("packed")
    if got is None:
        got = spec._blobs["packed"] = pack_scan_spec(spec)
    return got


def scan_plan(plen: int, spec: ScanSpec, sms: int = 132,
              threads: int = SCAN_THREADS, per_sm: int = SCAN_PER_SM,
              budget: int = SCAN_SMEM_BUDGET) -> ScanPlan:
    """The launch of K4 over a ``plen``-row chunk on a card of ``sms``
    SMs: tiles of ``SCAN_ROWS`` rows, a persistent grid of at most
    ``per_sm`` blocks of ``threads`` an SM (fewer where the staged spec or
    the threads an SM run out), no more blocks than the tiles fill; grid 0
    for an empty chunk."""
    if not 32 <= threads <= SCAN_MAX_THREADS or threads % 32:
        raise ValueError("chunk_scan: threads must be a multiple of 32 up "
                         f"to {SCAN_MAX_THREADS}")
    staged = scan_staged_words(packed_scan_spec(spec)[1], budget)
    smem = 8 * staged
    if plen <= 0:
        return ScanPlan(threads, 0, smem, staged)
    fit = min(per_sm, 2048 // threads,
              SMEM_SM // (smem + SCAN_STATIC_SMEM + SMEM_RESERVED))
    tiles = -(-plen // SCAN_ROWS)
    grid = max(1, min(sms * max(1, fit), -(-tiles // threads)))
    return ScanPlan(threads, grid, smem, staged)


def scan_plans(plen: int, spec: ScanSpec, sms: int) -> list[ScanPlan]:
    """Every plan the k4 sweep times: 1, 2 and 4 blocks of 256 threads an
    SM, and 128-thread blocks at 8 and 16 an SM."""
    plans = [scan_plan(plen, spec, sms, per_sm=q) for q in (1, 2, 4)]
    plans += [scan_plan(plen, spec, sms, threads=128, per_sm=q)
              for q in (8, 16)]
    return sorted(set(plans), key=plans.index)


class _ScanArgs(ctypes.Structure):
    """The argument block of ``nds_chunk_scan`` (csrc/chunk_scan.cu
    ``NdsScanArgs``, field for field)."""
    _fields_ = [("data", ctypes.c_void_p * _SCAN_MAX_COLS),
                ("valid", ctypes.c_void_p * _SCAN_MAX_COLS),
                ("keys", ctypes.c_void_p * _SCAN_MAX_KEYS),
                ("data_tag", ctypes.c_int * _SCAN_MAX_COLS),
                ("key_tag", ctypes.c_int * _SCAN_MAX_KEYS),
                ("ncols", ctypes.c_int), ("nentries", ctypes.c_int),
                ("nkeys", ctypes.c_int), ("float_lane", ctypes.c_int),
                ("spec", ctypes.c_void_p),
                ("off_cols", ctypes.c_int), ("off_ivals", ctypes.c_int),
                ("off_fvals", ctypes.c_int), ("off_tables", ctypes.c_int),
                ("total_words", ctypes.c_int),
                ("staged_words", ctypes.c_int),
                ("threads", ctypes.c_int), ("grid", ctypes.c_int),
                ("smem", ctypes.c_int),
                ("n_dev", ctypes.c_void_p), ("plen", ctypes.c_longlong),
                ("mask", ctypes.c_void_p), ("hash", ctypes.c_void_p)]


def _clamp_i64(v) -> int:
    return max(min(int(v), (1 << 63) - 1), -(1 << 63))


def _scan_blob(spec: ScanSpec, dev) -> torch.Tensor:
    """The packed words on ``dev``, once per (spec, device):
    chunk-invariant, so no chunk uploads them again."""
    from nds_tpu_torch.engine.ops import staging, upload
    key = str(dev)
    blob = None if staging() else spec._blobs.get(key)
    if blob is None:
        words = packed_scan_spec(spec)[0]
        blob = upload(words.tolist() or [0], dev, I64)
        if not staging():            # never keep a graph pool's tensor
            spec._blobs[key] = blob
    return blob


def _tag(name, t):
    tag = _TAGS.get(t.dtype)
    if tag is None:
        raise ValueError(f"{name}: unsupported dtype {t.dtype}")
    return tag


def _cuda_1d(name, t, dev, n, dtypes=None):
    if t.device != dev or t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{name}: buffers must be 1-D of length {n} on "
                         f"{dev}, got {tuple(t.shape)} on {t.device}")
    if dtypes is not None and t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    return t.contiguous()


def _scan_args(chunk_flat, n_dev, spec: ScanSpec,
               plan: ScanPlan | None = None, words=None):
    """(argument block, keep-alive tensors, mask, hash) of one K4 launch;
    ``plan`` defaults to :func:`scan_plan` on this card; ``words`` is one
    execution's packed spec on the card (default the spec's own)."""
    datas, valids, keybufs = _scan_inputs(chunk_flat, spec)
    dev = datas[0].device
    if dev.type != "cuda":
        raise ValueError(f"chunk_scan: kernel needs CUDA tensors, got {dev}")
    if len(datas) > _SCAN_MAX_COLS or len(keybufs) > _SCAN_MAX_KEYS:
        raise ValueError(f"chunk_scan: at most {_SCAN_MAX_COLS} columns and "
                         f"{_SCAN_MAX_KEYS} keys")
    if not (torch.is_tensor(n_dev) and n_dev.dtype == I64
            and n_dev.numel() == 1 and n_dev.device == dev):
        raise ValueError("chunk_scan: n_dev must be an int64 scalar on the "
                         "chunk's device")
    plen = int(datas[0].shape[0])
    if plan is None:
        plan = scan_plan(plen, spec, _sm_count(dev))
    a = _ScanArgs()
    keep = []
    for i, (d, v) in enumerate(zip(datas, valids)):
        d = _cuda_1d("chunk_scan", d, dev, plen)
        a.data[i] = d.data_ptr()
        a.data_tag[i] = _tag("chunk_scan", d)
        keep.append(d)
        if v is not None:
            v = _cuda_1d("chunk_scan", v, dev, plen, (torch.bool,))
            a.valid[i] = v.data_ptr()
            keep.append(v)
    for i, k in enumerate(keybufs):
        k = _cuda_1d("chunk_scan", k, dev, plen)
        a.keys[i] = k.data_ptr()
        a.key_tag[i] = _tag("chunk_scan", k)
        keep.append(k)
    a.ncols, a.nentries, a.nkeys = len(datas), len(spec.entries), \
        len(keybufs)
    lay = packed_scan_spec(spec)[1]
    if words is None:
        words = _scan_blob(spec, dev)
    elif not (words.device == dev and words.dtype == I64
              and words.dim() == 1 and words.shape[0] >= max(lay.total, 1)
              and words.is_contiguous()):
        raise ValueError("chunk_scan: bound words must be a contiguous "
                         f"int64 vector of {lay.total} words on {dev}")
    keep.append(words)
    a.spec = words.data_ptr()
    a.off_cols, a.off_ivals = lay.off_cols, lay.off_ivals
    a.off_fvals, a.off_tables = lay.off_fvals, lay.off_tables
    a.total_words, a.staged_words = lay.total, plan.staged
    a.float_lane = int(any(_SCAN_OPS[e[0]] >= _SCAN_OPS["feq"]
                           for e in spec.entries))
    a.threads, a.grid, a.smem = plan.threads, plan.grid, plan.smem
    n_dev = n_dev.reshape(())
    keep.append(n_dev)
    a.n_dev = n_dev.data_ptr()
    a.plen = plen
    mask = torch.empty(plen, dtype=torch.bool, device=dev)
    h = torch.empty(plen, dtype=torch.int32, device=dev) if keybufs \
        else None
    a.mask = mask.data_ptr()
    a.hash = None if h is None else h.data_ptr()
    return a, keep, mask, h


class ScanBinding(NamedTuple):
    """One execution's bound K4 spec: its entries (the plain version reads
    them) and its packed words on the device (the kernel reads them)."""
    entries: tuple
    words: torch.Tensor | None


def chunk_scan(chunk_flat, n_dev, spec: ScanSpec,
               bound: ScanBinding | None = None):
    """``(mask, hash)`` of one padded chunk: the AND of the spec's lowered
    WHERE entries on the stored codes, & ``row < n_dev``; and the routing
    hash over ``spec.key_slots`` (int32 holding uint32 bits; None without
    key slots). ``chunk_flat`` is the pipeline's flattened chunk (data,
    validity per column), ``n_dev`` the live row count as a 0-d int64
    tensor on the chunk's device. ``bound`` carries one execution's
    parameter values (a spec with ``binds``). On the card the launch takes
    :func:`scan_plan`."""
    first = chunk_flat[spec.cols[0][0]]
    if first.device.type == "cpu":
        return chunk_scan_plain(chunk_flat, n_dev, spec,
                                None if bound is None else bound.entries)
    args, keep, mask, h = _scan_args(
        chunk_flat, n_dev, spec, words=None if bound is None
        else bound.words)
    rc = _lib().nds_chunk_scan(ctypes.byref(args), _stream(mask))
    _check("chunk_scan", rc)
    LAUNCHES["chunk_scan"] += 1
    return mask, h


# ---------------------------------------------------------------------------
# K5: bound-bucket join probe
# ---------------------------------------------------------------------------


def join_probe_plain(views, valids, n_valid, excluded, rh_sorted):
    """Plain version of :func:`join_probe`."""
    from nds_tpu_torch.engine import prim
    from nds_tpu_torch.engine.ops import _key_hash_impl, unsigned_order
    lh = unsigned_order(_key_hash_impl(tuple(views), tuple(valids), 0,
                                       False, n_valid, excluded))
    lo = prim.searchsorted(rh_sorted, lh)
    hi = prim.searchsorted(rh_sorted, lh, right=True)
    return hi - lo, lo


PROBE_BITS_MIN, PROBE_BITS_MAX = 10, 20


def probe_bits(r: int) -> int:
    """Directory bits B for ``r`` build rows: ceil(log2 r), so a bucket
    holds about one entry, clamped to [10, 20] (at most a 4 MB directory,
    which stays in L2)."""
    return min(max((max(r, 1) - 1).bit_length(), PROBE_BITS_MIN),
               PROBE_BITS_MAX)


def probe_directory_plain(rh_sorted: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain version of the K5 directory (csrc/join_probe.cu
    ``probe_directory_kernel``): int32 ``dir[0 .. 2^bits]``, ``dir[b]`` the
    first position of ``rh_sorted`` (bit-63-flipped hashes, ascending)
    whose unsigned top-``bits`` bucket is ``>= b``."""
    nb = 1 << bits
    # the flipped value's arithmetic shift is the unsigned bucket - nb/2
    buckets = (rh_sorted >> (64 - bits)) + (nb >> 1)
    edges = torch.arange(nb + 1, dtype=I64, device=rh_sorted.device)
    return torch.searchsorted(buckets.contiguous(), edges).to(torch.int32)


class _ProbeArgs(ctypes.Structure):
    """The argument block of ``nds_join_probe`` (csrc/join_probe.cu
    ``NdsProbeArgs``, field for field)."""
    _fields_ = [("views", ctypes.c_void_p * _SCAN_MAX_KEYS),
                ("valid", ctypes.c_void_p * _SCAN_MAX_KEYS),
                ("view_tag", ctypes.c_int * _SCAN_MAX_KEYS),
                ("nkeys", ctypes.c_int), ("pad_", ctypes.c_int),
                ("excluded", ctypes.c_void_p),
                ("n_valid_ptr", ctypes.c_void_p),
                ("n_valid_host", ctypes.c_longlong),
                ("rh_sorted", ctypes.c_void_p), ("r", ctypes.c_longlong),
                ("n", ctypes.c_longlong), ("counts", ctypes.c_void_p),
                ("lo", ctypes.c_void_p), ("dir", ctypes.c_void_p),
                ("bits", ctypes.c_int), ("pad2_", ctypes.c_int)]


_PROBE_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64,
                 torch.uint8, torch.bool)


def _probe_args(views, valids, n_valid, excluded, rh_sorted):
    """(argument block, keep-alive tensors, counts, lo) of one K5 launch;
    the directory scratch is ``keep[1]``."""
    dev = rh_sorted.device
    if dev.type != "cuda":
        raise ValueError(f"join_probe: kernel needs CUDA tensors, got {dev}")
    if not views or len(views) > _SCAN_MAX_KEYS:
        raise ValueError(f"join_probe: 1 to {_SCAN_MAX_KEYS} key views")
    if rh_sorted.dtype != I64 or rh_sorted.dim() != 1:
        raise ValueError("join_probe: rh_sorted must be 1-D int64")
    r = int(rh_sorted.shape[0])
    if r >= 1 << 31:
        raise ValueError("join_probe: the directory holds int32 positions, "
                         f"r = {r} is too large")
    n = int(views[0].shape[0])
    a = _ProbeArgs()
    bits = probe_bits(r)
    keep = [rh_sorted.contiguous(),
            torch.empty((1 << bits) + 1, dtype=torch.int32, device=dev)]
    for i, (v, ok) in enumerate(zip(views, valids)):
        v = _cuda_1d("join_probe", v, dev, n, _PROBE_DTYPES)
        a.views[i] = v.data_ptr()
        a.view_tag[i] = _tag("join_probe", v)
        keep.append(v)
        if ok is not None:
            ok = _cuda_1d("join_probe", ok, dev, n, (torch.bool,))
            a.valid[i] = ok.data_ptr()
            keep.append(ok)
    a.nkeys = len(views)
    if excluded is not None:
        excluded = _cuda_1d("join_probe", excluded, dev, n, (torch.bool,))
        a.excluded = excluded.data_ptr()
        keep.append(excluded)
    if torch.is_tensor(n_valid):
        if n_valid.device != dev or n_valid.numel() != 1:
            raise ValueError("join_probe: n_valid must be a scalar on "
                             f"{dev}")
        n_valid = n_valid.reshape(()).to(I64)
        a.n_valid_ptr = n_valid.data_ptr()
        keep.append(n_valid)
    else:
        a.n_valid_host = int(n_valid)
    a.rh_sorted = keep[0].data_ptr()
    a.r = r
    a.dir, a.bits = keep[1].data_ptr(), bits
    a.n = n
    counts = torch.empty(n, dtype=I64, device=dev)
    lo = torch.empty(n, dtype=I64, device=dev)
    a.counts, a.lo = counts.data_ptr(), lo.data_ptr()
    return a, keep, counts, lo


def join_probe(views, valids, n_valid, excluded, rh_sorted):
    """``(counts, lo)`` of the stream-bounds join probe: per probe row,
    the key hash of ``ops._key_hash_impl`` with side salt 0 (null, pad
    and excluded rows take their unmatchable per-row sentinel), then the
    number of equal entries in ``rh_sorted`` and the position of the
    first. ``views`` are integer key views, ``valids`` their masks (None
    entries allowed), ``n_valid`` the live probe rows (int or device
    scalar), ``excluded`` a bool mask or None, ``rh_sorted`` the
    build-side hashes in the order ``ops.unsigned_order`` sorts them."""
    if rh_sorted.device.type == "cpu":
        return join_probe_plain(views, valids, n_valid, excluded, rh_sorted)
    args, keep, counts, lo = _probe_args(views, valids, n_valid, excluded,
                                         rh_sorted)
    rc = _lib().nds_join_probe(ctypes.byref(args), _stream(counts))
    _check("join_probe", rc)
    LAUNCHES["join_probe"] += 1
    return counts, lo


# ---------------------------------------------------------------------------
# device-time measurement
# ---------------------------------------------------------------------------


def launcher(name: str, *args, plan=None, words=None):
    """A function that launches kernel ``name`` (a key of ``LAUNCHES``)
    once on outputs allocated here, with no input check, allocation or
    count per call: what a measurement of the kernel's own device time
    calls in a loop. ``args`` are the wrapper's arguments (for
    ``segment_sum_f64`` the values may be None: a count-only launch);
    K1-K3 also take ``plan=`` (a :class:`SegmentPlan`) and K4 a
    :class:`ScanPlan` in place of the card's own, for a sweep; K4 takes
    ``words=``, one execution's bound spec on the card. Sums accumulate
    across calls; nothing reads them."""
    if name in ("chunk_scan", "join_probe"):
        if name == "chunk_scan":
            block, keep, out, out2 = _scan_args(*args, plan=plan,
                                                words=words)
            fn_name = "nds_chunk_scan"
        else:
            block, keep, out, out2 = _probe_args(*args)
            fn_name = "nds_join_probe"
        fn = getattr(_lib(), fn_name)
        ref, stream = ctypes.byref(block), _stream(out)

        def launch():
            _check(name, fn(ref, stream))
            return keep, out, out2
        return launch
    values, gids, ngroups = args
    values, gids = _seg_inputs(name, values, gids)
    seg_args, outs = _seg_args(name, values, gids, ngroups, plan)
    fn = getattr(_lib(), _SEG_ENTRY[name])

    def launch():
        _check(name, fn(*seg_args))
        return outs
    return launch
