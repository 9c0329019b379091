# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Index and segment primitives with the engine's out-of-range semantics.

Torch indexing raises on an out-of-range index on the CPU and device-asserts
on CUDA, while the engine relies on three milder rules:

* clip gathers (:func:`take_clip`): an index past either end reads the
  nearest row, so pad slots duplicate a real row;
* fill gathers (:func:`take_fill`, :func:`take`): an index in ``[-n, 0)``
  counts from the end, any other out-of-range index reads a fill value;
* dropping scatters (:func:`scatter_set`, :func:`scatter_add`,
  :func:`scatter_amin`, :func:`segment_sum`, ...): an index in ``[-n, 0)``
  counts from the end for the ``scatter_*`` helpers, every other
  out-of-range row is dropped; segment ids below 0 or at least
  ``num_segments`` are always dropped.

Padded index vectors point past the end on purpose, so every gather and
scatter of the engine goes through these functions.
"""

from __future__ import annotations

import torch

I64_MIN = -(1 << 63)
I64_MAX = (1 << 63) - 1


def _fill_default(dtype):
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point:
        return float("nan")
    return torch.iinfo(dtype).min


def take_clip(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[clip(idx, 0, n-1)]`` (zeros when ``a`` is empty)."""
    n = int(a.shape[0])
    if n == 0:
        return torch.zeros(idx.shape + a.shape[1:], dtype=a.dtype,
                           device=a.device)
    return a[idx.long().clamp(0, n - 1)]


def take_fill(a: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """Gather with negative indices counted from the end and every other
    out-of-range index reading ``fill``."""
    n = int(a.shape[0])
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    if n == 0:
        return torch.full(idx.shape, fill, dtype=a.dtype, device=a.device)
    got = a[idx.clamp(0, n - 1)]
    return torch.where(ok, got, torch.full((), fill, dtype=a.dtype,
                                           device=a.device))


def take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Fill gather with the dtype's default fill (NaN, the most negative
    integer, True)."""
    return take_fill(a, idx, _fill_default(a.dtype))


def wrap_clamp(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[idx]`` with negative indices counted from the end and the rest
    clamped into range (plain subscript semantics of the engine)."""
    n = int(a.shape[0])
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    return a[idx.clamp(0, max(n - 1, 0))]


def _spill_index(idx: torch.Tensor, n: int, wrap: bool) -> torch.Tensor:
    """``idx`` with every out-of-range entry sent to the spare slot ``n``
    (negatives counted from the end first when ``wrap``). Scattering into
    an ``n + 1`` buffer and dropping the spare slot drops those rows
    without a boolean-mask gather, which would sync the host on CUDA."""
    idx = idx.long()
    if wrap:
        idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((idx >= 0) & (idx < n), idx,
                       torch.full((), n, dtype=torch.int64,
                                  device=idx.device))


def _as_vals(vals, like: torch.Tensor, shape) -> torch.Tensor:
    if not torch.is_tensor(vals):
        return torch.full(shape, vals, dtype=like.dtype, device=like.device)
    return vals.to(like.dtype).expand(shape)


def _spare(target: torch.Tensor, fill) -> torch.Tensor:
    return torch.cat([target, torch.full((1,), fill, dtype=target.dtype,
                                         device=target.device)])


def scatter_set(target: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """New tensor: ``target`` with ``target[idx] = vals``, out-of-range rows
    dropped. ``vals`` may be a scalar."""
    n = int(target.shape[0])
    out = _spare(target, 0)
    out[_spill_index(idx, n, True)] = _as_vals(vals, target, idx.shape)
    return out[:n]


def scatter_add(target: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """New tensor: ``target`` with ``vals`` added at ``idx`` (drop)."""
    n = int(target.shape[0])
    out = _spare(target, 0).index_add(0, _spill_index(idx, n, True),
                                      _as_vals(vals, target, idx.shape))
    return out[:n]


def scatter_amin(target: torch.Tensor, idx: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """New tensor: elementwise min of ``target`` and ``vals`` at ``idx``
    (drop)."""
    n = int(target.shape[0])
    out = _spare(target, 0).scatter_reduce(
        0, _spill_index(idx, n, True), vals.to(target.dtype), "amin",
        include_self=True)
    return out[:n]


def segment_sum(data: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment sum in ``data``'s dtype; ids outside
    ``[0, num_segments)`` are dropped."""
    out = torch.zeros(num_segments + 1, dtype=data.dtype, device=data.device)
    return out.index_add(0, _spill_index(ids, num_segments, False),
                         data)[:num_segments]


def _seg_extreme(data, ids, num_segments, is_max):
    if data.dtype.is_floating_point:
        init = float("-inf") if is_max else float("inf")
    else:
        info = torch.iinfo(data.dtype)
        init = info.min if is_max else info.max
    out = torch.full((num_segments + 1,), init, dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce(0, _spill_index(ids, num_segments, False),
                              data, "amax" if is_max else "amin",
                              include_self=True)[:num_segments]


def segment_max(data, ids, num_segments):
    """Per-segment max; empty segments hold -inf (floats) or the dtype
    minimum; a NaN in a segment makes it NaN."""
    return _seg_extreme(data, ids, num_segments, True)


def segment_min(data, ids, num_segments):
    """Per-segment min; empty segments hold +inf (floats) or the dtype
    maximum; a NaN in a segment makes it NaN."""
    return _seg_extreme(data, ids, num_segments, False)


def nonzero_sized(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Indices of the first ``size`` True rows of ``mask``, padded with
    ``fill`` up to ``size`` (int64). Built from a prefix sum and a scatter,
    so it never waits for the host (``torch.nonzero`` would)."""
    dev = mask.device
    m = mask.to(torch.bool)
    pos = torch.cumsum(m.to(torch.int64), 0) - 1
    slot = torch.where(m & (pos < size), pos,
                       torch.full((), size, dtype=torch.int64, device=dev))
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=dev)
    out[slot] = torch.arange(m.shape[0], dtype=torch.int64, device=dev)
    return out[:size]


def repeat_total(vals: torch.Tensor, counts: torch.Tensor,
                 total: int) -> torch.Tensor:
    """``vals[i]`` repeated ``counts[i]`` times, cut or padded (with the
    last value) to ``total`` entries. Callers mask the pad slots. A
    searchsorted over the prefix sum, so no host wait for the length."""
    if vals.shape[0] == 0:
        return torch.zeros(total, dtype=vals.dtype, device=vals.device)
    ends = torch.cumsum(counts.long(), 0)
    src = torch.searchsorted(ends, torch.arange(total, device=vals.device),
                             right=True)
    return vals[src.clamp(max=vals.shape[0] - 1)]


def f64_to_i64(x: torch.Tensor) -> torch.Tensor:
    """Saturating float64 -> int64 (NaN -> 0): torch's own cast wraps or
    yields the minimum on out-of-range values."""
    big = x >= 9.223372036854775807e18
    small = x < -9.223372036854775807e18
    nan = torch.isnan(x)
    safe = torch.where(big | small | nan, torch.zeros((), dtype=x.dtype,
                                                      device=x.device), x)
    out = safe.to(torch.int64)
    out = torch.where(big, torch.full((), I64_MAX, dtype=torch.int64,
                                      device=x.device), out)
    return torch.where(small, torch.full((), I64_MIN, dtype=torch.int64,
                                         device=x.device), out)


# the divisors of true_div, one 0-d tensor per (value, dtype, device)
_DIVISORS: dict = {}


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as one IEEE division, on every device. On CUDA,
    torch divides by a Python (host) scalar as a multiplication by its
    reciprocal, which may differ from the quotient in the last bit; a
    divisor on the tensor's own device takes the true division. Each
    divisor is filled once (on the stream current then) and kept, so a
    decode launches no fill kernel of its own. While a CUDA graph is
    prepared or captured (``ops.staging``) each call fills its own
    divisor and keeps none: one filled in the capture would come from the
    graph's pool."""
    from nds_tpu_torch.engine.ops import staging
    if staging():
        return x / torch.full((), d, dtype=x.dtype, device=x.device)
    key = (d, x.dtype, x.device)
    div = _DIVISORS.get(key)
    if div is None:
        div = _DIVISORS[key] = torch.full((), d, dtype=x.dtype,
                                          device=x.device)
    return x / div


def searchsorted(sorted_seq: torch.Tensor, vals: torch.Tensor,
                 right: bool = False) -> torch.Tensor:
    """``searchsorted`` on signed int64/float64 keys (int64 result)."""
    return torch.searchsorted(sorted_seq.contiguous(), vals.contiguous(),
                              right=right).long()


def argsort_stable(v: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort (NaN last, as the reference orders it)."""
    if v.dtype == torch.bool:
        v = v.to(torch.int8)
    return torch.sort(v, stable=True).indices


def lexsort2(minor: torch.Tensor, major: torch.Tensor) -> torch.Tensor:
    """Stable sort by ``major`` then ``minor`` (``lexsort((minor,
    major))``)."""
    o1 = argsort_stable(minor)
    o2 = argsort_stable(major[o1])
    return o1[o2]
