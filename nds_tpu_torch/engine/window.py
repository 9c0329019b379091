# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Window functions: rank/row_number/dense_rank and partition aggregates.

Implementation: one lexsort over (partition keys, order keys), segment
boundary detection, then prefix-scan arithmetic within segments — all static
dtype device ops. Results scatter back to the original row order.
"""

from __future__ import annotations

import torch

from nds_tpu_torch.engine import prim
from nds_tpu_torch.engine.column import Column, is_dec
from nds_tpu_torch.engine.ops import lexsort_indices, sortable_view

I64 = torch.int64
F64 = torch.float64


def _first_true(n: int, dev) -> torch.Tensor:
    # one kernel: ``b[0] = True`` would copy a host scalar to the device
    return torch.arange(n, device=dev) == 0


def _boundaries(cols, order):
    """Sorted-order boundary mask: True where a new run of equal keys starts."""
    n = int(order.shape[0])
    dev = order.device
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    b = _first_true(n, dev)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    for col in cols:
        v = sortable_view(col)
        if col.valid is not None:
            v = torch.where(col.valid, v, torch.zeros((), dtype=v.dtype,
                                                      device=dev))
        sv = prim.take(v, order)
        b = b | torch.cat([one, sv[1:] != sv[:-1]])
        if col.valid is not None:
            nv = prim.take(col.valid, order)
            b = b | torch.cat([~one, nv[1:] != nv[:-1]])
    return b


class WindowContext:
    """One sort shared by every window function over the same
    (partition, order) spec."""

    def __init__(self, partition_cols, order_cols=(), descending=None,
                 nulls_last=None, n_valid: int | None = None):
        self.n = len(partition_cols[0]) if partition_cols else len(order_cols[0])
        if n_valid is None:
            n_valid = self.n
        all_cols = list(partition_cols) + list(order_cols)
        desc = [False] * len(partition_cols) + list(
            descending or [False] * len(order_cols))
        nl = [False] * len(partition_cols) + list(
            nulls_last or [d for d in (descending or [False] * len(order_cols))])
        # pad rows sort last and are walled off into their own partition so
        # no real partition's aggregate sees pad garbage
        self.order = lexsort_indices(all_cols, desc, nl, n_valid=n_valid)
        dev = self.order.device
        pos = torch.arange(self.n, device=dev)
        if self.n == 0:
            self.part_boundary = torch.zeros(0, dtype=torch.bool, device=dev)
        elif partition_cols:
            self.part_boundary = _boundaries(partition_cols, self.order)
        else:
            self.part_boundary = _first_true(self.n, dev)
        # wall off the pad suffix into its own partition. A device count
        # applies the traced form unconditionally: at n_valid == n the
        # boundary lands past every row (no-op), at 0 it re-marks row 0.
        from nds_tpu_torch.engine.ops import DeviceCount, count_arr
        if isinstance(n_valid, DeviceCount):
            if self.n:
                self.part_boundary = self.part_boundary | (
                    pos == count_arr(n_valid))
        elif 0 < n_valid < self.n:
            self.part_boundary = self.part_boundary | (pos == n_valid)
        self.gid_sorted = torch.cumsum(self.part_boundary.to(I64), 0) - 1
        # segment capacity: physical length is a static upper bound on the
        # partition count — no host sync, canonical shapes
        self.ngroups = self.n
        # start position of each row's segment
        seg_starts = torch.where(self.part_boundary, pos, 0)
        self.start_for_row = prim.wrap_clamp(prim.segment_max(
            seg_starts, self.gid_sorted, self.ngroups), self.gid_sorted)
        self.pos = pos
        self.order_boundary = (self.part_boundary |
                               _boundaries(order_cols, self.order)
                               if order_cols else self.part_boundary)

    def _scatter(self, sorted_vals, kind="i64", valid_sorted=None, dict_values=None):
        dev = sorted_vals.device
        out = prim.scatter_set(torch.zeros(self.n, dtype=sorted_vals.dtype,
                                           device=dev),
                               self.order, sorted_vals)
        valid = None
        if valid_sorted is not None:
            valid = prim.scatter_set(torch.zeros(self.n, dtype=torch.bool,
                                                 device=dev),
                                     self.order, valid_sorted)
        return Column(kind, out, valid, dict_values)

    def row_number(self) -> Column:
        rn = self.pos - self.start_for_row + 1
        return self._scatter(rn.to(I64))

    def rank(self) -> Column:
        # rank = position of the last order-boundary at or before this row
        marks = torch.where(self.order_boundary, self.pos, -1)
        last_b = torch.cummax(marks, 0).values if self.n else marks
        rk = last_b - self.start_for_row + 1
        return self._scatter(rk.to(I64))

    def dense_rank(self) -> Column:
        cb = torch.cumsum(self.order_boundary.to(I64), 0)
        cb_at_start = prim.wrap_clamp(prim.segment_max(
            torch.where(self.part_boundary, cb, 0), self.gid_sorted,
            self.ngroups), self.gid_sorted)
        dr = cb - cb_at_start + 1
        return self._scatter(dr.to(I64))

    def _per_row(self, seg_vals):
        return prim.wrap_clamp(seg_vals, self.gid_sorted)

    def partition_agg(self, col: Column, agg: str) -> Column:
        """sum/avg/min/max/count over the whole partition, broadcast per row."""
        col = col.plain()                 # window math needs logical values
        valid = prim.take(col.valid_mask(), self.order)
        data = prim.take(col.data, self.order)
        gs, ng = self.gid_sorted, self.ngroups
        dev = data.device
        if agg == "count":
            red = prim.segment_sum(valid.to(I64), gs, ng)
            return self._scatter(self._per_row(red), "i64")
        c = prim.segment_sum(valid.to(I64), gs, ng)
        if agg in ("sum", "avg"):
            f = data.to(F64) if col.kind == "f64" else data.to(I64)
            f = torch.where(valid, f, torch.zeros((), dtype=f.dtype,
                                                  device=dev))
            s = prim.segment_sum(f, gs, ng)
            if agg == "avg":
                sf = s.to(F64)
                if is_dec(col.kind):
                    sf = prim.true_div(sf, 10.0 ** col.scale)
                per_row = self._per_row(sf / c.clamp(min=1))
                return self._scatter(per_row, "f64",
                                     valid_sorted=self._per_row(c > 0))
            kind = ("f64" if col.kind == "f64"
                    else (f"dec(38,{col.scale})" if is_dec(col.kind) else "i64"))
            return self._scatter(self._per_row(s), kind,
                                 valid_sorted=self._per_row(c > 0))
        if agg in ("min", "max"):
            is_f = col.kind == "f64"
            big = float("inf") if is_f else prim.I64_MAX
            sent = -big if agg == "max" else big
            f = data.to(F64) if is_f else data.to(I64)
            f = torch.where(valid, f, torch.full((), sent, dtype=f.dtype,
                                                 device=dev))
            seg = prim.segment_max if agg == "max" else prim.segment_min
            per_row = self._per_row(seg(f, gs, ng))
            kind = "f64" if is_f else (col.kind if is_dec(col.kind) else "i64")
            return self._scatter(per_row, kind,
                                 valid_sorted=self._per_row(c > 0))
        raise ValueError(f"unsupported window aggregate: {agg}")

    def _segmented_scan(self, vals: torch.Tensor, op: str) -> torch.Tensor:
        """Inclusive scan of ``vals`` (already in sorted order) that resets at
        partition boundaries: a log-step (Hillis-Steele) scan over
        (reset-flag, value) pairs, one vectorized step per power of two."""
        if op == "sum":
            fn = torch.add
        elif op == "min":
            fn = torch.minimum
        elif op == "max":
            fn = torch.maximum
        else:
            raise ValueError(op)
        flags = self.part_boundary.clone()
        out = vals.clone()
        n = int(out.shape[0])
        d = 1
        while d < n:
            fb, vb = flags[d:], out[d:]
            va = out[:-d]
            new_v = torch.where(fb, vb, fn(va, vb))
            new_f = flags[:-d] | fb
            out = torch.cat([out[:d], new_v])
            flags = torch.cat([flags[:d], new_f])
            d *= 2
        return out

    def _range_extend(self, run: torch.Tensor) -> torch.Tensor:
        """RANGE frames include order-key peers: every row takes the scan
        value of the LAST row of its peer run."""
        rid = torch.cumsum(self.order_boundary.to(I64), 0) - 1
        # capacity bound, not exact count: avoids a host sync
        nruns = self.n
        last_pos = prim.segment_max(self.pos, rid, nruns)
        return prim.take(run, prim.take(last_pos, rid))

    def running_agg(self, col: Column, agg: str, rows_frame: bool = False) -> Column:
        """sum/count/avg/min/max over (partition ... order ... unbounded
        preceding .. current row). ``rows_frame`` selects ROWS semantics;
        the SQL default frame is RANGE (order-key peers included)."""
        col = col.plain()
        valid = prim.take(col.valid_mask(), self.order)
        data = prim.take(col.data, self.order)
        dev = data.device
        is_f = col.kind == "f64"
        f = data.to(F64) if is_f else data.to(I64)

        vcount = self._segmented_scan(valid.to(I64), "sum")
        if not rows_frame:
            vcount = self._range_extend(vcount)
        has_any = vcount > 0

        if agg == "count":
            return self._scatter(vcount, "i64")
        if agg in ("sum", "avg"):
            run = self._segmented_scan(
                torch.where(valid, f, torch.zeros((), dtype=f.dtype,
                                                  device=dev)), "sum")
            if not rows_frame:
                run = self._range_extend(run)
            if agg == "avg":
                sf = run.to(F64)
                if is_dec(col.kind):
                    sf = prim.true_div(sf, 10.0 ** col.scale)
                return self._scatter(sf / vcount.clamp(min=1), "f64",
                                     valid_sorted=has_any)
            kind = ("f64" if is_f
                    else (f"dec(38,{col.scale})" if is_dec(col.kind) else "i64"))
            return self._scatter(run, kind, valid_sorted=has_any)
        if agg in ("min", "max"):
            big = float("inf") if is_f else prim.I64_MAX
            sent = -big if agg == "max" else big
            run = self._segmented_scan(
                torch.where(valid, f, torch.full((), sent, dtype=f.dtype,
                                                 device=dev)), agg)
            if not rows_frame:
                run = self._range_extend(run)
            kind = "f64" if is_f else (col.kind if is_dec(col.kind) else "i64")
            return self._scatter(run, kind, valid_sorted=has_any)
        raise ValueError(f"unsupported running aggregate: {agg}")

    def running_sum(self, col: Column) -> Column:
        """Back-compat alias: ROWS-frame running sum."""
        return self.running_agg(col, "sum", rows_frame=True)
