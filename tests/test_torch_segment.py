# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Host-side pieces of the grouped-aggregation kernels K1-K3, on the CPU.

All three pick their path by one host rule, ``segment_plan``, from the
group count and the shared-memory bytes a group takes (16 for K1, K2 with
values and K3; 4 for a count-only K2 launch); its cases pin path, grid
and shared bytes at the edges. The 8-byte cases take no kernel: they pin
the rule's arithmetic at a width between the two. On the private path
every block reduces its own rows into shared memory and folds its
non-empty groups into global memory; a mirror of that split and merge,
built from the plain version's keys, must give the plain version's bits
whatever the rows' split into blocks. The CUDA kernels themselves run on
a GPU (``tests/test_torch_gpu.py``)."""

import numpy as np
import pytest
import torch

from nds_tpu_torch.engine import kernels as K
from tests.test_torch_gpu import _gids, _t

torch.set_num_threads(1)   # tiny tensors: spare the other workers' cores

SF1 = 2_880_404
CAP = {gb: K.SMEM_BLOCK_CAP // gb for gb in (16, 8, 4)}


@pytest.mark.parametrize("gb", [16, 8, 4])
@pytest.mark.parametrize("edge", ["G=0", "G=1", "cap", "cap+1"])
def test_segment_plan_at_the_edges(gb, edge):
    cap = CAP[gb]
    G = {"G=0": 0, "G=1": 1, "cap": cap, "cap+1": cap + 1}[edge]
    want = {"G=0": K.SegmentPlan("empty", 0, 0),
            "G=1": K.SegmentPlan("private", 132 * K.PRIV_PER_SM, gb),
            # a full block leaves room for one block an SM
            "cap": K.SegmentPlan("private", 132, K.SMEM_BLOCK_CAP),
            "cap+1": K.SegmentPlan("global", 132 * 64, 0)}[edge]
    assert K.segment_plan(SF1, G, sms=132, group_bytes=gb) == want
    assert K.segment_plan(0, G, sms=132, group_bytes=gb).path == "empty"


def test_the_caps_are_the_shared_memory_caps():
    assert (CAP[16], CAP[8], CAP[4]) == (K.G_PRIV, 29_056, 58_112)
    # g_priv, where given, lowers the cap; it never raises it past the
    # shared memory
    assert K.segment_plan(SF1, 1000, g_priv=999).path == "global"
    assert K.segment_plan(SF1, CAP[16] + 1, g_priv=1 << 30).path == "global"


@pytest.mark.parametrize("gb", [16, 8, 4])
def test_segment_plan_keeps_blocks_within_the_shared_memory(gb):
    for G in list(range(1, CAP[gb] + 1, 997)) + [CAP[gb]]:
        for per_sm in (1, 2, 4, 8):
            p = K.segment_plan(SF1, G, per_sm=per_sm, group_bytes=gb)
            blocks_an_sm = p.grid // 132
            assert p.path == "private"
            assert p.smem == gb * G <= K.SMEM_BLOCK_CAP
            assert 1 <= blocks_an_sm <= per_sm
            assert blocks_an_sm * (p.smem + K.SMEM_RESERVED) <= K.SMEM_SM


@pytest.mark.parametrize("gb", [16, 4])
@pytest.mark.parametrize("n,G,grids", [
    (SF1, 1, [132, 264, 396, 528]),
    (SF1, 1000, [132, 264, 396, 528]),
    # few rows: at most one block per 1,024 rows, so fewer distinct grids
    (3000, 1, [3]),
    (200_000, 16, [132, 196]),
    (SF1, "cap", [132]),
    (SF1, "cap+1", []),
])
def test_segment_plans_are_the_sweep_plans(gb, n, G, grids):
    """The sweep's plans: the private path at each of 1-4 blocks an SM,
    each grid once and none above the cap, then the global path."""
    G = {"cap": CAP[gb], "cap+1": CAP[gb] + 1}.get(G, G)
    plans = K.segment_plans(n, G, 132, group_bytes=gb)
    assert [p.grid for p in plans[:-1]] == grids
    assert all(p == K.SegmentPlan("private", p.grid, gb * G)
               for p in plans[:-1])
    assert plans[-1] == K.segment_plan(n, G, 132, g_priv=0)
    assert plans[-1].path == "global"


# ------------------------------------------------- the private path's merge


def _blocks_of_rows(n, grid, threads):
    """csrc/segment_agg.cu ``seg_priv_kernel`` with 16-byte loads: unit u
    (rows 2u and 2u + 1) goes to thread u mod (grid x threads) and so to
    its block; an odd row count's last row to block 0."""
    units = np.arange(n // 2)
    block = (units % (grid * threads)) // threads
    rows = np.empty(n, dtype=np.int64)
    rows[0:2 * len(units):2] = block
    rows[1:2 * len(units):2] = block
    if n % 2:
        rows[n - 1] = 0
    return rows


def _merge_like_kernel(values, gids, G, grid, threads):
    """The private path of K3 and of a count-only K2 in the plain
    version's terms: each block's keys and counts over its own rows, then
    the flush of each block's groups off the identity into global keys
    that start at the identity (min keys by min, max keys by max, counts
    by addition)."""
    blocks = _blocks_of_rows(len(gids), grid, threads)
    kmin = torch.full((G,), K._KEY_MAX, dtype=torch.int64)
    kmax = torch.full((G,), K._KEY_MIN, dtype=torch.int64)
    counts = torch.zeros(G, dtype=torch.int64)
    for b in range(grid):
        mine = torch.from_numpy(blocks == b)
        bmin, bmax = K.minmax_keys_plain(values[mine], gids[mine], G)
        _, bcnt = K.segment_sum_f64_plain(None, gids[mine], G)
        lo, hi = bmin != K._KEY_MAX, bmax != K._KEY_MIN
        kmin[lo] = torch.minimum(kmin[lo], bmin[lo])
        kmax[hi] = torch.maximum(kmax[hi], bmax[hi])
        counts += bcnt
    return K.decode_minmax_keys(kmin, kmax), counts


def _boundary_case(n, G, threads, seed):
    """Rows whose values put NaN, -0.0, +0.0 and both infinities on both
    sides of every block boundary, into groups that span the boundaries;
    null and pad group ids; group 3 (G > 4) empty."""
    rng = np.random.default_rng(seed)
    g = _gids(rng, n, G)
    v = rng.standard_normal(n) * 100.0
    special = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, -0.0, 0.0])
    for edge in range(0, n, 2 * threads):
        for k, x in enumerate(special):
            i = edge - 3 + k
            if 0 <= i < n:
                v[i] = x
                g[i] = (k + edge // (2 * threads)) % min(G, 2)
    v[-1] = -0.0                       # the odd tail row
    g[-1] = 0
    return _t(v), _t(g)


@pytest.mark.parametrize("G", [1, 2, 7, 1000])
@pytest.mark.parametrize("grid", [1, 3, 8])
def test_block_partial_merge_equals_the_plain_version(G, grid):
    threads = 4                        # many block boundaries in few rows
    v, g = _boundary_case(2001, G, threads, G * 31 + grid)
    (mins, maxs), counts = _merge_like_kernel(v, g, G, grid, threads)
    pmin, pmax = K.segment_minmax_f64_plain(v, g, G)
    assert torch.equal(mins.view(torch.int64), pmin.view(torch.int64))
    assert torch.equal(maxs.view(torch.int64), pmax.view(torch.int64))
    assert torch.equal(counts, K.segment_sum_f64_plain(None, g, G)[1])
    if G >= 2:
        assert bool(torch.isnan(mins[:2]).all())      # a NaN wins both
        assert bool(torch.isnan(maxs[:2]).all())
    if G == 1000:
        assert float(mins[3]) == np.inf and float(maxs[3]) == -np.inf


def test_signed_zeros_merge_across_blocks():
    """-0.0 in one block and +0.0 in another: the min is -0.0 and the max
    +0.0, whichever block flushes first."""
    v = _t(np.array([0.0, 0.0, -0.0, -0.0, 0.0, 0.0, -0.0, -0.0]))
    g = _t(np.zeros(8, dtype=np.int64))
    for grid in (1, 2, 4):
        (mins, maxs), _ = _merge_like_kernel(v, g, 1, grid, 1)
        assert np.signbit(float(mins[0])) and not np.signbit(float(maxs[0]))


# ------------------------------------------------------ launchers, wrappers


@pytest.mark.parametrize("name,with_values", [
    ("segment_sum_f64", False), ("segment_sum_f64", True),
    ("segment_minmax_f64", True)])
def test_launcher_refuses_host_tensors(name, with_values):
    g = torch.zeros(8, dtype=torch.int64)
    v = torch.zeros(8, dtype=torch.float64) if with_values else None
    with pytest.raises(ValueError, match="CUDA"):
        K.launcher(name, v, g, 2)


@pytest.mark.parametrize("G", [1, K.G_PRIV + 1])
def test_cpu_wrappers_take_the_plain_versions_at_every_plan(G):
    """On the CPU the K2 and K3 wrappers compute the plain versions
    whatever path the card would take (at G = 1 the private path for all;
    past G_PRIV the global path, and private for count-only), and count
    nothing."""
    rng = np.random.default_rng(G)
    n = 3000
    g = rng.integers(-1, G + 2, n)
    v = rng.standard_normal(n)
    v[::97] = np.nan
    v[1::89] = -0.0
    K.reset_launches()
    s, c = K.segment_sum_f64(_t(v), _t(g), G)
    s0, c0 = K.segment_sum_f64(None, _t(g), G)
    mn, mx = K.segment_minmax_f64(_t(v), _t(g), G)
    ok = (g >= 0) & (g < G)
    want_c = np.bincount(g[ok], minlength=G)
    assert np.array_equal(c.numpy(), want_c)
    assert np.array_equal(c0.numpy(), want_c) and not bool(s0.any())
    ps, _ = K.segment_sum_f64_plain(_t(v), _t(g), G)
    assert torch.equal(s.view(torch.int64), ps.view(torch.int64))
    pmn, pmx = K.segment_minmax_f64_plain(_t(v), _t(g), G)
    assert torch.equal(mn.view(torch.int64), pmn.view(torch.int64))
    assert torch.equal(mx.view(torch.int64), pmx.view(torch.int64))
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)
