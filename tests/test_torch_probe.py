# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Host-side pieces of the redesigned K1 and K5 kernels, on the CPU.

K5 ``join_probe`` searches only the probe hash's bucket of a radix
directory over the sorted build hashes. ``probe_directory_plain`` is the
directory's plain version; here it is held against a line-for-line
mirror of the CUDA build loop (head, interior, tail), and a mirror of the
kernel's search (binary search inside ``dir[b] .. dir[b+1]``, then a
gallop) is held against ``searchsorted``'s bounds on awkward tables and
against the reference's ``probe_reference``. K1 ``segment_sum_i64`` picks
its path by the host rule ``segment_plan``; its cases pin path, grid and
shared bytes. The CUDA kernels themselves run on a GPU
(``tests/test_torch_gpu.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nds_tpu.engine import kernels as RK
from nds_tpu_torch.engine import kernels as K
from nds_tpu_torch.engine import ops as PO
from tests.test_torch_gpu import _probe_case, _t

torch.set_num_threads(1)   # tiny tensors: spare the other workers' cores

M64 = (1 << 64) - 1
SIGN = 1 << 63


def _bucket(key: int, bits: int) -> int:
    """csrc/join_probe.cu ``bucket_of``: the unsigned top bits of the
    unflipped hash of a bit-63-flipped signed key."""
    return ((key & M64) ^ SIGN) >> (64 - bits)


def _directory_like_kernel(rh, bits):
    """csrc/join_probe.cu ``probe_directory_kernel``, one thread at a
    time."""
    r, nb = len(rh), 1 << bits
    d = [None] * (nb + 1)
    first = _bucket(rh[0], bits) if r else nb
    last = _bucket(rh[r - 1], bits) if r else -1
    for t in range(max(r, nb + 1)):
        if t <= nb:
            if t <= first:
                d[t] = 0
            elif t > last:
                d[t] = r
        if 1 <= t < r:
            for b in range(_bucket(rh[t - 1], bits) + 1,
                           _bucket(rh[t], bits) + 1):
                d[b] = t
    return d


def _bounds_like_kernel(rh, d, bits, key):
    """csrc/join_probe.cu ``join_probe_kernel``'s search: (lo, hi)."""
    bk = _bucket(key, bits)
    end = d[bk + 1]
    b, e = d[bk], end
    while b < e:
        mid = b + ((e - b) >> 1)
        if rh[mid] < key:
            b = mid + 1
        else:
            e = mid
    lo = b
    e, p, step = end, lo, 1
    while p < end:
        if rh[p] > key:
            e = p
            break
        b = p + 1
        p, step = lo + step, step << 1
    while b < e:
        mid = b + ((e - b) >> 1)
        if rh[mid] <= key:
            b = mid + 1
        else:
            e = mid
    return lo, b


def _flipped(u):
    """Unsigned 64-bit hashes as the port stores them sorted: bit 63
    flipped, signed int64."""
    return (np.asarray(u, dtype=np.uint64) ^ np.uint64(SIGN)).view(np.int64)


def _build_hashes(keys, valid=None, n_live=None, excl=None):
    n = len(keys)
    return PO.unsigned_order(PO._key_hash_impl(
        (_t(keys),), (None if valid is None else _t(valid),), 1, False,
        n if n_live is None else n_live,
        None if excl is None else _t(excl)))


def _table(name):
    """(sorted flipped build hashes as int64 numpy, directory bits)."""
    rng = np.random.default_rng(len(name))
    if name == "random":
        rh = _build_hashes(rng.integers(0, 1 << 40, 3000))
    elif name == "all_duplicates":
        rh = _build_hashes(np.full(700, 42, dtype=np.int64))
    elif name == "all_sentinels":
        keys = rng.integers(0, 100, 900)
        rh = _build_hashes(keys, valid=np.zeros(900, dtype=bool))
    elif name == "sentinels_and_fanout":
        # null, excluded and pad build rows beside a fanout-4 key set
        keys = np.repeat(rng.integers(0, 1 << 30, 400), 4)
        valid = rng.random(1600) > 0.1
        excl = rng.random(1600) > 0.9
        rh = _build_hashes(keys, valid=valid, n_live=1500, excl=excl)
    elif name == "duplicates_straddle_bucket_edge":
        # runs of equal hashes on both sides of bucket edges at B = 10
        edges = [(b << 54) for b in (1, 2, 511, 512, 1023)]
        u = []
        for e in edges:
            u += [e - 1] * 3 + [e] * 3 + [e + 1]
        rh = torch.from_numpy(np.sort(_flipped(u)))
    elif name == "r0":
        rh = torch.zeros(0, dtype=torch.int64)
    elif name == "r1":
        rh = _build_hashes(np.array([7], dtype=np.int64))
    elif name == "bits_at_high_clamp":
        rh = _build_hashes(rng.integers(0, 1 << 50, (1 << 20) + 5))
    else:
        raise KeyError(name)
    rh = torch.sort(rh).values.numpy()
    return rh, K.probe_bits(len(rh))


_TABLES = ["random", "all_duplicates", "all_sentinels", "sentinels_and_fanout",
           "duplicates_straddle_bucket_edge", "r0", "r1",
           "bits_at_high_clamp"]


def _probe_keys(rh, rng):
    """Every table value and its neighbours, random hashes, probe-side
    sentinels and both extremes."""
    pick = rh if len(rh) <= 4000 else rng.choice(rh, 4000)
    keys = [int(x) for x in pick]
    keys += [k + 1 for k in keys[:500] if k < (1 << 63) - 1]
    keys += [k - 1 for k in keys[:500] if k > -(1 << 63)]
    keys += [int(x) for x in _flipped(rng.integers(0, 1 << 63, 300,
                                                   dtype=np.uint64) << 1)]
    keys += [int(x) for x in _flipped(2 + (np.arange(50, dtype=np.uint64)
                                           << 3))]
    return keys + [-(1 << 63), (1 << 63) - 1]


@pytest.mark.parametrize("name", _TABLES)
def test_directory_search_gives_searchsorted_bounds(name):
    rh, bits = _table(name)
    d = K.probe_directory_plain(torch.from_numpy(rh), bits).tolist()
    assert d == _directory_like_kernel(rh.tolist(), bits)
    assert len(d) == (1 << bits) + 1 and d[0] == 0 and d[-1] == len(rh)
    keys = _probe_keys(rh, np.random.default_rng(5))
    los = np.searchsorted(rh, np.array(keys, dtype=np.int64), "left")
    his = np.searchsorted(rh, np.array(keys, dtype=np.int64), "right")
    rl = rh.tolist()
    got = [_bounds_like_kernel(rl, d, bits, k) for k in keys]
    assert [g[0] for g in got] == los.tolist()
    assert [g[1] for g in got] == his.tolist()
    if name not in ("r0", "all_sentinels"):
        assert any(h > lo for lo, h in got)          # some keys match


def test_directory_search_matches_reference_probe():
    """The confined search over the port's build hashes gives the
    reference's ``probe_reference`` counts and starts for the same probe
    rows (null, pad and excluded rows included)."""
    n, r, n_valid = 700, 5000, 650
    lk, lv, excl, rk, rv = _probe_case(n, r, 1, 11)
    rh = torch.sort(PO.unsigned_order(PO._key_hash_impl(
        (_t(rk[0]),), (None,), 1, False, r - 9, None))).values
    ref_sorted = jnp.asarray((rh.numpy() ^ np.int64(-1 << 63))
                             .view(np.uint64))
    c_ref, lo_ref = RK.probe_reference((jnp.asarray(lk[0]),),
                                       (jnp.asarray(lv[0]),), n_valid,
                                       jnp.asarray(excl), ref_sorted)
    lh = PO.unsigned_order(PO._key_hash_impl(
        (_t(lk[0]),), (_t(lv[0]),), 0, False, n_valid, _t(excl)))
    bits = K.probe_bits(r)
    d = K.probe_directory_plain(rh, bits).tolist()
    rl = rh.tolist()
    got = [_bounds_like_kernel(rl, d, bits, k) for k in lh.tolist()]
    np.testing.assert_array_equal([g[0] for g in got], np.asarray(lo_ref))
    np.testing.assert_array_equal([g[1] - g[0] for g in got],
                                  np.asarray(c_ref))
    assert int(np.asarray(c_ref).sum()) > 0


@pytest.mark.parametrize("r,bits", [
    (0, 10), (1, 10), (1024, 10), (1025, 11), (102_000, 17),
    (1 << 20, 20), ((1 << 20) + 1, 20)])
def test_probe_bits_is_ceil_log2_clamped(r, bits):
    assert K.probe_bits(r) == bits


SF1 = 2_880_404


@pytest.mark.parametrize("n,G,path,grid,smem", [
    (SF1, 0, "empty", 0, 0),
    (0, 1000, "empty", 0, 0),
    (SF1, 1, "private", 132 * 2, 16),
    (SF1, 1000, "private", 132 * 2, 16_000),
    (SF1, 8192, "private", 132, 16 * 8192),
    (SF1, K.G_PRIV, "private", 132, 16 * K.G_PRIV),
    (SF1, K.G_PRIV + 1, "global", 132 * 64, 0),
    (SF1, 100_000, "global", 132 * 64, 0),
    (1001, 1, "private", 1, 16),
    (1001, 100_000, "global", 4, 0),
])
def test_segment_plan_picks_path_grid_and_shared_bytes(n, G, path, grid,
                                                       smem):
    assert K.segment_plan(n, G, sms=132) == K.SegmentPlan(path, grid, smem)


def test_segment_plan_keeps_a_block_under_227_kb():
    cap_groups = K.SMEM_BLOCK_CAP // 16                   # 14,528 groups
    big = 10 ** 6
    at_cap = K.segment_plan(SF1, cap_groups, g_priv=big)
    assert at_cap == K.SegmentPlan("private", 132, K.SMEM_BLOCK_CAP)
    assert K.segment_plan(SF1, cap_groups + 1, g_priv=big).path == "global"
    for G in range(1, cap_groups + 1, 997):
        p = K.segment_plan(SF1, G, g_priv=big, per_sm=8)
        per_sm = p.grid // 132
        assert p.smem == 16 * G <= K.SMEM_BLOCK_CAP
        assert per_sm * (p.smem + K.SMEM_RESERVED) <= K.SMEM_SM


def test_cpu_segment_sum_i64_takes_the_plain_version_at_every_plan():
    """On the CPU the wrapper computes the plain version whatever path the
    card would take; it counts nothing."""
    rng = np.random.default_rng(9)
    K.reset_launches()
    for G in (1, 2, 1000, K.G_PRIV, K.G_PRIV + 1):
        g = rng.integers(-1, G + 2, 5000)
        v = rng.integers(-(1 << 62), 1 << 62, 5000)
        s, c = K.segment_sum_i64(_t(v), _t(g), G)
        ok = (g >= 0) & (g < G)
        want_c = np.bincount(g[ok], minlength=G)
        want_s = np.zeros(G, dtype=np.int64)
        np.add.at(want_s, g[ok], v[ok])
        assert np.array_equal(c.numpy(), want_c)
        assert np.array_equal(s.numpy(), want_s)
    assert K.LAUNCHES["segment_sum_i64"] == 0
