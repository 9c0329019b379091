# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The grouped-aggregation kernels of the torch port (K1-K3) against the
reference: each plain version against ``nds_tpu.engine.kernels`` run under
``NDS_TPU_PALLAS=interpret`` and against the Pallas-off arm
(``ops._agg_*_impl``). The CUDA kernels themselves run only on a GPU
(``tests/test_torch_gpu.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nds_tpu.engine import kernels as RK
from nds_tpu.engine import ops as RO
from nds_tpu_torch.engine import kernels as K

torch.set_num_threads(1)   # tiny tensors: spare the other workers' cores

I64_MAX = np.iinfo(np.int64).max
I64_MIN = np.iinfo(np.int64).min


@pytest.fixture()
def interpret_mode(monkeypatch):
    monkeypatch.setenv("NDS_TPU_PALLAS", "interpret")


def _gids(rng, n, G, pads=True):
    """Group ids with nulls (-1), pads (>= G) and some empty groups."""
    g = rng.integers(0, G, size=n)
    if G > 4:
        g = np.where(g == 3, 2, g)                      # group 3 stays empty
    u = rng.random(n)
    g = np.where(u < 0.1, -1, g)
    if pads:
        g = np.where((u >= 0.1) & (u < 0.15), G + (g % 3), g)
    return g.astype(np.int64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- K1


@pytest.mark.parametrize("n,G", [(1000, 1), (3000, 37), (5000, 1000)])
def test_k1_matches_interpret_arm(interpret_mode, n, G):
    rng = np.random.default_rng(n + G)
    g = _gids(rng, n, G, pads=False)        # the Pallas tile needs gid < G
    v = rng.integers(-(1 << 40), 1 << 40, size=n).astype(np.int64)
    rs, rc = RK.segment_sum_exact(jnp.asarray(v), jnp.asarray(g.astype(
        np.int32)), G)
    ps, pc = K.segment_sum_i64(_t(v), _t(g), G)
    assert np.array_equal(np.asarray(rs), ps.numpy())
    assert np.array_equal(np.asarray(rc), pc.numpy())


@pytest.mark.parametrize("n,G", [(1000, 1), (4000, 100)])
def test_k1_matches_off_arm_with_pads_and_extremes(monkeypatch, n, G):
    monkeypatch.setenv("NDS_TPU_PALLAS", "off")
    rng = np.random.default_rng(7 * n + G)
    g = _gids(rng, n, G)
    v = rng.integers(I64_MIN, I64_MAX, size=n, dtype=np.int64)
    v[:6] = [I64_MAX, I64_MAX, I64_MIN, I64_MIN, -1, 1]
    valid = rng.random(n) > 0.2
    # the Pallas-off arm's decimal sum: _agg_sum_impl over the masked data
    # (it drops gid -1 and gid >= G like the port's kernel)
    out, nonempty = RO._agg_sum_impl(jnp.asarray(v), jnp.asarray(valid),
                                     jnp.asarray(g), G, False)
    ps, pc = K.segment_sum_i64(_t(np.where(valid, v, 0)),
                               _t(np.where(valid, g, -1)), G)
    assert np.array_equal(np.asarray(out), ps.numpy())
    assert np.array_equal(np.asarray(nonempty), (pc > 0).numpy())


def test_k1_extremes_wrap_like_reference(interpret_mode):
    """Every row at the domain extreme in one group (the reference's
    test_segment_sum_exact_extremes input) plus a sum that wraps."""
    n = 8192
    v = np.full(n, (1 << 52) + 12345, dtype=np.int64)
    v[::2] = -(1 << 52) - 99999
    g = np.zeros(n, dtype=np.int64)
    rs, rc = RK.segment_sum_exact(jnp.asarray(v), jnp.asarray(g.astype(
        np.int32)), 1)
    ps, pc = K.segment_sum_i64(_t(v), _t(g), 1)
    assert int(ps[0]) == int(rs[0]) == int(v.sum())
    assert int(pc[0]) == int(rc[0]) == n
    w = np.array([I64_MAX, I64_MAX, 5], dtype=np.int64)
    ps, _ = K.segment_sum_i64(_t(w), _t(np.zeros(3, dtype=np.int64)), 1)
    assert int(ps[0]) == int(w.sum())                    # wraps mod 2^64


# ---------------------------------------------------------------- K2


@pytest.mark.parametrize("n,G", [(2000, 1), (3000, 200)])
def test_k2_matches_interpret_arm(interpret_mode, n, G):
    rng = np.random.default_rng(3 * n + G)
    g = _gids(rng, n, G, pads=False)
    w = rng.integers(0, 100, size=n).astype(np.float64)
    rs, rc = RK.segment_sum_fused(jnp.asarray(w.astype(np.float32)),
                                  jnp.asarray(g.astype(np.int32)), G)
    ps, pc = K.segment_sum_f64(_t(w), _t(g), G)
    # the interpret arm accumulates in f32: rel 1e-5
    np.testing.assert_allclose(ps.numpy(), np.asarray(rs), rtol=1e-5)
    assert np.array_equal(pc.numpy(), np.asarray(rc).astype(np.int64))
    _, pc_only = K.segment_sum_f64(None, _t(g), G)
    assert torch.equal(pc_only, pc)


@pytest.mark.parametrize("n,G", [(2000, 1), (3000, 200)])
def test_k2_matches_off_arm(monkeypatch, n, G):
    monkeypatch.setenv("NDS_TPU_PALLAS", "off")
    rng = np.random.default_rng(5 * n + G)
    g = _gids(rng, n, G)
    w = rng.normal(scale=1000.0, size=n)
    valid = rng.random(n) > 0.2
    col = np.where(valid, w, 0.0)
    # sums: _agg_sum_impl (f64); counts: _agg_count_impl (int64); both
    # drop gid -1 and gid >= G, as the port's kernels do
    out, nonempty = RO._agg_sum_impl(jnp.asarray(col), jnp.asarray(valid),
                                     jnp.asarray(g), G, True)
    cnt = RO._agg_count_impl(jnp.asarray(valid), jnp.asarray(g), G)
    ps, pc = K.segment_sum_f64(_t(col), _t(np.where(valid, g, -1)), G)
    np.testing.assert_allclose(ps.numpy(), np.asarray(out), rtol=1e-12,
                               atol=1e-9)
    assert np.array_equal(pc.numpy(), np.asarray(cnt))
    assert np.array_equal(np.asarray(nonempty), (pc > 0).numpy())


# ---------------------------------------------------------------- K3


@pytest.mark.parametrize("n,G", [(2000, 1), (3000, 100)])
def test_k3_matches_interpret_arm(interpret_mode, n, G):
    rng = np.random.default_rng(11 * n + G)
    g = _gids(rng, n, G, pads=False)
    v = (rng.random(n) * 200 - 100).astype(np.float32).astype(np.float64)
    rmin, rmax = RK.segment_minmax_fused(jnp.asarray(v.astype(np.float32)),
                                         jnp.asarray(g.astype(np.int32)), G)
    pmin, pmax = K.segment_minmax_f64(_t(v), _t(g), G)
    has = np.bincount(g[g >= 0], minlength=G) > 0
    np.testing.assert_allclose(pmin.numpy()[has], np.asarray(rmin)[has],
                               rtol=1e-5)
    np.testing.assert_allclose(pmax.numpy()[has], np.asarray(rmax)[has],
                               rtol=1e-5)
    assert np.all(np.isposinf(pmin.numpy()[~has]))
    assert np.all(np.isneginf(pmax.numpy()[~has]))


@pytest.mark.parametrize("is_max", [False, True])
def test_k3_matches_off_arm_with_nan_and_signed_zero(monkeypatch, is_max):
    monkeypatch.setenv("NDS_TPU_PALLAS", "off")
    rng = np.random.default_rng(13 + is_max)
    n, G = 4000, 64
    g = _gids(rng, n, G)
    v = rng.normal(size=n)
    v[g == 5] = np.nan                     # a NaN group
    idx7 = np.nonzero(g == 7)[0]
    v[idx7] = 0.0
    v[idx7[::2]] = -0.0                    # signed zeros in one group
    valid = rng.random(n) > 0.2
    out, ok = RO._agg_min_impl(jnp.asarray(v), jnp.asarray(valid),
                               jnp.asarray(g), G, is_max)
    pmin, pmax = K.segment_minmax_f64(_t(v), _t(np.where(valid, g, -1)), G)
    mine = (pmax if is_max else pmin).numpy()
    ref = np.asarray(out)
    has = np.asarray(ok)
    # exact, bit for bit, on every non-empty group (NaN and -0.0 included)
    assert np.array_equal(mine[has].view(np.int64), ref[has].view(np.int64))
    assert np.isnan(mine[5])
    assert np.signbit(pmin.numpy()[7]) and not np.signbit(pmax.numpy()[7])


def test_launcher_refuses_host_tensors():
    """The raw launcher times a kernel alone: it never takes the plain
    version, so host tensors are refused."""
    g = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        K.launcher("segment_sum_i64", torch.zeros(8, dtype=torch.int64), g, 2)


# ---------------------------------------------------------------- wrappers


def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    K.reset_launches()
    g = torch.tensor([0, 1, -1, 2, 5], dtype=torch.int64)
    K.segment_sum_i64(torch.arange(5, dtype=torch.int64), g, 3)
    K.segment_sum_f64(torch.ones(5, dtype=torch.float64), g, 3)
    K.segment_minmax_f64(torch.ones(5, dtype=torch.float64), g, 3)
    assert K.LAUNCHES == {"segment_sum_i64": 0, "segment_sum_f64": 0,
                          "segment_minmax_f64": 0, "chunk_scan": 0,
                          "join_probe": 0}


def test_build_is_lazy_and_keyed_by_source_hash():
    # importing the module compiled nothing; the build dir is keyed by a
    # hash of the CUDA sources
    assert K._LIB is None
    assert K.source_hash() in K.build_dir()
