"""Dense gradient aggregation against a NumPy oracle: `segment_mean_dense`
(XLA scatter and the sorted one-hot path) and the factored outer-product
scatter `segment_outer_mean_dense`, at the shapes, tails, padding and wide
rows the training paths produce."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from skge_tpu import training
from skge_tpu.ops.aggregate import (
    FactoredOcc,
    segment_mean_dense,
    segment_outer_mean_dense,
)


def oracle_mean(idx, g, m, r, premasked=False):
    """Masked duplicate-index mean; ids outside [0, r) are dropped."""
    g = np.asarray(g, np.float64)
    m = np.asarray(m, np.float64)
    w = g if premasked else g * m.reshape((-1,) + (1,) * (g.ndim - 1))
    ok = (idx >= 0) & (idx < r)
    gsum = np.zeros((r,) + g.shape[1:])
    cnt = np.zeros(r)
    np.add.at(gsum, idx[ok], w[ok])
    np.add.at(cnt, idx[ok], m[ok])
    return gsum / np.maximum(cnt, 1.0).reshape((-1,) + (1,) * (g.ndim - 1)), cnt


def _case(t, r, feat, seed, dtype=np.float32, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    idx = rng.integers(lo, r if hi is None else hi, t).astype(np.int32)
    g = rng.standard_normal((t,) + tuple(feat)).astype(dtype)
    m = (rng.random(t) < 0.7).astype(dtype)
    return idx, g, m


@pytest.mark.parametrize("backend", ["xla", "sorted"])
@pytest.mark.parametrize("t,r,d", [
    (64, 16, 8), (1000, 37, 152), (4096, 200, 24),
    (1500, 50, 16),  # occurrence count that is no power of two
])
def test_segment_mean_dense_matches_oracle(t, r, d, backend):
    idx, g, m = _case(t, r, (d,), seed=t + d)
    got = segment_mean_dense(jnp.asarray(idx), jnp.asarray(g),
                             jnp.asarray(m), r, backend=backend)
    want, cnt = oracle_mean(idx, g, m, r)
    np.testing.assert_allclose(np.asarray(got.count), cnt, rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(got.grads), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("backend", ["xla", "sorted"])
def test_segment_mean_dense_drops_out_of_range(backend):
    """Ids >= num_rows (the padding convention) contribute neither
    gradient nor count."""
    idx, g, m = _case(512, 20, (16,), seed=1, hi=24)
    idx[::5] = 20
    got = segment_mean_dense(jnp.asarray(idx), jnp.asarray(g),
                             jnp.asarray(m), 20, backend=backend)
    want, cnt = oracle_mean(idx, g, m, 20)
    np.testing.assert_array_equal(np.asarray(got.count), cnt)
    np.testing.assert_allclose(np.asarray(got.grads), want, rtol=1e-5,
                               atol=1e-5)


def test_segment_mean_dense_premasked_counts():
    """premasked=True: grads are already weighted sums and `mask` holds
    occurrence counts (possibly > 1), as the fused train step emits."""
    idx, g, _ = _case(300, 12, (6,), seed=2)
    counts = np.random.default_rng(3).integers(0, 3, 300).astype(np.float32)
    got = segment_mean_dense(jnp.asarray(idx), jnp.asarray(g),
                             jnp.asarray(counts), 12, premasked=True)
    want, cnt = oracle_mean(idx, g, counts, 12, premasked=True)
    np.testing.assert_array_equal(np.asarray(got.count), cnt)
    np.testing.assert_allclose(np.asarray(got.grads), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_segment_mean_dense_wide_rows(dtype):
    """Rows of >= 4096 features ((d, d) relation slices) take the split
    grads/counts path: the one-hot matmul for small float32 tables, XLA's
    scatter otherwise."""
    idx, g, m = _case(300, 9, (64, 64), seed=4, dtype=dtype, hi=11)
    got = segment_mean_dense(jnp.asarray(idx), jnp.asarray(g),
                             jnp.asarray(m), 9)
    want, cnt = oracle_mean(idx, g, m, 9)
    assert got.grads.shape == (9, 64, 64)
    np.testing.assert_array_equal(np.asarray(got.count), cnt)
    np.testing.assert_allclose(np.asarray(got.grads), want, rtol=1e-5,
                               atol=1e-5)


def test_segment_mean_dense_rejects_unknown_backend():
    idx, g, m = _case(8, 4, (2,), seed=5)
    with pytest.raises(ValueError, match="unknown segment backend"):
        segment_mean_dense(jnp.asarray(idx), jnp.asarray(g),
                           jnp.asarray(m), 4, backend="bogus")


def oracle_outer(idx, us, vs, count, r):
    d = us[0].shape[1]
    gsum = np.zeros((r, d, d))
    cnt = np.zeros(r)
    for i in range(idx.shape[0]):
        if 0 <= idx[i] < r:
            for u, v in zip(us, vs):
                gsum[idx[i]] += np.outer(u[i], v[i])
            cnt[idx[i]] += count[i]
    return gsum / np.maximum(cnt, 1.0)[:, None, None], cnt


@pytest.mark.parametrize("rank,t,d,r", [
    (1, 512, 36, 17), (2, 512, 36, 17), (1, 64, 300, 11),
])
def test_segment_outer_mean_dense_matches_oracle(rank, t, d, r):
    rng = np.random.default_rng(rank * d)
    idx = rng.integers(0, r, t).astype(np.int32)
    us = tuple(rng.standard_normal((t, d)).astype(np.float32)
               for _ in range(rank))
    vs = tuple(rng.standard_normal((t, d)).astype(np.float32)
               for _ in range(rank))
    count = rng.integers(1, 3, t).astype(np.float32)
    got = segment_outer_mean_dense(FactoredOcc(
        jnp.asarray(idx), tuple(map(jnp.asarray, us)),
        tuple(map(jnp.asarray, vs)), jnp.asarray(count)), r)
    want, cnt = oracle_outer(idx, us, vs, count, r)
    np.testing.assert_array_equal(np.asarray(got.count), cnt)
    np.testing.assert_allclose(np.asarray(got.grads), want, rtol=2e-5,
                               atol=2e-4)


def test_segment_outer_mean_dense_drops_out_of_range():
    rng = np.random.default_rng(6)
    t, d, r = 256, 8, 11
    idx = rng.integers(0, r + 3, t).astype(np.int32)
    u = rng.standard_normal((t, d)).astype(np.float32)
    v = rng.standard_normal((t, d)).astype(np.float32)
    count = np.ones(t, np.float32)
    got = segment_outer_mean_dense(FactoredOcc(
        jnp.asarray(idx), (jnp.asarray(u),), (jnp.asarray(v),),
        jnp.asarray(count)), r)
    want, cnt = oracle_outer(idx, (u,), (v,), count, r)
    np.testing.assert_array_equal(np.asarray(got.count), cnt)
    np.testing.assert_allclose(np.asarray(got.grads), want, rtol=2e-5,
                               atol=2e-4)


def _rescal_step_inputs():
    from skge_tpu import AdaGrad, RESCAL, init_state

    model = RESCAL(30, 4, 6, dtype="float64")
    opt = AdaGrad(lr=0.1)
    state = init_state(model, opt, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    pos = jnp.asarray(np.stack([rng.integers(0, 30, 40),
                                rng.integers(0, 30, 40),
                                rng.integers(0, 4, 40)], 1).astype(np.int32))
    pool = jnp.asarray(rng.integers(0, 30, 12).astype(np.int32))
    mask = jnp.ones(40)
    _, _, occ, g_dense = training.pairwise_grads_shared_bilinear(
        model, state.params, pos, pool, mask, 1.0)
    return model, opt, state, occ, g_dense


def test_factored_rescal_dense_equals_unique():
    """The factored W occurrences give the same update through the dense
    outer-product scatter as through the batch-local unique path."""
    model, opt, state, occ, g_dense = _rescal_step_inputs()
    assert isinstance(occ["W"], FactoredOcc)
    out = {
        agg: training.apply_gradients(
            model, opt, state.params, state.opt_state, occ, g_dense, agg,
            premasked=True)
        for agg in ("dense", "unique")
    }
    for k in state.params:
        np.testing.assert_allclose(
            np.asarray(out["dense"][0][k]), np.asarray(out["unique"][0][k]),
            rtol=1e-12, atol=1e-12, err_msg=k)
        np.testing.assert_allclose(
            np.asarray(out["dense"][1][k]["p2"]),
            np.asarray(out["unique"][1][k]["p2"]),
            rtol=1e-12, atol=1e-12, err_msg=k)


def test_apply_gradients_rejects_unknown_aggregate():
    model, opt, state, occ, g_dense = _rescal_step_inputs()
    with pytest.raises(ValueError, match="unknown aggregate mode"):
        training.apply_gradients(model, opt, state.params, state.opt_state,
                                 occ, g_dense, "dense_bogus",
                                 premasked=True)
