"""Factored RESCAL shared-pool gradients + the outer-product scatter.

`pairwise_grads_shared_bilinear` (training.py) hand-derives RESCAL's W
cotangent in rank-1 factored form; it must be EXACTLY the reference math
over the fully expanded pair list — the same oracle contract as
tests/test_shared.py pins for the generic autodiff path.
"""

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from skge_tpu import training  # noqa: E402
from skge_tpu.models import RESCAL  # noqa: E402
from skge_tpu.optim import AdaGrad  # noqa: E402
from skge_tpu.sampling import SharedNegativeSampler  # noqa: E402
from test_parity import (  # noqa: E402
    B, CASES, LR, N_E, make_batch, make_params, oracle_apply, to_jax,
)
from test_shared import K, expanded_pairs  # noqa: E402


@pytest.mark.parametrize("aggregate", ["unique", "dense"])
def test_factored_bilinear_matches_oracle(aggregate):
    model = CASES["rescal"][0]()
    assert model.factored_pool_grads
    margin = 0.8
    prm = make_params(model.name)
    oracle = CASES["rescal"][1](prm, margin=margin)
    pos = make_batch(seed=23)
    rng = np.random.default_rng(24)
    pool = rng.integers(0, N_E, K)

    pxs, nxs = expanded_pairs(pos, pool, (0, 1))
    grads, nviol = oracle.pairwise_gradients(pxs, nxs)
    assert nviol > 0
    want_prm, want_p2 = oracle_apply(
        grads, {k: v.copy() for k, v in prm.items()}, model
    )

    opt = AdaGrad(lr=LR)
    jprm = to_jax(prm)
    ost = opt.init(jprm)
    loss, jnviol, occ, g_dense = training.pairwise_grads_shared_bilinear(
        model, jprm, jnp.asarray(pos), jnp.asarray(pool),
        jnp.ones(B, jnp.float64), margin,
    )
    new_prm, new_ost = training.apply_gradients(
        model, opt, jprm, ost, occ, g_dense, aggregate, premasked=True
    )

    assert int(jnviol) == nviol
    # loss agrees with the generic path
    gloss, _, _, _ = training.pairwise_grads_shared(
        model, jprm, jnp.asarray(pos), jnp.asarray(pool),
        jnp.ones(B, jnp.float64), margin,
    )
    np.testing.assert_allclose(float(loss), float(gloss), rtol=1e-12)
    for k in prm:
        np.testing.assert_allclose(
            np.asarray(new_prm[k]), want_prm[k], rtol=1e-9, atol=1e-11,
            err_msg=f"param {k}",
        )
        np.testing.assert_allclose(
            np.asarray(new_ost[k]["p2"]), want_p2[k], rtol=1e-9, atol=1e-11,
            err_msg=f"p2 {k}",
        )


def test_factored_respects_batch_mask():
    model = CASES["rescal"][0]()
    margin = 0.8
    prm = make_params("rescal")
    oracle = CASES["rescal"][1](prm, margin=margin)
    pos = make_batch(seed=31)
    rng = np.random.default_rng(32)
    pool = rng.integers(0, N_E, K)
    mask = np.ones(B)
    mask[::3] = 0.0
    keep = [b for b in range(B) if mask[b] > 0]

    pxs, nxs = expanded_pairs(pos, pool, (0, 1), keep=keep)
    grads, nviol = oracle.pairwise_gradients(pxs, nxs)
    want_prm, want_p2 = oracle_apply(
        grads, {k: v.copy() for k, v in prm.items()}, model
    )

    opt = AdaGrad(lr=LR)
    jprm = to_jax(prm)
    ost = opt.init(jprm)
    _, jnviol, occ, g_dense = training.pairwise_grads_shared_bilinear(
        model, jprm, jnp.asarray(pos), jnp.asarray(pool),
        jnp.asarray(mask), margin,
    )
    new_prm, new_ost = training.apply_gradients(
        model, opt, jprm, ost, occ, g_dense, "dense", premasked=True
    )
    assert int(jnviol) == nviol
    for k in prm:
        np.testing.assert_allclose(
            np.asarray(new_prm[k]), want_prm[k], rtol=1e-9, atol=1e-11
        )
        np.testing.assert_allclose(
            np.asarray(new_ost[k]["p2"]), want_p2[k], rtol=1e-9, atol=1e-11
        )


@pytest.mark.parametrize("mode", [(0,), (1,), (0, 1)])
def test_factored_single_modes(mode):
    """Subject-only / object-only corruption agrees with the generic path."""
    model = CASES["rescal"][0]()
    margin = 0.8
    prm = make_params("rescal", seed=5)
    pos = make_batch(seed=41)
    rng = np.random.default_rng(42)
    pool = rng.integers(0, N_E, K)
    jprm = to_jax(prm)
    mask = jnp.ones(B, jnp.float64)

    opt = AdaGrad(lr=LR)
    args = (jprm, jnp.asarray(pos), jnp.asarray(pool), mask, margin)
    gl, gn, gocc, gdense = training.pairwise_grads_shared(
        model, *args, modes=mode
    )
    fl, fn, focc, fdense = training.pairwise_grads_shared_bilinear(
        model, *args, modes=mode
    )
    np.testing.assert_allclose(float(fl), float(gl), rtol=1e-12)
    assert int(fn) == int(gn)
    a = training.apply_gradients(
        model, opt, jprm, opt.init(jprm), gocc, gdense, "dense",
        premasked=True,
    )
    b = training.apply_gradients(
        model, opt, jprm, opt.init(jprm), focc, fdense, "dense",
        premasked=True,
    )
    for k in jprm:
        np.testing.assert_allclose(
            np.asarray(b[0][k]), np.asarray(a[0][k]), rtol=1e-9, atol=1e-12
        )


def test_step_dispatches_to_factored(monkeypatch):
    """make_pairwise_step routes RESCAL+pool samplers to the factored path."""
    calls = {}
    orig = training.pairwise_grads_shared_bilinear

    def spy(*a, **kw):
        calls["hit"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(training, "pairwise_grads_shared_bilinear", spy)
    model = RESCAL(N_E, 4, 6, dtype="float64")
    opt = AdaGrad(lr=LR)
    sampler = SharedNegativeSampler(N_E, k=K)
    step = training.make_pairwise_step(model, opt, sampler, margin=0.5)
    state = training.init_state(model, opt, jax.random.PRNGKey(0))
    batch = jnp.asarray(make_batch(seed=7))
    state, m = step(state, batch, jnp.ones(B, jnp.float64))
    assert calls.get("hit")
    assert np.isfinite(float(m.loss))


@pytest.mark.parametrize("aggregate", ["unique", "dense"])
def test_factored_pointwise_matches_oracle(aggregate):
    """Logistic loss over the (positives + all pool corruptions) expansion,
    via the factored bilinear path."""
    model = CASES["rescal"][0]()
    prm = make_params(model.name)
    oracle = CASES["rescal"][1](prm)
    pos = make_batch(seed=41)
    rng = np.random.default_rng(42)
    pool = rng.integers(0, N_E, K)
    mask = np.ones(B)
    mask[::4] = 0.0
    keep = [b for b in range(B) if mask[b] > 0]

    xys = [(tuple(map(int, pos[b])), 1.0) for b in keep]
    for mode in (0, 1):
        for k in range(K):
            for b in keep:
                neg = pos[b].copy()
                neg[mode] = pool[k]
                xys.append((tuple(map(int, neg)), -1.0))
    grads, _ = oracle.gradients(xys)
    want_prm, want_p2 = oracle_apply(
        grads, {k: v.copy() for k, v in prm.items()}, model
    )

    opt = AdaGrad(lr=LR)
    jprm = to_jax(prm)
    ost = opt.init(jprm)
    loss, occ, g_dense = training.pointwise_grads_shared_bilinear(
        model, jprm, jnp.asarray(pos), jnp.asarray(pool), jnp.asarray(mask)
    )
    gloss, _, _ = training.pointwise_grads_shared(
        model, jprm, jnp.asarray(pos), jnp.asarray(pool), jnp.asarray(mask)
    )
    np.testing.assert_allclose(float(loss), float(gloss), rtol=1e-12)
    new_prm, new_ost = training.apply_gradients(
        model, opt, jprm, ost, occ, g_dense, aggregate, premasked=True
    )
    for k in prm:
        np.testing.assert_allclose(
            np.asarray(new_prm[k]), want_prm[k], rtol=1e-9, atol=1e-11,
            err_msg=f"param {k}",
        )
        np.testing.assert_allclose(
            np.asarray(new_ost[k]["p2"]), want_p2[k], rtol=1e-9, atol=1e-11,
            err_msg=f"p2 {k}",
        )
