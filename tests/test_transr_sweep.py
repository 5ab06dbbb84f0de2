"""TransR quadratic candidate sweep: fp64 parity against the definitional
per-triple projection form (`sweep='direct'`), forward AND gradient, on both
the single-chunk (shared-pool) and multi-chunk (all-entity eval) shapes.

The quadratic sweep (models/transr.py `_sweep_quadratic`) expands
-||q - Me||^2 into two large matmuls — exact algebra, so fp64 agreement
to ~1e-12 is the contract (VERDICT round-2 item 5: >=5x over the direct
form at the FB15k bench shape with fp64 parity; measured speedup recorded
in RESULTS.md)."""

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from skge_tpu import TransR  # noqa: E402

N_E, N_R, D, B, K = 31, 5, 7, 18, 11


def build(n_e=N_E, rcomp=0, seed=0):
    mq = TransR(n_e, N_R, D, rcomp=rcomp, dtype="float64")
    md = TransR(n_e, N_R, D, rcomp=rcomp, dtype="float64", sweep="direct")
    assert mq.sweep == "quadratic"  # the default
    rng = np.random.default_rng(seed + 100)
    params = dict(mq.init_params(jax.random.PRNGKey(seed)))
    # identity init degenerates to TransE; randomize M to test the full form
    params["M"] = jnp.asarray(
        rng.normal(size=np.asarray(params["M"]).shape) * 0.5
    )
    return mq, md, params


def triples(n_e, b=B, seed=1):
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.integers(0, n_e, b)),
            jnp.asarray(rng.integers(0, n_e, b)),
            jnp.asarray(rng.integers(0, N_R, b)))


@pytest.mark.parametrize("rcomp", [0, 9])
def test_pool_and_eval_sweeps_match_direct(rcomp):
    mq, md, params = build(rcomp=rcomp)
    s, o, p = triples(N_E)
    rng = np.random.default_rng(2)
    pool = jnp.asarray(rng.integers(0, N_E, K))
    rows = mq.gather_rows(params, s, o, p)
    for mode in (0, 1):
        a = np.asarray(mq.score_pool(rows, params["E"][pool], {}, mode))
        b = np.asarray(md.score_pool(rows, params["E"][pool], {}, mode))
        np.testing.assert_allclose(a, b, rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(mq.score_all_o(params, s, p)),
        np.asarray(md.score_all_o(params, s, p)), rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(mq.score_all_s(params, o, p)),
        np.asarray(md.score_all_s(params, o, p)), rtol=1e-11, atol=1e-12)


def test_gradients_match_direct():
    mq, md, params = build(seed=3)
    s, o, p = triples(N_E, seed=4)
    pool = jnp.asarray(np.random.default_rng(5).integers(0, N_E, K))

    def loss(P, model):
        rows = model.gather_rows(P, s, o, p)
        l = 0.0
        for mode in (0, 1):
            sc = model.score_pool(rows, P["E"][pool], {}, mode)
            l = l + jnp.sum(jax.nn.relu(1.0 - sc))
        return l

    ga = jax.grad(loss)(params, mq)
    gb = jax.grad(loss)(params, md)
    for k in params:
        np.testing.assert_allclose(
            np.asarray(ga[k]), np.asarray(gb[k]), rtol=1e-10, atol=1e-12)


def test_multichunk_eval_sweep_matches_direct():
    """n_entities > the 2048 candidate chunk exercises the lax.map +
    checkpoint branch of the quadratic sweep."""
    n_e = 2048 + 37
    mq, md, params = build(n_e=n_e, seed=6)
    s, o, p = triples(n_e, b=4, seed=7)
    np.testing.assert_allclose(
        np.asarray(mq.score_all_o(params, s, p)),
        np.asarray(md.score_all_o(params, s, p)), rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------------------
# factored=True: M_p = I + u_p v_p^T (TransD-style rank-1 projections)
# ---------------------------------------------------------------------------

def build_factored(seed=0):
    model = TransR(N_E, N_R, D, dtype="float64", factored=True)
    rng = np.random.default_rng(seed + 200)
    params = dict(model.init_params(jax.random.PRNGKey(seed)))
    # U inits to zero (M = I); randomize so tests see the full rank-1 form
    params["U"] = jnp.asarray(rng.normal(size=(N_R, D)) * 0.3)
    return model, params


def _full_rank_twin(params):
    """Materialize M = I + u v^T so the full-rank model is the oracle."""
    u, v = np.asarray(params["U"]), np.asarray(params["V"])
    M = np.eye(D)[None] + u[:, :, None] * v[:, None, :]
    return {"E": params["E"], "R": params["R"], "M": jnp.asarray(M)}


def test_factored_matches_materialized_full_rank():
    mf, params = build_factored()
    mfull = TransR(N_E, N_R, D, dtype="float64")
    pfull = _full_rank_twin(params)
    s, o, p = triples(N_E, seed=9)
    np.testing.assert_allclose(
        np.asarray(mf.score(params, s, o, p)),
        np.asarray(mfull.score(pfull, s, o, p)), rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(mf.score_all_o(params, s, p)),
        np.asarray(mfull.score_all_o(pfull, s, p)), rtol=1e-10, atol=1e-11)
    np.testing.assert_allclose(
        np.asarray(mf.score_all_s(params, o, p)),
        np.asarray(mfull.score_all_s(pfull, o, p)), rtol=1e-10, atol=1e-11)
    pool = jnp.asarray(np.random.default_rng(10).integers(0, N_E, K))
    rows = mf.gather_rows(params, s, o, p)
    rows_full = mfull.gather_rows(pfull, s, o, p)
    for mode in (0, 1):
        np.testing.assert_allclose(
            np.asarray(mf.score_pool(rows, params["E"][pool], {}, mode)),
            np.asarray(mfull.score_pool(rows_full, pfull["E"][pool], {}, mode)),
            rtol=1e-10, atol=1e-11)


def test_factored_identity_init_is_transe_l2():
    from skge_tpu import TransE

    model = TransR(N_E, N_R, D, dtype="float64", factored=True)
    params = model.init_params(jax.random.PRNGKey(11))  # U = 0 => M = I
    te = TransE(N_E, N_R, D, dtype="float64", l1=False)
    s, o, p = triples(N_E, seed=12)
    np.testing.assert_allclose(
        np.asarray(model.score(params, s, o, p)),
        np.asarray(te.score({"E": params["E"], "R": params["R"]}, s, o, p)),
        rtol=1e-12)


def test_factored_shared_pool_equals_expanded_generic():
    from skge_tpu import AdaGrad, training
    from test_shared import expanded_pairs

    model, params = build_factored(seed=13)
    rng = np.random.default_rng(14)
    pos = np.stack([rng.integers(0, N_E, B), rng.integers(0, N_E, B),
                    rng.integers(0, N_R, B)], 1).astype(np.int32)
    pool = rng.integers(0, N_E, K)
    mask = jnp.ones(B, jnp.float64)
    sl, sn, socc, sdense = training.pairwise_grads_shared(
        model, params, jnp.asarray(pos), jnp.asarray(pool), mask, 0.7)
    pxs, nxs = expanded_pairs(pos, pool, (0, 1))
    gl, gn, gocc, gdense = training.pairwise_grads(
        model, params, jnp.asarray(np.asarray(pxs, np.int32)),
        jnp.asarray(np.asarray(nxs, np.int32)),
        jnp.ones(len(pxs), jnp.float64), 0.7)
    np.testing.assert_allclose(float(sl), float(gl), rtol=1e-12)
    assert int(sn) == int(gn)
    opt = AdaGrad(lr=0.1)
    a = training.apply_gradients(model, opt, params, opt.init(params),
                                 socc, sdense, "dense", premasked=True)
    b = training.apply_gradients(model, opt, params, opt.init(params),
                                 gocc, gdense, "dense", premasked=False)
    for kk in params:
        np.testing.assert_allclose(
            np.asarray(a[0][kk]), np.asarray(b[0][kk]),
            rtol=1e-9, atol=1e-12, err_msg=kk)


def test_factored_trains_on_latent_kg():
    from skge_tpu import (AdaGrad, SharedNegativeSampler, init_state,
                          make_epoch_fn, make_pairwise_step)
    from skge_tpu.data import latent_kg
    from skge_tpu.evaluation import FilteredRankingEval

    ds = latent_kg(n_entities=400, n_relations=6, n_train=2000,
                   n_valid=0, n_test=60, latent_dim=8, seed=2)
    model = TransR(ds.n_entities, ds.n_relations, 24, factored=True)
    opt = AdaGrad(lr=0.3)
    sampler = SharedNegativeSampler(ds.n_entities, k=64)
    step = make_pairwise_step(model, opt, sampler, margin=0.5,
                              aggregate="dense")
    epoch = jax.jit(make_epoch_fn(step, ds.train.shape[0], 10),
                    donate_argnums=(0,))
    state = init_state(model, opt, jax.random.PRNGKey(0))
    xs = jnp.asarray(ds.train)
    first = last = None
    for _ in range(30):
        state, m = epoch(state, xs)
        nv = float(np.asarray(m.nviolations).sum())
        first = nv if first is None else first
        last = nv
    assert last < first * 0.7
    r = FilteredRankingEval(model, ds.test, ds.all_triples(),
                            batch_size=64)(state.params)
    assert r.mrr > 5.0 / ds.n_entities
