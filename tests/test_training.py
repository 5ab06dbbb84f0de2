"""Integration tests: samplers, epoch scan, end-to-end mini-KG training."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from skge_tpu import (
    AdaGrad,
    BernoulliSampler,
    CorruptedSampler,
    HolE,
    LCWASampler,
    RandomModeSampler,
    TransE,
    init_state,
    make_epoch_fn,
    make_pairwise_step,
    make_pointwise_step,
)
from skge_tpu.data import (
    bernoulli_probs,
    sorted_train_keys,
    synthetic_kg,
    type_index_arrays,
)
from skge_tpu.evaluation import FilteredRankingEval
from skge_tpu.sampling import encode_keys


@pytest.fixture(scope="module")
def ds():
    return synthetic_kg(n_entities=120, n_relations=6, n_train=1200, n_test=40, seed=7)


def test_random_mode_sampler_shapes(ds):
    s = RandomModeSampler(ds.n_entities)
    pos = jnp.asarray(ds.train[:50])
    rep, neg, m = s(jax.random.PRNGKey(0), pos, jnp.ones(50))
    assert rep.shape == neg.shape == (100, 3)
    assert m.shape == (100,)
    # exactly one position corrupted per negative (or the rare same-id draw)
    diff = np.asarray(rep != neg)
    assert np.all(diff[:, 2] == 0)  # relation untouched
    assert np.all(diff.sum(axis=1) <= 1)
    # first half corrupts subject, second half corrupts object
    assert np.all(diff[:50, 1] == 0)
    assert np.all(diff[50:, 0] == 0)


def test_lcwa_sampler_avoids_train_set(ds):
    keys = jnp.asarray(sorted_train_keys(ds))
    s = LCWASampler(ds.n_entities, ds.n_relations, keys, ntries=100)
    pos = jnp.asarray(ds.train[:200])
    _, neg, valid = s(jax.random.PRNGKey(1), pos, jnp.ones(200))
    nk = np.asarray(encode_keys(neg, ds.n_entities, ds.n_relations))
    member = np.isin(nk, np.asarray(keys))
    v = np.asarray(valid) > 0
    assert not member[v].any(), "valid LCWA negatives must not be train triples"
    assert v.mean() > 0.95  # rejection rarely exhausts 100 tries here


def test_lcwa_sampler_masks_exhausted_tries():
    """When every candidate collides with a known-true triple, the pair is
    masked out — the reference's ntries giveup (skge/sample.py ~60)."""
    import itertools

    n_e, n_r = 3, 2
    all_triples = np.asarray(
        [(s, o, p) for s, o, p in itertools.product(range(n_e), range(n_e), range(n_r))],
        np.int32,
    )
    keys = jnp.sort(jnp.asarray(
        (all_triples[:, 0].astype(np.int64) * n_e + all_triples[:, 1]) * n_r
        + all_triples[:, 2]
    ))
    s = LCWASampler(n_e, n_r, keys, ntries=50)
    pos = jnp.asarray(all_triples[:5])
    _, _, valid = s(jax.random.PRNGKey(0), pos, jnp.ones(5))
    assert not np.asarray(valid).any()


def test_bernoulli_sampler_mode_probabilities(ds):
    probs = bernoulli_probs(ds.train, ds.n_relations)
    s = BernoulliSampler(ds.n_entities, jnp.asarray(probs))
    pos = jnp.asarray(np.tile(ds.train[:1], (4000, 1)))
    _, neg, _ = s(jax.random.PRNGKey(2), pos, jnp.ones(4000))
    subj_corrupted = np.asarray(neg[:, 0] != pos[:, 0])
    p_rel = probs[int(ds.train[0, 2])]
    # allow for same-entity draws and binomial noise
    assert abs(subj_corrupted.mean() - p_rel) < 0.05


def test_corrupted_sampler_type_compatible(ds):
    arrs = type_index_arrays(ds.train, ds.n_relations)
    s = CorruptedSampler(ds.n_entities, *(jnp.asarray(a) for a in arrs))
    pos = jnp.asarray(ds.train[:100])
    _, neg, _ = s(jax.random.PRNGKey(3), pos, jnp.ones(100))
    neg = np.asarray(neg)
    sub_flat, sub_off, sub_cnt, obj_flat, obj_off, obj_cnt = (
        np.asarray(a) for a in arrs
    )
    for i in range(100):  # first half: subject corrupted
        p = neg[i, 2]
        cands = sub_flat[sub_off[p] : sub_off[p] + sub_cnt[p]]
        assert neg[i, 0] in cands
    for i in range(100, 200):
        p = neg[i, 2]
        cands = obj_flat[obj_off[p] : obj_off[p] + obj_cnt[p]]
        assert neg[i, 1] in cands


def test_transe_pairwise_training_converges_and_ranks(ds):
    model = TransE(ds.n_entities, ds.n_relations, ncomp=32)
    opt = AdaGrad(lr=0.1)
    step = make_pairwise_step(model, opt, RandomModeSampler(ds.n_entities), margin=0.5)
    epoch = jax.jit(make_epoch_fn(step, ds.train.shape[0], nbatches=12))
    state = init_state(model, opt, jax.random.PRNGKey(0))
    xs = jnp.asarray(ds.train)
    first = last = None
    for e in range(40):
        state, m = epoch(state, xs)
        v = int(jnp.sum(m.nviolations))
        first = v if first is None else first
        last = v
    assert last < 0.5 * first, f"violations {first} -> {last}"
    # memorization check: filtered ranking of TRAIN triples should be good
    ev = FilteredRankingEval(model, ds.train[:100], ds.train, batch_size=50)
    res = ev(state.params)
    assert res.mrr > 0.35, res.summary()
    assert res.hits[10] > 0.6, res.summary()


def test_shared_pool_generalizes_on_latent_kg():
    """Quality gate for the flagship shared-negative scheme: on a genuinely
    learnable KG (latent translational geometry), held-out filtered MRR of
    shared-pool training must be in the same range as iid corruption at the
    same epoch budget (at production scale, RESULTS.md, the shared scheme matched
    or beat iid: 0.138 vs 0.128 L1 / 0.217 vs 0.202 L2 MRR at 60 epochs)."""
    from skge_tpu import SharedNegativeSampler
    from skge_tpu.data import latent_kg

    kg = latent_kg(
        n_entities=400, n_relations=8, n_train=2400, n_test=300,
        latent_dim=8, seed=3,
    )
    model = TransE(kg.n_entities, kg.n_relations, ncomp=32, l1=False)
    opt = AdaGrad(lr=0.1)
    xs = jnp.asarray(kg.train)
    ev = FilteredRankingEval(model, kg.test, kg.all_triples(), batch_size=150)

    mrr = {}
    for name, sampler in (
        ("iid", RandomModeSampler(kg.n_entities, modes=(0, 1) * 4)),
        ("shared", SharedNegativeSampler(kg.n_entities, k=64)),
    ):
        step = make_pairwise_step(model, opt, sampler, margin=1.0)
        epoch = jax.jit(make_epoch_fn(step, kg.train.shape[0], nbatches=8))
        state = init_state(model, opt, jax.random.PRNGKey(1))
        for _ in range(30):
            state, _ = epoch(state, xs)
        mrr[name] = ev(state.params).mrr
    assert mrr["shared"] > 0.1, mrr
    assert mrr["shared"] > 0.7 * mrr["iid"], mrr


def test_bf16_compute_dtype_scores_close_and_trains(ds):
    """compute_dtype='bfloat16' (opt-in bf16 mode): pool scores within bf16
    tolerance of the fp32 path, parameters stay fp32, training converges."""
    from skge_tpu import SharedNegativeSampler

    kw = dict(n_entities=ds.n_entities, n_relations=ds.n_relations, ncomp=32)
    exact = HolE(**kw)
    fast = HolE(**kw, compute_dtype="bfloat16")
    state = init_state(exact, AdaGrad(), jax.random.PRNGKey(0))
    rows = exact.gather_rows(
        state.params,
        jnp.arange(16) % ds.n_entities,
        (jnp.arange(16) * 3) % ds.n_entities,
        jnp.arange(16) % ds.n_relations,
    )
    pool = state.params["E"][jnp.arange(12)]
    a = exact.score_pool(rows, pool, {}, 1)
    b = fast.score_pool(rows, pool, {}, 1)
    assert b.dtype == a.dtype  # cast back to the param dtype
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=0.03)

    opt = AdaGrad(lr=0.1)
    step = make_pairwise_step(
        fast, opt, SharedNegativeSampler(ds.n_entities, k=32), margin=0.2
    )
    st = init_state(fast, opt, jax.random.PRNGKey(1))
    assert st.params["E"].dtype == jnp.float32
    xs = jnp.asarray(ds.train)
    epoch = jax.jit(make_epoch_fn(step, ds.train.shape[0], nbatches=10))
    first = last = None
    for _ in range(15):
        st, m = epoch(st, xs)
        v = int(jnp.sum(m.nviolations))
        first = v if first is None else first
        last = v
    assert st.params["E"].dtype == jnp.float32
    assert last < 0.7 * first, (first, last)


def test_hole_pointwise_training_loss_decreases(ds):
    model = HolE(ds.n_entities, ds.n_relations, ncomp=24)
    opt = AdaGrad(lr=0.1)
    keys = jnp.asarray(sorted_train_keys(ds))
    sampler = LCWASampler(ds.n_entities, ds.n_relations, keys)
    step = make_pointwise_step(model, opt, sampler)
    epoch = jax.jit(make_epoch_fn(step, ds.train.shape[0], nbatches=10))
    state = init_state(model, opt, jax.random.PRNGKey(1))
    xs = jnp.asarray(ds.train)
    losses = []
    for e in range(20):
        state, m = epoch(state, xs)
        losses.append(float(jnp.sum(m.loss)))
    assert losses[-1] < 0.7 * losses[0], losses[::5]


def test_epoch_padding_when_nbatches_does_not_divide(ds):
    """1200 triples, 7 batches -> padding path must still work."""
    model = TransE(ds.n_entities, ds.n_relations, ncomp=8)
    opt = AdaGrad(lr=0.1)
    step = make_pairwise_step(model, opt, RandomModeSampler(ds.n_entities), margin=0.2)
    epoch = jax.jit(make_epoch_fn(step, ds.train.shape[0], nbatches=7))
    state = init_state(model, opt, jax.random.PRNGKey(2))
    state, m = epoch(state, jnp.asarray(ds.train))
    assert m.nviolations.shape == (7,)
    assert int(state.step) == 7


def test_unigram_pool_distribution_and_training():
    """SharedNegativeSampler(logits=...): pool draws follow the unigram^a
    distribution (empirical vs expected frequencies), and the weighted pool
    trains end-to-end identically in machinery to the uniform pool."""
    import numpy as np

    from skge_tpu import (AdaGrad, SharedNegativeSampler, TransE, init_state,
                          make_epoch_fn, make_pairwise_step)
    from skge_tpu.data import latent_kg, unigram_logits

    ds = latent_kg(n_entities=300, n_relations=6, n_train=900, n_valid=0,
                   n_test=30, latent_dim=6, seed=3)
    logits = unigram_logits(ds.train, ds.n_entities)
    # expected: softmax(logits) ∝ (deg + 1)^0.75
    deg = np.bincount(
        np.concatenate([ds.train[:, 0], ds.train[:, 1]]),
        minlength=ds.n_entities,
    )
    want = (deg + 1.0) ** 0.75
    want = want / want.sum()

    sampler = SharedNegativeSampler(ds.n_entities, k=512, logits=logits)
    draws = []
    for i in range(40):
        draws.append(np.asarray(
            sampler.pool(jax.random.PRNGKey(i), None, None)
        ))
    freq = np.bincount(np.concatenate(draws), minlength=ds.n_entities)
    got = freq / freq.sum()
    # 20k draws: compare aggregate mass of the top-degree decile (tight
    # per-entity comparison would need far more samples)
    top = np.argsort(-want)[:20]
    np.testing.assert_allclose(got[top].sum(), want[top].sum(), rtol=0.1)
    # weighted pool must oversample high-degree entities vs uniform
    assert got[top].sum() > 1.5 * (20 / ds.n_entities)

    model = TransE(ds.n_entities, ds.n_relations, 12, l1=False)
    opt = AdaGrad(lr=0.2)
    step = make_pairwise_step(model, opt,
                              SharedNegativeSampler(ds.n_entities, k=32,
                                                    logits=logits),
                              margin=1.0, aggregate="dense")
    epoch = jax.jit(make_epoch_fn(step, ds.train.shape[0], 6),
                    donate_argnums=(0,))
    state = init_state(model, opt, jax.random.PRNGKey(0))
    xs = jnp.asarray(ds.train)
    first = last = None
    for e in range(20):
        state, m = epoch(state, xs)
        nv = float(np.asarray(m.nviolations).sum())
        first = nv if first is None else first
        last = nv
    assert last < first * 0.8
