"""Evaluation tests: all-entity scoring parity and filtered ranking."""

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from skge_tpu.models import ERMLP, HolE, RESCAL, TransE  # noqa: E402
from skge_tpu.evaluation import FilteredRankingEval, ranking_scores  # noqa: E402
from skge_tpu.data import synthetic_kg, true_triple_index  # noqa: E402

N_E, N_R, D = 31, 4, 16


def build(model_cls, **kw):
    model = model_cls(N_E, N_R, D, dtype="float64", **kw)
    params = model.init_params(jax.random.PRNGKey(0))
    return model, params


MODELS = [
    (TransE, {"l1": True}),
    (TransE, {"l1": False}),
    (RESCAL, {}),
    (HolE, {}),
    (ERMLP, {"nhidden": 6}),
]


@pytest.mark.parametrize("model_cls,kw", MODELS)
def test_score_all_matches_per_triple(model_cls, kw):
    """score_all_o / score_all_s columns must equal per-triple scores."""
    model, params = build(model_cls, **kw)
    rng = np.random.default_rng(0)
    b = 7
    s = rng.integers(0, N_E, b)
    o = rng.integers(0, N_E, b)
    p = rng.integers(0, N_R, b)

    all_o = np.asarray(model.score_all_o(params, jnp.asarray(s), jnp.asarray(p)))
    all_s = np.asarray(model.score_all_s(params, jnp.asarray(o), jnp.asarray(p)))
    assert all_o.shape == (b, N_E)

    for e in [0, 5, N_E - 1]:
        want_o = np.asarray(
            model.score(params, jnp.asarray(s), jnp.full(b, e), jnp.asarray(p))
        )
        np.testing.assert_allclose(all_o[:, e], want_o, rtol=1e-9, atol=1e-9)
        want_s = np.asarray(
            model.score(params, jnp.full(b, e), jnp.asarray(o), jnp.asarray(p))
        )
        np.testing.assert_allclose(all_s[:, e], want_s, rtol=1e-9, atol=1e-9)


def _brute_force_ranks(model, params, test, known):
    """NumPy reference for filtered/raw ranks (optimistic tie-breaking)."""
    sp_o, op_s = true_triple_index(known)
    raw = np.zeros((2, len(test)), np.int64)
    filt = np.zeros((2, len(test)), np.int64)
    for i, (s, o, p) in enumerate(test):
        so = np.asarray(
            model.score_all_o(params, jnp.asarray([s]), jnp.asarray([p]))
        )[0]
        raw[0, i] = 1 + np.sum(so > so[o])
        m = so.copy()
        m[sp_o.get((int(s), int(p)), np.array([], np.int32))] = -np.inf
        filt[0, i] = 1 + np.sum(m > so[o])

        ss = np.asarray(
            model.score_all_s(params, jnp.asarray([o]), jnp.asarray([p]))
        )[0]
        raw[1, i] = 1 + np.sum(ss > ss[s])
        m = ss.copy()
        m[op_s.get((int(o), int(p)), np.array([], np.int32))] = -np.inf
        filt[1, i] = 1 + np.sum(m > ss[s])
    return raw, filt


@pytest.mark.parametrize("model_cls,kw", [(TransE, {}), (HolE, {})])
def test_filtered_ranking_matches_brute_force(model_cls, kw):
    model, params = build(model_cls, **kw)
    ds = synthetic_kg(N_E, N_R, n_train=120, n_valid=20, n_test=25, seed=3)
    known = ds.all_triples()
    ev = FilteredRankingEval(model, ds.test, known, batch_size=8)
    res = ev(params)
    want_raw, want_filt = _brute_force_ranks(model, params, ds.test, known)
    np.testing.assert_array_equal(res.ranks_raw, want_raw)
    np.testing.assert_array_equal(res.ranks, want_filt)
    # metric formulas
    mrr, mr, hits = ranking_scores(want_filt)
    assert res.mrr == pytest.approx(mrr)
    assert res.mean_rank == pytest.approx(mr)
    assert res.hits[10] == pytest.approx(hits[10])


def test_filtered_beats_raw():
    """Filtering can only improve (reduce) ranks."""
    model, params = build(HolE)
    ds = synthetic_kg(N_E, N_R, n_train=150, n_test=30, seed=4)
    ev = FilteredRankingEval(model, ds.test, ds.all_triples(), batch_size=16)
    res = ev(params)
    assert np.all(res.ranks <= res.ranks_raw)
    assert res.mrr >= res.mrr_raw


def test_sharded_eval_matches_unsharded():
    """FilteredRankingEval with a mesh (entity-column-sharded score matrix,
    row-sharded E placement) returns EXACTLY the single-device ranks."""
    from skge_tpu.models import TransE
    from skge_tpu.parallel import make_mesh, shard_state
    from skge_tpu import AdaGrad, init_state

    ds = synthetic_kg(n_entities=96, n_relations=5, n_train=600,
                      n_test=50, seed=3)
    model = TransE(ds.n_entities, ds.n_relations, 16, dtype="float64")
    opt = AdaGrad()
    state = init_state(model, opt, jax.random.PRNGKey(1))

    base = FilteredRankingEval(model, ds.test, ds.all_triples(),
                               batch_size=16)
    want = base(state.params)

    mesh = make_mesh(jax.devices()[:8], shape=(4, 2))
    sstate = shard_state(state, model, mesh)
    ev = FilteredRankingEval(model, ds.test, ds.all_triples(),
                             batch_size=16, mesh=mesh)
    got = ev(sstate.params)
    np.testing.assert_array_equal(got.ranks, want.ranks)
    np.testing.assert_array_equal(got.ranks_raw, want.ranks_raw)
    assert got.mrr == want.mrr


def test_mean_tiebreak_on_collapsed_scores():
    """A degenerate model whose scores are all EQUAL must score ~random
    (rank ~ n/2), not MRR 1.0 — the tie exploit from the KGE re-evaluation
    literature. 'optimistic' preserves the reference's strict-greater rank."""
    model, params = build(TransE)
    params = {k: jnp.zeros_like(v) for k, v in params.items()}  # all-0 scores
    ds = synthetic_kg(N_E, N_R, n_train=100, n_test=20, seed=5)
    known = ds.all_triples()

    res = FilteredRankingEval(model, ds.test, known, batch_size=8)(params)
    assert res.mrr < 0.2
    assert res.mean_rank_raw == pytest.approx(1 + (N_E - 1) // 2)

    opt = FilteredRankingEval(
        model, ds.test, known, batch_size=8, ties="optimistic"
    )(params)
    assert opt.mrr == 1.0  # the artifact, explicitly opted into


def test_breakdowns_partition_the_pooled_metrics():
    """by_direction / by_relation slices must reassemble exactly into the
    pooled metrics (weighted by count) and partition the rank arrays."""
    model, params = build(TransE, l1=False)
    ds = synthetic_kg(N_E, N_R, n_train=150, n_test=40, seed=5)
    ev = FilteredRankingEval(model, ds.test, ds.all_triples(), batch_size=16)
    res = ev(params)

    by_dir = res.by_direction()
    assert by_dir["object"]["n"] == by_dir["subject"]["n"] == len(ds.test)
    np.testing.assert_allclose(
        by_dir["object"]["mrr"],
        float(np.mean(1.0 / res.ranks[0])), rtol=1e-12,
    )
    np.testing.assert_allclose(
        0.5 * (by_dir["object"]["mrr"] + by_dir["subject"]["mrr"]),
        res.mrr, rtol=1e-12,
    )

    by_rel = res.by_relation()
    assert sum(m["n"] for m in by_rel.values()) == 2 * len(ds.test)
    pooled = sum(m["mrr"] * m["n"] for m in by_rel.values()) / (2 * len(ds.test))
    np.testing.assert_allclose(pooled, res.mrr, rtol=1e-12)
    for p, m in by_rel.items():
        sel = ds.test[:, 2] == p
        np.testing.assert_allclose(
            m["mean_rank"], float(np.mean(res.ranks[:, sel])), rtol=1e-12
        )


def test_relation_categories_and_by_category():
    """1-1/1-N/N-1/N-N typing from constructed multiplicities, and the
    category breakdown partitioning the per-direction rank arrays."""
    from skge_tpu.evaluation import relation_categories

    # relation 0: bijection (1-1); relation 1: one head, many tails (1-N);
    # relation 2: many heads, one tail (N-1); relation 3: all-pairs (N-N)
    r0 = np.stack([np.arange(6), np.arange(6) + 6, np.zeros(6, int)], axis=1)
    r1 = np.stack([np.zeros(6, int), np.arange(6) + 6, np.full(6, 1)], axis=1)
    r2 = np.stack([np.arange(6), np.full(6, 12), np.full(6, 2)], axis=1)
    hh, tt = np.meshgrid(np.arange(4), np.arange(4) + 8)
    r3 = np.stack([hh.ravel(), tt.ravel(), np.full(16, 3)], axis=1)
    train = np.concatenate([r0, r1, r2, r3]).astype(np.int32)
    cats = relation_categories(train)
    assert cats == {0: "1-1", 1: "1-N", 2: "N-1", 3: "N-N"}

    model, params = build(TransE, l1=False)
    ds = synthetic_kg(N_E, N_R, n_train=150, n_test=40, seed=6)
    ev = FilteredRankingEval(model, ds.test, ds.all_triples(), batch_size=16)
    res = ev(params)
    cats = relation_categories(ds.train)
    by_cat = res.by_category(cats)
    total = sum(v["object"]["n"] for v in by_cat.values())
    assert total == len(ds.test)
    # reassemble pooled MRR from the category x direction cells
    cells = [
        (v[d]["mrr"], v[d]["n"]) for v in by_cat.values()
        for d in ("object", "subject")
    ]
    pooled = sum(m * n for m, n in cells) / sum(n for _, n in cells)
    np.testing.assert_allclose(pooled, res.mrr, rtol=1e-12)


def test_reciprocal_eval_wrapper_routes_heads_through_inverse():
    """Wrapper contract: score_all_o passes through; score_all_s(o, p)
    ranks candidates e by score(o, e, inv(p)) — the canonical protocol for
    reciprocal-CE-trained models — and wrapping ConvE (which already
    routes internally) is a no-op."""
    from skge_tpu.evaluation import ReciprocalEvalWrapper
    from skge_tpu.models import ConvE, DistMult

    n_r2 = 6  # doubled count
    model = DistMult(N_E, n_r2, D, dtype="float64")
    params = model.init_params(jax.random.PRNGKey(2))
    w = ReciprocalEvalWrapper(model)
    rng = np.random.default_rng(3)
    b = 7
    o = jnp.asarray(rng.integers(0, N_E, b), jnp.int32)
    p = jnp.asarray(rng.integers(0, n_r2 // 2, b), jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(w.score_all_o(params, o, p)),
        np.asarray(model.score_all_o(params, o, p)),
    )
    got = np.asarray(w.score_all_s(params, o, p))
    want = np.asarray(model.score_all_o(params, o, p + n_r2 // 2))
    np.testing.assert_array_equal(got, want)
    # involution: inverse ids route back to the base ids
    got2 = np.asarray(w.score_all_s(params, o, p + n_r2 // 2))
    np.testing.assert_array_equal(
        got2, np.asarray(model.score_all_o(params, o, p))
    )

    conve = ConvE(N_E, n_r2, 6, nfilters=4, dtype="float64")
    cp = conve.init_params(jax.random.PRNGKey(4))
    wc = ReciprocalEvalWrapper(conve)
    np.testing.assert_allclose(
        np.asarray(wc.score_all_s(cp, o, p)),
        np.asarray(conve.score_all_s(cp, o, p)), rtol=1e-12,
    )
    import pytest

    with pytest.raises(ValueError, match="DOUBLED"):
        ReciprocalEvalWrapper(DistMult(N_E, 5, D))


def test_rank_kernel_cache_reuses_compiled_kernels():
    """Fresh FilteredRankingEval instances over equal model values share
    the jitted kernels (the sweep/early-stopping loops build one evaluator
    per validation pass; recompiling 2 kernels each time dominated the
    suite's wall clock)."""
    from skge_tpu.evaluation import _rank_kernel
    from skge_tpu.models import TransE

    a = TransE(50, 4, 8)
    b = TransE(50, 4, 8)  # equal by value, distinct instance
    assert _rank_kernel(a, "o") is _rank_kernel(b, "o")
    assert _rank_kernel(a, "o") is not _rank_kernel(a, "s")
    assert _rank_kernel(a, "o", ties="optimistic") is not _rank_kernel(a, "o")
    # mask-carrying kernels skip the cache (mask arrays aren't hashable)
    import numpy as np

    m = np.ones(50, bool)
    assert _rank_kernel(a, "o", candidate_mask=m) is not _rank_kernel(
        a, "o", candidate_mask=m
    )


def test_reciprocal_wrapper_value_hashable():
    from skge_tpu.evaluation import ReciprocalEvalWrapper
    from skge_tpu.models import DistMult

    m = DistMult(50, 8, 8)
    assert hash(ReciprocalEvalWrapper(m)) == hash(ReciprocalEvalWrapper(m))
    assert ReciprocalEvalWrapper(m) == ReciprocalEvalWrapper(DistMult(50, 8, 8))
