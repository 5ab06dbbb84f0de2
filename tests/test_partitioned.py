"""Partition-aligned SPMD step: edge partitioning, relabeling, and exact
distributed/single-device equivalence of the boundary-exchange math."""

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from skge_tpu import AdaGrad, HolE, TransE, init_state, training  # noqa: E402
from skge_tpu.data import (  # noqa: E402
    greedy_entity_partition,
    partition_edges,
    synthetic_kg,
)
from skge_tpu.parallel.partitioned import (  # noqa: E402
    SHARD_AXIS,
    make_partitioned_pairwise_step,
    make_shard_mesh,
    relabel_entities,
    shard_state_partitioned,
)

P_PARTS = 4


class FixedPool:
    modes = (0, 1)

    def __init__(self, pool):
        self._pool = pool

    def pool(self, key, pos, mask):
        return self._pool


class FixedCorruptions:
    """Per-shard slices of global (P, L) replacement tables."""

    def __init__(self, repls):
        self._repls = repls  # [(mode, (P, L) array)]

    def corruptions(self, key, pos, mask):
        out = []
        for m, r in self._repls:
            if r.ndim == 2:  # inside shard_map: take this shard's row
                r = r[jax.lax.axis_index(SHARD_AXIS)]
            out.append((m, r, mask))
        return out


def test_partition_and_relabel_roundtrip():
    ds = synthetic_kg(97, 6, n_train=900, seed=13, clustered=True)
    part = greedy_entity_partition(ds.train, ds.n_entities, P_PARTS)
    assert part.shape == (ds.n_entities,)
    assert part.min() >= 0 and part.max() < P_PARTS
    rel, new_of_old, n_pad = relabel_entities(ds.train, part, P_PARTS)
    assert n_pad % P_PARTS == 0
    s = n_pad // P_PARTS
    # ownership is contiguous: new id // S == part of old id
    for old in range(ds.n_entities):
        assert new_of_old[old] // s == part[old]
    # relabeled triples reference the same entities
    assert rel.shape == ds.train.shape
    batches, mask, stats = partition_edges(rel, _range_part(n_pad, s), P_PARTS)
    assert batches.shape[0] == P_PARTS
    assert int(mask.sum()) == ds.train.shape[0]
    assert 0.0 < stats["balance"] <= 1.0


def _range_part(n_pad, s):
    return (np.arange(n_pad) // s).astype(np.int32)


def test_greedy_partition_beats_hash_on_clustered_graph():
    ds = synthetic_kg(400, 8, n_train=6000, seed=3, clustered=True)
    part = greedy_entity_partition(ds.train, ds.n_entities, P_PARTS)
    rel, _, n_pad = relabel_entities(ds.train, part, P_PARTS)
    s = n_pad // P_PARTS
    _, _, greedy = partition_edges(rel, _range_part(n_pad, s), P_PARTS)
    hash_part = (np.arange(ds.n_entities) * 2654435761 % P_PARTS).astype(np.int32)
    relh, _, n_pad_h = relabel_entities(ds.train, hash_part, P_PARTS)
    sh = n_pad_h // P_PARTS
    _, _, hashed = partition_edges(relh, _range_part(n_pad_h, sh), P_PARTS)
    assert greedy["object_locality"] > hashed["object_locality"] + 0.1, (
        greedy, hashed,
    )


@pytest.mark.parametrize("case", ["transe", "hole"])
def test_partitioned_step_matches_single_device(case):
    if len(jax.devices()) < P_PARTS:
        pytest.skip("needs virtual devices")
    ds = synthetic_kg(61, 5, n_train=400, seed=7, clustered=True)
    part = greedy_entity_partition(ds.train, ds.n_entities, P_PARTS)
    rel, _, n_pad = relabel_entities(ds.train, part, P_PARTS)
    s = n_pad // P_PARTS
    batches, mask, _ = partition_edges(rel, _range_part(n_pad, s), P_PARTS)
    batches = jnp.asarray(batches)
    mask = jnp.asarray(mask, jnp.float64)

    if case == "transe":
        model = TransE(n_pad, ds.n_relations, 16, dtype="float64")
    else:
        model = HolE(n_pad, ds.n_relations, 16, dtype="float64", rparam=0.01)
    opt = AdaGrad(lr=0.1)
    margin = 0.7
    rng = np.random.default_rng(11)
    L = batches.shape[1]

    samplers = [
        FixedPool(jnp.asarray(rng.integers(0, n_pad, 7), jnp.int32)),
        FixedCorruptions([
            (0, jnp.asarray(rng.integers(0, n_pad, (P_PARTS, L)), jnp.int32)),
            (1, jnp.asarray(rng.integers(0, n_pad, (P_PARTS, L)), jnp.int32)),
        ]),
    ]
    flat_batch = batches.reshape(-1, 3)
    flat_mask = mask.reshape(-1)
    mesh = make_shard_mesh(jax.devices()[:P_PARTS])
    for sampler in samplers:
        # single-device reference over the concatenated shard batches
        ref = init_state(model, opt, jax.random.PRNGKey(4))
        for _ in range(3):
            if hasattr(sampler, "pool"):
                loss, nviol, occ, g_dense = training.pairwise_grads_shared(
                    model, ref.params, flat_batch, sampler._pool,
                    flat_mask, margin,
                )
            else:
                corr = [
                    (m, r.reshape(-1), flat_mask) for m, r in sampler._repls
                ]
                loss, nviol, occ, g_dense = training.pairwise_grads_fused(
                    model, ref.params, flat_batch, corr, flat_mask, margin
                )
            p_new, o_new = training.apply_gradients(
                model, opt, ref.params, ref.opt_state, occ, g_dense,
                "dense", premasked=True,
            )
            ref = training.TrainState(p_new, o_new, ref.key, ref.step + 1)

        step = make_partitioned_pairwise_step(model, opt, sampler, margin, mesh)
        state = shard_state_partitioned(
            init_state(model, opt, jax.random.PRNGKey(4)), model, mesh
        )
        for _ in range(3):
            state, m = step(state, batches, mask)
        assert int(m.nviolations) == int(nviol)
        for k in ref.params:
            np.testing.assert_allclose(
                np.asarray(state.params[k]), np.asarray(ref.params[k]),
                rtol=1e-9, atol=1e-12, err_msg=f"{case} param {k}",
            )


def test_boundary_compacted_step_matches_single_device():
    """`boundary_cap` (compacted gather + compacted gradient return) must
    be bit-exact (fp64) against the same single-device reference as the
    full-exchange path — at the EXACT cap and at a larger cap (padding
    request slots re-request owned ids and must not double-count)."""
    from skge_tpu.parallel.partitioned import object_boundary_cap

    if len(jax.devices()) < P_PARTS:
        pytest.skip("needs virtual devices")
    ds = synthetic_kg(61, 5, n_train=400, seed=7, clustered=True)
    part = greedy_entity_partition(ds.train, ds.n_entities, P_PARTS)
    rel, _, n_pad = relabel_entities(ds.train, part, P_PARTS)
    s = n_pad // P_PARTS
    batches_np, mask_np, _ = partition_edges(rel, _range_part(n_pad, s), P_PARTS)
    exact_cap = object_boundary_cap(batches_np, s)
    assert exact_cap > 0, "test KG must have non-local objects"
    batches = jnp.asarray(batches_np)
    mask = jnp.asarray(mask_np, jnp.float64)

    model = TransE(n_pad, ds.n_relations, 16, dtype="float64")
    opt = AdaGrad(lr=0.1)
    margin = 0.7
    rng = np.random.default_rng(11)
    sampler = FixedPool(jnp.asarray(rng.integers(0, n_pad, 7), jnp.int32))
    flat_batch = batches.reshape(-1, 3)
    flat_mask = mask.reshape(-1)

    ref = init_state(model, opt, jax.random.PRNGKey(4))
    for _ in range(3):
        loss, nviol, occ, g_dense = training.pairwise_grads_shared(
            model, ref.params, flat_batch, sampler._pool, flat_mask, margin,
        )
        p_new, o_new = training.apply_gradients(
            model, opt, ref.params, ref.opt_state, occ, g_dense,
            "dense", premasked=True,
        )
        ref = training.TrainState(p_new, o_new, ref.key, ref.step + 1)

    mesh = make_shard_mesh(jax.devices()[:P_PARTS])
    for cap in (exact_cap, exact_cap + 3):
        step = make_partitioned_pairwise_step(
            model, opt, sampler, margin, mesh, boundary_cap=cap
        )
        state = shard_state_partitioned(
            init_state(model, opt, jax.random.PRNGKey(4)), model, mesh
        )
        for _ in range(3):
            state, m = step(state, batches, mask)
        assert int(m.nviolations) == int(nviol)
        for k in ref.params:
            np.testing.assert_allclose(
                np.asarray(state.params[k]), np.asarray(ref.params[k]),
                rtol=1e-9, atol=1e-12, err_msg=f"cap={cap} param {k}",
            )


def test_boundary_cap_requires_pool_sampler():
    if len(jax.devices()) < P_PARTS:
        pytest.skip("needs virtual devices")
    mesh = make_shard_mesh(jax.devices()[:P_PARTS])
    model = TransE(P_PARTS * 16, 4, 8)
    sampler = FixedCorruptions([])
    with pytest.raises(ValueError, match="shared-pool"):
        make_partitioned_pairwise_step(
            model, AdaGrad(), sampler, 1.0, mesh, boundary_cap=8
        )


def test_partitioned_epoch_single_minibatch_matches_step():
    """make_partitioned_epoch with nbatches=1 shuffles row order inside the
    one minibatch but computes the same row-sum math: identical violation
    counts and params equal to fp64 reassociation noise vs the plain step
    (FixedPool ignores the RNG, so the extra shuffle key split is moot)."""
    from skge_tpu.parallel.partitioned import (
        make_partitioned_epoch, object_boundary_cap,
    )

    if len(jax.devices()) < P_PARTS:
        pytest.skip("needs virtual devices")
    ds = synthetic_kg(61, 5, n_train=400, seed=7, clustered=True)
    part = greedy_entity_partition(ds.train, ds.n_entities, P_PARTS)
    rel, _, n_pad = relabel_entities(ds.train, part, P_PARTS)
    s = n_pad // P_PARTS
    batches_np, mask_np, _ = partition_edges(rel, _range_part(n_pad, s), P_PARTS)
    cap = object_boundary_cap(batches_np, s, mask_np)
    batches = jnp.asarray(batches_np)
    mask = jnp.asarray(mask_np, jnp.float64)
    L = batches.shape[1]

    model = TransE(n_pad, ds.n_relations, 16, dtype="float64")
    opt = AdaGrad(lr=0.1)
    rng = np.random.default_rng(11)
    sampler = FixedPool(jnp.asarray(rng.integers(0, n_pad, 7), jnp.int32))
    mesh = make_shard_mesh(jax.devices()[:P_PARTS])

    step = make_partitioned_pairwise_step(
        model, opt, sampler, 0.7, mesh, boundary_cap=cap
    )
    sstate = shard_state_partitioned(
        init_state(model, opt, jax.random.PRNGKey(4)), model, mesh
    )
    sstate, sm = step(sstate, batches, mask)

    epoch = make_partitioned_epoch(
        model, opt, sampler, 0.7, mesh, length=L, nbatches=1,
        boundary_cap=cap,
    )
    estate = shard_state_partitioned(
        init_state(model, opt, jax.random.PRNGKey(4)), model, mesh
    )
    estate, em = epoch(estate, batches, mask)
    assert em.nviolations.shape == (1,)
    assert int(em.nviolations[0]) == int(sm.nviolations)
    for k in sstate.params:
        np.testing.assert_allclose(
            np.asarray(estate.params[k]), np.asarray(sstate.params[k]),
            rtol=1e-9, atol=1e-12, err_msg=f"param {k}",
        )


def test_partitioned_epoch_minibatched_converges():
    """Multi-minibatch epochs with the compacted exchange + a real shared
    sampler must run and reduce violations (cap clamps to min(C, Lb))."""
    from skge_tpu import SharedNegativeSampler
    from skge_tpu.parallel.partitioned import (
        make_partitioned_epoch, object_boundary_cap,
    )

    if len(jax.devices()) < P_PARTS:
        pytest.skip("needs virtual devices")
    ds = synthetic_kg(90, 4, n_train=700, seed=5, clustered=True)
    part = greedy_entity_partition(ds.train, ds.n_entities, P_PARTS)
    rel, _, n_pad = relabel_entities(ds.train, part, P_PARTS)
    s = n_pad // P_PARTS
    batches_np, mask_np, _ = partition_edges(rel, _range_part(n_pad, s), P_PARTS)
    cap = max(1, object_boundary_cap(batches_np, s, mask_np))
    batches = jnp.asarray(batches_np)
    mask = jnp.asarray(mask_np, jnp.float64)

    model = TransE(n_pad, ds.n_relations, 16, dtype="float64")
    opt = AdaGrad(lr=0.1)
    sampler = SharedNegativeSampler(n_pad, k=32)
    mesh = make_shard_mesh(jax.devices()[:P_PARTS])
    epoch = make_partitioned_epoch(
        model, opt, sampler, 0.5, mesh, length=batches.shape[1],
        nbatches=4, boundary_cap=cap,
    )
    state = shard_state_partitioned(
        init_state(model, opt, jax.random.PRNGKey(0)), model, mesh
    )
    first = last = None
    for _ in range(6):
        state, m = epoch(state, batches, mask)
        tot = float(jnp.sum(m.nviolations))
        first = tot if first is None else first
        last = tot
    assert m.nviolations.shape == (4,)
    assert last < 0.7 * first, (first, last)
    assert np.isfinite(np.asarray(state.params["E"])).all()


def test_partitioned_trainer_end_to_end():
    """PartitionedTrainer: original-id triples in, trained original-id
    params out; pool never samples relabeling padding rows."""
    from skge_tpu import SharedNegativeSampler  # noqa: F401 (API neighbors)
    from skge_tpu.parallel.partitioned import (
        PartitionedTrainer, RelabeledPoolSampler,
    )

    if len(jax.devices()) < P_PARTS:
        pytest.skip("needs virtual devices")
    ds = synthetic_kg(90, 4, n_train=700, seed=5, clustered=True)
    model = TransE(ds.n_entities, ds.n_relations, 16)
    mesh = make_shard_mesh(jax.devices()[:P_PARTS])
    tr = PartitionedTrainer(
        model, AdaGrad(lr=0.1), ds.train, mesh, margin=0.5, k=32,
        nbatches=4, seed=0,
    )
    tr.fit(epochs=6)
    ms = tr.metrics
    assert len(ms) == 6
    assert ms[-1]["nviolations"] < 0.7 * ms[0]["nviolations"], ms
    params = tr.params()
    assert params["E"].shape == (ds.n_entities, 16)
    assert np.isfinite(params["E"]).all()

    # the real-entity pool never draws padding rows
    sampler = RelabeledPoolSampler(tr.new_of_old, k=256)
    pool = np.asarray(sampler.pool(jax.random.PRNGKey(3), None, None))
    real_rows = set(int(x) for x in tr.new_of_old)
    assert all(int(x) in real_rows for x in pool)


def test_partitioned_eval_matches_host_eval():
    """trainer.evaluate ranks on the SHARDED relabeled table (padding
    candidates masked, columns sharded over 'shard') and must equal the
    host-side original-id evaluation of the gathered params."""
    from skge_tpu import AdaGrad
    from skge_tpu.evaluation import evaluate
    from skge_tpu.parallel.partitioned import PartitionedTrainer

    ds = synthetic_kg(61, 5, n_train=500, n_test=60, seed=21, clustered=True)
    model = TransE(ds.n_entities, ds.n_relations, 16, dtype="float64")
    mesh = make_shard_mesh(jax.devices()[:P_PARTS])
    tr = PartitionedTrainer(
        model, AdaGrad(lr=0.1), ds.train, mesh, margin=0.5, k=32,
        nbatches=5, seed=7,
    ).fit(epochs=2)

    got = tr.evaluate(ds.test, ds.all_triples(), batch_size=16)
    want = evaluate(model, tr.params(), ds.test, ds.all_triples(),
                    batch_size=16)
    np.testing.assert_array_equal(got.ranks, want.ranks)
    np.testing.assert_array_equal(got.ranks_raw, want.ranks_raw)
    assert got.mrr == want.mrr


def test_ragged_exchange_emulation_matches_dense():
    """The owner-routed (ragged) boundary exchange must produce the SAME
    states as the dense all_to_all exchange. CPU XLA lacks the
    ragged-all-to-all op, so this pins the full offset/permutation
    bookkeeping through `ragged='emulate'` (identical math, rows placed at
    their ragged output offsets inside a dense frame); chip_smoke.py
    --multi checks the real op against the dense exchange on GPUs."""
    from skge_tpu.parallel.partitioned import object_boundary_cap

    if len(jax.devices()) < P_PARTS:
        pytest.skip("needs virtual devices")
    ds = synthetic_kg(61, 5, n_train=400, seed=7, clustered=True)
    part = greedy_entity_partition(ds.train, ds.n_entities, P_PARTS)
    rel, _, n_pad = relabel_entities(ds.train, part, P_PARTS)
    s = n_pad // P_PARTS
    batches_np, mask_np, _ = partition_edges(
        rel, _range_part(n_pad, s), P_PARTS
    )
    cap = object_boundary_cap(batches_np, s) + 2  # exercise surplus slots
    batches = jnp.asarray(batches_np)
    mask = jnp.asarray(mask_np, jnp.float64)
    model = TransE(n_pad, ds.n_relations, 16, dtype="float64")
    opt = AdaGrad(lr=0.1)
    rng = np.random.default_rng(13)
    sampler = FixedPool(jnp.asarray(rng.integers(0, n_pad, 9), jnp.int32))
    mesh = make_shard_mesh(jax.devices()[:P_PARTS])

    states = {}
    for mode in (False, "emulate"):
        step = make_partitioned_pairwise_step(
            model, opt, sampler, 0.7, mesh, boundary_cap=cap, ragged=mode
        )
        st = shard_state_partitioned(
            init_state(model, opt, jax.random.PRNGKey(4)), model, mesh
        )
        for _ in range(3):
            st, m = step(st, batches, mask)
        states[mode] = (st, m)
    a, b = states[False], states["emulate"]
    assert float(a[1].nviolations) == float(b[1].nviolations)
    for k in a[0].params:
        np.testing.assert_array_equal(
            np.asarray(a[0].params[k]), np.asarray(b[0].params[k]),
            err_msg=f"ragged param {k}",
        )


def test_partitioned_trainer_ragged_matches_dense():
    """PartitionedTrainer(ragged='emulate') reproduces the dense-exchange
    trainer bitwise (full epoch driver: shuffle, minibatching, compacted
    caps, owner-routed gather AND gradient return)."""
    from skge_tpu import AdaGrad
    from skge_tpu.parallel.partitioned import PartitionedTrainer

    ds = synthetic_kg(61, 5, n_train=500, seed=23, clustered=True)
    model = TransE(ds.n_entities, ds.n_relations, 16, dtype="float64")
    mesh = make_shard_mesh(jax.devices()[:P_PARTS])

    def run(mode):
        return PartitionedTrainer(
            model, AdaGrad(lr=0.1), ds.train, mesh, margin=0.5, k=32,
            nbatches=5, seed=7, ragged=mode,
        ).fit(epochs=2)

    a, b = run(False), run("emulate")
    assert [m["nviolations"] for m in a.metrics] == [
        m["nviolations"] for m in b.metrics
    ]
    pa, pb = a.params(), b.params()
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


def test_debug_checks_cap_warning_compiles_and_runs(capfd):
    """debug_checks=True adds the undersized-cap device warning (opt-in:
    the host callback cannot lower on remote-execution backends)."""
    ds = synthetic_kg(61, 5, n_train=400, seed=7, clustered=True)
    part = greedy_entity_partition(ds.train, ds.n_entities, P_PARTS)
    rel, _, n_pad = relabel_entities(ds.train, part, P_PARTS)
    s = n_pad // P_PARTS
    batches_np, mask_np, _ = partition_edges(
        rel, _range_part(n_pad, s), P_PARTS
    )
    batches = jnp.asarray(batches_np)
    mask = jnp.asarray(mask_np, jnp.float64)
    model = TransE(n_pad, ds.n_relations, 16, dtype="float64")
    opt = AdaGrad(lr=0.1)
    rng = np.random.default_rng(11)
    sampler = FixedPool(jnp.asarray(rng.integers(0, n_pad, 7), jnp.int32))
    mesh = make_shard_mesh(jax.devices()[:P_PARTS])
    step = make_partitioned_pairwise_step(
        model, opt, sampler, 0.7, mesh, boundary_cap=1,  # deliberately tiny
        debug_checks=True,
    )
    state = shard_state_partitioned(
        init_state(model, opt, jax.random.PRNGKey(4)), model, mesh
    )
    state, _ = step(state, batches, mask)
    jax.block_until_ready(state.params["E"])
    out = capfd.readouterr()
    assert "PARTITIONED WARNING" in out.out + out.err


def test_partitioned_step_with_adam_matches_single_device():
    """The partitioned path's P(SHARD_AXIS) specs are rank-agnostic: Adam's
    1-D per-row t slot shards and updates identically to single device."""
    from skge_tpu import Adam

    if len(jax.devices()) < P_PARTS:
        pytest.skip("needs virtual devices")
    ds = synthetic_kg(61, 5, n_train=400, seed=7, clustered=True)
    part = greedy_entity_partition(ds.train, ds.n_entities, P_PARTS)
    rel, _, n_pad = relabel_entities(ds.train, part, P_PARTS)
    s = n_pad // P_PARTS
    batches, mask, _ = partition_edges(rel, _range_part(n_pad, s), P_PARTS)
    batches = jnp.asarray(batches)
    mask = jnp.asarray(mask, jnp.float64)

    model = TransE(n_pad, ds.n_relations, 16, dtype="float64")
    opt = Adam(lr=0.01)
    margin = 0.7
    rng = np.random.default_rng(13)
    sampler = FixedPool(jnp.asarray(rng.integers(0, n_pad, 7), jnp.int32))

    flat_batch = batches.reshape(-1, 3)
    flat_mask = mask.reshape(-1)
    ref = init_state(model, opt, jax.random.PRNGKey(4))
    for _ in range(3):
        loss, nviol, occ, g_dense = training.pairwise_grads_shared(
            model, ref.params, flat_batch, sampler._pool, flat_mask, margin,
        )
        p_new, o_new = training.apply_gradients(
            model, opt, ref.params, ref.opt_state, occ, g_dense,
            "dense", premasked=True,
        )
        ref = training.TrainState(p_new, o_new, ref.key, ref.step + 1)

    mesh = make_shard_mesh(jax.devices()[:P_PARTS])
    step = make_partitioned_pairwise_step(model, opt, sampler, margin, mesh)
    state = shard_state_partitioned(
        init_state(model, opt, jax.random.PRNGKey(4)), model, mesh
    )
    for _ in range(3):
        state, m = step(state, batches, mask)
    for k in ref.params:
        np.testing.assert_allclose(
            np.asarray(state.params[k]), np.asarray(ref.params[k]),
            rtol=1e-9, atol=1e-12,
        )
    np.testing.assert_array_equal(
        np.asarray(state.opt_state["E"]["t"]),
        np.asarray(ref.opt_state["E"]["t"]),
    )


def test_partitioned_selfadv_matches_single_device():
    """Partitioned self-adversarial step (plain AND compacted boundary_cap)
    reproduces the single-device make_selfadv_step trajectory in fp64."""
    from skge_tpu.parallel.partitioned import (
        make_partitioned_selfadv_step, object_boundary_cap,
    )
    from skge_tpu.training import make_selfadv_step

    if len(jax.devices()) < P_PARTS:
        pytest.skip("needs virtual devices")
    ds = synthetic_kg(61, 5, n_train=400, seed=9, clustered=True)
    part = greedy_entity_partition(ds.train, ds.n_entities, P_PARTS)
    rel, _, n_pad = relabel_entities(ds.train, part, P_PARTS)
    s = n_pad // P_PARTS
    batches, mask, _ = partition_edges(rel, _range_part(n_pad, s), P_PARTS)
    batches = jnp.asarray(batches)
    mask = jnp.asarray(mask, jnp.float64)
    model = TransE(n_pad, ds.n_relations, 16, dtype="float64", l1=False)
    opt = AdaGrad(lr=0.1)
    rng = np.random.default_rng(17)
    pool = jnp.asarray(rng.integers(0, n_pad, 7), jnp.int32)

    class Pool:
        modes = (0, 1)
        k = 7

        def pool(self, key, pos, m):
            return pool

    flat_batch = batches.reshape(-1, 3)
    flat_mask = mask.reshape(-1)
    ref_step = make_selfadv_step(
        model, opt, Pool(), margin=2.0, alpha=1.0, aggregate="dense"
    )
    ref = init_state(model, opt, jax.random.PRNGKey(4))
    for _ in range(3):
        ref, rm = jax.jit(ref_step)(ref, flat_batch, flat_mask)

    mesh = make_shard_mesh(jax.devices()[:P_PARTS])
    cap = max(1, object_boundary_cap(np.asarray(batches), s))
    for kwargs in ({}, {"boundary_cap": cap},
                   {"boundary_cap": cap, "ragged": "emulate"}):
        step = make_partitioned_selfadv_step(
            model, opt, Pool(), margin=2.0, mesh=mesh, alpha=1.0, **kwargs
        )
        state = shard_state_partitioned(
            init_state(model, opt, jax.random.PRNGKey(4)), model, mesh
        )
        for _ in range(3):
            state, m = step(state, batches, mask)
        np.testing.assert_allclose(
            float(m.loss), float(rm.loss), rtol=1e-12, err_msg=str(kwargs)
        )
        for k in ref.params:
            np.testing.assert_allclose(
                np.asarray(state.params[k]), np.asarray(ref.params[k]),
                rtol=1e-10, atol=1e-13, err_msg=f"{kwargs} {k}",
            )


def test_partitioned_trainer_selfadv_runs():
    """PartitionedTrainer(loss='selfadv') trains (loss drops) through the
    epoch driver with the compacted exchange."""
    from skge_tpu import AdaGrad as _Ada, PartitionedTrainer
    from skge_tpu.data import latent_kg

    if len(jax.devices()) < P_PARTS:
        pytest.skip("needs virtual devices")
    ds = latent_kg(n_entities=200, n_relations=5, n_train=800, n_valid=0,
                   n_test=30, latent_dim=6, seed=2)
    model = TransE(ds.n_entities, ds.n_relations, 12, l1=False)
    mesh = make_shard_mesh(jax.devices()[:P_PARTS])
    tr = PartitionedTrainer(
        model, _Ada(lr=0.3), ds.train, mesh, margin=2.0, k=32, nbatches=8,
        seed=0, loss="selfadv",
    ).fit(epochs=15)
    losses = [m["loss"] for m in tr.metrics]
    assert losses[-1] < losses[0] * 0.7


@pytest.mark.parametrize("directions,ls", [
    (("o", "s"), 0.0), (("o",), 0.1),
])
def test_partitioned_ce_matches_single_device(directions, ls):
    """Partitioned full-cross-entropy step reproduces the single-device
    make_ce_step trajectory in fp64 — same relabeled batch, same padded
    model, both directions and the reciprocal (object-only, smoothed)
    protocol. VERDICT r2 ask 2."""
    from skge_tpu.models import DistMult
    from skge_tpu.parallel.partitioned import make_partitioned_ce_step
    from skge_tpu.training import make_ce_step

    if len(jax.devices()) < P_PARTS:
        pytest.skip("needs virtual devices")
    ds = synthetic_kg(61, 6, n_train=400, seed=9, clustered=True)
    part = greedy_entity_partition(ds.train, ds.n_entities, P_PARTS)
    rel, _, n_pad = relabel_entities(ds.train, part, P_PARTS)
    s = n_pad // P_PARTS
    batches, mask, _ = partition_edges(rel, _range_part(n_pad, s), P_PARTS)
    batches = jnp.asarray(batches)
    mask = jnp.asarray(mask, jnp.float64)
    opt = AdaGrad(lr=0.1)

    for model in (
        DistMult(n_pad, ds.n_relations, 12, dtype="float64"),
        TransE(n_pad, ds.n_relations, 12, dtype="float64", l1=False),
    ):
        flat_batch = batches.reshape(-1, 3)
        flat_mask = mask.reshape(-1)
        ref_step = make_ce_step(
            model, opt, directions=directions, label_smoothing=ls
        )
        ref = init_state(model, opt, jax.random.PRNGKey(4))
        for _ in range(3):
            ref, rm = jax.jit(ref_step)(ref, flat_batch, flat_mask)

        mesh = make_shard_mesh(jax.devices()[:P_PARTS])
        step = make_partitioned_ce_step(
            model, opt, mesh, directions=directions, label_smoothing=ls
        )
        state = shard_state_partitioned(
            init_state(model, opt, jax.random.PRNGKey(4)), model, mesh
        )
        for _ in range(3):
            state, m = step(state, batches, mask)
        np.testing.assert_allclose(
            float(m.loss), float(rm.loss), rtol=1e-12,
            err_msg=f"{model.name} {directions} ls={ls}",
        )
        for k in ref.params:
            np.testing.assert_allclose(
                np.asarray(state.params[k]), np.asarray(ref.params[k]),
                rtol=1e-10, atol=1e-13,
                err_msg=f"{model.name} {directions} ls={ls} {k}",
            )
        assert (jnp.asarray(state.key) == jnp.asarray(ref.key)).all()
        assert int(state.step) == int(ref.step) == 3


def test_partitioned_trainer_ce_and_reciprocal():
    """PartitionedTrainer(loss='ce') trains (loss drops, eval works); the
    reciprocal variant routes head queries through inverse relations."""
    from skge_tpu import Adam, PartitionedTrainer
    from skge_tpu.data import add_reciprocal_relations, latent_kg
    from skge_tpu.models import DistMult

    if len(jax.devices()) < P_PARTS:
        pytest.skip("needs virtual devices")
    ds = latent_kg(n_entities=200, n_relations=5, n_train=800, n_valid=0,
                   n_test=30, latent_dim=6, seed=2)
    mesh = make_shard_mesh(jax.devices()[:P_PARTS])

    model = DistMult(ds.n_entities, ds.n_relations, 16)
    tr = PartitionedTrainer(
        model, Adam(lr=1e-2), ds.train, mesh, nbatches=8, seed=0,
        loss="ce", label_smoothing=0.1,
    ).fit(epochs=12)
    losses = [m["loss"] for m in tr.metrics]
    assert losses[-1] < losses[0] * 0.8
    res = tr.evaluate(ds.test, ds.all_triples(), batch_size=32)
    assert res.mrr > 3.0 / ds.n_entities

    aug = add_reciprocal_relations(ds)
    model_r = DistMult(aug.n_entities, aug.n_relations, 16)
    tr_r = PartitionedTrainer(
        model_r, Adam(lr=1e-2), aug.train, mesh, nbatches=8, seed=0,
        loss="ce", reciprocal=True, label_smoothing=0.1,
    ).fit(epochs=12)
    losses_r = [m["loss"] for m in tr_r.metrics]
    assert losses_r[-1] < losses_r[0] * 0.8
    # test triples keep ORIGINAL relation ids; head ranks route via p+half
    res_r = tr_r.evaluate(ds.test, aug.all_triples(), batch_size=32)
    assert res_r.mrr > 3.0 / ds.n_entities


def test_partitioned_sampled_ce_matches_single_device():
    """Partitioned sampled-softmax-CE step (plain, compacted AND ragged-
    emulated) reproduces the single-device make_sampled_ce_step trajectory
    in fp64 — same relabeled batch, same injected pool, both direction
    protocols (completes the loss x distribution matrix for the practical
    10^7+-vocabulary scheme)."""
    from skge_tpu.models import DistMult
    from skge_tpu.parallel.partitioned import (
        make_partitioned_sampled_ce_step, object_boundary_cap,
    )
    from skge_tpu.training import make_sampled_ce_step

    if len(jax.devices()) < P_PARTS:
        pytest.skip("needs virtual devices")
    ds = synthetic_kg(61, 5, n_train=400, seed=9, clustered=True)
    part = greedy_entity_partition(ds.train, ds.n_entities, P_PARTS)
    rel, _, n_pad = relabel_entities(ds.train, part, P_PARTS)
    s = n_pad // P_PARTS
    batches, mask, _ = partition_edges(rel, _range_part(n_pad, s), P_PARTS)
    batches = jnp.asarray(batches)
    mask = jnp.asarray(mask, jnp.float64)
    opt = AdaGrad(lr=0.1)
    rng = np.random.default_rng(21)
    pool = jnp.asarray(rng.integers(0, n_pad, 9), jnp.int32)

    class Pool:
        modes = (0, 1)
        k = 9

        def pool(self, key, pos, m):
            return pool

    mesh = make_shard_mesh(jax.devices()[:P_PARTS])
    cap = max(1, object_boundary_cap(np.asarray(batches), s))
    for model, directions, ls in (
        (TransE(n_pad, ds.n_relations, 16, dtype="float64", l1=False),
         ("o", "s"), 0.0),
        (DistMult(n_pad, ds.n_relations, 12, dtype="float64"),
         ("o",), 0.1),
    ):
        flat_batch = batches.reshape(-1, 3)
        flat_mask = mask.reshape(-1)
        ref_step = make_sampled_ce_step(
            model, opt, Pool(), directions=directions, label_smoothing=ls
        )
        ref = init_state(model, opt, jax.random.PRNGKey(4))
        for _ in range(3):
            ref, rm = jax.jit(ref_step)(ref, flat_batch, flat_mask)

        for kwargs in ({}, {"boundary_cap": cap},
                       {"boundary_cap": cap, "ragged": "emulate"}):
            step = make_partitioned_sampled_ce_step(
                model, opt, Pool(), mesh, directions=directions,
                label_smoothing=ls, **kwargs,
            )
            state = shard_state_partitioned(
                init_state(model, opt, jax.random.PRNGKey(4)), model, mesh
            )
            for _ in range(3):
                state, m = step(state, batches, mask)
            np.testing.assert_allclose(
                float(m.loss), float(rm.loss), rtol=1e-12,
                err_msg=f"{model.name} {directions} {kwargs}",
            )
            for k in ref.params:
                np.testing.assert_allclose(
                    np.asarray(state.params[k]), np.asarray(ref.params[k]),
                    rtol=1e-10, atol=1e-13,
                    err_msg=f"{model.name} {directions} {kwargs} {k}",
                )


def test_partitioned_trainer_sampled_ce_runs():
    """PartitionedTrainer(loss='sampled_ce') trains (loss drops) through
    the epoch driver, incl. the reciprocal protocol."""
    from skge_tpu import Adam, PartitionedTrainer
    from skge_tpu.data import add_reciprocal_relations, latent_kg
    from skge_tpu.models import DistMult

    if len(jax.devices()) < P_PARTS:
        pytest.skip("needs virtual devices")
    ds = latent_kg(n_entities=200, n_relations=5, n_train=800, n_valid=0,
                   n_test=30, latent_dim=6, seed=2)
    mesh = make_shard_mesh(jax.devices()[:P_PARTS])
    aug = add_reciprocal_relations(ds)
    model = DistMult(aug.n_entities, aug.n_relations, 16)
    tr = PartitionedTrainer(
        model, Adam(lr=1e-2), aug.train, mesh, k=64, nbatches=8, seed=0,
        loss="sampled_ce", reciprocal=True, label_smoothing=0.1,
    ).fit(epochs=12)
    losses = [m["loss"] for m in tr.metrics]
    assert losses[-1] < losses[0] * 0.8
    res = tr.evaluate(ds.test, ds.all_triples(), batch_size=32)
    assert res.mrr > 3.0 / ds.n_entities
