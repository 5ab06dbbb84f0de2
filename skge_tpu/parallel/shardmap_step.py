"""Explicitly-scheduled SPMD train step (shard_map + hand-placed collectives).

The GSPMD path (parallel/sharded.py) lets XLA infer collectives from
shardings; its lowering of index-gathers and scatter-adds on a row-sharded
entity table is generic and measured 2-3.7x slower than the unsharded
program on the same total batch (scripts/scaling_bench.py). This module
writes the SPMD program by hand over the ('data', 'model') mesh:

- batch sharded over 'data'; REPLICATED over 'model' (each model-group
  member re-scores the same pairs — compute is cheap, communication is
  not; 'model' stays small, 2-4).
- entity table E and its AdaGrad accumulator row-sharded over 'model'
  ('model' is the memory axis: tables too big for one chip split here).
- **gather** of entity rows: each shard reads its owned rows (others
  zeroed) and one `psum('model')` assembles full rows — traffic O(B*d),
  with identical indices across the model group by construction.
- **scatter** of entity gradients: every device scatter-adds ONLY the
  occurrence rows its shard owns into its local (n_e/M, d) table — zero
  communication on 'model' — then one `psum('data')` reduces across data
  shards — traffic O(n_e*d/M) per step, independent of batch size.
- relation tables replicated; their gradient tables psum over 'data'.
- losses/violation counts psum over 'data'.

This is the SPMD form of the reference-scale plan in SURVEY.md
section 5 ("row-sharding E across hosts ... gradients exchanged and
overlapped"): collectives ride the interconnect, every tensor keeps a
static shape, and a (1, 1) mesh degenerates to the single-device program
bit-for-bit (tested).

Requires n_entities divisible by the 'model' axis size (pad the entity
count up if needed — embedding row count is free).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from skge_tpu.models.base import KGEModel
from skge_tpu.optim import Optimizer
from skge_tpu.ops.aggregate import DenseGrads, FactoredOcc
from skge_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
from skge_tpu.training import (
    StepMetrics,
    TrainState,
    pairwise_grads_fused,
    select_shared_pairwise_fn,
)


def _entity_param(model: KGEModel) -> str:
    by_role = {role: pname for _, pname, role in model.slot_spec()}
    assert by_role["s"] == by_role["o"], "one entity table expected"
    return by_role["s"]


def _param_specs(model: KGEModel, shard_relations: bool = False):
    """E sharded over 'model'; relation tables replicated by default (or
    row-sharded too with `shard_relations` — the DGL-KE relation-partition
    analogue for large-n_r / wide-relation models like RESCAL/TransR whose
    (n_r, d, d) tables dominate memory); dense params replicated."""
    epname = _entity_param(model)
    specs = {}
    for _, pname, role in model.slot_spec():
        if pname == epname or (shard_relations and role == "p"):
            specs[pname] = P(MODEL_AXIS)
        else:
            specs[pname] = P()
    for pname in model.dense_param_names:
        specs[pname] = P()
    return specs


def _sharded_row_tables(
    model: KGEModel, m_size: int, shard_relations: bool
):
    """{pname: global_rows} for every row table sharded over 'model';
    validates divisibility."""
    epname = _entity_param(model)
    tables = {epname: model.n_entities}
    if shard_relations:
        for _, pname, role in model.slot_spec():
            if role == "p":
                tables[pname] = model.n_relations
    for pname, rows in tables.items():
        if rows % m_size != 0:
            raise ValueError(
                f"{pname}: {rows} rows not divisible by model axis "
                f"{m_size}; pad the row count (embedding row count is free)"
            )
    return tables


def _pool_state_specs(model: KGEModel, opt: Optimizer, m_size: int,
                      shard_relations: bool):
    """Shared scaffolding of every shard_map step builder: row-sharded
    table sizes, per-shard row counts, PartitionSpecs and the TrainState /
    StepMetrics spec trees (optimizer slot names from a dummy init)."""
    tables = _sharded_row_tables(model, m_size, shard_relations)
    local_rows = {k: rows // m_size for k, rows in tables.items()}
    specs = _param_specs(model, shard_relations)
    slot_names = tuple(opt.init({"x": jnp.zeros(1)})["x"])
    state_spec = TrainState(
        params={k: specs[k] for k in specs},
        opt_state={k: {sn: specs[k] for sn in slot_names} for k in specs},
        key=P(),
        step=P(),
    )
    metrics_spec = StepMetrics(loss=P(), nviolations=P())
    return local_rows, state_spec, metrics_spec


def _make_gather(params, local_rows, offs):
    """Masked-local row gather: each shard contributes its owned rows
    (others zeroed), one psum('model') assembles full rows — O(B*d)
    traffic with identical indices across the model group."""

    def gather(pname, idx, role=None):
        if pname not in local_rows:
            return params[pname][idx]
        srows = local_rows[pname]
        local = idx - offs[pname]
        own = jnp.logical_and(local >= 0, local < srows)
        rows = params[pname][jnp.clip(local, 0, srows - 1)]
        rows = jnp.where(
            own.reshape(own.shape + (1,) * (rows.ndim - 1)), rows, 0
        )
        return jax.lax.psum(rows, MODEL_AXIS)

    return gather


def _apply_row_occurrences(model, opt, state, new_params, new_opt, occ,
                           local_rows, offs, combine="mean", scale=None):
    """Owned-rows scatter + psum('data') reduction + optimizer apply for
    every row-table occurrence list — the loop every shard_map step
    shares. `combine='mean'` divides the reduced sums by the duplicate
    counts (margin/selfadv/pointwise semantics); `'sum'` keeps sums
    (sampled-CE; counts only gate which rows update). `scale` multiplies
    grads before the scatter (sampled-CE's local->global mean rescale).
    """
    reg = model.regularization
    reg3 = model.regularization_n3
    for pname, entry in occ.items():
        if isinstance(entry, FactoredOcc):
            # factored rank-2 W cotangents (RESCAL dispatch): under SPMD
            # the sanctioned aggregation is the XLA fallback of
            # `segment_outer_mean_dense` — the outers feed ONE fused
            # scatter-add. Counts/averaging semantics are identical to the
            # 3-tuple path below.
            idx = entry.idx
            grads = sum(
                u[:, :, None] * v[:, None, :]
                for u, v in zip(entry.us, entry.vs)
            )
            counts = entry.count
        else:
            idx, grads, counts = entry
        if scale is not None:
            grads = grads * scale
        if pname in local_rows:
            srows = local_rows[pname]
            local = idx - offs[pname]
            # JAX .at[] wraps NEGATIVE indices NumPy-style BEFORE the
            # drop-mode bounds check — route non-owned rows to an
            # always-out-of-range positive index instead
            local = jnp.where(
                jnp.logical_and(local >= 0, local < srows),
                local, srows,
            )
            table = _scatter_sums(local, grads, counts, srows)
        else:
            table = _scatter_sums(idx, grads, counts, model.num_rows(pname))
        table = jax.lax.psum(table, DATA_AXIS)
        count = table[:, -1]
        feat = grads.shape[1:]
        g = table[:, :-1].reshape((table.shape[0],) + feat)
        if combine == "mean":
            g = g / jnp.maximum(count, 1.0).reshape(
                (-1,) + (1,) * len(feat)
            )
        if reg != 0.0 and pname in model.reg_row_params:
            g = g + reg * model.reg_grad_rows(pname, new_params[pname])
        if reg3 != 0.0 and pname in model.reg_row_params:
            g = g + (3.0 * reg3) * model.n3_grad_rows(
                pname, new_params[pname]
            )
        dg = DenseGrads(grads=g, count=count)
        new_params[pname], new_opt[pname] = opt.apply_dense_masked(
            new_params[pname], new_opt[pname], dg,
            model.post_constraints.get(pname), step=state.step,
        )
    return new_params, new_opt


def _scatter_sums(idx, grads, counts, rows):
    """Raw (un-averaged) masked scatter: grads+counts into `rows` slots.

    Out-of-range indices (negative or >= rows) are dropped — this is what
    restricts each shard to its owned rows after subtracting the offset.
    """
    t = idx.shape[0]
    aug = jnp.concatenate(
        [grads.reshape(t, -1), counts.astype(grads.dtype)[:, None]], axis=1
    )
    return jnp.zeros((rows, aug.shape[1]), grads.dtype).at[idx].add(
        aug, mode="drop"
    )


def make_shardmap_pairwise_step(
    model: KGEModel,
    opt: Optimizer,
    sampler: Callable,
    margin: float,
    mesh: Mesh,
    shard_relations: bool = False,
):
    """Jitted explicit-SPMD pairwise step: (state, batch, mask) -> (state, m).

    `state` entity tables must be placed with `shard_state_shardmap`; batch
    and mask sharded over 'data'. Supports the `pool` (shared-negative) and
    `corruptions` (iid) sampler protocols.

    `shard_relations` row-shards the relation tables over 'model' too
    (place the state with the same flag): per-chip relation storage drops
    to n_r/M rows — the scaling story for wide-relation models (RESCAL /
    TransR hold (n_r, d, d) tables that dominate memory at large n_r) —
    at the cost of one extra O(B·feat) psum per relation table for the
    row gather (same masked-local + psum('model') pattern as E) and an
    owned-rows scatter that needs NO extra collective (the gradient
    reduction stays psum('data'), now over an n_r/M-row table).

    Sampling happens OUTSIDE shard_map on the global batch, from the same
    `split(state.key)` stream as the single-device step — so a mesh run's
    trajectory is the single-device trajectory (same negatives for the
    same rows; each data shard just receives its slice of the global
    draws). The update math reduces per-shard scatter tables with
    psum('data') before the duplicate-count averaging, which reorders
    only exact zero-padding adds. Trajectory parity is pinned in
    tests/test_trainer_mesh.py (and tests/test_shardmap.py for
    shard_relations).
    """
    m_size = mesh.shape[MODEL_AXIS]
    local_rows, state_spec, metrics_spec = _pool_state_specs(
        model, opt, m_size, shard_relations
    )
    shared = hasattr(sampler, "pool")
    # same factored-model dispatch as the single-device builder (ADVICE r4)
    shared_grads_fn = select_shared_pairwise_fn(model)

    def local_step(modes, state: TrainState, batch, mask, draws):
        params = state.params
        shard_idx = jax.lax.axis_index(MODEL_AXIS)
        offs = {k: shard_idx * r for k, r in local_rows.items()}
        gather = _make_gather(params, local_rows, offs)

        key = state.key  # already advanced by the global-sampling wrapper
        if shared:
            (pool_idx,) = draws
            loss, nviol, occ, g_dense = shared_grads_fn(
                model, params, batch, pool_idx, mask, margin,
                modes=modes, gather=gather,
            )
        else:
            repls, valids = draws
            corr = list(zip(modes, repls, valids))
            loss, nviol, occ, g_dense = pairwise_grads_fused(
                model, params, batch, corr, mask, margin, gather=gather
            )

        loss = jax.lax.psum(loss, DATA_AXIS)
        nviol_local = nviol
        nviol = jax.lax.psum(nviol, DATA_AXIS)

        new_params, new_opt = _apply_row_occurrences(
            model, opt, state, dict(params), dict(state.opt_state),
            occ, local_rows, offs,
        )
        # dense (non-row) params: recover local gradient SUMS, reduce, then
        # divide by the GLOBAL violation count
        for pname, g in g_dense.items():
            gsum = jax.lax.psum(
                g * jnp.maximum(nviol_local, 1.0), DATA_AXIS
            )
            g_global = gsum / jnp.maximum(nviol, 1.0)
            new_params[pname], new_opt[pname] = opt.apply_full(
                new_params[pname], new_opt[pname], g_global,
                step=state.step,
            )
        new_state = TrainState(new_params, new_opt, key, state.step + 1)
        return new_state, StepMetrics(loss=loss, nviolations=nviol)

    def step(state: TrainState, batch, mask):
        # global sampling: the SAME split(state.key) stream as the
        # single-device step — draws for row i equal the single-device
        # draws for row i, whatever the mesh shape.
        key, sk = jax.random.split(state.key)
        state = state._replace(key=key)
        if shared:
            modes = tuple(sampler.modes)
            draws = (sampler.pool(sk, batch, mask),)
            draws_spec = (P(),)  # one global pool, replicated
        else:
            corr = sampler.corruptions(sk, batch, mask)
            modes = tuple(m for m, _, _ in corr)  # static at trace time
            draws = (
                tuple(r for _, r, _ in corr),
                tuple(v for _, _, v in corr),
            )
            draws_spec = (
                tuple(P(DATA_AXIS) for _ in modes),   # replacement ids
                tuple(P(DATA_AXIS) for _ in modes),   # validity masks
            )
        smapped = jax.shard_map(
            partial(local_step, modes),
            mesh=mesh,
            in_specs=(
                state_spec, P(DATA_AXIS, None), P(DATA_AXIS), draws_spec,
            ),
            out_specs=(state_spec, metrics_spec),
            check_vma=False,
        )
        return smapped(state, batch, mask, draws)

    return jax.jit(step, donate_argnums=(0,))


def make_shardmap_selfadv_step(
    model: KGEModel,
    opt: Optimizer,
    sampler: Callable,
    margin: float,
    mesh: Mesh,
    alpha: float = 1.0,
    shard_relations: bool = False,
):
    """Explicit-SPMD self-adversarial step (Sun et al. 2019 over the shared
    pool) — the multi-chip path for the loss the quality table shows is the
    strongest lever (RESULTS.md). Same collective structure as the shared
    branch of `make_shardmap_pairwise_step` (masked-local row gather +
    psum('model'), owned-rows scatter + psum('data')); the only new
    reduction is the dense-param gradient, whose per-shard means are
    recombined with element-count weights (selfadv normalizes by the
    number of scored elements, not violations). Trajectory parity with the
    single-device `make_selfadv_step` is pinned in tests/test_shardmap.py.
    """
    if not hasattr(sampler, "pool"):
        raise ValueError(
            "make_shardmap_selfadv_step needs a shared-pool sampler "
            "(SharedNegativeSampler)"
        )
    from skge_tpu.training import selfadv_grads_shared

    m_size = mesh.shape[MODEL_AXIS]
    local_rows, state_spec, metrics_spec = _pool_state_specs(
        model, opt, m_size, shard_relations
    )
    modes = tuple(sampler.modes)
    k_pool = int(sampler.k)

    def local_step(state: TrainState, batch, mask, pool_idx):
        params = state.params
        shard_idx = jax.lax.axis_index(MODEL_AXIS)
        offs = {k: shard_idx * r for k, r in local_rows.items()}
        gather = _make_gather(params, local_rows, offs)

        key = state.key  # advanced by the global-sampling wrapper
        loss, occ, g_dense = selfadv_grads_shared(
            model, params, batch, pool_idx, mask, margin, alpha,
            modes=modes, gather=gather,
        )
        loss = jax.lax.psum(loss, DATA_AXIS)

        new_params, new_opt = _apply_row_occurrences(
            model, opt, state, dict(params), dict(state.opt_state),
            occ, local_rows, offs,
        )
        # dense params: g_dense is the per-shard MEAN over that shard's
        # scored elements — recover sums (g * clamped local count; a
        # fully-masked shard has g == 0 so the clamp is harmless there),
        # reduce, then renormalize by the GLOBAL raw count clamped once
        # (clamping per shard before the psum would let fully-masked
        # padding shards inflate the denominator)
        n_raw = jnp.sum(mask) * (1.0 + k_pool * len(modes))
        n_local = jnp.maximum(n_raw, 1.0)
        n_global = jnp.maximum(jax.lax.psum(n_raw, DATA_AXIS), 1.0)
        for pname, g in g_dense.items():
            g_global = jax.lax.psum(g * n_local, DATA_AXIS) / n_global
            new_params[pname], new_opt[pname] = opt.apply_full(
                new_params[pname], new_opt[pname], g_global,
                step=state.step,
            )
        new_state = TrainState(new_params, new_opt, key, state.step + 1)
        return new_state, StepMetrics(
            loss=loss, nviolations=jnp.zeros((), loss.dtype)
        )

    def step(state: TrainState, batch, mask):
        key, sk = jax.random.split(state.key)
        state = state._replace(key=key)
        pool_idx = sampler.pool(sk, batch, mask)
        smapped = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(state_spec, P(DATA_AXIS, None), P(DATA_AXIS), P()),
            out_specs=(state_spec, metrics_spec),
            check_vma=False,
        )
        return smapped(state, batch, mask, pool_idx)

    return jax.jit(step, donate_argnums=(0,))


def make_shardmap_pointwise_step(
    model: KGEModel,
    opt: Optimizer,
    sampler: Callable,
    mesh: Mesh,
    shard_relations: bool = False,
):
    """Explicit-SPMD POINTWISE (logistic) step over the shared pool —
    the reference's non-pairwise trainer semantic (reference skge/base.py
    ~`PairwiseStochasticTrainer` sibling) on the ('data', 'model') mesh.
    Closes the one trainer-loss without an explicit-SPMD counterpart
    (GSPMD `make_sharded_pointwise_step` remains the iid-sampler route).

    Collective structure is `make_shardmap_selfadv_step`'s: masked-local
    row gather + psum('model'), owned-rows scatter + psum('data'); the
    dense-param gradient means are recombined with element-count weights
    (pointwise normalizes by #scored elements = sum(mask)*(1+K*|modes|)).
    Trajectory parity with single-device `pointwise_grads_shared` under
    the same update is pinned in tests/test_shardmap.py.
    """
    if not hasattr(sampler, "pool"):
        raise ValueError(
            "make_shardmap_pointwise_step needs a shared-pool sampler "
            "(SharedNegativeSampler); iid samplers route to the GSPMD "
            "make_sharded_pointwise_step"
        )
    from skge_tpu.training import select_shared_pointwise_fn

    # same dispatch as the single-device builder: factored models
    # (RESCAL) take the bilinear path whose W cotangent never
    # materializes per-occurrence (d, d) blocks (ADVICE r4)
    grads_fn = select_shared_pointwise_fn(model)

    m_size = mesh.shape[MODEL_AXIS]
    local_rows, state_spec, metrics_spec = _pool_state_specs(
        model, opt, m_size, shard_relations
    )
    modes = tuple(sampler.modes)
    k_pool = int(sampler.k)

    def local_step(state: TrainState, batch, mask, pool_idx):
        params = state.params
        shard_idx = jax.lax.axis_index(MODEL_AXIS)
        offs = {k: shard_idx * r for k, r in local_rows.items()}
        gather = _make_gather(params, local_rows, offs)

        key = state.key  # advanced by the global-sampling wrapper
        loss, occ, g_dense = grads_fn(
            model, params, batch, pool_idx, mask,
            modes=modes, gather=gather,
        )
        loss = jax.lax.psum(loss, DATA_AXIS)

        new_params, new_opt = _apply_row_occurrences(
            model, opt, state, dict(params), dict(state.opt_state),
            occ, local_rows, offs,
        )
        # dense params: same raw-count global renormalization as selfadv
        # (clamp once AFTER the psum so fully-masked padding shards don't
        # inflate the denominator)
        n_raw = jnp.sum(mask) * (1.0 + k_pool * len(modes))
        n_local = jnp.maximum(n_raw, 1.0)
        n_global = jnp.maximum(jax.lax.psum(n_raw, DATA_AXIS), 1.0)
        for pname, g in g_dense.items():
            g_global = jax.lax.psum(g * n_local, DATA_AXIS) / n_global
            new_params[pname], new_opt[pname] = opt.apply_full(
                new_params[pname], new_opt[pname], g_global,
                step=state.step,
            )
        new_state = TrainState(new_params, new_opt, key, state.step + 1)
        return new_state, StepMetrics(
            loss=loss, nviolations=jnp.zeros((), loss.dtype)
        )

    def step(state: TrainState, batch, mask):
        key, sk = jax.random.split(state.key)
        state = state._replace(key=key)
        pool_idx = sampler.pool(sk, batch, mask)
        smapped = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(state_spec, P(DATA_AXIS, None), P(DATA_AXIS), P()),
            out_specs=(state_spec, metrics_spec),
            check_vma=False,
        )
        return smapped(state, batch, mask, pool_idx)

    return jax.jit(step, donate_argnums=(0,))


def make_shardmap_sampled_ce_step(
    model: KGEModel,
    opt: Optimizer,
    sampler: Callable,
    mesh: Mesh,
    directions: Tuple[str, ...] = ("o", "s"),
    label_smoothing: float = 0.0,
    shard_relations: bool = False,
):
    """Explicit-SPMD SAMPLED-softmax-CE step on the ('data', 'model') mesh.

    Closes the last hole in the loss x distribution matrix (VERDICT r3
    missing #4): a model whose entity table needs the 'model' memory axis
    can now train with the practical 10^7+-vocabulary loss — the
    importance-corrected exclusion-form estimator of
    `sampled_ce_grads_shared` — instead of choosing between full CE
    (O(B*n_e*d) logit work) and pool-margin losses.

    Collective structure is the selfadv step's, NOT the vocab-parallel CE
    step's: the candidate pool is small and drawn GLOBALLY (identical on
    every shard, same `split(state.key)` stream as the single-device
    step), so batch + pool rows arrive through the masked-local
    psum('model') row gather — O((B+K)*d) — and the softmax needs no
    further collective; per-chip logit work is O(B/D * K * d). Occurrence
    gradients keep sampled-CE SUM semantics (the k=n_e == full-CE
    identity needs sums; training.apply_gradients combine='sum'),
    rescaled from the local-batch mean to the global one before the
    owned-row scatter + psum('data') table reduction. A sampler with
    unigram `logits` feeds the proposal correction, computed on the
    global pool outside shard_map. fp64 trajectory parity with the
    single-device `make_sampled_ce_step` is pinned in
    tests/test_shardmap.py.
    """
    if not hasattr(sampler, "pool"):
        raise ValueError(
            "make_shardmap_sampled_ce_step needs a shared-pool sampler "
            "(SharedNegativeSampler)"
        )
    from skge_tpu.training import sampled_ce_grads_shared

    m_size = mesh.shape[MODEL_AXIS]
    local_rows, state_spec, metrics_spec = _pool_state_specs(
        model, opt, m_size, shard_relations
    )
    logits = getattr(sampler, "logits", None)
    log_q_table = None if logits is None else jax.nn.log_softmax(
        jnp.asarray(logits)
    )

    def local_step(state: TrainState, batch, mask, pool_idx, log_q=None):
        params = state.params
        shard_idx = jax.lax.axis_index(MODEL_AXIS)
        offs = {k: shard_idx * r for k, r in local_rows.items()}
        gather = _make_gather(params, local_rows, offs)

        key = state.key  # advanced by the global-sampling wrapper
        loss, occ, g_dense = sampled_ce_grads_shared(
            model, params, batch, pool_idx, mask,
            directions=directions, label_smoothing=label_smoothing,
            log_q=log_q, gather=gather,
        )
        # sampled-CE occurrence grads are SUMS of the mean-over-LOCAL-valid
        # loss; rescale them (and the reported loss) to the global mean so
        # the psum('data') table reduction reproduces the single-device
        # trajectory exactly (clamp the global denominator ONCE — clamping
        # per shard would let fully-masked padding shards inflate it).
        # combine='sum': no count averaging (the k=n_e == full-CE identity
        # needs sums; counts only gate which rows update).
        dnorm_raw = jnp.sum(mask)
        dnorm_local = jnp.maximum(dnorm_raw, 1.0)
        dnorm_global = jnp.maximum(jax.lax.psum(dnorm_raw, DATA_AXIS), 1.0)
        scale = dnorm_local / dnorm_global
        loss = jax.lax.psum(loss * dnorm_raw / dnorm_global, DATA_AXIS)

        new_params, new_opt = _apply_row_occurrences(
            model, opt, state, dict(params), dict(state.opt_state),
            occ, local_rows, offs, combine="sum", scale=scale,
        )
        # dense params: g_dense is the per-shard MEAN over its valid rows —
        # recover sums (g * clamped local count; a fully-masked shard has
        # g == 0 so the clamp is harmless), reduce, renormalize globally
        for pname, g in g_dense.items():
            g_global = jax.lax.psum(g * dnorm_local, DATA_AXIS) / dnorm_global
            new_params[pname], new_opt[pname] = opt.apply_full(
                new_params[pname], new_opt[pname], g_global,
                step=state.step,
            )
        new_state = TrainState(new_params, new_opt, key, state.step + 1)
        return new_state, StepMetrics(
            loss=loss, nviolations=jnp.zeros((), loss.dtype)
        )

    def step(state: TrainState, batch, mask):
        # global sampling: the SAME split(state.key) stream as the
        # single-device make_sampled_ce_step, so a mesh run's trajectory
        # is the single-device trajectory whatever the mesh shape
        key, sk = jax.random.split(state.key)
        state = state._replace(key=key)
        pool_idx = sampler.pool(sk, batch, mask)
        operands = [pool_idx]
        op_specs = [P()]
        if log_q_table is not None:
            operands.append(log_q_table[pool_idx])
            op_specs.append(P())
        smapped = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(
                state_spec, P(DATA_AXIS, None), P(DATA_AXIS), *op_specs,
            ),
            out_specs=(state_spec, metrics_spec),
            check_vma=False,
        )
        return smapped(state, batch, mask, *operands)

    return jax.jit(step, donate_argnums=(0,))


def make_shardmap_ce_step(
    model: KGEModel,
    opt: Optimizer,
    mesh: Mesh,
    directions: Tuple[str, ...] = ("o", "s"),
    label_smoothing: float = 0.0,
):
    """Vocab-parallel full-cross-entropy step (Megatron-style softmax).

    The way to train 1-vs-all at entity counts beyond one device: E is row-sharded over 'model', each shard scores every positive
    against ONLY its (n_e/M, d) candidate block — a local matmul —
    and the softmax is assembled with three scalar-per-row collectives:

        m    = max(all_gather_model(rowmax(local logits)))
        logZ = log(psum_model(sum(exp(local - m)))) + m
        f_y  = psum_model(local logits at the label, 0 if not owned)

    so no device ever materializes the full (B, n_e) logit matrix. The
    label-smoothing term reuses psum_model(rowsum(local logits)).

    Gradients: autodiff runs w.r.t. (gathered query rows, local candidate
    block, dense params), then the per-device cotangents are rescaled by
    1/M and the query-row partials completed with one psum('model')
    before the owned-row scatter (see the in-body note on shard_map's
    psum transpose), followed by the psum('data') batch reduction. fp64
    trajectory parity with the single-device `make_ce_step` is pinned in
    tests/test_ce.py at 1-ulp-per-step agreement.
    """
    epname = _entity_param(model)
    n_e = model.n_entities
    m_size = mesh.shape[MODEL_AXIS]
    if n_e % m_size != 0:
        raise ValueError(
            f"n_entities={n_e} not divisible by model axis {m_size}; pad the "
            "entity count (embedding row count is free)"
        )
    shard_rows = n_e // m_size
    _, state_spec, metrics_spec = _pool_state_specs(
        model, opt, m_size, shard_relations=False
    )
    slot_spec = model.slot_spec()
    ls = float(label_smoothing)

    def local_step(state: TrainState, batch, mask):
        params = state.params
        row_off = jax.lax.axis_index(MODEL_AXIS) * shard_rows
        s, o, p = batch[:, 0], batch[:, 1], batch[:, 2]
        role_idx = {"s": s, "o": o, "p": p}
        barange = jnp.arange(batch.shape[0])

        def gather(pname, idx):
            if pname != epname:
                return params[pname][idx]
            local = idx - row_off
            own = jnp.logical_and(local >= 0, local < shard_rows)
            rows = params[pname][jnp.clip(local, 0, shard_rows - 1)]
            rows = jnp.where(
                own.reshape(own.shape + (1,) * (rows.ndim - 1)), rows, 0
            )
            return jax.lax.psum(rows, MODEL_AXIS)

        rows = {
            slot: gather(pname, role_idx[role])
            for slot, pname, role in slot_spec
        }
        e_local = params[epname]
        dense = model.dense_params(params)

        def loss_fn(rows, e_local, dense):
            total = 0.0
            for d in directions:
                mode = {"o": 1, "s": 0}[d]
                labels = role_idx[d]
                logits_l = model.score_pool(rows, e_local, dense, mode)
                # pmax has no AD rule; all_gather + max does, and the
                # max-subtraction cotangent cancels exactly as in any
                # logsumexp implementation
                mrow = jnp.max(
                    jax.lax.all_gather(jnp.max(logits_l, axis=1), MODEL_AXIS),
                    axis=0,
                )
                se = jax.lax.psum(
                    jnp.sum(jnp.exp(logits_l - mrow[:, None]), axis=1),
                    MODEL_AXIS,
                )
                logz = jnp.log(se) + mrow
                ll = labels - row_off
                own = jnp.logical_and(ll >= 0, ll < shard_rows)
                fl = logits_l[barange, jnp.clip(ll, 0, shard_rows - 1)]
                f_label = jax.lax.psum(jnp.where(own, fl, 0.0), MODEL_AXIS)
                nll = logz - f_label
                if ls:
                    sum_logits = jax.lax.psum(
                        jnp.sum(logits_l, axis=1), MODEL_AXIS
                    )
                    mean_logp = sum_logits / n_e - logz
                    nll = (1.0 - ls) * nll - ls * mean_logp
                total = total + jnp.sum(nll * mask)
            return total

        loss_l, (g_rows, g_cand, g_dense) = jax.value_and_grad(
            loss_fn, argnums=(0, 1, 2)
        )(rows, e_local, dense)
        n_valid = jax.lax.psum(jnp.sum(mask), DATA_AXIS)
        denom = jnp.maximum(n_valid, 1.0)
        loss = jax.lax.psum(loss_l, DATA_AXIS) / denom
        # Cotangent bookkeeping (pinned by the multi-shard cases of
        # tests/test_ce.py): every path from logits to the loss crosses a
        # model-axis collective, and shard_map transposes psum to psum —
        # summing the REPLICATED downstream cotangents — so each device's
        # autodiff grads come back as M * (its true partial). Dividing by
        # M recovers the partials; the query-row partials then still need
        # the explicit cross-block completion psum, while the candidate-
        # block partial is already the whole gradient for owned rows.
        m_sz = float(m_size)
        g_rows = {
            slot: jax.lax.psum(g / m_sz, MODEL_AXIS)
            for slot, g in g_rows.items()
        }
        g_cand = g_cand / m_sz

        # assemble full-table gradients per shard
        g_tables = {}
        for slot, pname, role in slot_spec:
            g = g_rows[slot]
            idx = role_idx[role]
            if pname == epname:
                local = idx - row_off
                local = jnp.where(
                    jnp.logical_and(local >= 0, local < shard_rows),
                    local, shard_rows,
                )
                tbl = jnp.zeros_like(params[pname]).at[local].add(
                    g, mode="drop"
                )
            else:
                tbl = jnp.zeros_like(params[pname]).at[idx].add(g)
            g_tables[pname] = g_tables.get(pname, 0.0) + tbl
        g_tables[epname] = g_tables[epname] + g_cand
        for pname in g_dense:
            g_tables[pname] = jax.lax.psum(g_dense[pname] / m_sz, MODEL_AXIS)

        reg = model.regularization
        reg3 = model.regularization_n3
        new_params = dict(params)
        new_opt = dict(state.opt_state)
        for pname, g in g_tables.items():
            g = jax.lax.psum(g, DATA_AXIS) / denom
            if reg != 0.0 and pname in model.reg_row_params:
                g = g + reg * model.reg_grad_rows(pname, new_params[pname])
            if reg3 != 0.0 and pname in model.reg_row_params:
                g = g + (3.0 * reg3) * model.n3_grad_rows(
                    pname, new_params[pname]
                )
            new_params[pname], new_opt[pname] = opt.apply_full(
                new_params[pname], new_opt[pname], g, step=state.step
            )
            post = model.post_constraints.get(pname)
            if post is not None:
                from skge_tpu.optim import POST_CONSTRAINTS

                new_params[pname] = POST_CONSTRAINTS[post](new_params[pname])
        new_state = TrainState(new_params, new_opt, state.key, state.step + 1)
        return new_state, StepMetrics(
            loss=loss, nviolations=jnp.zeros((), loss.dtype)
        )

    def step(state: TrainState, batch, mask):
        key, _ = jax.random.split(state.key)  # keep key-stream parity
        state = state._replace(key=key)
        smapped = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(state_spec, P(DATA_AXIS, None), P(DATA_AXIS)),
            out_specs=(state_spec, metrics_spec),
            check_vma=False,
        )
        return smapped(state, batch, mask)

    return jax.jit(step, donate_argnums=(0,))


def shard_state_shardmap(
    state: TrainState, model: KGEModel, mesh: Mesh,
    shard_relations: bool = False,
) -> TrainState:
    """Place a TrainState for the shard_map step (E over 'model'; relation
    tables too with `shard_relations` — match the step's flag)."""
    specs = _param_specs(model, shard_relations)

    def put(tree_specs, tree):
        return jax.tree.map(
            lambda s, v: jax.device_put(v, NamedSharding(mesh, s)),
            tree_specs, tree,
        )

    return TrainState(
        params=put({k: specs[k] for k in state.params}, state.params),
        opt_state=put(
            {k: {kk: specs[k] for kk in state.opt_state[k]} for k in state.opt_state},
            state.opt_state,
        ),
        key=jax.device_put(state.key, NamedSharding(mesh, P())),
        step=jax.device_put(state.step, NamedSharding(mesh, P())),
    )
