"""SPMD multi-chip training steps (jit + NamedSharding over the 2-D mesh).

The step body is the SAME functional code as single-chip training — only the
aggregation mode changes to 'dense' (full-table averaged gradients), which
keeps every per-parameter array sharded exactly like the parameter itself:
the scatter-add of batch gradients into the row-sharded entity table and the
implicit psum of replicated relation-table gradients are inserted by GSPMD
as collectives. `with_sharding_constraint` pins the gradient tables to
the parameter layout so XLA cannot materialize a replicated copy.

Single-device parity is tested on an 8-way virtual CPU mesh
(tests/test_sharded.py); the driver's `dryrun_multichip` compiles and runs
one step of this path on N virtual devices.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from skge_tpu.models.base import KGEModel
from skge_tpu.optim import Optimizer
from skge_tpu.parallel.mesh import (
    DATA_AXIS,
    batch_sharding,
    mask_sharding,
    state_shardings,
)
from skge_tpu.training import (
    StepMetrics,
    TrainState,
    apply_gradients,
    make_pairwise_update,
    make_pointwise_update,
    pairwise_grads_fused,
    select_shared_pairwise_fn,
    select_shared_pointwise_fn,
)


def make_sharded_pairwise_step(
    model: KGEModel,
    opt: Optimizer,
    sampler: Callable,
    margin: float,
    mesh: Mesh,
):
    """Jitted SPMD pairwise step: (state, batch (B,3), mask (B,)) -> ...

    `state` must be placed with `parallel.mesh.shard_state`; batch/mask are
    placed (or constrained) to the 'data' axis.
    """
    st_sh = state_shardings(model, mesh, opt)
    b_sh = batch_sharding(mesh)
    m_sh = mask_sharding(mesh)
    shared = hasattr(sampler, "pool")
    fused = hasattr(sampler, "corruptions")
    update = (
        None
        if fused or shared
        else make_pairwise_update(model, opt, margin, "dense")
    )

    def step(state: TrainState, batch, mask):
        batch = jax.lax.with_sharding_constraint(batch, b_sh)
        mask = jax.lax.with_sharding_constraint(mask, m_sh)
        key, sk = jax.random.split(state.key)
        if shared:
            # pool ids are replicated; pool scoring against the row-sharded
            # entity table inserts an all-gather of K pool rows over the interconnect,
            # and pool-row gradients psum back — both O(K*d), independent
            # of batch size
            pool_idx = sampler.pool(sk, batch, mask)
            loss, nviol, occ, g_dense = select_shared_pairwise_fn(model)(
                model, state.params, batch, pool_idx, mask, margin,
                modes=sampler.modes,
            )
            params, opt_state = apply_gradients(
                model, opt, state.params, state.opt_state, occ, g_dense,
                "dense", premasked=True, step=state.step,
            )
            new_state = TrainState(params, opt_state, key, state.step + 1)
            return new_state, StepMetrics(loss=loss, nviolations=nviol)
        if fused:
            # structurally-fused path: fewer gathers and smaller gradient
            # scatters => fewer/lighter cross-chip collectives on the
            # row-sharded entity table
            corr = sampler.corruptions(sk, batch, mask)
            loss, nviol, occ, g_dense = pairwise_grads_fused(
                model, state.params, batch, corr, mask, margin
            )
            params, opt_state = apply_gradients(
                model, opt, state.params, state.opt_state, occ, g_dense,
                "dense", premasked=True, step=state.step,
            )
            new_state = TrainState(params, opt_state, key, state.step + 1)
            return new_state, StepMetrics(loss=loss, nviolations=nviol)
        pos_rep, neg, pm = sampler(sk, batch, mask)
        state = state._replace(key=key)
        return update(state, pos_rep, neg, pm)

    metrics_sh = StepMetrics(
        loss=NamedSharding(mesh, P()), nviolations=NamedSharding(mesh, P())
    )
    return jax.jit(
        step,
        in_shardings=(st_sh, b_sh, m_sh),
        out_shardings=(st_sh, metrics_sh),
        donate_argnums=(0,),
    )


def make_sharded_pointwise_step(
    model: KGEModel,
    opt: Optimizer,
    sampler: Callable,
    mesh: Mesh,
):
    update = make_pointwise_update(model, opt, aggregate="dense")
    st_sh = state_shardings(model, mesh, opt)
    b_sh = batch_sharding(mesh)
    m_sh = mask_sharding(mesh)
    shared = hasattr(sampler, "pool")

    def step(state: TrainState, batch, mask):
        batch = jax.lax.with_sharding_constraint(batch, b_sh)
        mask = jax.lax.with_sharding_constraint(mask, m_sh)
        key, sk = jax.random.split(state.key)
        if shared:
            pool_idx = sampler.pool(sk, batch, mask)
            loss, occ, g_dense = select_shared_pointwise_fn(model)(
                model, state.params, batch, pool_idx, mask,
                modes=sampler.modes,
            )
            params, opt_state = apply_gradients(
                model, opt, state.params, state.opt_state, occ, g_dense,
                "dense", premasked=True, step=state.step,
            )
            new_state = TrainState(params, opt_state, key, state.step + 1)
            return new_state, StepMetrics(
                loss=loss, nviolations=jnp.zeros((), loss.dtype)
            )
        pos_rep, neg, pm = sampler(sk, batch, mask)
        state = state._replace(key=key)
        triples = jnp.concatenate([batch, neg])
        ys = jnp.concatenate(
            [jnp.ones(batch.shape[0]), -jnp.ones(neg.shape[0])]
        ).astype(model.jdtype)
        mm = jnp.concatenate([mask, pm])
        return update(state, triples, ys, mm)

    metrics_sh = StepMetrics(
        loss=NamedSharding(mesh, P()), nviolations=NamedSharding(mesh, P())
    )
    return jax.jit(
        step,
        in_shardings=(st_sh, b_sh, m_sh),
        out_shardings=(st_sh, metrics_sh),
        donate_argnums=(0,),
    )


def make_sharded_score_all_o(model: KGEModel, mesh: Mesh):
    """All-entity scoring with the (B, n_e) score matrix sharded over both
    mesh axes — the eval-time 'sharded matmul' (SURVEY.md §3.4)."""
    st = state_shardings(model, mesh)

    def score(params, s, p):
        s = jax.lax.with_sharding_constraint(
            s, NamedSharding(mesh, P(DATA_AXIS))
        )
        out = model.score_all_o(params, s, p)
        return jax.lax.with_sharding_constraint(
            out, NamedSharding(mesh, P(DATA_AXIS, None))
        )

    return jax.jit(score, in_shardings=(st.params, None, None))
