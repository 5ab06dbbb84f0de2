"""Partition-aligned SPMD training: edge partitioning + boundary-row
exchange over a 1-D 'shard' mesh (SURVEY.md §5 "long-context equivalent").

The shardmap_step module scales MEMORY (entity table split over 'model')
by replicating each batch across the model group — compute duplicates M
ways. This module instead aligns DATA and MODEL on one axis: entities are
partitioned (data.greedy_entity_partition), relabeled so each part owns a
contiguous row range (relabel_entities), and each shard trains on exactly
the triples whose SUBJECT it owns (data.partition_edges). Consequences:

- subject rows are always shard-local — zero communication;
- object / corruption rows are fetched with a request-response exchange:
  the (L,) object ids are all_gathered (tiny), every shard answers with
  its owned rows zero-filled elsewhere, and one psum('shard') assembles
  them — O(P*L*d) over the interconnect, no replicated compute, no
  full-table allgather;
- **compacted boundary exchange** (`boundary_cap=C`, shared-pool mode):
  with a community-structured graph most object rows are local, so each
  shard compacts its <= C NON-local object ids into a static-width
  request buffer (argsort-by-ownership — no dynamic shapes), all_gathers
  the (P, C) ids, and one tiled `psum_scatter` returns each shard exactly
  its C answered rows: O(P*C*d) = the full exchange times
  (1 - object_locality). Size C with `object_boundary_cap` (exact host
  count); overflow beyond C leaves the extra rows zero — cap generously;
- the shared negative pool is identical on every shard, so pool rows
  assemble with a single psum('shard') of owned rows — O(K*d);
- entity gradients: the default path scatters into a full-size local
  table and one `psum_scatter('shard')` both reduces across shards and
  leaves each shard exactly its owned slice — O(n_e*d) per step, one
  interconnect pass, but the full-size transient bounds it to tables that
  fit one device's HBM. With `boundary_cap` the gradient return is compacted
  too: owned occurrence rows scatter straight into the (S, d) shard
  table, and the <= C+K non-owned rows (boundary objects + non-owned
  pool entities) travel via one all_gather of (P, C+K, d) and an
  owner-filtered scatter — NO n_e-sized transient, so the entity table
  per chip is bounded by S = n_e/P, the true billion-row regime;
- `make_partitioned_epoch` is the epoch driver (the `make_epoch_fn`
  equivalent): per-shard on-device shuffle + minibatch lax.scan of the
  same step, with the cap clamped per minibatch to min(C, ceil(L/nb))
  — safe because the request compaction prioritizes valid
  gradient-carrying rows over shuffled-in padding.

Distributed math is EXACTLY the single-device update (tests/
test_partitioned.py): same duplicate-occurrence averaging, violation
filtering, AdaGrad + normless1 semantics as everywhere else.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from skge_tpu.models.base import KGEModel
from skge_tpu.optim import Optimizer
from skge_tpu.ops.aggregate import DenseGrads


from skge_tpu.training import (
    StepMetrics,
    TrainState,
    pairwise_grads_fused,
    pairwise_grads_shared,
    sampled_ce_grads_shared,
    selfadv_grads_shared,
)

SHARD_AXIS = "shard"


def ragged_mode(platform: str):
    """The `ragged` argument that exchange='ragged' runs with on `platform`:
    the real `ragged_all_to_all`, except on the CPU, whose XLA has no
    lowering for it; there the same placement runs through the dense
    emulation (`_ragged_send(emulate=True)`)."""
    return "emulate" if platform == "cpu" else True


def make_shard_mesh(devices=None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.asarray(devices), (SHARD_AXIS,))


def relabel_entities(
    triples: np.ndarray, entity_part: np.ndarray, n_parts: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Renumber entities so part p owns the contiguous rows [p*S, (p+1)*S).

    S = max part size; smaller parts leave unused padding rows (embedding
    row count is free). Returns (relabeled_triples, new_of_old, n_padded).
    """
    entity_part = np.asarray(entity_part)
    n_e = entity_part.shape[0]
    sizes = np.bincount(entity_part, minlength=n_parts)
    s = int(sizes.max())
    if n_parts * s >= 2**31:
        # relabeled ids run up to n_parts*S and are stored int32; fail
        # loudly instead of silently corrupting ids. Imbalanced partitions
        # inflate the padded id space — rebalance or split further.
        raise ValueError(
            f"relabeled id space n_parts*S = {n_parts}*{s} = "
            f"{n_parts * s} overflows int32; use more/better-balanced "
            "partitions"
        )
    order = np.argsort(entity_part, kind="stable")
    within = np.arange(n_e) - np.concatenate(
        [[0], np.cumsum(sizes)]
    )[entity_part[order]]
    new_of_old = np.empty(n_e, np.int64)
    new_of_old[order] = entity_part[order].astype(np.int64) * s + within
    t = np.asarray(triples)
    out = np.stack(
        [new_of_old[t[:, 0]], new_of_old[t[:, 1]], t[:, 2]], axis=1
    ).astype(np.int32)
    return out, new_of_old, n_parts * s


def object_boundary_cap(
    batches: np.ndarray, s_rows: int, mask: np.ndarray | None = None
) -> int:
    """Exact max count, over shards, of NON-local object ids in `batches`.

    `batches` is the (P, L, 3) output of data.partition_edges on RELABELED
    triples (shard p owns rows [p*S, (p+1)*S)). Use the result (or any
    larger value) as `boundary_cap` for make_partitioned_pairwise_step /
    make_partitioned_epoch. Pass `mask` to count only valid rows — the
    request compaction prioritizes valid non-local rows, so masked padding
    never consumes cap slots.
    """
    b = np.asarray(batches)
    caps = []
    for p in range(b.shape[0]):
        obj = b[p, :, 1]
        nonlocal_ = (obj < p * s_rows) | (obj >= (p + 1) * s_rows)
        if mask is not None:
            nonlocal_ = nonlocal_ & (np.asarray(mask)[p] > 0)
        caps.append(int(np.sum(nonlocal_)))
    return max(caps) if caps else 0


def _ragged_send(
    payload, in_off, sizes, out_off, recv_sizes, out_len, emulate, fill=0
):
    """One owner-routed hop (inside shard_map over SHARD_AXIS).

    `payload` (N, ...) is the static send buffer with the rows for
    destination q at [in_off[q], in_off[q]+sizes[q]); my block lands at
    [out_off[q], +sizes[q]) in q's (out_len, ...) output; I receive
    recv_sizes[s] rows from each sender s. The destination regions must
    tile [0, sum(recv_sizes)) (both call sites' cumsum plans do).

    `emulate=True` runs the identical placement through a dense
    all_to_all frame and a receivers' sum of the disjoint blocks —
    byte-identical output layout to the real `ragged_all_to_all`, for
    backends without the op (CPU tests). Untouched tail rows hold
    `fill`.
    """
    if not emulate:
        return jax.lax.ragged_all_to_all(
            payload,
            jnp.full((out_len,) + payload.shape[1:], fill, payload.dtype),
            in_off.astype(jnp.int32), sizes.astype(jnp.int32),
            out_off.astype(jnp.int32), recv_sizes.astype(jnp.int32),
            axis_name=SHARD_AXIS,
        )
    p_sz = sizes.shape[0]
    n = payload.shape[0]
    j = jnp.arange(p_sz * out_len, dtype=jnp.int32)
    dest, slot = j // out_len, j % out_len
    src = jnp.clip(in_off[dest] + (slot - out_off[dest]), 0, n - 1)
    val = jnp.logical_and(
        slot >= out_off[dest], slot < out_off[dest] + sizes[dest]
    )
    rows = jnp.where(
        val.reshape((-1,) + (1,) * (payload.ndim - 1)), payload[src], 0
    ).reshape((p_sz, out_len) + payload.shape[1:])
    out = jnp.sum(
        jax.lax.all_to_all(rows, SHARD_AXIS, split_axis=0, concat_axis=0),
        axis=0,
    )
    if fill != 0:
        tail = jnp.arange(out_len) >= jnp.sum(recv_sizes)
        out = jnp.where(
            tail.reshape((-1,) + (1,) * (out.ndim - 1)), fill, out
        )
    return out


def _warn_if_cap_exceeded(n_needed, cap: int, what: str) -> None:
    """Runtime guard for an undersized compaction cap: rows beyond the cap
    silently contribute zero gradient, so surface it loudly (device-side
    print fires only when tripped; steady-state cost is one reduce).

    OPT-IN (`debug_checks=True` on the step/epoch builders): the print is
    a host callback inside the step. PartitionedTrainer sizes the cap
    exactly (object_boundary_cap) and does not need it."""

    def warn():
        jax.debug.print(
            "skge_tpu PARTITIONED WARNING: {n} valid non-local rows but "
            + what
            + f"={cap} — the excess rows are DROPPED and gradients are "
            "wrong; size the cap with object_boundary_cap", n=n_needed,
        )
        return 0

    jax.lax.cond(n_needed > cap, warn, lambda: 0)


def make_partitioned_pairwise_step(
    model: KGEModel,
    opt: Optimizer,
    sampler: Callable,
    margin: float,
    mesh: Mesh,
    boundary_cap: int | None = None,
    overlap: bool = True,
    ragged=False,
    debug_checks: bool = False,
):
    """Jitted partition-aligned pairwise step.

    Inputs: state placed by `shard_state_partitioned`; `batches` (P, L, 3)
    and `mask` (P, L) from data.partition_edges on RELABELED triples —
    shard p receives row p. Requires model.n_entities == P * S (use
    relabel_entities' n_padded). Supports the `pool` and `corruptions`
    sampler protocols.

    `boundary_cap` (shared-pool samplers only) switches both the entity-row
    gather and the gradient return to the compacted boundary exchange (see
    the module docstring): communication O(P*(C+K)*d) per step instead of
    O(P*L*d + n_e*d), and no n_e-sized transient. C must be >= the max
    per-shard non-local object count (`object_boundary_cap`); rows beyond
    the cap silently contribute zero, so size it from the data, not a
    guess.

    `overlap` (default True) expresses the answer exchange as
    `all_to_all` + a local one-nonzero-per-row sum instead of a
    `psum`/`psum_scatter` reduction. Row values are bitwise identical
    (every request row has exactly one owner; the others contribute
    zeros), but the collective becomes one that an asynchronous
    collective scheduler can split into start/done and hide behind
    scoring compute that does not depend on the fetched object rows (the
    mode-1 pool matmul needs only subject + pool rows). It also halves
    the exchange volume of the non-compacted path (all-reduce moves ~2x
    an all-to-all). SURVEY.md §7 hard part (e).
    """
    epname, s_rows, shared, state_spec = _prep(
        model, opt, mesh, sampler, boundary_cap
    )
    if ragged and boundary_cap is None:
        raise ValueError("ragged exchange requires boundary_cap")
    local_step = _build_local_step(
        model, opt, sampler, margin, epname, s_rows, shared, boundary_cap,
        overlap, ragged, debug_checks,
    )

    def block_step(state: TrainState, batch, mask):
        return local_step(state, batch[0], mask[0])  # strip (1, L, ...) block

    smapped = jax.shard_map(
        block_step,
        mesh=mesh,
        in_specs=(state_spec, P(SHARD_AXIS, None, None), P(SHARD_AXIS, None)),
        out_specs=(state_spec, StepMetrics(loss=P(), nviolations=P())),
        check_vma=False,
    )
    return jax.jit(smapped, donate_argnums=(0,))


def make_partitioned_selfadv_step(
    model: KGEModel,
    opt: Optimizer,
    sampler: Callable,
    margin: float,
    mesh: Mesh,
    alpha: float = 1.0,
    boundary_cap: int | None = None,
    overlap: bool = True,
    ragged=False,
    debug_checks: bool = False,
):
    """Partition-aligned SELF-ADVERSARIAL step (Sun et al. 2019): the
    strongest measured loss (RESULTS.md) on the billion-row path. Same
    inputs, exchange machinery (incl. `boundary_cap` compaction, overlap,
    ragged routing) and collective structure as
    `make_partitioned_pairwise_step`; only the per-pair loss and the
    dense-gradient normalization (scored elements instead of violations)
    differ. Requires a `pool`-protocol sampler."""
    if not hasattr(sampler, "pool"):
        raise ValueError(
            "make_partitioned_selfadv_step needs a shared-pool sampler"
        )
    epname, s_rows, shared, state_spec = _prep(
        model, opt, mesh, sampler, boundary_cap
    )
    if ragged and boundary_cap is None:
        raise ValueError("ragged exchange requires boundary_cap")
    local_step = _build_local_step(
        model, opt, sampler, margin, epname, s_rows, shared, boundary_cap,
        overlap, ragged, debug_checks, loss_kind="selfadv", alpha=alpha,
    )

    def block_step(state: TrainState, batch, mask):
        return local_step(state, batch[0], mask[0])

    smapped = jax.shard_map(
        block_step,
        mesh=mesh,
        in_specs=(state_spec, P(SHARD_AXIS, None, None), P(SHARD_AXIS, None)),
        out_specs=(state_spec, StepMetrics(loss=P(), nviolations=P())),
        check_vma=False,
    )
    return jax.jit(smapped, donate_argnums=(0,))


def make_partitioned_sampled_ce_step(
    model: KGEModel,
    opt: Optimizer,
    sampler: Callable,
    mesh: Mesh,
    directions: Tuple[str, ...] = ("o", "s"),
    label_smoothing: float = 0.0,
    boundary_cap: int | None = None,
    overlap: bool = True,
    ragged=False,
    debug_checks: bool = False,
):
    """Partition-aligned SAMPLED-softmax-CE step (no reference counterpart;
    completes the loss x distribution matrix for the practical
    10^7+-vocabulary scheme): the importance-corrected exclusion-form
    estimator of `sampled_ce_grads_shared` on the entity-sharded layout.

    Unlike full partitioned CE — whose candidates ARE the shard rows, so
    queries must all_gather — the sampled candidate pool is small and
    identical on every shard (drawn from the unfolded key), so each shard
    scores only its OWN batch: pool rows arrive through one replicated
    psum gather, subject rows are shard-local by construction, object/
    label rows ride the same request-response exchange as the pairwise
    path (incl. `boundary_cap` compaction and `ragged` owner routing).
    Occurrence gradients keep the sampled-CE SUM semantics (the k=n_e ==
    full-CE identity needs sums, see training.apply_gradients
    combine='sum'), rescaled from the local-batch mean to the global one;
    fp64 trajectory parity with the single-device `make_sampled_ce_step`
    on the same relabeled batch is pinned in tests/test_partitioned.py.
    A sampler with unigram `logits` feeds the proposal correction, as on
    the single-device path."""
    if not hasattr(sampler, "pool"):
        raise ValueError(
            "make_partitioned_sampled_ce_step needs a shared-pool sampler"
        )
    epname, s_rows, shared, state_spec = _prep(
        model, opt, mesh, sampler, boundary_cap
    )
    if ragged and boundary_cap is None:
        raise ValueError("ragged exchange requires boundary_cap")
    local_step = _build_local_step(
        model, opt, sampler, 0.0, epname, s_rows, shared, boundary_cap,
        overlap, ragged, debug_checks, loss_kind="sampled_ce",
        directions=directions, label_smoothing=label_smoothing,
    )

    def block_step(state: TrainState, batch, mask):
        return local_step(state, batch[0], mask[0])

    smapped = jax.shard_map(
        block_step,
        mesh=mesh,
        in_specs=(state_spec, P(SHARD_AXIS, None, None), P(SHARD_AXIS, None)),
        out_specs=(state_spec, StepMetrics(loss=P(), nviolations=P())),
        check_vma=False,
    )
    return jax.jit(smapped, donate_argnums=(0,))


def make_partitioned_ce_step(
    model: KGEModel,
    opt: Optimizer,
    mesh: Mesh,
    directions: Tuple[str, ...] = ("o", "s"),
    label_smoothing: float = 0.0,
    overlap: bool = True,
):
    """Partition-aligned FULL-CROSS-ENTROPY step (VERDICT r2 ask 2): the
    framework's best-quality scheme on its billion-row layout.

    Composition of the two existing pieces: the entity-sharded layout of
    the pairwise partitioned step (each shard owns contiguous rows and its
    subject-local triples) and the vocab-parallel softmax of
    `make_shardmap_ce_step` — but where that step replicates every batch
    across the model group (compute x M), here each shard contributes its
    OWN batch and the gathered queries are scored once per candidate
    block: total logit FLOPs equal the single-device step's, split P ways.

        queries   all_gather of the (B, d)-ish slot rows   O(P*B*d) link
        logits_l  (P*B, S) local matmul per shard          no replication
        softmax   max/sum-exp/label psums                  O(P*B) scalars

    Gradients mirror the shardmap-CE recipe: autodiff w.r.t. (gathered
    query rows, local candidate block, dense params) inside shard_map,
    divide by P (psum-transpose replication — see make_shardmap_ce_step's
    in-body note), complete query-row partials with one psum, and scatter
    owned rows locally; candidate-block and dense gradients are whole
    after the rescale. Updates run `apply_full` per shard slice — the
    single-device CE convention (every row touched each step), so fp64
    trajectories match `make_ce_step` on the same relabeled batch
    (tests/test_partitioned.py::test_ce_*).

    Notes: the contiguous relabeling's PADDING rows participate in the
    partition function exactly as they do when running single-device CE
    on the padded model (parity), receive only partition-function
    gradients, and are masked out of candidates at evaluation
    (PartitionedTrainer.evaluate). Direction 's' queries need object
    rows, fetched with the same request-response exchange as the pairwise
    path; with `directions=('o',)` (the reciprocal protocol) no entity
    row ever crosses the interconnect in the forward gather.
    """
    epname, _, state_spec = partitioned_state_specs(model, opt)
    p_size = mesh.shape[SHARD_AXIS]
    n_e = model.n_entities
    if n_e % p_size != 0:
        raise ValueError(
            f"n_entities={n_e} must be {p_size}*S — relabel with "
            "relabel_entities and build the model with its n_padded"
        )
    s_rows = n_e // p_size
    local_step = _build_ce_local_step(
        model, opt, epname, s_rows, directions, label_smoothing, overlap
    )

    def block_step(state: TrainState, batch, mask):
        return local_step(state, batch[0], mask[0])

    smapped = jax.shard_map(
        block_step,
        mesh=mesh,
        in_specs=(state_spec, P(SHARD_AXIS, None, None), P(SHARD_AXIS, None)),
        out_specs=(state_spec, StepMetrics(loss=P(), nviolations=P())),
        check_vma=False,
    )
    return jax.jit(smapped, donate_argnums=(0,))


def _build_ce_local_step(
    model, opt, epname, s_rows, directions, label_smoothing, overlap=True
):
    """Per-shard CE step body (see make_partitioned_ce_step)."""
    n_e = model.n_entities
    slot_spec = model.slot_spec()
    ls = float(label_smoothing)
    need_roles = {"p"}
    if "o" in directions:
        need_roles.add("s")
    if "s" in directions:
        need_roles.add("o")

    def local_step(state: TrainState, batch, mask):
        params = state.params
        me = jax.lax.axis_index(SHARD_AXIS)
        p_sz = jax.lax.axis_size(SHARD_AXIS)
        row_off = me * s_rows
        s, o, p = batch[:, 0], batch[:, 1], batch[:, 2]
        role_idx = {"s": s, "o": o, "p": p}

        def local_rows(idx):
            local = idx - row_off
            own = jnp.logical_and(local >= 0, local < s_rows)
            rows = params[epname][jnp.clip(local, 0, s_rows - 1)]
            return jnp.where(
                own.reshape(own.shape + (1,) * (rows.ndim - 1)), rows, 0
            )

        def exchange(answers):
            if overlap:  # async-fusable; value-identical (one owner/row)
                blocks = answers.reshape((p_sz, -1) + answers.shape[1:])
                recv = jax.lax.all_to_all(
                    blocks, SHARD_AXIS, split_axis=0, concat_axis=0
                )
                return jnp.sum(recv, axis=0)
            return jax.lax.psum_scatter(
                answers, SHARD_AXIS, scatter_dimension=0, tiled=True
            )

        def gather(pname, idx, role):
            if pname != epname:
                return params[pname][idx]
            if role == "s":  # subject rows are shard-local by construction
                return params[epname][idx - row_off]
            all_ids = jax.lax.all_gather(idx, SHARD_AXIS)
            return exchange(local_rows(all_ids.reshape(-1)))

        rows = {
            slot: gather(pname, role_idx[role], role)
            for slot, pname, role in slot_spec if role in need_roles
        }

        def ag(x):  # replicate every shard's batch-aligned array
            g = jax.lax.all_gather(x, SHARD_AXIS)
            return g.reshape((-1,) + g.shape[2:])

        rows_all = {k: ag(v) for k, v in rows.items()}
        mask_all = ag(mask)
        labels_all = {d: ag(role_idx[d]) for d in directions}
        idx_all = {r: ag(role_idx[r]) for r in need_roles}
        e_local = params[epname]
        dense = model.dense_params(params)
        barange = jnp.arange(mask_all.shape[0])
        denom = jnp.maximum(jnp.sum(mask_all), 1.0)

        def loss_fn(rows_all, e_local, dense):
            total = 0.0
            for d in directions:
                mode = {"o": 1, "s": 0}[d]
                labels = labels_all[d]
                logits_l = model.score_pool(rows_all, e_local, dense, mode)
                mrow = jnp.max(
                    jax.lax.all_gather(
                        jnp.max(logits_l, axis=1), SHARD_AXIS
                    ),
                    axis=0,
                )
                se = jax.lax.psum(
                    jnp.sum(jnp.exp(logits_l - mrow[:, None]), axis=1),
                    SHARD_AXIS,
                )
                logz = jnp.log(se) + mrow
                ll = labels - row_off
                own = jnp.logical_and(ll >= 0, ll < s_rows)
                fl = logits_l[barange, jnp.clip(ll, 0, s_rows - 1)]
                f_label = jax.lax.psum(jnp.where(own, fl, 0.0), SHARD_AXIS)
                nll = logz - f_label
                if ls:
                    sum_logits = jax.lax.psum(
                        jnp.sum(logits_l, axis=1), SHARD_AXIS
                    )
                    mean_logp = sum_logits / n_e - logz
                    nll = (1.0 - ls) * nll - ls * mean_logp
                total = total + jnp.sum(nll * mask_all)
            return total / denom

        loss, (g_rows, g_cand, g_dense) = jax.value_and_grad(
            loss_fn, argnums=(0, 1, 2)
        )(rows_all, e_local, dense)
        # /P cotangent rescale + query-row completion: identical reasoning
        # to make_shardmap_ce_step's in-body note — every logits->loss path
        # crosses a shard-axis collective, whose shard_map transpose sums
        # the replicated downstream cotangents, so local grads are P * the
        # true partial. The candidate-block partial is then already the
        # whole gradient for owned rows (every query's contribution to my
        # block is computed on MY shard); query-row and dense partials need
        # one completion psum.
        psz = float(jax.lax.axis_size(SHARD_AXIS))
        g_rows = {
            k: jax.lax.psum(g / psz, SHARD_AXIS) for k, g in g_rows.items()
        }
        g_cand = g_cand / psz
        g_dense = {
            k: jax.lax.psum(g / psz, SHARD_AXIS) for k, g in g_dense.items()
        }

        g_tables = {epname: g_cand}
        for slot, pname, role in slot_spec:
            if slot not in g_rows:
                continue
            g = g_rows[slot]  # (P*B, ...) full grads, replicated
            ids = idx_all[role]
            if pname == epname:
                local = ids - row_off
                owng = jnp.logical_and(local >= 0, local < s_rows)
                g_tables[pname] = g_tables[pname].at[
                    jnp.where(owng, local, s_rows)
                ].add(g, mode="drop")
            else:  # replicated table: identical scatter on every shard
                g_tables[pname] = g_tables.get(
                    pname, jnp.zeros_like(params[pname])
                ).at[ids].add(g)
        for pname, g in g_dense.items():
            g_tables[pname] = g_tables.get(pname, 0.0) + g

        reg = model.regularization
        reg3 = model.regularization_n3
        new_params = dict(params)
        new_opt = dict(state.opt_state)
        for pname, g in g_tables.items():
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
        key, _ = jax.random.split(state.key)  # keep key-stream parity
        new_state = TrainState(new_params, new_opt, key, state.step + 1)
        return new_state, StepMetrics(
            loss=loss, nviolations=jnp.zeros((), loss.dtype)
        )

    return local_step


def partitioned_state_specs(model, opt):
    """(epname, per-param PartitionSpecs, TrainState-of-PartitionSpecs)
    for the partitioned placement: entity table row-sharded over 'shard',
    everything else replicated."""
    by_role = {role: pname for _, pname, role in model.slot_spec()}
    epname = by_role["s"]
    assert epname == by_role["o"]
    specs = {}
    for _, pname, role in model.slot_spec():
        specs[pname] = P(SHARD_AXIS) if pname == epname else P()
    for pname in model.dense_param_names:
        specs[pname] = P()
    slot_names = tuple(opt.init({"x": jnp.zeros(1)})["x"])
    state_spec = TrainState(
        params=dict(specs),
        opt_state={k: {sn: specs[k] for sn in slot_names} for k in specs},
        key=P(),
        step=P(),
    )
    return epname, specs, state_spec


def _prep(model, opt, mesh, sampler, boundary_cap):
    """Shared validation + PartitionSpecs for the partitioned builders."""
    epname, _, state_spec = partitioned_state_specs(model, opt)
    p_size = mesh.shape[SHARD_AXIS]
    n_e = model.n_entities
    if n_e % p_size != 0:
        raise ValueError(
            f"n_entities={n_e} must be {p_size}*S — relabel with "
            "relabel_entities and build the model with its n_padded"
        )
    s_rows = n_e // p_size
    shared = hasattr(sampler, "pool")
    if boundary_cap is not None and not shared:
        raise ValueError(
            "boundary_cap requires a shared-pool sampler (the iid "
            "corruption gather is ~uniformly non-local; compaction only "
            "pays when most object rows are shard-local)"
        )
    return epname, s_rows, shared, state_spec


def _build_local_step(
    model, opt, sampler, margin, epname, s_rows, shared, boundary_cap,
    overlap=True, ragged=False, debug_checks=False,
    loss_kind="margin", alpha=1.0,
    directions=("o", "s"), label_smoothing=0.0,
):
    """Per-shard step body: (state, (L, 3) batch, (L,) mask) -> updated
    state + globally-psum'd metrics. Runs inside shard_map."""
    n_e = model.n_entities
    log_q_table = None
    if loss_kind == "sampled_ce":
        logits = getattr(sampler, "logits", None)
        if logits is not None:
            log_q_table = jax.nn.log_softmax(jnp.asarray(logits))

    def local_step(state: TrainState, batch, mask):
        params = state.params
        me = jax.lax.axis_index(SHARD_AXIS)
        p_sz = jax.lax.axis_size(SHARD_AXIS)
        row_off = me * s_rows

        def local_rows(idx):
            """Owned rows for arbitrary global ids, zeros elsewhere."""
            local = idx - row_off
            own = jnp.logical_and(local >= 0, local < s_rows)
            rows = params[epname][jnp.clip(local, 0, s_rows - 1)]
            return jnp.where(
                own.reshape(own.shape + (1,) * (rows.ndim - 1)), rows, 0
            )

        def _exchange(answers):
            """(P*T, d) per-shard answer blocks -> (T, d) rows for MY
            requests. Every row has exactly ONE owning shard; the other
            shards contribute exact zeros, so the all_to_all + sum is
            value-identical to the psum_scatter reduction — but
            all_to_all is async-fusable (overlappable with scoring) and
            moves half the bytes of an all-reduce."""
            if overlap:
                blocks = answers.reshape((p_sz, -1) + answers.shape[1:])
                recv = jax.lax.all_to_all(
                    blocks, SHARD_AXIS, split_axis=0, concat_axis=0
                )                                       # (P, T, d): per-owner
                return jnp.sum(recv, axis=0)
            return jax.lax.psum_scatter(
                answers, SHARD_AXIS, scatter_dimension=0, tiled=True
            )

        def gather(pname, idx, role=None):
            if pname != epname:
                return params[pname][idx]
            if role == "s":
                # subjects are shard-local BY CONSTRUCTION (partition_edges
                # groups triples by the subject's owner): a direct local
                # gather, no collective. Saves one full exchange per step.
                return params[epname][idx - row_off]
            # object / corruption ids are not local — resolve ownership
            # generically: local part + exchange. Identical-ids case
            # (pool / same idx on all shards) would need only the psum;
            # differing ids need the request exchange.
            all_ids = jax.lax.all_gather(idx, SHARD_AXIS)       # (P, T)
            answers = local_rows(all_ids.reshape(-1))           # (P*T, d)
            return _exchange(answers)                           # (T, d)

        def gather_replicated(pname, idx, role=None):
            """Cheaper path when ids are identical on every shard (pool)."""
            if pname != epname:
                return params[pname][idx]
            return jax.lax.psum(local_rows(idx), SHARD_AXIS)

        def _ragged_exchange(req_ids):
            """Owner-routed boundary fetch: each answer row travels ONCE
            (from its owning shard to the requester) instead of riding a
            P-wide dense block — exchange volume C*d per shard, a P-fold
            reduction over the dense all_to_all (scaling-book recipe:
            shrink the bytes before hiding them).

            Bookkeeping (all static-shape): requests sort by owner, a tiny
            (P, P) count matrix is all_gathered, and the cumulative sums
            give every sender its input offsets AND where its block lands
            in each receiver's owner-ordered output — exactly the
            sender-specified layout `jax.lax.ragged_all_to_all` wants.
            `ragged='emulate'` runs the SAME bookkeeping through a dense
            all_to_all with rows placed at their ragged output offsets
            (receivers sum the one-nonzero-per-row blocks) — bit-identical
            output, runs on backends without the ragged op (CPU tests).
            Returns answers in REQUEST order."""
            c = req_ids.shape[0]
            owner = jnp.clip(req_ids // s_rows, 0, p_sz - 1)
            o_perm = jnp.argsort(owner, stable=True)
            req_sorted = req_ids[o_perm]                 # (C,) owner-grouped
            counts = jnp.zeros((p_sz,), jnp.int32).at[owner].add(1)
            all_req = jax.lax.all_gather(req_sorted, SHARD_AXIS)   # (P, C)
            all_counts = jax.lax.all_gather(counts, SHARD_AXIS)    # (P, P)
            # starts[q, o] = offset of owner o's block in q's sorted requests
            starts = jnp.cumsum(all_counts, axis=1) - all_counts
            # --- answer side (me as owner) ---
            flat_req = all_req.reshape(-1)               # (P*C,)
            flat_owner = jnp.clip(flat_req // s_rows, 0, p_sz - 1)
            mine_mask = flat_owner == me
            pack = jnp.argsort(~mine_mask, stable=True)  # mine first, in
            send_ids = flat_req[pack]                    # (q, within-q) order
            send_rows = params[epname][
                jnp.clip(send_ids - row_off, 0, s_rows - 1)
            ]                                            # (P*C, d) static buf
            sizes_for_me = all_counts[:, me]             # (P,) rows per dest q
            input_offsets = jnp.cumsum(sizes_for_me) - sizes_for_me
            output_offsets = starts[:, me]               # my block's spot at q
            recv = _ragged_send(
                send_rows, input_offsets, sizes_for_me, output_offsets,
                counts, c, emulate=(ragged == "emulate"),
            )                                            # (C, d) owner-ordered
            inv = jnp.zeros((c,), jnp.int32).at[o_perm].set(
                jnp.arange(c, dtype=jnp.int32)
            )
            return recv[inv]                             # request order

        def gather_compact(idx):
            """Compacted boundary exchange: fetch only the <= C non-local
            ids through the collective; local ids gather locally.

            argsort packs VALID non-owned positions first (static shapes;
            masked padding rows must not consume cap slots — their scores
            carry zero loss/gradient either way). Surplus slots re-request
            other rows, whose exchanged answer equals the correct row, so
            the final `set` is value-identical for them."""
            local = idx - row_off
            own = jnp.logical_and(local >= 0, local < s_rows)
            needed = jnp.logical_and(~own, mask > 0)
            if debug_checks:
                _warn_if_cap_exceeded(
                    jnp.sum(needed), boundary_cap, "boundary_cap"
                )
            req_pos = jnp.argsort(~needed)[:boundary_cap]  # needed first
            if ragged:
                mine = _ragged_exchange(idx[req_pos])   # (C, d)
            else:
                all_req = jax.lax.all_gather(
                    idx[req_pos], SHARD_AXIS
                )                                       # (P, C) ids — tiny
                answers = local_rows(all_req.reshape(-1))  # (P*C, d)
                mine = _exchange(answers)               # (C, d): my requests
            rows = params[epname][jnp.clip(local, 0, s_rows - 1)]
            rows = jnp.where(own[:, None], rows, 0)
            return rows.at[req_pos].set(mine)

        key, sk = jax.random.split(state.key)
        dk = jax.random.fold_in(sk, me)
        if shared:
            # pool drawn from the UNFOLDED key: identical across shards
            pool_idx = sampler.pool(sk, batch, mask)

            def g(pname, idx, role=None):
                if idx is pool_idx:
                    return gather_replicated(pname, idx)
                if role == "s" and pname == epname:
                    return params[epname][idx - row_off]  # local (see gather)
                if boundary_cap is not None and pname == epname:
                    return gather_compact(idx)
                return gather(pname, idx, role)

            if loss_kind == "selfadv":
                loss, occ, g_dense = selfadv_grads_shared(
                    model, params, batch, pool_idx, mask, margin, alpha,
                    modes=sampler.modes, gather=g,
                )
                nviol = jnp.zeros((), loss.dtype)
                # selfadv dense grads are means over scored ELEMENTS; keep
                # the RAW count for the global denominator (clamping before
                # the psum would let fully-masked shards inflate it)
                dnorm_raw = jnp.sum(mask) * (
                    1.0 + pool_idx.shape[0] * len(sampler.modes)
                )
                dnorm_local = jnp.maximum(dnorm_raw, 1.0)
            elif loss_kind == "sampled_ce":
                loss, occ, g_dense = sampled_ce_grads_shared(
                    model, params, batch, pool_idx, mask,
                    directions=directions,
                    label_smoothing=label_smoothing,
                    log_q=(None if log_q_table is None
                           else log_q_table[pool_idx]),
                    gather=g,
                )
                nviol = jnp.zeros((), loss.dtype)
                # sampled-CE occurrence grads are SUMS of the mean-over-
                # LOCAL-valid loss; rescale them (and the reported loss) to
                # the global mean here, so the shared psum'd aggregation
                # below reproduces the single-device trajectory exactly
                dnorm_raw = jnp.sum(mask)
                dnorm_local = jnp.maximum(dnorm_raw, 1.0)
                g_all = jnp.maximum(
                    jax.lax.psum(dnorm_raw, SHARD_AXIS), 1.0
                )
                scale = dnorm_local / g_all
                occ = {
                    pn: (i, gr * scale, c) for pn, (i, gr, c) in occ.items()
                }
                loss = loss * dnorm_raw / g_all
            else:
                loss, nviol, occ, g_dense = pairwise_grads_shared(
                    model, params, batch, pool_idx, mask, margin,
                    modes=sampler.modes, gather=g,
                )
                dnorm_local = None
        else:
            corr = sampler.corruptions(dk, batch, mask)
            loss, nviol, occ, g_dense = pairwise_grads_fused(
                model, params, batch, corr, mask, margin, gather=gather
            )
            dnorm_local = None

        loss = jax.lax.psum(loss, SHARD_AXIS)
        nviol_local = nviol
        nviol = jax.lax.psum(nviol, SHARD_AXIS)
        if dnorm_local is None:  # margin losses normalize by violations
            dnorm_local = jnp.maximum(nviol_local, 1.0)
            dnorm_global = jnp.maximum(nviol, 1.0)
        else:
            dnorm_global = jnp.maximum(
                jax.lax.psum(dnorm_raw, SHARD_AXIS), 1.0
            )

        new_params = dict(params)
        new_opt = dict(state.opt_state)
        reg = model.regularization
        reg3 = model.regularization_n3
        for pname, (idx, grads, counts) in occ.items():
            t = idx.shape[0]
            aug = jnp.concatenate(
                [grads.reshape(t, -1), counts.astype(grads.dtype)[:, None]],
                axis=1,
            )
            if pname == epname and boundary_cap is not None:
                # compacted gradient return: owned occurrence rows scatter
                # straight into the (S, F+1) shard table; the <= C+K
                # non-owned rows (boundary objects + non-owned pool ids)
                # travel via ONE all_gather and an owner-filtered scatter.
                # No n_e-sized transient anywhere.
                local = idx - row_off
                own = jnp.logical_and(local >= 0, local < s_rows)
                table = jnp.zeros(
                    (s_rows, aug.shape[1]), grads.dtype
                ).at[jnp.where(own, local, s_rows)].add(aug, mode="drop")
                gcap = boundary_cap + pool_idx.shape[0]
                # prioritize non-owned rows CARRYING gradient (masked /
                # non-violating rows are all-zero and lose nothing when
                # dropped), so <= C valid boundary objects + <= K pool
                # rows always fit the cap even after shuffling
                nonzero = jnp.any(aug != 0, axis=1)
                needed = jnp.logical_and(~own, nonzero)
                if debug_checks:
                    _warn_if_cap_exceeded(
                        jnp.sum(needed), gcap, "gradient-return cap"
                    )
                npos = jnp.argsort(~needed)[:gcap]      # needed first
                # zero the surplus slots (owned rows already scattered
                # above — without this they would double-count)
                nb_aug = aug[npos] * needed[npos].astype(grads.dtype)[:, None]
                if ragged:
                    # owner-routed gradient return: each non-owned row
                    # travels once to its owning shard — (C+K)*F bytes vs
                    # the broadcast's P*(C+K)*F (the step's biggest
                    # collective). Rows sort by destination (STABLE, so
                    # same-table-row adds keep their order and the scatter
                    # is bitwise-identical to the dense return); ids ride
                    # a second tiny ragged op. Receive layout is
                    # sender-major in both the real packed op and the
                    # emulation's per-sender blocks; surplus slots carry
                    # id -1 (dropped) and zero rows.
                    rid = idx[npos]
                    dst = jnp.clip(rid // s_rows, 0, p_sz - 1)
                    dperm = jnp.argsort(dst, stable=True)
                    pay = nb_aug[dperm]
                    ids_s = rid[dperm].astype(jnp.int32)
                    cnt = jnp.zeros((p_sz,), jnp.int32).at[dst].add(1)
                    allc = jax.lax.all_gather(cnt, SHARD_AXIS)  # (P,P) s->d
                    in_off = (jnp.cumsum(cnt) - cnt).astype(jnp.int32)
                    col_cum = jnp.cumsum(allc, axis=0) - allc
                    out_off = col_cum[me].astype(jnp.int32)
                    recv_sz = allc[:, me].astype(jnp.int32)
                    emu = ragged == "emulate"
                    all_aug = _ragged_send(
                        pay, in_off, cnt, out_off, recv_sz, p_sz * gcap,
                        emulate=emu,
                    )
                    all_ids = _ragged_send(
                        ids_s, in_off, cnt, out_off, recv_sz, p_sz * gcap,
                        emulate=emu, fill=-1,
                    )
                elif overlap:
                    # express the row broadcast as an all_to_all of P
                    # identical blocks: received block p == shard p's
                    # rows, exactly the all_gather layout — but as an
                    # all_to_all it can run asynchronously behind the
                    # owned-row scatter + relation/dense updates.
                    def bcast_a2a(x):
                        b = jnp.broadcast_to(x[None], (p_sz,) + x.shape)
                        return jax.lax.all_to_all(
                            b, SHARD_AXIS, split_axis=0, concat_axis=0
                        )
                    all_ids = bcast_a2a(idx[npos]).reshape(-1)
                    all_aug = bcast_a2a(nb_aug).reshape(-1, aug.shape[1])
                else:
                    all_ids = jax.lax.all_gather(
                        idx[npos], SHARD_AXIS
                    ).reshape(-1)                       # (P*(C+K),)
                    all_aug = jax.lax.all_gather(
                        nb_aug, SHARD_AXIS
                    ).reshape(-1, aug.shape[1])
                lcl = all_ids - row_off
                owng = jnp.logical_and(lcl >= 0, lcl < s_rows)
                table = table.at[jnp.where(owng, lcl, s_rows)].add(
                    all_aug, mode="drop"
                )
            elif pname == epname:
                full = jnp.zeros((n_e, aug.shape[1]), grads.dtype).at[
                    idx
                ].add(aug, mode="drop")
                table = jax.lax.psum_scatter(
                    full, SHARD_AXIS, scatter_dimension=0, tiled=True
                )  # (S, F+1): reduced AND sliced to the owned rows
            else:
                table = jnp.zeros(
                    (model.num_rows(pname), aug.shape[1]), grads.dtype
                ).at[idx].add(aug, mode="drop")
                table = jax.lax.psum(table, SHARD_AXIS)
            count = table[:, -1]
            feat = grads.shape[1:]
            gsum = table[:, :-1].reshape((table.shape[0],) + feat)
            if loss_kind == "sampled_ce":
                # sampled-CE keeps SUM semantics over duplicate occurrences
                # (training.apply_gradients combine='sum'): the k=n_e ==
                # full-CE identity needs sums; counts still gate which
                # rows update
                gavg = gsum
            else:
                gavg = gsum / jnp.maximum(count, 1.0).reshape(
                    (-1,) + (1,) * len(feat)
                )
            if reg != 0.0 and pname in model.reg_row_params:
                gavg = gavg + reg * model.reg_grad_rows(pname, new_params[pname])
            if reg3 != 0.0 and pname in model.reg_row_params:
                gavg = gavg + (3.0 * reg3) * model.n3_grad_rows(
                    pname, new_params[pname]
                )
            dg = DenseGrads(grads=gavg, count=count)
            new_params[pname], new_opt[pname] = opt.apply_dense_masked(
                new_params[pname], new_opt[pname], dg,
                model.post_constraints.get(pname), step=state.step,
            )
        for pname, g_d in g_dense.items():
            gsum = jax.lax.psum(g_d * dnorm_local, SHARD_AXIS)
            new_params[pname], new_opt[pname] = opt.apply_full(
                new_params[pname], new_opt[pname], gsum / dnorm_global,
                step=state.step,
            )
        new_state = TrainState(new_params, new_opt, key, state.step + 1)
        return new_state, StepMetrics(loss=loss, nviolations=nviol)

    return local_step


def make_partitioned_epoch(
    model: KGEModel,
    opt: Optimizer,
    sampler: Callable,
    margin: float,
    mesh: Mesh,
    length: int,
    nbatches: int,
    boundary_cap: int | None = None,
    overlap: bool = True,
    ragged=False,
    debug_checks: bool = False,
    loss: str = "margin",
    adv_alpha: float = 1.0,
    directions: Tuple[str, ...] = ("o", "s"),
    label_smoothing: float = 0.0,
):
    """Jitted epoch over partitioned batches: per-shard on-device shuffle
    + minibatch scan of the partitioned step (the `make_epoch_fn`
    equivalent for the edge-partitioned path).

    `loss='ce'` runs the full-cross-entropy step
    (make_partitioned_ce_step; `directions`/`label_smoothing` apply,
    sampler/margin/boundary_cap are ignored — CE has no sampler and its
    entity gradient is dense). `loss='sampled_ce'` runs the sampled-
    softmax step (make_partitioned_sampled_ce_step; needs a pool sampler,
    `directions`/`label_smoothing`/`boundary_cap` all apply).

    Call: `epoch(state, batches, mask)` with the SAME (P, L, 3) / (P, L)
    inputs as the single step; returns (state, StepMetrics) with (nb,)
    per-minibatch metric arrays. Each shard shuffles its OWN triples
    (subjects stay shard-local by construction) with a per-shard fold of
    the epoch key; the scalar step RNG stream stays replicated across
    shards exactly as in the single-step path.

    `boundary_cap` is clamped per minibatch to min(C, ceil(L/nb)), which
    is always sufficient: the request compaction prioritizes VALID
    non-local rows, so shuffled-in padding rows never consume cap slots,
    and a minibatch cannot contain more valid non-local objects than the
    whole shard batch (<= C) or than its own size.
    """
    epname, s_rows, shared, state_spec = _prep(
        model, opt, mesh, sampler, boundary_cap
    )
    batch_size = -(-length // nbatches)
    padded = nbatches * batch_size
    cap = None if boundary_cap is None else min(boundary_cap, batch_size)
    if ragged and cap is None:
        raise ValueError("ragged exchange requires boundary_cap")
    if loss not in ("margin", "selfadv", "ce", "sampled_ce"):
        raise ValueError(f"unknown partitioned loss {loss!r}")
    if loss in ("selfadv", "sampled_ce") and not hasattr(sampler, "pool"):
        raise ValueError(
            f"loss={loss!r} needs a shared-pool sampler (the softmax "
            "terms are defined over a candidate pool)"
        )
    if loss == "ce":
        local_step = _build_ce_local_step(
            model, opt, epname, s_rows, directions, label_smoothing, overlap
        )
    else:
        local_step = _build_local_step(
            model, opt, sampler, margin, epname, s_rows, shared, cap,
            overlap, ragged, debug_checks, loss_kind=loss, alpha=adv_alpha,
            directions=directions, label_smoothing=label_smoothing,
        )

    def local_epoch(state: TrainState, batch, mask):
        batch = batch[0]  # (1, L, 3) -> (L, 3)
        mask = mask[0]
        key, pk = jax.random.split(state.key)
        state = state._replace(key=key)
        me = jax.lax.axis_index(SHARD_AXIS)
        perm = jax.random.permutation(jax.random.fold_in(pk, me), length)
        pad_idx = jnp.concatenate(
            [perm, jnp.zeros((padded - length,), perm.dtype)]
        )
        mask_flat = (
            jnp.arange(padded) < length
        ).astype(mask.dtype) * mask[pad_idx]
        mbs = batch[pad_idx].reshape(nbatches, batch_size, batch.shape[1])
        mms = mask_flat.reshape(nbatches, batch_size)

        def body(st, bm):
            b, m = bm
            return local_step(st, b, m)

        state, metrics = jax.lax.scan(body, state, (mbs, mms))
        return state, metrics

    smapped = jax.shard_map(
        local_epoch,
        mesh=mesh,
        in_specs=(state_spec, P(SHARD_AXIS, None, None), P(SHARD_AXIS, None)),
        out_specs=(state_spec, StepMetrics(loss=P(), nviolations=P())),
        check_vma=False,
    )
    return jax.jit(smapped, donate_argnums=(0,))


def init_state_partitioned(
    model: KGEModel, opt: Optimizer, key, mesh: Mesh
) -> TrainState:
    """Initialize a TrainState DIRECTLY into the partitioned placement.

    `jax.jit` with `out_shardings` lets GSPMD materialize each shard on
    its owner device — no full-table transient on one device (the
    single-device `init_state` + `device_put` pattern breaks the
    "entity table per chip bounded by S" guarantee at init time), and it
    is the only correct path under multi-process execution, where
    `device_put` cannot place onto non-addressable devices. Values are
    bit-identical to `init_state(model, opt, key)` — same traced
    computation, only the output placement differs.
    """
    from skge_tpu.training import init_state

    _, _, state_spec = partitioned_state_specs(model, opt)
    sh = jax.tree.map(
        lambda s: NamedSharding(mesh, s),
        state_spec,
        is_leaf=lambda x: isinstance(x, P),
    )
    fn = jax.jit(lambda k: init_state(model, opt, k), out_shardings=sh)
    with mesh:
        return fn(key)


def shard_state_partitioned(
    state: TrainState, model: KGEModel, mesh: Mesh
) -> TrainState:
    """Place a TrainState for the partitioned step (E over 'shard')."""
    by_role = {role: pname for _, pname, role in model.slot_spec()}
    epname = by_role["s"]
    specs = {}
    for _, pname, role in model.slot_spec():
        specs[pname] = P(SHARD_AXIS) if pname == epname else P()
    for pname in model.dense_param_names:
        specs[pname] = P()

    def put(spec_tree, tree):
        return jax.tree.map(
            lambda s, v: jax.device_put(v, NamedSharding(mesh, s)),
            spec_tree, tree,
        )

    return TrainState(
        params=put({k: specs[k] for k in state.params}, state.params),
        opt_state=put(
            {k: {kk: specs[k] for kk in state.opt_state[k]}
             for k in state.opt_state},
            state.opt_state,
        ),
        key=jax.device_put(state.key, NamedSharding(mesh, P())),
        step=jax.device_put(state.step, NamedSharding(mesh, P())),
    )


class RelabeledPoolSampler:
    """Shared negative pool over REAL entities in relabeled id space.

    Draws ORIGINAL entity ids uniformly and maps them through
    `new_of_old`, so the padding rows that contiguous relabeling inserts
    are never sampled — matching the reference's corruption over real
    entities only (skge/sample.py ~35). Identical on every shard (drawn
    from the replicated step key), as the partitioned step requires.
    """

    modes = (0, 1)

    def __init__(self, new_of_old: np.ndarray, k: int = 1024):
        self._map = jnp.asarray(np.asarray(new_of_old), jnp.int32)
        self.k = int(k)

    def pool(self, key, pos, mask):
        u = jax.random.randint(key, (self.k,), 0, self._map.shape[0])
        return self._map[u]


class PartitionedTrainer:
    """Host-facing convenience around the partitioned SPMD path.

    Takes a triple list in ORIGINAL entity ids, partitions entities
    (community-aware), relabels them to contiguous per-shard ownership,
    builds the compacted-exchange epoch over `mesh`, and maps trained
    parameters back to original ids for evaluation/saving — the same
    in/out contract as `outofcore.OutOfCoreTrainer`, but scaling across
    devices instead of across host memory.

    Multi-process aware: pass a mesh built over the GLOBAL device list
    after `parallel.distributed.initialize()`. Partitioning is pure
    deterministic NumPy, so every process computes the same layout and
    then feeds only its own shards' triples
    (`distributed.make_global_batches`); state is initialized straight
    into its sharded placement (`init_state_partitioned`); `params()`
    allgathers across processes. tests/test_multiprocess.py pins the
    2-process trajectory to the single-process one in fp64.
    """

    def __init__(
        self,
        model: KGEModel,
        opt: Optimizer,
        triples: np.ndarray,
        mesh: Mesh,
        margin: float = 1.0,
        k: int = 1024,
        nbatches: int = 100,
        seed: int = 0,
        ragged=False,
        loss: str = "margin",
        adv_alpha: float = 1.0,
        reciprocal: bool = False,
        label_smoothing: float = 0.0,
        exchange: str = "",
    ):
        """`loss='ce'` trains full cross-entropy on the partitioned layout
        (make_partitioned_ce_step); `loss='sampled_ce'` the importance-
        corrected sampled softmax over the k-entity pool
        (make_partitioned_sampled_ce_step — full-CE quality at O(B*k*d)
        work, the practical scheme at 10^7+ vocabularies).
        `reciprocal=True` (ce/sampled_ce) applies the canonical reciprocal
        protocol: the caller passes triples ALREADY augmented by
        data.add_reciprocal_relations and a model built with the DOUBLED
        n_relations; training is object-direction-only and `evaluate`
        routes head queries through the inverse relation
        (ReciprocalEvalWrapper).

        `exchange` selects the boundary-exchange implementation:
        'dense' (overlapped all_to_all) or 'ragged' (owner-routed
        ragged_all_to_all, ~P-fold fewer bytes, synchronous; see
        `ragged_mode`). Empty (default) defers to the legacy `ragged`
        argument (False | True | 'emulate')."""
        from dataclasses import replace

        from skge_tpu.data import greedy_entity_partition, partition_edges
        from skge_tpu.parallel import distributed as dist

        n_shards = mesh.shape[SHARD_AXIS]
        t = np.asarray(triples, np.int32)
        part = (
            greedy_entity_partition(t, model.n_entities, n_shards, seed=seed)
            if n_shards > 1
            else np.zeros(model.n_entities, np.int32)
        )
        rel, self.new_of_old, n_pad = relabel_entities(t, part, n_shards)
        s = n_pad // n_shards
        owner = (np.arange(n_pad) // s).astype(np.int32)
        batches, mask, self.stats = partition_edges(rel, owner, n_shards)
        cap = max(1, object_boundary_cap(batches, s, mask))
        self.full_model = model
        self.model = replace(model, n_entities=n_pad)
        if reciprocal and loss not in ("ce", "sampled_ce"):
            raise ValueError(
                "reciprocal=True requires loss='ce' or 'sampled_ce'"
            )
        self.reciprocal = reciprocal
        sampler = RelabeledPoolSampler(self.new_of_old, k=k)
        length = batches.shape[1]
        if exchange:
            if ragged:
                raise ValueError("pass either `exchange` or legacy `ragged`")
            if exchange == "ragged":
                ragged = ragged_mode(mesh.devices.flat[0].platform)
            elif exchange != "dense":
                raise ValueError(f"unknown exchange mode {exchange!r}")
        self._epoch = make_partitioned_epoch(
            self.model, opt, sampler, margin, mesh,
            length=length, nbatches=max(1, min(nbatches, length)),
            boundary_cap=cap, ragged=ragged, loss=loss, adv_alpha=adv_alpha,
            directions=("o",) if reciprocal else ("o", "s"),
            label_smoothing=label_smoothing,
        )
        self._mesh = mesh
        self._state = init_state_partitioned(
            self.model, opt, jax.random.PRNGKey(seed), mesh
        )
        mine = dist.local_shard_ids(mesh)
        self._batches, self._mask = dist.make_global_batches(
            batches[mine], mask[mine].astype(self.model.dtype), mesh
        )
        self._metrics: list = []

    def fit(self, epochs: int = 1, verbose: bool = False):
        for _ in range(epochs):
            self._state, m = self._epoch(
                self._state, self._batches, self._mask
            )
            self._metrics.append(
                {
                    "epoch": len(self._metrics),
                    "loss": float(jnp.sum(m.loss)),
                    "nviolations": float(jnp.sum(m.nviolations)),
                }
            )
            if verbose:
                print(self._metrics[-1], flush=True)
        return self

    @property
    def metrics(self):
        return list(self._metrics)

    def save(self, dirpath: str):
        """Sharded checkpoint: each shard's rows go to their own file,
        written by the process that owns them — no full-table host
        gather (utils/checkpoint.py save_sharded_checkpoint)."""
        from skge_tpu.utils.checkpoint import save_sharded_checkpoint

        save_sharded_checkpoint(
            dirpath, self._state,
            meta={"metrics": self._metrics,
                  "n_entities": int(self.full_model.n_entities)},
        )
        return self

    def restore(self, dirpath: str):
        """Resume from `save`; re-places shards per the current mesh (the
        shard count may differ from the saving run's). The metric history
        is restored too, so `metrics` and epoch numbering continue."""
        from skge_tpu.utils.checkpoint import load_sharded_checkpoint

        state, meta = load_sharded_checkpoint(dirpath, self._mesh)
        self._state = state
        self._metrics = list(meta.get("metrics", []))
        return self

    def evaluate(
        self,
        test: np.ndarray,
        known: np.ndarray | None = None,
        batch_size: int = 1024,
        hits_at=(1, 3, 10),
        ties: str = "mean",
    ):
        """Filtered ranking directly on the SHARDED, relabeled state — no
        full-table gather (VERDICT r1 ask 9). Test/known triples are
        mapped into the relabeled id space, the (B, n_pad) score matrix
        is column-sharded over 'shard' (matching the row-sharded entity
        table, so each device scores only its owned vocabulary slice),
        and the padding rows that contiguous relabeling inserts are
        masked out of the candidate set. Ranks are identical to
        evaluating the gathered original-id table (ids are a
        permutation; tests/test_partitioned.py pins it)."""
        from skge_tpu.evaluation import FilteredRankingEval

        test = np.asarray(test, np.int64)
        known = test if known is None else np.asarray(known, np.int64)

        def remap(t):
            out = np.stack(
                [self.new_of_old[t[:, 0]], self.new_of_old[t[:, 1]],
                 t[:, 2]], axis=1,
            )
            return out.astype(np.int32)

        cmask = np.zeros(self.model.n_entities, bool)
        cmask[self.new_of_old] = True
        eval_model = self.model
        if self.reciprocal:
            from skge_tpu.evaluation import ReciprocalEvalWrapper

            eval_model = ReciprocalEvalWrapper(self.model)
        ev = FilteredRankingEval(
            eval_model, remap(test), remap(known), batch_size, hits_at,
            mesh=self._mesh, axis=SHARD_AXIS, ties=ties,
            candidate_mask=cmask,
        )
        return ev(self._state.params)

    def params(self):
        """Host params with the entity table back in ORIGINAL ids (use
        with the original-size model for evaluation/saving). Works across
        processes (allgather of the row-sharded table)."""
        from skge_tpu.parallel import distributed as dist

        out = {}
        for name, v in self._state.params.items():
            arr = dist.host_replicate(v)
            if arr.shape[:1] == (self.model.n_entities,):
                arr = arr[self.new_of_old]
            out[name] = arr
        return out
