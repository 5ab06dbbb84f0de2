"""Functional training core: losses, gradients, sparse updates, train steps.

This module replaces the reference's per-model hand-written `_gradients` /
`_pairwise_gradients` (skge/{transe,rescal,hole,ermlp}.py) and the trainer
batch machinery (skge/base.py ~140-265) with ONE generic, jittable pipeline:

    gather rows -> score -> jax.grad w.r.t. the gathered rows
    -> duplicate-index segment averaging -> sparse optimizer update.

Reference semantics preserved exactly (verified against
tests/oracle/oracle_numpy.py):

- pointwise logistic loss `sum(logaddexp(0, -y*f))`, negatives appended to
  the batch (skge/base.py ~180);
- pairwise margin ranking on violating pairs only; a batch with zero
  violations performs NO update at all (skge/base.py ~265);
- the pairwise margin test applies the model's `pairwise_af` transform
  (sigmoid for HolE) BEFORE comparing (skge/hole.py ~70);
- gradients are AVERAGED over duplicate row indices (skge/util.py ~30);
- `rparam * row` L2 regularization added per unique touched row; models
  with an `n3` hyperparam additionally get the nuclear-3-norm gradient
  (Lacroix et al. 2018) on the same touched rows via `model.n3_grad_rows`;
- dense params (ER-MLP W/C) receive the masked-mean batch gradient.

Everything is static-shape: batches are padded and masked, so whole epochs
compile once and run as `lax.scan` on-device (no per-batch Python).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from skge_tpu.models.base import ACTIVATIONS, KGEModel, Params
from skge_tpu.ops.aggregate import (
    DenseGrads,
    FactoredOcc,
    segment_mean_dense,
    segment_mean_unique,
    segment_outer_mean_dense,
)
from skge_tpu.optim import Optimizer, OptState

Arrays = Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]


class TrainState(NamedTuple):
    params: Params
    opt_state: OptState
    key: jax.Array
    step: jnp.ndarray


def init_state(model: KGEModel, opt: Optimizer, key: jax.Array) -> TrainState:
    pk, sk = jax.random.split(key)
    params = model.init_params(pk)
    return TrainState(
        params=params,
        opt_state=opt.init(params),
        key=sk,
        step=jnp.zeros((), jnp.int32),
    )


# ---------------------------------------------------------------------------
# Occurrence grouping: slot gradients -> per-parameter concatenated
# (indices, grads, mask) lists, mirroring the reference's
# `grad_sum_matrix(concat(indices))` calls.
# ---------------------------------------------------------------------------

def _group_occurrences(
    model: KGEModel,
    batches,  # iterable of (slot_grads: dict, sop: (s, o, p), mask: (B,))
):
    occ: Dict[str, Tuple[list, list, list]] = {}
    for slot, pname, role in model.slot_spec():
        idxs, grads, masks = occ.setdefault(pname, ([], [], []))
        for slot_grads, (s, o, p), mask in batches:
            idxs.append({"s": s, "o": o, "p": p}[role])
            grads.append(slot_grads[slot])
            masks.append(mask)
    return {
        pname: (
            jnp.concatenate(i),
            jnp.concatenate(g),
            jnp.concatenate(m),
        )
        for pname, (i, g, m) in occ.items()
    }


# ---------------------------------------------------------------------------
# Loss gradients
# ---------------------------------------------------------------------------

def pointwise_grads(
    model: KGEModel,
    params: Params,
    triples: jnp.ndarray,  # (B, 3) int, (s, o, p)
    ys: jnp.ndarray,       # (B,) float +-1
    mask: jnp.ndarray,     # (B,) float {0,1}
):
    """Logistic loss over the (positives + appended negatives) batch."""
    s, o, p = triples[:, 0], triples[:, 1], triples[:, 2]
    rows = model.gather_rows(params, s, o, p)
    dense = model.dense_params(params)

    def loss_fn(rows, dense):
        f = model.score_from_rows(rows, dense)
        per = jnp.logaddexp(0.0, -ys * f) * mask
        return jnp.sum(per)

    loss, (g_rows, g_dense) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
        rows, dense
    )
    occ = _group_occurrences(model, [(g_rows, (s, o, p), mask)])
    n_valid = jnp.maximum(jnp.sum(mask), 1.0)
    g_dense = {k: v / n_valid for k, v in g_dense.items()}
    return loss, occ, g_dense


def pairwise_grads(
    model: KGEModel,
    params: Params,
    pos: jnp.ndarray,   # (M, 3) positives (repeated per negative)
    neg: jnp.ndarray,   # (M, 3) corrupted triples
    mask: jnp.ndarray,  # (M,) float {0,1} pair validity (padding/sampler)
    margin: float,
):
    """Margin ranking loss on violating pairs only."""
    sp, op_, pp = pos[:, 0], pos[:, 1], pos[:, 2]
    sn, on_, pn = neg[:, 0], neg[:, 1], neg[:, 2]
    rows_p = model.gather_rows(params, sp, op_, pp)
    rows_n = model.gather_rows(params, sn, on_, pn)
    dense = model.dense_params(params)
    af = ACTIVATIONS[model.pairwise_af][0]

    def loss_fn(rows_p, rows_n, dense):
        gp = af(model.score_from_rows(rows_p, dense))
        gn = af(model.score_from_rows(rows_n, dense))
        viol = jnp.logical_and(gn + margin > gp, mask > 0)
        fm = jax.lax.stop_gradient(viol.astype(gp.dtype))
        loss = jnp.sum(fm * (margin + gn - gp))
        return loss, fm

    (loss, fm), (gr_p, gr_n, g_dense) = jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2), has_aux=True
    )(rows_p, rows_n, dense)

    occ = _group_occurrences(
        model,
        [(gr_p, (sp, op_, pp), fm), (gr_n, (sn, on_, pn), fm)],
    )
    nviol = jnp.sum(fm)
    g_dense = {k: v / jnp.maximum(nviol, 1.0) for k, v in g_dense.items()}
    return loss, nviol, occ, g_dense


def pairwise_grads_fused(
    model: KGEModel,
    params: Params,
    pos: jnp.ndarray,       # (B, 3) positives, NOT repeated
    corruptions,            # [(mode, replacement (B,), valid (B,)), ...]
    mask: jnp.ndarray,      # (B,) batch validity
    margin: float,
    gather: Optional[Callable] = None,  # (pname, idx, role) -> rows override
):
    """Structurally-fused pairwise gradients — exact reference semantics,
    a fraction of the memory traffic.

    Every sampler here corrupts exactly ONE role per negative, so a
    (positive, corruption) pair shares the positive's gathered rows and its
    score. This path therefore gathers each base row ONCE, scores the
    positive ONCE, and pre-combines the per-pair gradients that provably hit
    the same row (e.g. with modes (0,1): subject s receives contributions as
    the positive's subject in BOTH pairs plus as the mode-1 negative's
    subject). The reference's duplicate-index AVERAGING is preserved by
    carrying the structural occurrence COUNTS alongside the pre-summed
    gradients into the `premasked` segment aggregation:

        cnt(s)   = sum_c m_c + sum_{c: mode_c != 0} m_c
        cnt(o)   = sum_c m_c + sum_{c: mode_c != 1} m_c
        cnt(rel) = 2 * sum_c m_c
        cnt(corrupted entity of c) = m_c

    where m_c is pair c's violation mask. Scatter sizes drop 2x for entity
    tables and 2|modes|x for relation tables versus the generic path.
    Verified exactly against the oracle in tests/test_fused.py.
    """
    s, o, p = pos[:, 0], pos[:, 1], pos[:, 2]
    b = pos.shape[0]
    n_corr = len(corruptions)
    if gather is None:
        gather = lambda pname, idx, role=None: params[pname][idx]  # noqa: E731
    role_idx_map = {"s": s, "o": o, "p": p}
    rows = {
        slot: gather(pname, role_idx_map[role], role)
        for slot, pname, role in model.slot_spec()
    }
    dense = model.dense_params(params)
    af = ACTIVATIONS[model.pairwise_af][0]
    slot_by_role = {role: (slot, pname) for slot, pname, role in model.slot_spec()}
    role_of_mode = {0: "s", 1: "o"}

    # ONE fused gather for all corruption rows instead of |modes| separate
    # gathers. All corruptions target the entity table in every model here
    # (subject/object roles share one param).
    cparam = slot_by_role["s"][1]
    assert cparam == slot_by_role["o"][1], "fused path assumes shared entity table"
    all_repl = jnp.concatenate([repl for _, repl, _ in corruptions])
    crows_flat = gather(cparam, all_repl, "corr")  # (n_corr * B, d)
    # slice OUTSIDE the differentiated function: static views, and the
    # backward pass yields per-corruption cotangents directly (no padded
    # dynamic-slice transpose buffers)
    crows = [crows_flat[c * b : (c + 1) * b] for c in range(n_corr)]

    def loss_fn(rows, crows, dense):
        gp = af(model.score_from_rows(rows, dense))
        loss = 0.0
        fms = []
        for (mode, _, valid), crow in zip(corruptions, crows):
            slot, _ = slot_by_role[role_of_mode[mode]]
            rows_n = dict(rows)
            rows_n[slot] = crow
            gn = af(model.score_from_rows(rows_n, dense))
            viol = jnp.logical_and(gn + margin > gp, valid > 0)
            viol = jnp.logical_and(viol, mask > 0)
            fm = jax.lax.stop_gradient(viol.astype(gp.dtype))
            fms.append(fm)
            loss = loss + jnp.sum(fm * (margin + gn - gp))
        return loss, fms

    (loss, fms), (g_rows, g_crows, g_dense) = jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2), has_aux=True
    )(rows, crows, dense)
    g_crows_flat = jnp.concatenate(g_crows)

    m_sum = sum(fms)
    nviol = jnp.sum(m_sum)

    # occurrence lists with structural counts (premasked grads)
    occ: dict = {}
    role_idx = {"s": s, "o": o, "p": p}
    for slot, pname, role in model.slot_spec():
        idxs, grads, counts = occ.setdefault(pname, ([], [], []))
        if role == "p":
            cnt = 2.0 * m_sum
        else:
            mode_of_role = 0 if role == "s" else 1
            cnt = m_sum + sum(
                fm
                for (mode, _, _), fm in zip(corruptions, fms)
                if mode != mode_of_role
            )
        idxs.append(role_idx[role])
        grads.append(g_rows[slot])
        counts.append(cnt)
    idxs, grads, counts = occ[cparam]
    idxs.append(all_repl)
    grads.append(g_crows_flat)
    counts.append(jnp.concatenate(fms))
    occ = {
        k: (jnp.concatenate(i), jnp.concatenate(g), jnp.concatenate(c))
        for k, (i, g, c) in occ.items()
    }
    g_dense = {k: v / jnp.maximum(nviol, 1.0) for k, v in g_dense.items()}
    return loss, nviol, occ, g_dense


def pairwise_grads_shared(
    model: KGEModel,
    params: Params,
    pos: jnp.ndarray,        # (B, 3) positives
    pool_idx: jnp.ndarray,   # (K,) shared negative entity ids
    mask: jnp.ndarray,       # (B,) batch validity
    margin: float,
    modes: Tuple[int, ...] = (0, 1),
    gather: Optional[Callable] = None,  # (pname, idx, role) -> rows override
):
    """Shared-negative-pool pairwise gradients (PBG/DGL-KE scheme).

    Every positive b is ranked against every pool entity k substituted into
    each role in `modes` — B*K*|modes| margin-ranked pairs per step, with the
    SAME per-pair semantics as the reference trainer (violation filtering
    before the gradient, `pairwise_af` transform before the margin test,
    duplicate-occurrence AVERAGING): this path is exactly the generic
    `pairwise_grads` over the fully expanded pair list (verified in
    tests/test_shared.py), computed without ever materializing it.

    Occurrence counts for the duplicate averaging (m_mode[b] = number of
    violating pairs of that mode for positive b):

        cnt(s_b)    = 2*m_o[b] + m_s[b]   (subject sits in pos+neg of an
                                           object-corrupted pair, pos only
                                           of a subject-corrupted pair)
        cnt(o_b)    = m_o[b] + 2*m_s[b]
        cnt(rel_b)  = 2*(m_o[b] + m_s[b])
        cnt(pool_k) = sum_b fm_o[b,k] + fm_s[b,k]

    The gradient scatter shrinks from O(B*K) corrupted rows (iid corruption)
    to 3B base rows + K pool rows, and pool scoring is one matmul for
    dot-style models.
    """
    s, o, p = pos[:, 0], pos[:, 1], pos[:, 2]
    if gather is None:
        gather = lambda pname, idx, role=None: params[pname][idx]  # noqa: E731
    role_idx_map = {"s": s, "o": o, "p": p}
    rows = {
        slot: gather(pname, role_idx_map[role], role)
        for slot, pname, role in model.slot_spec()
    }
    slot_by_role = {role: (slot, pname) for slot, pname, role in model.slot_spec()}
    epname = slot_by_role["s"][1]
    assert epname == slot_by_role["o"][1], "shared pool assumes one entity table"
    pool_rows = gather(epname, pool_idx, "pool")  # (K, d)
    dense = model.dense_params(params)
    af = ACTIVATIONS[model.pairwise_af][0]

    def loss_fn(rows, pool_rows, dense):
        gp = af(model.score_from_rows(rows, dense))  # (B,)
        loss = 0.0
        fms = []
        f_negs = model.score_pool_modes(rows, pool_rows, dense, tuple(modes))
        for mode, f_neg in zip(modes, f_negs):
            gn = af(f_neg)                                           # (B, K)
            viol = jnp.logical_and(
                gn + margin > gp[:, None], (mask > 0)[:, None]
            )
            fm = jax.lax.stop_gradient(viol.astype(gp.dtype))
            fms.append(fm)
            loss = loss + jnp.sum(fm * (margin + gn - gp[:, None]))
        return loss, fms

    (loss, fms), (g_rows, g_pool, g_dense) = jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2), has_aux=True
    )(rows, pool_rows, dense)

    m = [jnp.sum(fm, axis=1) for fm in fms]  # per-positive violation counts
    m_total = sum(m)
    nviol = jnp.sum(m_total)

    occ: dict = {}
    role_idx = {"s": s, "o": o, "p": p}
    role_mode = {"s": 0, "o": 1}
    for slot, pname, role in model.slot_spec():
        idxs, grads, counts = occ.setdefault(pname, ([], [], []))
        if role == "p":
            cnt = 2.0 * m_total
        else:
            cnt = sum(
                mm * (1.0 if mode == role_mode[role] else 2.0)
                for mode, mm in zip(modes, m)
            )
        idxs.append(role_idx[role])
        grads.append(g_rows[slot])
        counts.append(cnt)
    idxs, grads, counts = occ[epname]
    idxs.append(pool_idx)
    grads.append(g_pool)
    counts.append(sum(jnp.sum(fm, axis=0) for fm in fms))
    occ = {
        k: (jnp.concatenate(i), jnp.concatenate(g), jnp.concatenate(c))
        for k, (i, g, c) in occ.items()
    }
    g_dense = {k: v / jnp.maximum(nviol, 1.0) for k, v in g_dense.items()}
    return loss, nviol, occ, g_dense


def pairwise_grads_shared_bilinear(
    model: KGEModel,
    params: Params,
    pos: jnp.ndarray,        # (B, 3) positives
    pool_idx: jnp.ndarray,   # (K,) shared negative entity ids
    mask: jnp.ndarray,       # (B,) batch validity
    margin: float,
    modes: Tuple[int, ...] = (0, 1),
    gather: Optional[Callable] = None,
):
    """RESCAL shared-pool gradients with the W cotangent kept FACTORED.

    Mathematically identical to `pairwise_grads_shared` (pinned in
    tests/test_factored.py), but hand-derived so the (B, d, d) per-pair W
    gradient never materializes — it is provably rank-2 per triple:

        score(s, e, p) = q_b . e   with  q_b = e_s W_p       (object pool)
        score(e, o, p) = r_b . e   with  r_b = W_p e_o       (subject pool)
        =>  dL/dW_{p_b} = e_s (x) dL/dq_b  +  dL/dr_b (x) e_o

    so W's occurrence gradients are returned as a `FactoredOcc` of (u, v)
    factor pairs and scattered by `segment_outer_mean_dense`, so the
    autodiff path's (B, d, d) per-pair outer products never exist.

    The reference computes these same aggregated outer products per unique
    relation in skge/rescal.py `_pairwise_gradients` (~90); here the
    per-pair violation filtering, duplicate-occurrence AVERAGING, and raw
    (linear) margin test are preserved exactly.
    """
    assert model.pairwise_af == "linear", "factored path assumes raw scores"
    s, o, p = pos[:, 0], pos[:, 1], pos[:, 2]
    if gather is None:
        gather = lambda pname, idx, role=None: params[pname][idx]  # noqa: E731
    acc = jnp.promote_types(params["E"].dtype, jnp.float32)
    es = gather("E", s, "s")
    eo = gather("E", o, "o")
    wp = gather("W", p, "p")
    pool = gather("E", pool_idx, "pool")  # (K, d)

    q = jnp.einsum("bi,bij->bj", es, wp, preferred_element_type=acc)
    r = jnp.einsum("bij,bj->bi", wp, eo, preferred_element_type=acc)
    gp = jnp.sum(q * eo, axis=-1)  # (B,)

    loss = jnp.zeros((), acc)
    m_by_mode = {}
    fm_colsum = jnp.zeros((pool.shape[0],), acc)
    dq = jnp.zeros_like(q)
    dr = jnp.zeros_like(r)
    dpool = jnp.zeros_like(pool)
    for mode in modes:
        query = q if mode == 1 else r
        gn = model.mxu(query, pool.T)  # (B, K)
        fm = jnp.logical_and(
            gn + margin > gp[:, None], (mask > 0)[:, None]
        ).astype(acc)
        loss = loss + jnp.sum(fm * (margin + gn - gp[:, None]))
        m_by_mode[mode] = jnp.sum(fm, axis=1)  # (B,)
        fm_colsum = fm_colsum + jnp.sum(fm, axis=0)
        # dL/dgn[b,k] = fm  =>  d(query)_b += fm_b @ pool ; dpool_k += fm^T query
        dquery = jnp.dot(fm, pool, preferred_element_type=acc)
        dpool = dpool + jnp.dot(fm.T, query, preferred_element_type=acc)
        if mode == 1:
            dq = dq + dquery
        else:
            dr = dr + dquery
    m_total = sum(m_by_mode.values())
    nviol = jnp.sum(m_total)
    # dL/dgp_b = -(violations of b)  through gp = q . eo
    dq = dq - m_total[:, None] * eo
    deo_direct = -m_total[:, None] * q

    des = jnp.einsum("bij,bj->bi", wp, dq, preferred_element_type=acc)
    deo = deo_direct + jnp.einsum(
        "bij,bi->bj", wp, dr, preferred_element_type=acc
    )

    # occurrence counts — identical to pairwise_grads_shared
    cnt_s = sum(
        mm * (1.0 if mode == 0 else 2.0) for mode, mm in m_by_mode.items()
    )
    cnt_o = sum(
        mm * (1.0 if mode == 1 else 2.0) for mode, mm in m_by_mode.items()
    )
    occ = {
        "E": (
            jnp.concatenate([s, o, pool_idx]),
            jnp.concatenate([des, deo, dpool]),
            jnp.concatenate([cnt_s, cnt_o, fm_colsum]),
        ),
        # rank-2 factored entry per positive (2 occurrences per violating
        # pair: the relation row sits in both triples of a pair)
        "W": FactoredOcc(
            idx=p, us=(es, dr), vs=(dq, eo), count=2.0 * m_total
        ),
    }
    return loss, nviol, occ, {}


def pointwise_grads_shared(
    model: KGEModel,
    params: Params,
    pos: jnp.ndarray,        # (B, 3) positives
    pool_idx: jnp.ndarray,   # (K,) shared negative entity ids
    mask: jnp.ndarray,       # (B,) batch validity
    modes: Tuple[int, ...] = (0, 1),
    gather: Optional[Callable] = None,
):
    """Shared-pool POINTWISE (logistic) gradients.

    Reference semantics with the batch expanded to positives (y=+1) plus
    every (positive, pool-entity, mode) corruption (y=-1): loss
    `sum(logaddexp(0, -y*f))` over all elements, duplicate-occurrence
    AVERAGED gradients (occurrence counts below), dense params get the
    masked-mean gradient over the expanded batch — exactly the generic
    `pointwise_grads` over that expansion (tests/test_shared.py), computed
    as (B,K) pool score matrices instead.

    Occurrence counts per valid positive b (K = pool size):
        cnt(s_b)    = 1 + K*|{m != 0}|   (pos, plus every mode!=subject neg)
        cnt(o_b)    = 1 + K*|{m != 1}|
        cnt(rel_b)  = 1 + K*|modes|
        cnt(pool_k) = |modes| * sum_b mask_b
    """
    s, o, p = pos[:, 0], pos[:, 1], pos[:, 2]
    if gather is None:
        gather = lambda pname, idx, role=None: params[pname][idx]  # noqa: E731
    role_idx_map = {"s": s, "o": o, "p": p}
    rows = {
        slot: gather(pname, role_idx_map[role], role)
        for slot, pname, role in model.slot_spec()
    }
    slot_by_role = {role: (slot, pname) for slot, pname, role in model.slot_spec()}
    epname = slot_by_role["s"][1]
    assert epname == slot_by_role["o"][1], "shared pool assumes one entity table"
    pool_rows = gather(epname, pool_idx, "pool")
    dense = model.dense_params(params)
    k = pool_idx.shape[0]

    def loss_fn(rows, pool_rows, dense):
        f_pos = model.score_from_rows(rows, dense)          # (B,)
        loss = jnp.sum(jnp.logaddexp(0.0, -f_pos) * mask)   # y = +1
        f_negs = model.score_pool_modes(rows, pool_rows, dense, tuple(modes))
        for f_neg in f_negs:                                # (B, K) per mode
            loss = loss + jnp.sum(
                jnp.logaddexp(0.0, f_neg) * mask[:, None]   # y = -1
            )
        return loss

    loss, (g_rows, g_pool, g_dense) = jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2)
    )(rows, pool_rows, dense)

    occ: dict = {}
    for slot, pname, role in model.slot_spec():
        idxs, grads, counts = occ.setdefault(pname, ([], [], []))
        if role == "p":
            cnt = (1.0 + k * len(modes)) * mask
        else:
            mode_of_role = 0 if role == "s" else 1
            n_other = sum(1 for m in modes if m != mode_of_role)
            cnt = (1.0 + k * n_other) * mask
        idxs.append(role_idx_map[role])
        grads.append(g_rows[slot])
        counts.append(cnt)
    idxs, grads, counts = occ[epname]
    idxs.append(pool_idx)
    grads.append(g_pool)
    counts.append(
        jnp.full((k,), float(len(modes)), mask.dtype) * jnp.sum(mask)
    )
    occ = {
        kk: (jnp.concatenate(i), jnp.concatenate(g), jnp.concatenate(c))
        for kk, (i, g, c) in occ.items()
    }
    n_elems = jnp.maximum(jnp.sum(mask) * (1.0 + k * len(modes)), 1.0)
    g_dense = {kk: v / n_elems for kk, v in g_dense.items()}
    return loss, occ, g_dense


def selfadv_grads_shared(
    model: KGEModel,
    params: Params,
    pos: jnp.ndarray,        # (B, 3) positives
    pool_idx: jnp.ndarray,   # (K,) shared negative entity ids
    mask: jnp.ndarray,       # (B,) batch validity
    margin: float,
    alpha: float = 1.0,
    modes: Tuple[int, ...] = (0, 1),
    gather: Optional[Callable] = None,
):
    """Shared-pool SELF-ADVERSARIAL gradients (Sun et al. 2019, RotatE).

    No reference counterpart (build-scope; the scheme every modern KGE
    system ships — DGL-KE/PBG lineage). Per valid positive b with score
    f_b and pool scores f[b, k] per corruption mode:

        L_b = softplus(-(f_b + margin))
              + sum_mode sum_k w[b,k] * softplus(f[b,k] + margin)
        w[b,k] = softmax_k(alpha * f[b,k])        (stop-gradient)

    i.e. -log sigma(margin + f_pos) for the positive and a
    difficulty-weighted -log sigma(-f_neg - margin) over the pool: hard
    negatives dominate the gradient instead of being drowned by K easy
    ones, which is what lets small pools match huge iid negative counts.
    alpha=0 degenerates to the unweighted mean (1/K) pool logistic loss.

    Duplicate-occurrence averaging uses ELEMENT counts (each expanded
    (b, mode, k) element counts 1 occurrence regardless of its weight) —
    the same convention as `pointwise_grads_shared`, pinned against a
    full-table autodiff oracle in tests/test_selfadv.py.
    """
    s, o, p = pos[:, 0], pos[:, 1], pos[:, 2]
    if gather is None:
        gather = lambda pname, idx, role=None: params[pname][idx]  # noqa: E731
    role_idx_map = {"s": s, "o": o, "p": p}
    rows = {
        slot: gather(pname, role_idx_map[role], role)
        for slot, pname, role in model.slot_spec()
    }
    slot_by_role = {role: (slot, pname) for slot, pname, role in model.slot_spec()}
    epname = slot_by_role["s"][1]
    assert epname == slot_by_role["o"][1], "shared pool assumes one entity table"
    pool_rows = gather(epname, pool_idx, "pool")
    dense = model.dense_params(params)
    k = pool_idx.shape[0]

    def loss_fn(rows, pool_rows, dense):
        f_pos = model.score_from_rows(rows, dense)                    # (B,)
        loss = jnp.sum(jnp.logaddexp(0.0, -(f_pos + margin)) * mask)
        f_negs = model.score_pool_modes(rows, pool_rows, dense, tuple(modes))
        for f_neg in f_negs:                                      # (B, K)
            w = jax.lax.stop_gradient(jax.nn.softmax(alpha * f_neg, axis=1))
            loss = loss + jnp.sum(
                w * jnp.logaddexp(0.0, f_neg + margin) * mask[:, None]
            )
        return loss

    loss, (g_rows, g_pool, g_dense) = jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2)
    )(rows, pool_rows, dense)

    occ: dict = {}
    for slot, pname, role in model.slot_spec():
        idxs, grads, counts = occ.setdefault(pname, ([], [], []))
        if role == "p":
            cnt = (1.0 + k * len(modes)) * mask
        else:
            mode_of_role = 0 if role == "s" else 1
            n_other = sum(1 for m in modes if m != mode_of_role)
            cnt = (1.0 + k * n_other) * mask
        idxs.append(role_idx_map[role])
        grads.append(g_rows[slot])
        counts.append(cnt)
    idxs, grads, counts = occ[epname]
    idxs.append(pool_idx)
    grads.append(g_pool)
    counts.append(
        jnp.full((k,), float(len(modes)), mask.dtype) * jnp.sum(mask)
    )
    occ = {
        kk: (jnp.concatenate(i), jnp.concatenate(g), jnp.concatenate(c))
        for kk, (i, g, c) in occ.items()
    }
    n_elems = jnp.maximum(jnp.sum(mask) * (1.0 + k * len(modes)), 1.0)
    g_dense = {kk: v / n_elems for kk, v in g_dense.items()}
    return loss, occ, g_dense


def ce_grads_all(
    model: KGEModel,
    params: Params,
    pos: jnp.ndarray,        # (B, 3) positives, (s, o, p) columns
    mask: jnp.ndarray,       # (B,) batch validity
    directions: Tuple[str, ...] = ("o", "s"),
    label_smoothing: float = 0.0,
):
    """Full cross-entropy (1-vs-all) loss + FULL-TABLE gradients.

    No reference counterpart (build-scope): the training scheme of the
    ConvE / ComplEx-N3 era. Each positive is scored against EVERY entity
    in the corrupted role — one (B, d) x (d, n_e) matmul per
    direction via the model's `score_all_o`/`score_all_s` eval kernels —
    and the loss is the softmax cross entropy with the true entity as
    the label:

        L = mean_valid [ logZ(s,p) - f(s,p,o) ]        (direction 'o')
          + mean_valid [ logZ(o,p) - f(s,p,o) ]        (direction 's')

    With `label_smoothing` = ls the target distribution is
    (1-ls)*onehot + ls/n_e (ConvE's convention).

    Unlike the margin/pointwise paths there is no occurrence scatter: the
    partition function touches every entity row, so the gradient of E is
    inherently dense and this function returns the plain full-table
    autodiff gradient pytree (relation/dense tables included — their
    untouched rows carry exact zeros, which makes the dense optimizer
    apply a no-op there). Normalization is the mean over valid positives,
    per direction. Exactness is pinned against an independent oracle in
    tests/test_ce.py.
    """
    s, o, p = pos[:, 0], pos[:, 1], pos[:, 2]
    n_e = model.n_entities
    n_valid = jnp.maximum(jnp.sum(mask), 1.0)
    barange = jnp.arange(pos.shape[0])

    def loss_fn(params):
        total = 0.0
        for d in directions:
            if d == "o":
                logits = model.score_all_o(params, s, p)
                labels = o
            elif d == "s":
                logits = model.score_all_s(params, o, p)
                labels = s
            else:
                raise ValueError(f"direction {d!r} (want 'o'/'s')")
            logp = jax.nn.log_softmax(logits, axis=1)
            nll = -logp[barange, labels]
            if label_smoothing:
                nll = (1.0 - label_smoothing) * nll \
                    - label_smoothing * jnp.mean(logp, axis=1)
            total = total + jnp.sum(nll * mask)
        return total / n_valid

    return jax.value_and_grad(loss_fn)(params)


def sampled_ce_grads_shared(
    model: KGEModel,
    params: Params,
    pos: jnp.ndarray,        # (B, 3) positives, (s, o, p) columns
    pool_idx: jnp.ndarray,   # (K,) shared candidate entity ids
    mask: jnp.ndarray,       # (B,) batch validity
    directions: Tuple[str, ...] = ("o", "s"),
    label_smoothing: float = 0.0,
    log_q: Optional[jnp.ndarray] = None,  # (K,) proposal log-probs
    gather: Optional[Callable] = None,
    n_domain=None,  # candidate-domain size (static or traced scalar)
):
    """SAMPLED softmax cross-entropy over a shared candidate pool.

    No reference counterpart (build-scope; VERDICT r2 ask 3): the standard
    mid-ground between pool-margin losses and full CE at 10^7+
    vocabularies (Bengio & Senecal 2008; TF sampled_softmax / DGL-KE
    lineage). Per valid positive with true-triple score f_pos and pool
    scores f[b, k], the partition function is estimated with the
    importance-corrected EXCLUSION form

        Zhat_b = exp(f_pos_b)
               + sum_k [pool_k != label_b] * exp(f[b,k] - log(K*q_k))

    (q = the pool proposal; uniform 1/n_e when `log_q` is None), i.e. an
    unbiased estimator of the full-softmax partition sum, and

        nll_b = log Zhat_b - f_pos_b.

    With K = n_e and the pool enumerating every entity exactly once the
    correction vanishes and Zhat is the exact partition function, so this
    REPRODUCES `ce_grads_all` exactly — pinned in fp64 by
    tests/test_sampled_ce.py. Label smoothing uses the same
    importance-corrected estimator of mean(logits).

    Gradients are plain autodiff SUMS of the mean-over-valid loss — use
    `apply_gradients(..., premasked=True, combine='sum')` so duplicate
    occurrences add instead of averaging (the k=n_e identity needs sum
    semantics). Compute is O(B*K*d) matmul work vs full CE's O(B*n_e*d);
    the update touches only batch + pool rows.

    `n_domain` overrides the candidate-domain size used for the default
    uniform proposal (q = 1/n_domain) and the label-smoothing denominator;
    it may be a TRACED scalar — the out-of-core trainer passes the
    bucket's dynamic resident-row count so one compiled program serves
    every bucket (outofcore.py).
    """
    s, o, p = pos[:, 0], pos[:, 1], pos[:, 2]
    if gather is None:
        gather = lambda pname, idx, role=None: params[pname][idx]  # noqa: E731
    role_idx_map = {"s": s, "o": o, "p": p}
    rows = {
        slot: gather(pname, role_idx_map[role], role)
        for slot, pname, role in model.slot_spec()
    }
    slot_by_role = {role: (slot, pname) for slot, pname, role in model.slot_spec()}
    epname = slot_by_role["s"][1]
    assert epname == slot_by_role["o"][1], "shared pool assumes one entity table"
    pool_rows = gather(epname, pool_idx, "pool")
    dense = model.dense_params(params)
    k = pool_idx.shape[0]
    n_e = (model.n_entities if n_domain is None
           else jnp.asarray(n_domain, mask.dtype))
    ls = float(label_smoothing)
    n_valid = jnp.maximum(jnp.sum(mask), 1.0)
    if log_q is None:
        log_q = jnp.broadcast_to(
            -jnp.log(jnp.asarray(n_e, mask.dtype)), (k,)
        ).astype(mask.dtype)
    corr = -(jnp.log(float(k)) + log_q)          # (K,) importance correction
    labels = {"o": o, "s": s}

    def loss_fn(rows, pool_rows, dense):
        f_pos = model.score_from_rows(rows, dense)                    # (B,)
        total = 0.0
        f_pools = model.score_pool_modes(
            rows, pool_rows, dense,
            tuple({"o": 1, "s": 0}[d] for d in directions),
        )
        for d, f_pool in zip(directions, f_pools):        # (B, K) per dir
            lab = labels[d]
            hit = pool_idx[None, :] == lab[:, None]  # exclusion form
            logits = jnp.where(hit, -jnp.inf, f_pool + corr[None, :])
            all_logits = jnp.concatenate([f_pos[:, None], logits], axis=1)
            logz = jax.scipy.special.logsumexp(all_logits, axis=1)
            nll = logz - f_pos
            if ls:
                # corrected estimator of mean(logits over ALL entities):
                # (f_label + sum_k [k!=label] f_k / (K*q_k)) / n_e - logZhat
                wsum = jnp.where(
                    hit, 0.0, f_pool * jnp.exp(corr)[None, :]
                ).sum(axis=1)
                mean_logp = (f_pos + wsum) / n_e - logz
                nll = (1.0 - ls) * nll - ls * mean_logp
            total = total + jnp.sum(nll * mask)
        return total / n_valid

    loss, (g_rows, g_pool, g_dense) = jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2)
    )(rows, pool_rows, dense)

    # counts gate validity only (combine='sum' multiplies the averaged
    # grads back by the row totals, so any positive per-occurrence count
    # yields the exact sum); masked rows carry zero gradient AND zero count
    occ: dict = {}
    for slot, pname, role in model.slot_spec():
        idxs, grads, counts = occ.setdefault(pname, ([], [], []))
        idxs.append(role_idx_map[role])
        grads.append(g_rows[slot])
        counts.append(mask)
    idxs, grads, counts = occ[epname]
    idxs.append(pool_idx)
    grads.append(g_pool)
    counts.append(jnp.full((k,), 1.0, mask.dtype) * jnp.minimum(n_valid, 1.0))
    occ = {
        kk: (jnp.concatenate(i), jnp.concatenate(g), jnp.concatenate(c))
        for kk, (i, g, c) in occ.items()
    }
    return loss, occ, g_dense


def make_sampled_ce_step(
    model: KGEModel,
    opt: Optimizer,
    sampler: Callable,
    directions: Tuple[str, ...] = ("o", "s"),
    label_smoothing: float = 0.0,
    aggregate: str = "unique",
):
    """One sampled-softmax-CE step (see sampled_ce_grads_shared). Needs a
    `pool`-protocol sampler; a sampler with unigram `logits` feeds the
    proposal correction automatically."""
    if not hasattr(sampler, "pool"):
        raise ValueError("make_sampled_ce_step needs a shared-pool sampler")
    logits = getattr(sampler, "logits", None)
    log_q_table = None if logits is None else jax.nn.log_softmax(
        jnp.asarray(logits)
    )

    def step(state: TrainState, batch: jnp.ndarray, mask: jnp.ndarray):
        key, sk = jax.random.split(state.key)
        pool_idx = sampler.pool(sk, batch, mask)
        log_q = None if log_q_table is None else log_q_table[pool_idx]
        loss, occ, g_dense = sampled_ce_grads_shared(
            model, state.params, batch, pool_idx, mask,
            directions=directions, label_smoothing=label_smoothing,
            log_q=log_q,
        )
        params, opt_state = apply_gradients(
            model, opt, state.params, state.opt_state, occ, g_dense,
            aggregate, premasked=True, step=state.step, combine="sum",
        )
        new_state = TrainState(params, opt_state, key, state.step + 1)
        return new_state, StepMetrics(
            loss=loss, nviolations=jnp.zeros((), loss.dtype)
        )

    return step


def pointwise_grads_shared_bilinear(
    model: KGEModel,
    params: Params,
    pos: jnp.ndarray,        # (B, 3) positives
    pool_idx: jnp.ndarray,   # (K,) shared negative entity ids
    mask: jnp.ndarray,       # (B,) batch validity
    modes: Tuple[int, ...] = (0, 1),
    gather: Optional[Callable] = None,
):
    """RESCAL shared-pool POINTWISE gradients, W cotangent factored.

    Same contract as `pointwise_grads_shared` (logistic loss over positives
    plus every (positive, pool, mode) corruption; duplicate-occurrence
    averaged; pinned in tests/test_factored.py) via the same bilinear
    algebra as `pairwise_grads_shared_bilinear`:

        dL/df_pos = -sigmoid(-f_pos) * mask          (y = +1)
        dL/df_neg =  sigmoid(f_neg) * mask           (y = -1)
        dW_{p_b}  = e_s (x) dq_b + dr_b (x) e_o
    """
    s, o, p = pos[:, 0], pos[:, 1], pos[:, 2]
    if gather is None:
        gather = lambda pname, idx, role=None: params[pname][idx]  # noqa: E731
    acc = jnp.promote_types(params["E"].dtype, jnp.float32)
    es = gather("E", s, "s")
    eo = gather("E", o, "o")
    wp = gather("W", p, "p")
    pool = gather("E", pool_idx, "pool")  # (K, d)
    k = pool_idx.shape[0]

    q = jnp.einsum("bi,bij->bj", es, wp, preferred_element_type=acc)
    r = jnp.einsum("bij,bj->bi", wp, eo, preferred_element_type=acc)
    f_pos = jnp.sum(q * eo, axis=-1)

    loss = jnp.sum(jnp.logaddexp(0.0, -f_pos) * mask)
    c_pos = -jax.nn.sigmoid(-f_pos) * mask  # (B,)
    dq = c_pos[:, None] * eo
    dr = jnp.zeros_like(r)
    dpool = jnp.zeros_like(pool)
    for mode in modes:
        query = q if mode == 1 else r
        f_neg = model.mxu(query, pool.T)  # (B, K)
        loss = loss + jnp.sum(jnp.logaddexp(0.0, f_neg) * mask[:, None])
        c_neg = jax.nn.sigmoid(f_neg) * mask[:, None]
        dquery = jnp.dot(c_neg, pool, preferred_element_type=acc)
        dpool = dpool + jnp.dot(c_neg.T, query, preferred_element_type=acc)
        if mode == 1:
            dq = dq + dquery
        else:
            dr = dr + dquery

    des = jnp.einsum("bij,bj->bi", wp, dq, preferred_element_type=acc)
    deo = c_pos[:, None] * q + jnp.einsum(
        "bij,bi->bj", wp, dr, preferred_element_type=acc
    )

    n_other = {0: sum(1 for m in modes if m != 0),
               1: sum(1 for m in modes if m != 1)}
    occ = {
        "E": (
            jnp.concatenate([s, o, pool_idx]),
            jnp.concatenate([des, deo, dpool]),
            jnp.concatenate([
                (1.0 + k * n_other[0]) * mask,
                (1.0 + k * n_other[1]) * mask,
                jnp.full((k,), float(len(modes)), mask.dtype)
                * jnp.sum(mask),
            ]),
        ),
        "W": FactoredOcc(
            idx=p, us=(es, dr), vs=(dq, eo),
            count=(1.0 + k * len(modes)) * mask,
        ),
    }
    return loss, occ, {}


# ---------------------------------------------------------------------------
# Updates
# ---------------------------------------------------------------------------

def apply_gradients(
    model: KGEModel,
    opt: Optimizer,
    params: Params,
    opt_state: OptState,
    occ,                      # {pname: (indices, grads, mask_or_counts)}
    g_dense: Params,
    aggregate: str = "unique",  # 'unique' | 'dense' (SPMD) | 'dense_sorted'
    premasked: bool = False,    # occ grads pre-weighted, mask = counts
    step=None,                  # traced global step (lr schedules)
    combine: str = "mean",      # 'mean' (reference duplicate-averaging) |
                                # 'sum' (plain autodiff semantics; the
                                # sampled-CE path needs sums so k=n_e
                                # reproduces full CE exactly)
) -> Tuple[Params, OptState]:
    params = dict(params)
    opt_state = dict(opt_state)
    reg = model.regularization
    reg3 = model.regularization_n3
    backend = "xla"
    if aggregate == "dense_sorted":
        # sort + banded one-hot matmul (ops/sorted_segment.py) instead of
        # XLA's scatter; better-than-scatter fp32 precision
        aggregate, backend = "dense", "sorted"
    seg_dense = partial(segment_mean_dense, backend=backend)

    def apply_dense_grads(pname, dg: DenseGrads):
        if combine == "sum":
            # the segment machinery averages over duplicate occurrences;
            # multiplying back by the row count recovers the exact sum
            # (count==0 rows stay zero and remain gated by the mask apply)
            cnt = dg.count.reshape((-1,) + (1,) * (dg.grads.ndim - 1))
            dg = dg._replace(grads=dg.grads * cnt)
        if reg != 0.0 and pname in model.reg_row_params:
            dg = dg._replace(
                grads=dg.grads
                + reg * model.reg_grad_rows(pname, params[pname])
            )
        if reg3 != 0.0 and pname in model.reg_row_params:
            dg = dg._replace(
                grads=dg.grads
                + (3.0 * reg3) * model.n3_grad_rows(pname, params[pname])
            )
        params[pname], opt_state[pname] = opt.apply_dense_masked(
            params[pname], opt_state[pname], dg,
            model.post_constraints.get(pname), step=step,
        )

    # factored rank-1 entries (RESCAL W): dense aggregation via the outer-
    # product scatter; the unique path materializes the outers batch-locally
    # (CPU/test sizes only).
    factored = {
        p: f for p, f in occ.items() if isinstance(f, FactoredOcc)
    }
    occ = {p: o for p, o in occ.items() if p not in factored}
    for pname, f in factored.items():
        if aggregate == "dense":
            apply_dense_grads(
                pname,
                segment_outer_mean_dense(f, model.num_rows(pname)),
            )
        else:
            outers = sum(
                u[:, :, None] * v[:, None, :] for u, v in zip(f.us, f.vs)
            )
            occ[pname] = (f.idx, outers, f.count)

    if aggregate == "unique":
        for pname, (idx, g, m) in occ.items():
            n_rows = model.num_rows(pname)
            ug = segment_mean_unique(idx, g, m, n_rows, premasked)
            if combine == "sum":
                cnt = ug.count.reshape(
                    (-1,) + (1,) * (ug.grads.ndim - 1)
                )
                ug = ug._replace(grads=ug.grads * cnt)
            if reg != 0.0 and pname in model.reg_row_params:
                ug = ug._replace(
                    grads=ug.grads
                    + reg * model.reg_grad_rows(pname, params[pname][ug.uidx])
                )
            if reg3 != 0.0 and pname in model.reg_row_params:
                ug = ug._replace(
                    grads=ug.grads + (3.0 * reg3)
                    * model.n3_grad_rows(pname, params[pname][ug.uidx])
                )
            params[pname], opt_state[pname] = opt.apply_unique(
                params[pname], opt_state[pname], ug,
                model.post_constraints.get(pname), step=step,
            )
    elif aggregate == "dense":
        # row params with identical feature shape (e.g. TransE/HolE's E and
        # R) share ONE fused scatter into a stacked virtual table, split
        # after, so each step pays one scatter's fixed cost, not several.
        groups: dict = {}
        for pname in occ:
            groups.setdefault(occ[pname][1].shape[1:], []).append(pname)
        for feat_shape, names in groups.items():
            if len(names) == 1:
                pname = names[0]
                idx, g, m = occ[pname]
                apply_dense_grads(
                    pname,
                    seg_dense(idx, g, m, model.num_rows(pname), premasked),
                )
                continue
            offsets, total = {}, 0
            for pname in names:
                offsets[pname] = total
                total += model.num_rows(pname)
            cidx = jnp.concatenate(
                [occ[p][0] + offsets[p] for p in names]
            )
            cg = jnp.concatenate([occ[p][1] for p in names])
            cm = jnp.concatenate([occ[p][2] for p in names])
            dg_all = seg_dense(cidx, cg, cm, total, premasked)
            for pname in names:
                lo = offsets[pname]
                hi = lo + model.num_rows(pname)
                apply_dense_grads(
                    pname,
                    DenseGrads(
                        grads=dg_all.grads[lo:hi], count=dg_all.count[lo:hi]
                    ),
                )
    else:
        raise ValueError(f"unknown aggregate mode {aggregate!r}")
    for pname, g in g_dense.items():
        params[pname], opt_state[pname] = opt.apply_full(
            params[pname], opt_state[pname], g, step=step
        )
    return params, opt_state


# ---------------------------------------------------------------------------
# Train steps. `sampler` is a pure callable from skge_tpu.sampling.
# ---------------------------------------------------------------------------

def select_shared_pairwise_fn(model: KGEModel):
    """Shared-pool pairwise gradient dispatch (single source of truth —
    also used by scripts/profile_step.py): models whose pool-pair W
    gradient is low-rank (RESCAL) take the hand-derived factored path, the
    rest the generic autodiff path."""
    if (
        getattr(model, "factored_pool_grads", False)
        and model.pairwise_af == "linear"
    ):
        return pairwise_grads_shared_bilinear
    return pairwise_grads_shared


def select_shared_pointwise_fn(model: KGEModel):
    """Shared-pool pointwise gradient dispatch (see above)."""
    if getattr(model, "factored_pool_grads", False):
        return pointwise_grads_shared_bilinear
    return pointwise_grads_shared

class StepMetrics(NamedTuple):
    loss: jnp.ndarray
    nviolations: jnp.ndarray


def make_pairwise_update(
    model: KGEModel, opt: Optimizer, margin: float, aggregate: str = "unique"
):
    """Pre-sampled pairwise update: (state, pos_rep, neg, pair_mask) -> ...

    Used directly by the compat layer when negatives come from an arbitrary
    host `samplef` callable (reference API), and wrapped by
    `make_pairwise_step` for fully on-device sampling.
    """

    def update(state: TrainState, pos_rep, neg, pair_mask):
        loss, nviol, occ, g_dense = pairwise_grads(
            model, state.params, pos_rep, neg, pair_mask, margin
        )
        params, opt_state = apply_gradients(
            model, opt, state.params, state.opt_state, occ, g_dense,
            aggregate, step=state.step,
        )
        new_state = TrainState(params, opt_state, state.key, state.step + 1)
        return new_state, StepMetrics(loss=loss, nviolations=nviol)

    return update


def make_pointwise_update(
    model: KGEModel, opt: Optimizer, aggregate: str = "unique"
):
    """Pre-sampled pointwise update: (state, triples, ys, mask) -> ..."""

    def update(state: TrainState, triples, ys, mask):
        loss, occ, g_dense = pointwise_grads(
            model, state.params, triples, ys, mask
        )
        params, opt_state = apply_gradients(
            model, opt, state.params, state.opt_state, occ, g_dense,
            aggregate, step=state.step,
        )
        new_state = TrainState(params, opt_state, state.key, state.step + 1)
        return new_state, StepMetrics(
            loss=loss, nviolations=jnp.zeros((), loss.dtype)
        )

    return update


def make_pairwise_step(
    model: KGEModel,
    opt: Optimizer,
    sampler: Callable,  # (key, pos (B,3), mask (B,)) -> (pos_rep, neg, pair_mask)
    margin: float,
    aggregate: str = "unique",
    fused: bool = True,
):
    """One pairwise SGD step: sample negatives, rank, update on violations.

    When the sampler exposes the structured `corruptions` protocol (all
    built-in samplers do) and `fused` is set, the step uses the
    structurally-fused gradient path (same math, ~2x fewer scatters/gathers —
    see pairwise_grads_fused). Set fused=False to force the generic path.
    A sampler exposing the `pool` protocol (SharedNegativeSampler) selects
    the shared-negative-pool path instead (pairwise_grads_shared).
    """
    if fused and hasattr(sampler, "pool"):
        grads_fn = select_shared_pairwise_fn(model)

        def step(state: TrainState, batch: jnp.ndarray, mask: jnp.ndarray):
            key, sk = jax.random.split(state.key)
            pool_idx = sampler.pool(sk, batch, mask)
            loss, nviol, occ, g_dense = grads_fn(
                model, state.params, batch, pool_idx, mask, margin,
                modes=sampler.modes,
            )
            params, opt_state = apply_gradients(
                model, opt, state.params, state.opt_state, occ, g_dense,
                aggregate, premasked=True, step=state.step,
            )
            new_state = TrainState(params, opt_state, key, state.step + 1)
            return new_state, StepMetrics(loss=loss, nviolations=nviol)

        return step

    if fused and hasattr(sampler, "corruptions"):
        def step(state: TrainState, batch: jnp.ndarray, mask: jnp.ndarray):
            key, sk = jax.random.split(state.key)
            corr = sampler.corruptions(sk, batch, mask)
            loss, nviol, occ, g_dense = pairwise_grads_fused(
                model, state.params, batch, corr, mask, margin
            )
            params, opt_state = apply_gradients(
                model, opt, state.params, state.opt_state, occ, g_dense,
                aggregate, premasked=True, step=state.step,
            )
            new_state = TrainState(params, opt_state, key, state.step + 1)
            return new_state, StepMetrics(loss=loss, nviolations=nviol)

        return step

    update = make_pairwise_update(model, opt, margin, aggregate)

    def step(state: TrainState, batch: jnp.ndarray, mask: jnp.ndarray):
        key, sk = jax.random.split(state.key)
        pos_rep, neg, pair_mask = sampler(sk, batch, mask)
        state = state._replace(key=key)
        return update(state, pos_rep, neg, pair_mask)

    return step


def make_selfadv_step(
    model: KGEModel,
    opt: Optimizer,
    sampler: Callable,
    margin: float,
    alpha: float = 1.0,
    aggregate: str = "unique",
):
    """One self-adversarial step (Sun et al. 2019 loss over a shared pool).

    Requires a `pool`-protocol sampler (SharedNegativeSampler) — the
    softmax difficulty weights are defined over a candidate pool.
    `nviolations` in the metrics reports the number of pool pairs whose
    sigmoid is on the wrong side (f_neg + margin > 0 equivalent count is
    not defined for a smooth loss; we report 0 — monitor `loss`).
    """
    if not hasattr(sampler, "pool"):
        raise ValueError(
            "make_selfadv_step needs a shared-pool sampler "
            "(SharedNegativeSampler); iid samplers have no pool to weight"
        )

    def step(state: TrainState, batch: jnp.ndarray, mask: jnp.ndarray):
        key, sk = jax.random.split(state.key)
        pool_idx = sampler.pool(sk, batch, mask)
        loss, occ, g_dense = selfadv_grads_shared(
            model, state.params, batch, pool_idx, mask, margin, alpha,
            modes=sampler.modes,
        )
        params, opt_state = apply_gradients(
            model, opt, state.params, state.opt_state, occ, g_dense,
            aggregate, premasked=True, step=state.step,
        )
        new_state = TrainState(params, opt_state, key, state.step + 1)
        return new_state, StepMetrics(
            loss=loss, nviolations=jnp.zeros((), loss.dtype)
        )

    return step


def make_ce_step(
    model: KGEModel,
    opt: Optimizer,
    directions: Tuple[str, ...] = ("o", "s"),
    label_smoothing: float = 0.0,
):
    """One full-cross-entropy (1-vs-all) step: (state, batch, mask) -> ...

    No sampler: the "negatives" are all n_entities candidates, scored by
    the same all-entity matmul kernels evaluation uses. The optimizer runs
    the dense full-table path — correct because CE's entity gradient is
    dense (every row appears in the partition function) and a zero
    gradient row is an exact AdaGrad/SGD no-op. `rparam` regularization
    and post-constraints (TransE's normless1) consequently apply to the
    WHOLE table each step, which matches "every row touched" under the
    reference's touched-rows-only convention. `nviolations` is 0 (smooth
    loss — monitor `loss`).
    """

    def step(state: TrainState, batch: jnp.ndarray, mask: jnp.ndarray):
        key, _ = jax.random.split(state.key)  # keep the key stream moving
        loss, grads = ce_grads_all(
            model, state.params, batch, mask, directions, label_smoothing
        )
        reg = model.regularization
        reg3 = model.regularization_n3
        params = dict(state.params)
        opt_state = dict(state.opt_state)
        for pname, g in grads.items():
            if reg != 0.0 and pname in model.reg_row_params:
                g = g + reg * model.reg_grad_rows(pname, params[pname])
            if reg3 != 0.0 and pname in model.reg_row_params:
                g = g + (3.0 * reg3) * model.n3_grad_rows(pname, params[pname])
            params[pname], opt_state[pname] = opt.apply_full(
                params[pname], opt_state[pname], g, step=state.step
            )
            post = model.post_constraints.get(pname)
            if post is not None:
                from skge_tpu.optim import POST_CONSTRAINTS

                params[pname] = POST_CONSTRAINTS[post](params[pname])
        new_state = TrainState(params, opt_state, key, state.step + 1)
        return new_state, StepMetrics(
            loss=loss, nviolations=jnp.zeros((), loss.dtype)
        )

    return step


def make_pointwise_step(
    model: KGEModel,
    opt: Optimizer,
    sampler: Callable,
    aggregate: str = "unique",
):
    """One pointwise step: append sampled negatives (y=-1), logistic loss.

    A sampler exposing the `pool` protocol (SharedNegativeSampler) selects
    the shared-pool logistic path (pointwise_grads_shared).
    """
    if hasattr(sampler, "pool"):
        grads_fn = select_shared_pointwise_fn(model)

        def step(state: TrainState, batch: jnp.ndarray, mask: jnp.ndarray):
            key, sk = jax.random.split(state.key)
            pool_idx = sampler.pool(sk, batch, mask)
            loss, occ, g_dense = grads_fn(
                model, state.params, batch, pool_idx, mask,
                modes=sampler.modes,
            )
            params, opt_state = apply_gradients(
                model, opt, state.params, state.opt_state, occ, g_dense,
                aggregate, premasked=True, step=state.step,
            )
            new_state = TrainState(params, opt_state, key, state.step + 1)
            return new_state, StepMetrics(
                loss=loss, nviolations=jnp.zeros((), loss.dtype)
            )

        return step

    update = make_pointwise_update(model, opt, aggregate)

    def step(state: TrainState, batch: jnp.ndarray, mask: jnp.ndarray):
        key, sk = jax.random.split(state.key)
        pos_rep, neg, pair_mask = sampler(sk, batch, mask)
        state = state._replace(key=key)
        triples = jnp.concatenate([batch, neg], axis=0)
        ys = jnp.concatenate(
            [jnp.ones(batch.shape[0]), -jnp.ones(neg.shape[0])]
        ).astype(model.jdtype)
        m = jnp.concatenate([mask, pair_mask])
        return update(state, triples, ys, m)

    return step


# ---------------------------------------------------------------------------
# Epoch runner: shuffle -> pad -> scan over minibatches, fully on-device.
# Mirrors StochasticTrainer._optim's epoch loop (skge/base.py ~150) but
# compiles ONCE and runs nbatches steps per epoch inside lax.scan.
# ---------------------------------------------------------------------------

def make_epoch_fn(
    step_fn: Callable, n_triples: int, nbatches: int, pad_to: int = 1
):
    """On-device epoch: shuffle from the state key, split into `nbatches`
    masked minibatches, lax.scan `step_fn` over them.

    `pad_to` (for mesh steps whose batch axis must divide the 'data' axis)
    pads EVERY batch up to a multiple with masked dummy rows — batch
    membership of real rows is unchanged, and masked rows contribute
    exact zeros to every scatter/count, so the trajectory is the pad_to=1
    trajectory whenever the sampler's per-row draws are
    position-stable (JAX's partitionable threefry is)."""
    batch_size = -(-n_triples // nbatches)
    padded = nbatches * batch_size
    bs2 = batch_size + (-batch_size) % pad_to

    def epoch(state: TrainState, xs: jnp.ndarray):
        """xs: (n_triples, 3) int32 device array."""
        key, pk = jax.random.split(state.key)
        state = state._replace(key=key)
        perm = jax.random.permutation(pk, n_triples)
        pad_idx = jnp.concatenate(
            [perm, jnp.zeros((padded - n_triples,), perm.dtype)]
        )
        mask_flat = (
            jnp.arange(padded) < n_triples
        ).astype(jnp.float32)
        b_idx = pad_idx.reshape(nbatches, batch_size)
        masks = mask_flat.reshape(nbatches, batch_size)
        if bs2 != batch_size:
            extra = bs2 - batch_size
            b_idx = jnp.pad(b_idx, ((0, 0), (0, extra)))
            masks = jnp.pad(masks, ((0, 0), (0, extra)))
        batches = xs[b_idx]

        def body(st, bm):
            b, m = bm
            return step_fn(st, b, m)

        state, metrics = jax.lax.scan(body, state, (batches, masks))
        return state, metrics

    return epoch
