"""Filtered link-prediction ranking — the `FilteredRankingEval` equivalent.

Reference semantics (companion harness kg/base.py, SURVEY.md §3.4): for each
test triple (s, o, p), score ALL entities as object and as subject; the
FILTERED rank masks every known-true triple (train ∪ valid ∪ test) except the
target; report mean rank, MRR (raw + filtered) and Hits@{1,3,10} pooled over
both prediction directions. Default tie-breaking is `ties='mean'`
(rank = 1 + #greater + #ties/2, half-ranks preserved — robust against
constant-score degenerate models); `ties='optimistic'` reproduces the
reference's 1 + #(strictly greater) [M — its argsort order on exact ties is
unspecified; ties are measure-zero for continuous scores].

Design: the all-entity sweep is each model's `score_all_*` — one
matmul per batch (SURVEY.md §3.4; a sharded matmul on a mesh).
Known-true filtering avoids materializing (n_test, n_e) boolean masks: the
host precomputes, once per eval set, a flat (row, entity) pair list per test
batch (padded to a static width), and the device scatters -inf at those pairs
(`mode='drop'` for padding). Ranks come back as small float32 arrays (mean
tie-breaking produces half-ranks); metric reduction happens on host.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from skge_tpu.data import true_triple_index
from skge_tpu.models.base import KGEModel, Params

NEG_INF = -1e30


@dataclass
class RankingResult:
    """Pooled metrics over both directions (subject + object prediction)."""

    mrr: float
    mrr_raw: float
    mean_rank: float
    mean_rank_raw: float
    hits: Dict[int, float]
    hits_raw: Dict[int, float]
    ranks: np.ndarray       # (2, n_test) filtered ranks [object-dir, subject-dir]
    ranks_raw: np.ndarray
    test: Optional[np.ndarray] = None  # (n_test, 3) triples the ranks belong to

    def summary(self) -> Dict[str, float]:
        out = {
            "mrr": self.mrr,
            "mrr_raw": self.mrr_raw,
            "mean_rank": self.mean_rank,
            "mean_rank_raw": self.mean_rank_raw,
        }
        for k, v in self.hits.items():
            out[f"hits@{k}"] = v
        for k, v in self.hits_raw.items():
            out[f"hits@{k}_raw"] = v
        return out

    def _metrics(self, ranks: np.ndarray, hits_at) -> Dict[str, float]:
        mrr, mr, hits = ranking_scores(ranks, hits_at)
        out = {"mrr": mrr, "mean_rank": mr, "n": int(ranks.size)}
        out.update({f"hits@{k}": v for k, v in hits.items()})
        return out

    def by_direction(self, hits_at=(1, 3, 10)) -> Dict[str, Dict[str, float]]:
        """Filtered metrics split by prediction direction — 'object' (tail
        prediction, ranks[0]) vs 'subject' (head prediction, ranks[1]); the
        standard head/tail breakdown of the KGE literature (N-to-1
        relations make the two directions very unequal)."""
        return {
            "object": self._metrics(self.ranks[0], hits_at),
            "subject": self._metrics(self.ranks[1], hits_at),
        }

    def by_relation(self, hits_at=(1, 3, 10)) -> Dict[int, Dict[str, float]]:
        """Filtered metrics per relation id (both directions pooled).
        Requires the evaluator to have attached `test` (FilteredRankingEval
        does)."""
        if self.test is None:
            raise ValueError("per-relation breakdown needs the test triples "
                             "(RankingResult.test is None)")
        out = {}
        rel = self.test[:, 2]
        for p in np.unique(rel):
            sel = rel == p
            out[int(p)] = self._metrics(self.ranks[:, sel], hits_at)
        return out

    def by_category(
        self, categories: Dict[int, str], hits_at=(1, 3, 10)
    ) -> Dict[str, Dict[str, Dict[str, float]]]:
        """Filtered metrics per relation CATEGORY and direction — the
        TransE-paper 1-1 / 1-N / N-1 / N-N reporting (`categories` from
        `relation_categories`). Returns
        {category: {'object': metrics, 'subject': metrics}} — the split
        where N-side predictions are expected to be much harder."""
        if self.test is None:
            raise ValueError("category breakdown needs the test triples")
        # relations absent from `categories` (e.g. test-only relations when
        # typing was computed over train) get their own explicit bin rather
        # than silently polluting N-N
        cats = np.array(
            [categories.get(int(p), "uncategorized") for p in self.test[:, 2]]
        )
        out: Dict[str, Dict[str, Dict[str, float]]] = {}
        for c in sorted(set(cats.tolist())):
            sel = cats == c
            out[c] = {
                "object": self._metrics(self.ranks[0, sel], hits_at),
                "subject": self._metrics(self.ranks[1, sel], hits_at),
            }
        return out


def ranking_scores(
    ranks: np.ndarray, hits_at: Sequence[int] = (1, 3, 10)
) -> Tuple[float, float, Dict[int, float]]:
    """(MRR, mean rank, {k: Hits@k}) from a flat rank array."""
    r = ranks.astype(np.float64).ravel()
    return (
        float(np.mean(1.0 / r)),
        float(np.mean(r)),
        {k: float(np.mean(r <= k)) for k in hits_at},
    )


# jit caches per wrapped-function OBJECT, so constructing a fresh
# FilteredRankingEval used to recompile both direction kernels every time,
# which dominated quality_suite's sweep / early-stopping loops (one
# evaluator per validation pass). Models are
# frozen VALUE-hashable dataclasses, so the jitted kernel is reusable
# whenever (model, direction, ties) match; mesh- or mask-carrying kernels
# (partitioned eval) are rarer and long-lived, so they skip the cache.
_KERNEL_CACHE: dict = {}
_KERNEL_CACHE_MAX = 128


def _rank_kernel(
    model: KGEModel, direction: str, mesh=None, axis="model",
    ties: str = "mean", candidate_mask=None,
):
    if mesh is None and candidate_mask is None:
        try:
            key = (model, direction, ties)
            hash(key)
        except TypeError:
            key = None
        if key is not None:
            kern = _KERNEL_CACHE.get(key)
            if kern is None:
                if len(_KERNEL_CACHE) >= _KERNEL_CACHE_MAX:
                    _KERNEL_CACHE.clear()
                kern = _build_rank_kernel(
                    model, direction, mesh, axis, ties, candidate_mask
                )
                _KERNEL_CACHE[key] = kern
            return kern
    return _build_rank_kernel(model, direction, mesh, axis, ties,
                              candidate_mask)


def _build_rank_kernel(
    model: KGEModel, direction: str, mesh=None, axis="model",
    ties: str = "mean", candidate_mask=None,
):
    """Jitted per-batch kernel: (params, batch, frows, fents) -> raw/filt ranks.

    `ties='mean'` (default) ranks the target at 1 + #greater + #equal/2
    (equal scores EXCLUDING the target itself; half-ranks are kept — the
    returned ranks are float32) — the robust convention from the KGE
    re-evaluation literature (Sun et al. 2020): a degenerate model whose
    scores all collapse to a constant gets the expected random rank (n/2),
    not rank 1. `ties='optimistic'` is the reference harness's
    1 + #strictly-greater ([M] — its argsort tie order is unspecified;
    ties are measure-zero for healthy continuous scores, where the two
    conventions agree).

    With a `mesh`, the (B, n_e) score matrix is sharded over candidate
    ENTITIES on the mesh's `axis` (the same axis the entity table is
    row-sharded on by parallel.shard_state): every device scores only its
    slice of the entity vocabulary and the per-row strictly-greater counts
    reduce across shards — SURVEY.md §3.4's sharded matmul. The filter scatter and the rank reduction stay inside the same
    jitted program, so GSPMD keeps them on the column shards.
    """
    if ties not in ("mean", "optimistic"):
        raise ValueError(f"ties must be 'mean' or 'optimistic', got {ties!r}")
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        col_sharded = NamedSharding(mesh, PartitionSpec(None, axis))
    # `candidate_mask` ((n_e,) bool): entities that may compete. Used by the
    # partitioned/relabeled eval, where the contiguous per-shard layout
    # inserts untrained padding rows that must never outrank real entities.
    # Targets are always real, so masking before ranking is exact.
    cmask = None if candidate_mask is None else jnp.asarray(candidate_mask)

    def kernel(params, batch, frows, fents):
        s, o, p = batch[:, 0], batch[:, 1], batch[:, 2]
        if direction == "o":
            scores = model.score_all_o(params, s, p)
            target = o
        else:
            scores = model.score_all_s(params, o, p)
            target = s
        if cmask is not None:
            scores = jnp.where(cmask[None, :], scores, NEG_INF)
        if mesh is not None:
            scores = jax.lax.with_sharding_constraint(scores, col_sharded)
        b = scores.shape[0]
        tgt = scores[jnp.arange(b), target]

        def rank_of(sc, self_included):
            greater = jnp.sum(sc > tgt[:, None], axis=1)
            if ties == "optimistic":
                return (1 + greater).astype(jnp.float32)
            # mean tie-break (half-ranks preserved); the raw matrix still
            # contains the target's own slot (trivially equal), the
            # filtered one has it at -inf
            equal = jnp.sum(sc == tgt[:, None], axis=1)
            if self_included:
                equal = equal - 1
            return (
                1 + greater + jnp.maximum(equal, 0) * 0.5
            ).astype(jnp.float32)

        raw = rank_of(scores, True)
        # scatter -inf at all known-true (row, entity) pairs (incl. target,
        # which no longer competes since the comparisons are against the
        # saved target score)
        filt_scores = scores.at[frows, fents].set(NEG_INF, mode="drop")
        filt = rank_of(filt_scores, False)
        return raw, filt

    return jax.jit(kernel)


def _filter_pairs(batch: np.ndarray, index: dict, direction: str):
    """Flat (row, entity) known-true pairs for one batch, padded to the
    next power of two of the batch's own pair count (a single high-degree
    key must not inflate every batch's scatter; pow2 keeps the number of
    distinct compiled kernel shapes logarithmic).

    Padding rows use row id = batch-size (dropped by the device scatter).
    """
    rows, ents = [], []
    for i, (s, o, p) in enumerate(batch):
        key = (int(s), int(p)) if direction == "o" else (int(o), int(p))
        true_ents = index.get(key)
        if true_ents is not None:
            rows.extend([i] * len(true_ents))
            ents.extend(true_ents.tolist())
    width = 1 if len(rows) <= 1 else 1 << (len(rows) - 1).bit_length()
    pad = width - len(rows)
    rows.extend([batch.shape[0]] * pad)
    ents.extend([0] * pad)
    return (
        np.asarray(rows, np.int32),
        np.asarray(ents, np.int32),
    )


class FilteredRankingEval:
    """Precomputes filter indices once; evaluates any params snapshot.

    `known` defaults to train ∪ valid ∪ test (the reference's filtered
    protocol). `batch_size` bounds the (B, n_e) score matrix.
    """

    def __init__(
        self,
        model: KGEModel,
        test: np.ndarray,
        known: np.ndarray,
        batch_size: int = 1024,
        hits_at: Sequence[int] = (1, 3, 10),
        mesh=None,
        axis: str = "model",
        ties: str = "mean",
        candidate_mask=None,
    ):
        self.model = model
        self.hits_at = tuple(hits_at)
        self.batch_size = int(min(batch_size, max(1, len(test))))
        self.test = np.asarray(test, np.int32)
        sp_o, op_s = true_triple_index(np.asarray(known))
        self._index = {"o": sp_o, "s": op_s}
        self._kernels = {
            "o": _rank_kernel(model, "o", mesh, axis, ties, candidate_mask),
            "s": _rank_kernel(model, "s", mesh, axis, ties, candidate_mask),
        }

        # batch layout: pad the last batch by repeating row 0 (masked out)
        n = len(self.test)
        bs = self.batch_size
        self.n_batches = -(-n // bs)
        padded = self.n_batches * bs
        idx = np.concatenate([np.arange(n), np.zeros(padded - n, np.int64)])
        self._batches = self.test[idx].reshape(self.n_batches, bs, 3)
        self._valid = (np.arange(padded) < n).reshape(self.n_batches, bs)

        self._pairs = {
            direction: [
                _filter_pairs(
                    self._batches[b], self._index[direction], direction
                )
                for b in range(self.n_batches)
            ]
            for direction in ("o", "s")
        }

    def __call__(self, params: Params) -> RankingResult:
        n = len(self.test)
        # float64: mean tie-breaking produces half-ranks
        ranks = {d: np.zeros(n, np.float64) for d in ("o", "s")}
        ranks_raw = {d: np.zeros(n, np.float64) for d in ("o", "s")}
        pos = 0
        for b in range(self.n_batches):
            batch = jnp.asarray(self._batches[b])
            nvalid = int(self._valid[b].sum())
            for d in ("o", "s"):
                frows, fents = self._pairs[d][b]
                raw, filt = self._kernels[d](
                    params, batch, jnp.asarray(frows), jnp.asarray(fents)
                )
                ranks_raw[d][pos : pos + nvalid] = np.asarray(raw)[:nvalid]
                ranks[d][pos : pos + nvalid] = np.asarray(filt)[:nvalid]
            pos += nvalid
        all_filt = np.stack([ranks["o"], ranks["s"]])
        all_raw = np.stack([ranks_raw["o"], ranks_raw["s"]])
        mrr, mr, hits = ranking_scores(all_filt, self.hits_at)
        mrr_r, mr_r, hits_r = ranking_scores(all_raw, self.hits_at)
        return RankingResult(
            mrr=mrr,
            mrr_raw=mrr_r,
            mean_rank=mr,
            mean_rank_raw=mr_r,
            hits=hits,
            hits_raw=hits_r,
            ranks=all_filt,
            ranks_raw=all_raw,
            test=self.test,
        )


def evaluate(
    model: KGEModel,
    params: Params,
    test: np.ndarray,
    known: Optional[np.ndarray] = None,
    batch_size: int = 1024,
    hits_at: Sequence[int] = (1, 3, 10),
) -> RankingResult:
    """One-shot convenience wrapper around FilteredRankingEval."""
    if known is None:
        known = test
    ev = FilteredRankingEval(model, test, known, batch_size, hits_at)
    return ev(params)


@dataclass(frozen=True)
class ReciprocalEvalWrapper:
    """Evaluate a reciprocal-trained model with the CANONICAL protocol:
    head (subject-direction) queries route through the inverse relation id
    instead of the model's native `score_all_s` — exactly what ConvE does
    internally (models/conve.py `_inv`). Wrap any model trained on
    `data.add_reciprocal_relations` output with object-direction-only CE
    before passing it to FilteredRankingEval, so both directions rank
    through the objective that was actually optimized. `n_relations` on
    the wrapped model must be the DOUBLED count. Frozen/value-hashable so
    the wrapped kernels share the `_rank_kernel` cache like bare models."""

    model: KGEModel

    def __post_init__(self):
        if self.model.n_relations % 2 != 0:
            raise ValueError(
                "reciprocal eval expects the DOUBLED relation count "
                "(data.add_reciprocal_relations)"
            )

    def score_all_o(self, params, s, p):
        return self.model.score_all_o(params, s, p)

    def score_all_s(self, params, o, p):
        half = self.model.n_relations // 2
        return self.model.score_all_o(
            params, o, jnp.where(p < half, p + half, p - half)
        )


def relation_categories(
    triples: np.ndarray, threshold: float = 1.5
) -> Dict[int, str]:
    """TransE-paper (Bordes et al. 2013 §4) relation typing from data:
    for each relation, hpt = mean heads per (tail, rel) and tph = mean
    tails per (head, rel); a side is 'N' when its mean multiplicity
    exceeds `threshold` (the paper's 1.5). Returns {relation_id:
    '1-1' | '1-N' | 'N-1' | 'N-N'} — feed to `RankingResult.by_category`.
    Compute over TRAIN triples (the paper's convention)."""
    t = np.asarray(triples)
    out: Dict[int, str] = {}
    for p in np.unique(t[:, 2]):
        tp = t[t[:, 2] == p]
        tph = len(tp) / max(1, len(np.unique(tp[:, 0])))  # tails per head
        hpt = len(tp) / max(1, len(np.unique(tp[:, 1])))  # heads per tail
        out[int(p)] = (
            f"{'N' if hpt > threshold else '1'}-"
            f"{'N' if tph > threshold else '1'}"
        )
    return out


# ---------------------------------------------------------------------------
# Triple classification (Socher et al. 2013 / TransH protocol) — the OTHER
# standard KGE evaluation; no reference counterpart (build-scope).
# ---------------------------------------------------------------------------

def classification_negatives(
    triples: np.ndarray, n_entities: int, known: np.ndarray, seed: int = 0,
    ntries: int = 100, n_relations: Optional[int] = None,
) -> np.ndarray:
    """One corrupted triple per positive (alternating subject/object
    corruption), rejection-resampled against `known` so no generated
    negative is a true triple — the filtered convention that makes
    classification accuracy meaningful."""
    from skge_tpu.data import encode_keys_np

    if n_relations is None:
        n_relations = int(
            max(np.max(triples[:, 2]), np.max(known[:, 2]))
        ) + 1
    rng = np.random.default_rng(seed)
    known_keys = np.sort(
        encode_keys_np(np.asarray(known, np.int64), n_entities, n_relations)
    )
    neg = np.asarray(triples, np.int32).copy()
    modes = np.arange(len(neg)) % 2
    pending = np.arange(len(neg))
    for _ in range(ntries):
        if len(pending) == 0:
            break
        repl = rng.integers(0, n_entities, len(pending)).astype(np.int32)
        neg[pending, modes[pending]] = repl
        keys = encode_keys_np(
            neg[pending].astype(np.int64), n_entities, n_relations
        )
        pos = np.searchsorted(known_keys, keys)
        hit = (pos < len(known_keys)) & (known_keys[np.minimum(pos, len(known_keys) - 1)] == keys)
        pending = pending[hit]
    if len(pending):
        # returning a known-true triple as a "negative" would silently
        # inflate classification accuracy — fail loudly instead (a relation
        # so dense that ntries rejections all collide is a protocol
        # problem, not something to paper over)
        raise ValueError(
            f"{len(pending)} triples still collide with known-true triples "
            f"after {ntries} rejection rounds; raise ntries or drop the "
            "offending (near-universal) relations"
        )
    return neg


def _best_threshold(scores: np.ndarray, labels: np.ndarray) -> float:
    """Threshold tau maximizing accuracy of (score >= tau -> positive),
    chosen at midpoints between DISTINCT adjacent sorted scores (plus the
    two open ends). A cut between two EQUAL scores is unrealizable — the
    midpoint equals the scores themselves and `>=` would flip the lower
    item — so tied positions are excluded from the search (matters for
    quantized/saturated scores, e.g. sigmoid-saturated or bf16 outputs)."""
    order = np.argsort(scores)
    s, y = scores[order], labels[order]
    # predicting positive for >= tau at cut i means items [i:] positive:
    # correct = (#neg in [:i]) + (#pos in [i:])
    neg_below = np.concatenate([[0], np.cumsum(y <= 0)])
    pos_at_or_above = np.concatenate([np.cumsum((y > 0)[::-1])[::-1], [0]])
    correct = neg_below + pos_at_or_above
    realizable = np.concatenate([[True], s[1:] > s[:-1], [True]])
    correct = np.where(realizable, correct, -1)
    i = int(np.argmax(correct))
    if i == 0:
        return -np.inf
    if i == len(s):
        return np.inf
    return float((s[i - 1] + s[i]) / 2.0)


def triple_classification(
    model: KGEModel,
    params: Params,
    valid_pos: np.ndarray,
    valid_neg: np.ndarray,
    test_pos: np.ndarray,
    test_neg: np.ndarray,
    batch_size: int = 8192,
) -> Dict[str, Any]:
    """Per-relation score thresholds fit on valid, accuracy reported on
    test (the Socher et al. / TransH protocol). Relations absent from the
    valid set fall back to the global threshold. Scoring batches through
    the model's jitted `score_triples`; threshold search is exact (best
    midpoint per relation) on host.

    Returns {'accuracy', 'thresholds' {p: tau}, 'global_threshold',
    'per_relation' {p: accuracy}}.
    """
    def score(tr: np.ndarray) -> np.ndarray:
        out = np.empty(len(tr), np.float64)
        for i in range(0, len(tr), batch_size):
            chunk = np.asarray(tr[i : i + batch_size], np.int32)
            out[i : i + len(chunk)] = np.asarray(
                model.score_triples(params, jnp.asarray(chunk))
            )
        return out

    v_tr = np.concatenate([valid_pos, valid_neg])
    v_y = np.concatenate(
        [np.ones(len(valid_pos)), -np.ones(len(valid_neg))]
    )
    v_s = score(v_tr)
    global_tau = _best_threshold(v_s, v_y)
    thresholds: Dict[int, float] = {}
    for p in np.unique(v_tr[:, 2]):
        sel = v_tr[:, 2] == p
        thresholds[int(p)] = _best_threshold(v_s[sel], v_y[sel])

    t_tr = np.concatenate([test_pos, test_neg])
    t_y = np.concatenate([np.ones(len(test_pos)), -np.ones(len(test_neg))])
    t_s = score(t_tr)
    taus = np.array(
        [thresholds.get(int(p), global_tau) for p in t_tr[:, 2]]
    )
    pred = np.where(t_s >= taus, 1.0, -1.0)
    per_rel = {}
    for p in np.unique(t_tr[:, 2]):
        sel = t_tr[:, 2] == p
        per_rel[int(p)] = float(np.mean(pred[sel] == t_y[sel]))
    return {
        "accuracy": float(np.mean(pred == t_y)),
        "thresholds": thresholds,
        "global_threshold": global_tau,
        "per_relation": per_rel,
    }
