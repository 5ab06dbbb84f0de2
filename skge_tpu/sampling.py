"""On-device negative sampling — the skge/sample.py equivalent.

Reference semantics (SURVEY.md §2.1 #3): negatives are generated by
corrupting position `mode` of a positive triple, where mode 0 = subject and
mode 1 = object in the (s, o, p) column convention; one negative per
(positive, mode) pair with labels -1.0.

- `RandomModeSampler` (~35): uniform corruption, no membership check.
- `LCWASampler` (~60): rejection-resample while the corrupted triple is in
  the training set, up to `ntries` (default 100); on failure the negative is
  DROPPED (here: masked out, keeping shapes static).
- `CorruptedSampler` (~80): type-compatible corruption — the replacement is
  drawn from entities observed in that role for that relation (`type_index`).
- `BernoulliSampler`: per-relation corrupt-subject probability
  tph/(tph+hpt) (Wang et al. 2014, TransH) — a BASELINE.json build-scope
  capability with no verified reference counterpart (SURVEY.md §0).

Design: all samplers are pure (key, positives, mask) -> (positives
repeated, negatives, pair_mask) functions with static shapes. The LCWA
rejection loop becomes a fixed-width vectorized draw of `ntries` candidates
with a sorted-key binary-search membership test — no host round-trips, no
data-dependent shapes. Samplers run inside the jitted train step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp

Batch = jnp.ndarray  # (B, 3) int32, columns (s, o, p)


def encode_keys(triples: jnp.ndarray, n_entities: int, n_relations: int):
    """Bijective int64 key: ((s * n_e) + o) * n_r + p."""
    t = triples.astype(jnp.int64)
    return (t[..., 0] * n_entities + t[..., 1]) * n_relations + t[..., 2]


def _is_member(sorted_keys: jnp.ndarray, keys: jnp.ndarray) -> jnp.ndarray:
    idx = jnp.searchsorted(sorted_keys, keys)
    idx = jnp.clip(idx, 0, sorted_keys.shape[0] - 1)
    return sorted_keys[idx] == keys


def _corrupt(pos: Batch, mode: int, replacement: jnp.ndarray) -> Batch:
    return pos.at[:, mode].set(replacement.astype(pos.dtype))


@dataclass(frozen=True, eq=False)
class RandomModeSampler:
    """Uniform corruption of each mode in `modes` (skge/sample.py ~35)."""

    n_entities: int
    modes: Tuple[int, ...] = (0, 1)

    def corruptions(self, key, pos: Batch, mask):
        """[(mode, replacement (B,), valid (B,)), ...] — the structured form
        consumed by the fused train step (one corrupted role per negative)."""
        b = pos.shape[0]
        keys = jax.random.split(key, len(self.modes))
        return [
            (mode, jax.random.randint(k, (b,), 0, self.n_entities), mask)
            for mode, k in zip(self.modes, keys)
        ]

    def __call__(self, key, pos: Batch, mask):
        out = self.corruptions(key, pos, mask)
        reps = [pos] * len(out)
        negs = [_corrupt(pos, mode, repl) for mode, repl, _ in out]
        return (
            jnp.concatenate(reps),
            jnp.concatenate(negs),
            jnp.concatenate([v for _, _, v in out]),
        )


@dataclass(frozen=True, eq=False)
class LCWASampler:
    """Local-closed-world corruption with rejection (skge/sample.py ~60).

    `sorted_train_keys` is the sorted int64 encoding of the training triples;
    a candidate colliding with a known-true triple is rejected and the next of
    the `ntries` pre-drawn candidates is tried. If all collide, the pair is
    masked out (the reference drops it).
    """

    n_entities: int
    n_relations: int
    sorted_train_keys: jnp.ndarray
    modes: Tuple[int, ...] = (0, 1)
    ntries: int = 100

    def _sample_mode(self, key, pos: Batch, mode: int):
        b = pos.shape[0]
        cands = jax.random.randint(
            key, (b, self.ntries), 0, self.n_entities
        )
        # candidate triple keys: swap `mode` column for each candidate
        t = pos.astype(jnp.int64)
        s = jnp.where(mode == 0, cands, t[:, None, 0])
        o = jnp.where(mode == 1, cands, t[:, None, 1])
        p = jnp.broadcast_to(t[:, None, 2], cands.shape)
        keys = (s * self.n_entities + o) * self.n_relations + p
        ok = ~_is_member(self.sorted_train_keys, keys)          # (B, ntries)
        first = jnp.argmax(ok, axis=1)
        found = jnp.any(ok, axis=1)
        chosen = cands[jnp.arange(b), first]
        return _corrupt(pos, mode, chosen), found

    def corruptions(self, key, pos: Batch, mask):
        keys = jax.random.split(key, len(self.modes))
        out = []
        for mode, k in zip(self.modes, keys):
            neg, found = self._sample_mode(k, pos, mode)
            out.append((mode, neg[:, mode], mask * found.astype(mask.dtype)))
        return out

    def __call__(self, key, pos: Batch, mask):
        out = self.corruptions(key, pos, mask)
        return (
            jnp.concatenate([pos] * len(out)),
            jnp.concatenate([_corrupt(pos, m, r) for m, r, _ in out]),
            jnp.concatenate([v for _, _, v in out]),
        )


@dataclass(frozen=True, eq=False)
class BernoulliSampler:
    """Corrupt subject with per-relation probability tph/(tph+hpt).

    One negative per positive. `p_corrupt_subject`: (n_relations,) float.
    Build-scope sampler (BASELINE.json config 4); no reference counterpart.
    """

    n_entities: int
    p_corrupt_subject: jnp.ndarray

    def _draw(self, key, pos: Batch, mask):
        b = pos.shape[0]
        ks, ke = jax.random.split(key)
        p_subj = self.p_corrupt_subject[pos[:, 2]]
        corrupt_subj = jax.random.uniform(ks, (b,)) < p_subj
        repl = jax.random.randint(ke, (b,), 0, self.n_entities)
        return corrupt_subj, repl

    def corruptions(self, key, pos: Batch, mask):
        """One negative per positive with a per-row Bernoulli mode choice,
        expressed as two single-mode corruption slots gated by disjoint
        validity masks (fused-path requirement: one mode per slot)."""
        corrupt_subj, repl = self._draw(key, pos, mask)
        cs = corrupt_subj.astype(mask.dtype)
        return [(0, repl, mask * cs), (1, repl, mask * (1.0 - cs))]

    def __call__(self, key, pos: Batch, mask):
        corrupt_subj, repl = self._draw(key, pos, mask)
        neg_s = _corrupt(pos, 0, repl)
        neg_o = _corrupt(pos, 1, repl)
        neg = jnp.where(corrupt_subj[:, None], neg_s, neg_o)
        return pos, neg, mask


@dataclass(frozen=True, eq=False)
class CorruptedSampler:
    """Type-compatible corruption via the relation type index
    (skge/sample.py ~80 + type_index ~100).

    For each mode, the replacement entity is drawn from the entities observed
    in that role for the triple's relation. Flat CSR-like layout:
    `flat[off[p] : off[p] + cnt[p]]` are the candidates for relation p.
    Relations with an empty candidate set fall back to uniform corruption.
    """

    n_entities: int
    sub_flat: jnp.ndarray
    sub_off: jnp.ndarray
    sub_cnt: jnp.ndarray
    obj_flat: jnp.ndarray
    obj_off: jnp.ndarray
    obj_cnt: jnp.ndarray
    modes: Tuple[int, ...] = (0, 1)

    def _draw(self, key, p, flat, off, cnt):
        b = p.shape[0]
        ku, kf = jax.random.split(key)
        u = jax.random.uniform(ku, (b,))
        c = cnt[p]
        pick = off[p] + jnp.floor(u * jnp.maximum(c, 1)).astype(off.dtype)
        cand = flat[jnp.clip(pick, 0, flat.shape[0] - 1)]
        fallback = jax.random.randint(kf, (b,), 0, self.n_entities)
        return jnp.where(c > 0, cand, fallback)

    def corruptions(self, key, pos: Batch, mask):
        keys = jax.random.split(key, len(self.modes))
        p = pos[:, 2]
        out = []
        for mode, k in zip(self.modes, keys):
            if mode == 0:
                repl = self._draw(k, p, self.sub_flat, self.sub_off, self.sub_cnt)
            else:
                repl = self._draw(k, p, self.obj_flat, self.obj_off, self.obj_cnt)
            out.append((mode, repl, mask))
        return out

    def __call__(self, key, pos: Batch, mask):
        out = self.corruptions(key, pos, mask)
        return (
            jnp.concatenate([pos] * len(out)),
            jnp.concatenate([_corrupt(pos, m, r) for m, r, _ in out]),
            jnp.concatenate([v for _, _, v in out]),
        )


@dataclass(frozen=True, eq=False)
class SharedNegativeSampler:
    """Shared negative pool: K entities drawn ONCE per step, ranked against
    EVERY positive in the batch (for each mode in `modes`).

    This is the production scheme (batched/shared negative
    sampling as in DGL-KE, arXiv:2004.08532 §3.1 "negative sampling with
    batched matrix operations", and PyTorch-BigGraph — build-scope, no
    reference counterpart): pool scoring becomes a
    (B, d) x (d, K) matmul for dot-style models, and the gradient scatter
    shrinks from O(B * n_negatives) corrupted rows to the K pool rows plus
    the batch's base rows. Like `RandomModeSampler`, no false-negative
    filtering is applied (the reference's uniform sampler has none either);
    a pool entity colliding with the true entity yields a zero-gradient pair.

    Consumed by the `pool` protocol of `make_pairwise_step` /
    `make_sharded_pairwise_step` (training.pairwise_grads_shared). The
    expanded `__call__` form materializes all B*K*len(modes) pairs and exists
    for small-scale parity tests only.
    """

    n_entities: int
    k: int = 1024
    modes: Tuple[int, ...] = (0, 1)
    # optional (n_entities,) unnormalized log-probabilities: pool entities
    # drawn ~ softmax(logits) instead of uniform — the word2vec/DGL-KE
    # degree^alpha scheme (data.unigram_logits builds them). On-device
    # categorical draw via Gumbel-argmax inside the jitted step.
    #
    # Constant-capture note: `pool` is closed over by the jitted training
    # step, so the logits are captured as a COMPILE-TIME CONSTANT — one
    # (n_entities,) fp32 copy embedded per compiled executable. __post_init__
    # pre-places them once with device_put so every trace of the same sampler
    # instance reuses one device buffer (no re-upload per trace); at very
    # large vocabularies where even one extra table copy matters, prefer
    # uniform pools or share a single sampler instance across trainers.
    logits: object = None

    def __post_init__(self):
        if self.logits is not None:
            object.__setattr__(
                self,
                "logits",
                jax.device_put(jnp.asarray(self.logits, jnp.float32)),
            )

    def pool(self, key, pos: Batch, mask) -> jnp.ndarray:
        if self.logits is None:
            return jax.random.randint(key, (self.k,), 0, self.n_entities)
        return jax.random.categorical(
            key, self.logits, shape=(self.k,)
        ).astype(jnp.int32)

    def __call__(self, key, pos: Batch, mask):
        pool = self.pool(key, pos, mask)
        b = pos.shape[0]
        reps, negs, valids = [], [], []
        for mode in self.modes:
            for i in range(self.k):
                reps.append(pos)
                negs.append(_corrupt(pos, mode, jnp.broadcast_to(pool[i], (b,))))
                valids.append(mask)
        return (
            jnp.concatenate(reps),
            jnp.concatenate(negs),
            jnp.concatenate(valids),
        )


SAMPLERS = {
    "random-mode": RandomModeSampler,
    "lcwa": LCWASampler,
    "bernoulli": BernoulliSampler,
    "corrupted": CorruptedSampler,
    "shared": SharedNegativeSampler,
}
