"""Datasets and host-side index building.

Covers the reference's data conventions (SURVEY.md §2.2): pickled dataset
dicts with `train_subs`/`valid_subs`/`test_subs` lists of (s, o, p) int
tuples plus `entities`/`relations` vocab lists (WN18/FB15k format of the
companion harness). Also provides:

- `type_index_arrays`: flat CSR-like per-relation observed subject/object
  candidate lists (skge/sample.py type_index ~100) for `CorruptedSampler`;
- `bernoulli_probs`: per-relation corrupt-subject probability tph/(tph+hpt);
- `synthetic_kg`: a deterministic structured synthetic KG generator used by
  tests and benchmarks (no network access; real WN18/FB15k pickles load via
  `load_dataset` when present);
- `true_triple_index`: the filtered-evaluation known-true lookup.

All triples are (N, 3) int32 arrays in (s, o, p) column order.
"""

from __future__ import annotations

import logging
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Dataset:
    train: np.ndarray  # (N, 3) int32 (s, o, p)
    valid: np.ndarray
    test: np.ndarray
    n_entities: int
    n_relations: int
    entities: Optional[List[str]] = None
    relations: Optional[List[str]] = None

    @property
    def sz(self) -> Tuple[int, int, int]:
        return (self.n_entities, self.n_entities, self.n_relations)

    def all_triples(self) -> np.ndarray:
        return np.concatenate([self.train, self.valid, self.test])


def _to_array(subs: Sequence[Tuple[int, int, int]]) -> np.ndarray:
    a = np.asarray(list(subs), dtype=np.int32)
    if a.size == 0:
        return np.zeros((0, 3), np.int32)
    return a.reshape(-1, 3)


def load_dataset(path: str) -> Dataset:
    """Load a reference-format pickle (SURVEY.md §2.2 'Datasets')."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    entities = list(data["entities"])
    relations = list(data["relations"])
    return Dataset(
        train=_to_array(data["train_subs"]),
        valid=_to_array(data.get("valid_subs", [])),
        test=_to_array(data.get("test_subs", [])),
        n_entities=len(entities),
        n_relations=len(relations),
        entities=entities,
        relations=relations,
    )


def save_dataset(ds: Dataset, path: str) -> None:
    """Write the reference pickle format."""
    data = {
        "train_subs": [tuple(map(int, t)) for t in ds.train],
        "valid_subs": [tuple(map(int, t)) for t in ds.valid],
        "test_subs": [tuple(map(int, t)) for t in ds.test],
        "entities": ds.entities or [f"e{i}" for i in range(ds.n_entities)],
        "relations": ds.relations or [f"r{i}" for i in range(ds.n_relations)],
    }
    with open(path, "wb") as f:
        pickle.dump(data, f)


def load_tsv(
    train_path: str,
    valid_path: str,
    test_path: str,
    order: str = "spo",
    use_native: bool = True,
) -> Dataset:
    """Load whitespace-separated triple files (FB15k/WN18 raw release format).

    `order` gives the file column order; storage is always (s, o, p). Uses
    the native C++ mmap loader (skge_tpu.native, ~6x faster) when the
    toolchain is available, with a transparent pure-Python fallback.
    """
    if use_native:
        from skge_tpu import native

        out = native.load_triple_files(
            [train_path, valid_path, test_path], order
        )
        if out is not None:
            (train, valid, test), entities, relations = out
            return Dataset(
                train=train,
                valid=valid,
                test=test,
                n_entities=len(entities),
                n_relations=len(relations),
                entities=entities,
                relations=relations,
            )
    ent: Dict[str, int] = {}
    rel: Dict[str, int] = {}

    def intern(d, k):
        if k not in d:
            d[k] = len(d)
        return d[k]

    def read(path):
        rows = []
        cols = {c: i for i, c in enumerate(order)}
        with open(path) as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) != 3:
                    continue
                s = intern(ent, parts[cols["s"]])
                p = intern(rel, parts[cols["p"]])
                o = intern(ent, parts[cols["o"]])
                rows.append((s, o, p))
        return _to_array(rows)

    train, valid, test = read(train_path), read(valid_path), read(test_path)
    return Dataset(
        train=train,
        valid=valid,
        test=test,
        n_entities=len(ent),
        n_relations=len(rel),
        entities=list(ent),
        relations=list(rel),
    )


# ---------------------------------------------------------------------------
# Synthetic KG (tests/benchmarks; no network access in this environment).
# ---------------------------------------------------------------------------

def synthetic_kg(
    n_entities: int,
    n_relations: int,
    n_train: int,
    n_valid: int = 0,
    n_test: int = 0,
    seed: int = 0,
    clustered: bool = True,
) -> Dataset:
    """Deterministic synthetic KG with mild relational structure.

    `clustered=True` gives each relation preferred subject/object entity
    blocks (so type-index and Bernoulli statistics are non-trivial and models
    can actually learn something on mini-KGs); entities are drawn zipf-ish to
    mimic real degree skew.
    """
    rng = np.random.default_rng(seed)
    total = n_train + n_valid + n_test

    if clustered and n_relations > 1:
        p = rng.integers(0, n_relations, total)
        block = max(2, n_entities // n_relations)
        s_lo = (p * 7919) % max(1, n_entities - block)
        o_lo = (p * 104729) % max(1, n_entities - block)
        s = s_lo + rng.integers(0, block, total)
        o = o_lo + rng.integers(0, block, total)
    else:
        p = rng.integers(0, n_relations, total)
        s = rng.integers(0, n_entities, total)
        o = rng.integers(0, n_entities, total)

    triples = np.stack([s, o, p], axis=1).astype(np.int32)
    # de-dup across the whole set so train/valid/test are disjoint
    keys = encode_keys_np(triples, n_entities, n_relations)
    _, first = np.unique(keys, return_index=True)
    triples = triples[np.sort(first)]
    while triples.shape[0] < total:  # top up after dedup
        extra = np.stack(
            [
                rng.integers(0, n_entities, total),
                rng.integers(0, n_entities, total),
                rng.integers(0, n_relations, total),
            ],
            axis=1,
        ).astype(np.int32)
        triples = np.concatenate([triples, extra])
        keys = encode_keys_np(triples, n_entities, n_relations)
        _, first = np.unique(keys, return_index=True)
        triples = triples[np.sort(first)]
    triples = triples[:total]
    return Dataset(
        train=triples[:n_train],
        valid=triples[n_train : n_train + n_valid],
        test=triples[n_train + n_valid :],
        n_entities=n_entities,
        n_relations=n_relations,
    )


# latent_kg switches its object-assignment sweep from one (chunk, n_e)
# matmul to a blocked running-argmax scan above this entity count (HBM:
# the full score matrix stops fitting). Module-level so tests can lower it
# and pin blocked == single-matmul equality at CPU-sized vocabularies.
_BLOCKED_SWEEP_THRESHOLD = 1 << 21


def latent_kg(
    n_entities: int,
    n_relations: int,
    n_train: int,
    n_valid: int = 0,
    n_test: int = 0,
    latent_dim: int = 16,
    noise: float = 0.0,
    seed: int = 0,
    kind: str = "translational",
    rank: Optional[int] = None,
) -> Dataset:
    """Learnable synthetic KG with a chosen latent geometry.

    Link prediction on a held-out split is genuinely solvable, making these
    KGs the quality gates for training-scheme and model-family comparisons
    where `synthetic_kg`'s unstructured triples cannot differentiate
    anything. Three geometries, so EVERY model family has a KG it should
    win on (VERDICT r2 ask 1 — the translational-only generator left the
    multiplicative family without a realizable target):

    - ``kind='translational'``: entities are latent points z_e (unit ball),
      relations translations t_p; o = nearest entity to z_s + t_p. TransE /
      TransH geometry.
    - ``kind='bilinear'``: entities are unit vectors; relations random
      low-rank matrices W_p = A B^T / sqrt(rank) (``rank`` defaults to
      latent_dim // 2); o = argmax_o (z_s^T W_p) . z_o. RESCAL / TuckER /
      DistMult-family geometry.
    - ``kind='rotational'``: entities are complex latents ([re | im] block
      layout, latent_dim must be even); relations per-dimension phases
      theta_p; o = nearest entity to z_s rotated by e^{i theta_p}. RotatE /
      ComplEx / HolE geometry (rotation is an isometry, so the nearest-
      neighbour structure is exactly a RotatE score).
    - ``kind='lattice'``: the 10^7+ build path. Entities are the points of
      a b^latent_dim integer lattice (n_entities must equal b**latent_dim
      for an integer base b, e.g. 15**6 = 11,390,625); relations are
      continuous translations of up to ~3 lattice steps; o = the EXACT
      Euclidean nearest lattice point to z_s + t_p, computed in closed
      form (componentwise clamp+round — for an axis-aligned box lattice
      this IS the L2 argmin, no sweep). Same translational geometry as
      ``kind='translational'`` (exactly TransE-realizable), but the build
      is O(total) host work instead of an O(total * n_entities *
      latent_dim) device sweep — at 10^7 entities x 4 x 10^7 queries the
      exact blocked sweep is ~1.3e19 FLOPs (days on one chip; measured
      block timings in RESULTS.md), while the lattice build takes
      seconds. Gaussian `noise` perturbs the query before rounding, so a
      (s, p) pair can emit several distinct nearby objects.

    Optional Gaussian `noise` is added to the query before the
    argmin/argmax. Deterministic per (seed, kind, backend); the lattice
    path is backend-independent (pure host arithmetic).
    """
    import jax
    import jax.numpy as jnp

    if kind not in ("translational", "bilinear", "rotational", "lattice"):
        raise ValueError(f"unknown latent kind {kind!r}")
    if kind == "rotational" and latent_dim % 2 != 0:
        raise ValueError("rotational geometry needs an even latent_dim")
    if kind == "lattice":
        return _lattice_kg(
            n_entities, n_relations, n_train, n_valid, n_test,
            latent_dim, noise, seed,
        )

    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(n_entities, latent_dim)).astype(np.float32)
    if kind == "bilinear":
        # exact unit sphere: argmax of the bilinear form is then direction-
        # only (no degenerate large-norm entity winning every query)
        Z /= np.maximum(np.linalg.norm(Z, axis=1, keepdims=True), 1e-12)
        r = rank or max(2, latent_dim // 2)
        A = rng.normal(size=(n_relations, latent_dim, r))
        B = rng.normal(size=(n_relations, latent_dim, r))
        Rel = (A @ B.transpose(0, 2, 1) / np.sqrt(r)).astype(np.float32)
    else:
        Z /= np.maximum(np.linalg.norm(Z, axis=1, keepdims=True), 1.0)
        if kind == "translational":
            Rel = (rng.normal(size=(n_relations, latent_dim)) * 0.5).astype(
                np.float32
            )
        else:  # rotational: per-dimension phases in (-pi, pi]
            Rel = rng.uniform(
                -np.pi, np.pi, size=(n_relations, latent_dim // 2)
            ).astype(np.float32)

    total = n_train + n_valid + n_test
    if noise == 0.0 and total > 0.9 * n_entities * n_relations:
        # with noise=0, o is a function of (s, p): at most n_e * n_r unique
        # triples exist, and uniform sampling of the last few is coupon-
        # collector slow — refuse rather than loop (near-)forever
        raise ValueError(
            f"total={total} exceeds 90% of the {n_entities * n_relations} "
            "unique noise-free triples; lower the split sizes or set noise>0"
        )

    # object assignment runs on the default jax device (the 198 GFLOP sweep
    # at WN18 scale takes minutes in host NumPy but milliseconds on the
    # accelerator); fp32 on any backend, so the dataset is deterministic
    # per (seed, kind, backend)
    Zd = jnp.asarray(Z)
    Rd = jnp.asarray(Rel)
    zn = jnp.sum(Zd * Zd, axis=1)
    chunk = 16384

    # Beyond ~2M entities the (chunk, n_e) score matrix stops fitting HBM
    # (10^7 entities x 16384 queries x 4 B = 640 GB) — the sweep switches
    # to a lax.scan over candidate BLOCKS with a running (argmax, max)
    # carry: device footprint is one (chunk, block) tile + the carry,
    # independent of n_e (VERDICT r3 item 5's "stream/shard the argmax
    # sweep"). The small-n_e single-matmul path is kept VERBATIM: blocked
    # matmuls reduce in a different order, and a near-tie flipping under
    # ulp drift would silently change every cached dataset.
    big = n_entities > _BLOCKED_SWEEP_THRESHOLD
    if big:
        block = min(1 << 17, -(-n_entities // 2))
        chunk = 4096  # (chunk, block) fp32 tile = 2 GB at the full block
        n_blocks = -(-n_entities // block)
        padded_e = n_blocks * block
        Zp = jnp.concatenate(
            [Zd, jnp.zeros((padded_e - n_entities, latent_dim), Zd.dtype)]
        ).reshape(n_blocks, block, latent_dim)
        znp = jnp.concatenate(
            [zn, jnp.full((padded_e - n_entities,), jnp.inf, zn.dtype)]
        ).reshape(n_blocks, block)

    @jax.jit
    def assign(s, p, eps):
        if kind == "translational":
            q = Zd[s] + Rd[p] + eps
        elif kind == "rotational":
            h = Zd.shape[1] // 2
            a, b = Zd[s, :h], Zd[s, h:]
            c, sn = jnp.cos(Rd[p]), jnp.sin(Rd[p])
            q = jnp.concatenate([a * c - b * sn, a * sn + b * c], axis=1) + eps
        else:  # bilinear: query = z_s^T W_p, scored by dot
            q = jnp.einsum("bd,bde->be", Zd[s], Rd[p]) + eps
        if not big:
            dots = jnp.dot(q, Zd.T, preferred_element_type=jnp.float32)
            if kind == "bilinear":
                return jnp.argmax(dots, axis=1).astype(jnp.int32)
            return jnp.argmin(
                zn[None, :] - 2.0 * dots, axis=1
            ).astype(jnp.int32)

        def body(carry, blk):
            best_val, best_idx = carry
            zblk, znblk, base = blk
            dots = jnp.dot(q, zblk.T, preferred_element_type=jnp.float32)
            if kind == "bilinear":
                # padding rows are exact zeros: their dot is 0, which could
                # win a degenerate all-negative row — push them to -inf
                sc = jnp.where(jnp.isinf(znblk)[None, :], -jnp.inf, dots)
            else:
                sc = -(znblk[None, :] - 2.0 * dots)  # -inf at padding
            loc = jnp.argmax(sc, axis=1)
            val = jnp.take_along_axis(sc, loc[:, None], axis=1)[:, 0]
            better = val > best_val  # strict: first block keeps ties, like
            #                          argmax's first-occurrence rule
            return (
                jnp.where(better, val, best_val),
                jnp.where(better, base + loc.astype(jnp.int32), best_idx),
            ), None

        bases = (jnp.arange(n_blocks, dtype=jnp.int32) * block)
        init = (
            jnp.full((q.shape[0],), -jnp.inf, jnp.float32),
            jnp.zeros((q.shape[0],), jnp.int32),
        )
        (best_val, best_idx), _ = jax.lax.scan(
            body, init, (Zp, znp, bases)
        )
        return best_idx

    triples = np.zeros((0, 3), np.int32)
    while triples.shape[0] < total:
        # the small-n_e loop redraws the FULL total each iteration (kept
        # verbatim: the rng stream determines every cached dataset); the
        # big regime draws only the dedup shortfall — at 10^7 entities a
        # full redraw is a multi-minute argmax sweep per iteration
        draw = total if not big else min(
            total, max(chunk, int((total - triples.shape[0]) * 1.1))
        )
        s = rng.integers(0, n_entities, draw).astype(np.int32)
        p = rng.integers(0, n_relations, draw).astype(np.int32)
        o = np.zeros(draw, np.int32)
        pad = (-draw) % chunk
        sp = np.concatenate([s, np.zeros(pad, np.int32)])
        pp = np.concatenate([p, np.zeros(pad, np.int32)])
        for lo in range(0, draw, chunk):
            eps = (
                (rng.normal(size=(chunk, latent_dim)) * noise).astype(np.float32)
                if noise > 0.0
                else np.zeros((1, latent_dim), np.float32)
            )
            oc = np.asarray(
                assign(
                    jnp.asarray(sp[lo : lo + chunk]),
                    jnp.asarray(pp[lo : lo + chunk]),
                    jnp.asarray(eps),
                )
            )
            hi = min(lo + chunk, draw)
            if big and (lo // chunk) % 512 == 0:
                # logging, not print: callers speak one-JSON-line-per-row
                # protocols on stdout (quality_suite -> density_curve)
                logging.getLogger(__name__).info(
                    "latent_kg sweep: %d/%d queries assigned", lo, draw
                )
            o[lo:hi] = oc[: hi - lo]
        cand = np.stack([s, o, p], axis=1)
        triples = np.concatenate([triples, cand])
        keys = encode_keys_np(triples, n_entities, n_relations)
        _, first = np.unique(keys, return_index=True)
        triples = triples[np.sort(first)]
    triples = triples[rng.permutation(triples.shape[0])][:total]
    return Dataset(
        train=triples[:n_train],
        valid=triples[n_train : n_train + n_valid],
        test=triples[n_train + n_valid :],
        n_entities=n_entities,
        n_relations=n_relations,
    )


def _lattice_kg(
    n_entities: int,
    n_relations: int,
    n_train: int,
    n_valid: int,
    n_test: int,
    latent_dim: int,
    noise: float,
    seed: int,
) -> Dataset:
    """Closed-form lattice geometry (see latent_kg kind='lattice').

    Entity e <-> digits(e) in base b (little-endian), latent point
    z_e = (digits(e) + 0.5) / b in [0, 1]^dl. The Euclidean-nearest
    lattice point to any query q is componentwise clamp(round(q*b - 0.5))
    — exact for an axis-aligned box lattice — so object assignment needs
    no argmax sweep. Everything is vectorized host NumPy; a 5 x 10^7
    -triple build takes seconds."""
    b = int(round(n_entities ** (1.0 / latent_dim)))
    if b ** latent_dim != n_entities:
        raise ValueError(
            f"kind='lattice' needs n_entities == b**latent_dim for integer "
            f"b; {n_entities} is not a perfect {latent_dim}-th power "
            f"(nearest: {b ** latent_dim} = {b}**{latent_dim})"
        )
    rng = np.random.default_rng(seed)
    # translations of up to ~3 lattice steps, continuous (non-integer)
    Rel = (rng.uniform(-3.0, 3.0, size=(n_relations, latent_dim)) / b
           ).astype(np.float32)
    total = n_train + n_valid + n_test
    if noise == 0.0 and total > 0.9 * n_entities * n_relations:
        raise ValueError(
            f"total={total} exceeds 90% of the {n_entities * n_relations} "
            "unique noise-free triples; lower the split sizes or set noise>0"
        )
    powers = b ** np.arange(latent_dim, dtype=np.int64)

    def assign(s: np.ndarray, p: np.ndarray) -> np.ndarray:
        digs = (s[:, None].astype(np.int64) // powers[None, :]) % b
        q = (digs + 0.5) / b + Rel[p]
        if noise > 0.0:
            q = q + rng.normal(size=q.shape).astype(np.float32) * noise
        od = np.clip(np.round(q * b - 0.5), 0, b - 1).astype(np.int64)
        return (od @ powers).astype(np.int64)

    triples = np.zeros((0, 3), np.int64)
    while triples.shape[0] < total:
        draw = min(total, max(4096, int((total - triples.shape[0]) * 1.1)))
        s = rng.integers(0, n_entities, draw).astype(np.int64)
        p = rng.integers(0, n_relations, draw).astype(np.int64)
        o = assign(s, p)
        cand = np.stack([s, o, p], axis=1)
        triples = np.concatenate([triples, cand])
        keys = encode_keys_np(triples, n_entities, n_relations)
        _, first = np.unique(keys, return_index=True)
        triples = triples[np.sort(first)]
    triples = triples[rng.permutation(triples.shape[0])][:total]
    triples = triples.astype(np.int32)
    return Dataset(
        train=triples[:n_train],
        valid=triples[n_train : n_train + n_valid],
        test=triples[n_train + n_valid :],
        n_entities=n_entities,
        n_relations=n_relations,
    )


def unigram_logits(
    triples: np.ndarray, n_entities: int,
    alpha: float = 0.75, smoothing: float = 1.0,
) -> np.ndarray:
    """Log-probabilities for degree-weighted negative sampling (the
    word2vec / DGL-KE unigram^alpha scheme; no reference counterpart —
    build-scope). Entity e is drawn with probability proportional to
    (deg(e) + smoothing)^alpha, where deg counts subject + object slots in
    `triples`; smoothing keeps zero-degree entities reachable. Feed the
    result to `SharedNegativeSampler(logits=...)`."""
    deg = np.bincount(
        np.concatenate([triples[:, 0], triples[:, 1]]), minlength=n_entities
    ).astype(np.float64)
    return (alpha * np.log(deg + smoothing)).astype(np.float32)


def add_reciprocal_relations(ds: Dataset) -> Dataset:
    """Reciprocal-relation augmentation (the ConvE / ComplEx-N3 protocol;
    no reference counterpart — build-scope).

    Returns a new Dataset with n_relations DOUBLED: relation p's inverse is
    p + n_relations, and the TRAIN set additionally contains (o, s, p_inv)
    for every train triple (s, o, p). Directional models (ConvE) then learn
    subject-direction queries as object-direction queries under the inverse
    id and train with object-side corruption only; valid/test are left
    untouched (their relation ids stay < the original n_relations — the
    evaluator reaches inverses through the model's `score_all_s`), so
    filtered-ranking metrics remain directly comparable to the
    un-augmented protocol.
    """
    t = ds.train
    inv = np.stack([t[:, 1], t[:, 0], t[:, 2] + ds.n_relations], axis=1)
    relations = None
    if ds.relations is not None:
        relations = list(ds.relations) + [f"{r}_inv" for r in ds.relations]
    return Dataset(
        train=np.concatenate([t, inv.astype(t.dtype)]),
        valid=ds.valid,
        test=ds.test,
        n_entities=ds.n_entities,
        n_relations=2 * ds.n_relations,
        entities=ds.entities,
        relations=relations,
    )


# ---------------------------------------------------------------------------
# Edge partitioning (SURVEY.md §5 "long-context equivalent"): assign entities
# to P parts and triples to their subject's part so most row lookups in a
# partition-aligned distributed step are shard-local; the remainder is the
# "boundary" exchanged over the interconnect (parallel/partitioned.py).
# ---------------------------------------------------------------------------

def greedy_entity_partition(
    triples: np.ndarray, n_entities: int, n_parts: int, seed: int = 0,
    backend: str = "auto",
) -> np.ndarray:
    """Degree-descending greedy entity->part assignment (METIS-lite).

    Entities are placed, highest degree first, on the part where they have
    the most already-placed neighbors, subject to a +-12.5% balance cap on
    assigned DEGREE (so every part sees a similar number of triple
    endpoints). Beats hash partitioning on graphs with community structure
    (DGL-KE uses full METIS for the same purpose, arXiv:2004.08532 §3.2);
    on structureless graphs it degrades to balanced random.

    `backend='auto'` (default) runs the native C++ implementation
    (native/src/partitioner.cpp — bit-identical output, pinned in
    tests/test_native.py; no per-entity Python loop, so it scales to
    1e8+ edges) when the toolchain is available, else this NumPy+Python
    reference; 'python' / 'native' force one side.

    Returns (n_entities,) int32 part ids.
    """
    if backend not in ("auto", "python", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend != "python":
        from skge_tpu.native import greedy_partition

        out = greedy_partition(triples, n_entities, n_parts)
        if out is not None:
            return out
        if backend == "native":
            raise RuntimeError("native partitioner unavailable (no toolchain)")
    t = np.asarray(triples)
    deg = np.bincount(t[:, 0], minlength=n_entities) + np.bincount(
        t[:, 1], minlength=n_entities
    )
    # adjacency in CSR form over the undirected entity graph
    src = np.concatenate([t[:, 0], t[:, 1]])
    dst = np.concatenate([t[:, 1], t[:, 0]])
    order_e = np.argsort(src, kind="stable")
    src, dst = src[order_e], dst[order_e]
    starts = np.searchsorted(src, np.arange(n_entities))
    ends = np.searchsorted(src, np.arange(n_entities) + 1)

    part = np.full(n_entities, -1, np.int32)
    load = np.zeros(n_parts, np.int64)
    cap = max(1.0, deg.sum() / n_parts * 1.125)
    for e in np.argsort(-deg, kind="stable"):
        nbr_parts = part[dst[starts[e] : ends[e]]]
        nbr_parts = nbr_parts[nbr_parts >= 0]
        open_parts = load + deg[e] <= cap
        if not open_parts.any():
            open_parts[:] = True  # all full: fall back to least-loaded
        score = np.zeros(n_parts, np.int64)
        if nbr_parts.size:
            np.add.at(score, nbr_parts, 1)
        score = np.where(open_parts, score, -1)
        best = score.max()
        cands = np.flatnonzero(score == best)
        p = cands[np.argmin(load[cands])] if cands.size > 1 else cands[0]
        part[e] = p
        load[p] += deg[e]

    # local refinement (Kernighan-Lin flavored): move entities to their
    # neighbor-majority part when it strictly reduces cut edges and keeps
    # the degree balance; high-degree hubs were placed blind in the greedy
    # pass, so a couple of sweeps recover a lot of locality
    for _ in range(3):
        moved = 0
        for e in range(n_entities):
            nbrs = part[dst[starts[e] : ends[e]]]
            if nbrs.size == 0:
                continue
            tally = np.bincount(nbrs, minlength=n_parts)
            p_new = int(np.argmax(tally))
            p_old = part[e]
            if p_new == p_old or tally[p_new] <= tally[p_old]:
                continue
            if load[p_new] + deg[e] > cap:
                continue
            part[e] = p_new
            load[p_old] -= deg[e]
            load[p_new] += deg[e]
            moved += 1
        if moved == 0:
            break
    return part


def partition_edges(
    triples: np.ndarray, entity_part: np.ndarray, n_parts: int
):
    """Group triples by their SUBJECT's part, padded to equal length.

    Returns (batches, mask, stats): batches (P, L, 3) int32 with each part's
    triples padded by repeating its first row; mask (P, L) float32 zeroing
    the padding; stats dict with per-part counts and the locality fractions
    (subject-local is 1.0 by construction; object-local is what the
    boundary exchange must cover the complement of).
    """
    t = np.asarray(triples, np.int32)
    owner = entity_part[t[:, 0]]
    counts = np.bincount(owner, minlength=n_parts)
    length = int(counts.max())
    batches = np.zeros((n_parts, length, 3), np.int32)
    mask = np.zeros((n_parts, length), np.float32)
    for p in range(n_parts):
        rows = t[owner == p]
        if rows.shape[0] == 0:
            continue
        batches[p, : rows.shape[0]] = rows
        batches[p, rows.shape[0] :] = rows[0]
        mask[p, : rows.shape[0]] = 1.0
    obj_local = float(np.mean(entity_part[t[:, 1]] == owner))
    stats = {
        "counts": counts,
        "balance": float(counts.min() / max(1, counts.max())),
        "object_locality": obj_local,
    }
    return batches, mask, stats


# ---------------------------------------------------------------------------
# Index building (host-side, NumPy)
# ---------------------------------------------------------------------------

def encode_keys_np(triples: np.ndarray, n_entities: int, n_relations: int):
    t = triples.astype(np.int64)
    return (t[..., 0] * n_entities + t[..., 1]) * n_relations + t[..., 2]


def sorted_train_keys(ds: Dataset) -> np.ndarray:
    """Sorted int64 train-triple keys for LCWA membership tests."""
    return np.sort(encode_keys_np(ds.train, ds.n_entities, ds.n_relations))


def type_index_arrays(triples: np.ndarray, n_relations: int):
    """Per-relation observed subjects/objects as flat CSR-like arrays.

    Equivalent of skge/sample.py type_index (~100): for each relation p, the
    sets of entities seen as subject / as object. Returns
    (sub_flat, sub_off, sub_cnt, obj_flat, obj_off, obj_cnt), all int32.
    """

    def build(col):
        lists = [np.array([], np.int32)] * n_relations
        for p in range(n_relations):
            m = triples[:, 2] == p
            lists[p] = np.unique(triples[m, col]).astype(np.int32)
        cnt = np.array([len(x) for x in lists], np.int32)
        off = np.zeros(n_relations, np.int32)
        if n_relations > 1:
            off[1:] = np.cumsum(cnt)[:-1]
        flat = (
            np.concatenate(lists).astype(np.int32)
            if cnt.sum() > 0
            else np.zeros(1, np.int32)
        )
        return flat, off, cnt

    sub = build(0)
    obj = build(1)
    return (*sub, *obj)


def bernoulli_probs(triples: np.ndarray, n_relations: int) -> np.ndarray:
    """Per-relation P(corrupt subject) = tph / (tph + hpt) (TransH)."""
    probs = np.full(n_relations, 0.5, np.float32)
    for p in range(n_relations):
        t = triples[triples[:, 2] == p]
        if t.shape[0] == 0:
            continue
        # tails per head / heads per tail
        _, hc = np.unique(t[:, 0], return_counts=True)
        _, tc = np.unique(t[:, 1], return_counts=True)
        tph = hc.mean()  # avg #objects per subject
        hpt = tc.mean()  # avg #subjects per object
        probs[p] = tph / (tph + hpt)
    return probs


def true_triple_index(triples: np.ndarray):
    """Known-true lookup for filtered evaluation (SURVEY.md §3.4).

    Returns dicts: (s, p) -> sorted int32 array of true objects, and
    (o, p) -> sorted int32 array of true subjects.
    """
    sp_o: Dict[Tuple[int, int], list] = {}
    op_s: Dict[Tuple[int, int], list] = {}
    for s, o, p in triples:
        sp_o.setdefault((int(s), int(p)), []).append(int(o))
        op_s.setdefault((int(o), int(p)), []).append(int(s))
    return (
        {k: np.unique(v).astype(np.int32) for k, v in sp_o.items()},
        {k: np.unique(v).astype(np.int32) for k, v in op_s.items()},
    )
