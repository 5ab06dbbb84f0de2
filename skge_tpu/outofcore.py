"""Out-of-core (PBG-style) bucketed training: entity tables beyond HBM.

The reference holds every parameter in process memory (skge/base.py Model —
a few MB at WN18 scale). Production KGs have 10^8-10^9 entities; at d=256
fp32 the entity table plus its AdaGrad accumulator is ~2 KB/entity — far
beyond one chip's HBM. This module trains such tables on ONE device by the
PyTorch-BigGraph partition-bucket scheme (Lerer et al. 2019; same scheme as
DGL-KE's partitioned training, PAPERS.md):

1. entities are partitioned into P parts (`data.greedy_entity_partition`,
   community-aware) and relabeled so part p owns contiguous rows
   [p*S, (p+1)*S) (`parallel.partitioned.relabel_entities`);
2. triples are grouped into buckets (part(subject), part(object));
3. the entity table and its accumulator live in HOST memory; one bucket at
   a time, the two parts it touches are uploaded to the device, the
   standard jitted pairwise epoch runs on the bucket's triples (negatives
   drawn from the RESIDENT parts, as in PBG), and the updated rows stream
   back. Device footprint is 2S rows + the relation table, independent of
   the total entity count.

Semantics: within a bucket the update math is EXACTLY the in-core trainer
(same violation filtering, duplicate-occurrence averaging, sparse AdaGrad +
normless1 — the same `make_pairwise_step` program runs on the resident
slice; with P=1 the trajectory is bit-identical to in-core training, see
tests/test_outofcore.py). Across buckets the scheme differs from global iid
sampling the same way PBG does: positives arrive grouped by bucket and
negatives come from the bucket's resident parts. Relation parameters stay
device-resident the whole run (they are small: n_r rows).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from skge_tpu.data import greedy_entity_partition
from skge_tpu.models.base import KGEModel, Params
from skge_tpu.optim import Optimizer
from skge_tpu.parallel.partitioned import relabel_entities
from skge_tpu.training import StepMetrics, TrainState, make_pairwise_step


@dataclass(frozen=True, eq=False)
class BucketPoolSampler:
    """Shared-negative pool drawn from the bucket's RESIDENT entity rows.

    Slot layout: rows [0, size_i) are part i's real entities, rows
    [slot_stride, slot_stride + size_j) are part j's (slot_stride = S, the
    padded part size; for diagonal buckets i == j there is one slot).
    Draws land uniformly on the union of REAL rows — never on the padding
    rows of either slot (the reference corrupts with randint over real
    entities only, skge/sample.py ~35).

    The part sizes are DYNAMIC (read from the batch's masked sentinel last
    row — see make_bucket_epoch) so one compiled program serves every
    bucket of the same diagonal/off-diagonal kind regardless of which
    partitions are resident.
    """

    slot_stride: int  # 0 for diagonal buckets (single slot)
    k: int = 1024
    modes: Tuple[int, ...] = (0, 1)

    def pool(self, key: jax.Array, pos: jnp.ndarray, mask: jnp.ndarray):
        size_i = pos[-1, 0]
        if not self.slot_stride:
            return jax.random.randint(key, (self.k,), 0, size_i)
        total = size_i + pos[-1, 1]
        u = jax.random.randint(key, (self.k,), 0, total)
        return jnp.where(u < size_i, u, u - size_i + self.slot_stride)


def make_bucket_epoch(step_fn, length: int, nbatches: int):
    """Epoch over ONE bucket's (padded) triple list.

    Identical shuffle/pad/mask/scan structure (and PRNG stream) as
    `training.make_epoch_fn`, with two out-of-core extensions:

    - an explicit per-row `valid` input (buckets are padded to a COMMON
      length so every bucket of a kind shares one compiled program);
    - a masked sentinel row `[size_i, size_j, 0]` appended to every
      minibatch, carrying the resident parts' REAL row counts to the
      sampler as dynamic values. Its mask is 0: it contributes exactly
      0.0 to every loss term, gradient, occurrence count, and AdaGrad
      accumulator (verified bit-for-bit in tests/test_outofcore.py via
      the P=1 in-core equality).
    """
    batch_size = -(-length // nbatches)
    padded = nbatches * batch_size

    def epoch(state: TrainState, xs, valid, sizes_row):
        key, pk = jax.random.split(state.key)
        state = state._replace(key=key)
        perm = jax.random.permutation(pk, length)
        pad_idx = jnp.concatenate(
            [perm, jnp.zeros((padded - length,), perm.dtype)]
        )
        mask_flat = (
            jnp.arange(padded) < length
        ).astype(jnp.float32) * valid[pad_idx]
        batches = xs[pad_idx].reshape(nbatches, batch_size, xs.shape[1])
        masks = mask_flat.reshape(nbatches, batch_size)
        batches = jnp.concatenate(
            [
                batches,
                jnp.broadcast_to(sizes_row, (nbatches, 1, 3)).astype(
                    batches.dtype
                ),
            ],
            axis=1,
        )
        masks = jnp.concatenate(
            [masks, jnp.zeros((nbatches, 1), masks.dtype)], axis=1
        )

        def body(st, bm):
            b, m = bm
            return step_fn(st, b, m)

        state, metrics = jax.lax.scan(body, state, (batches, masks))
        return state, metrics

    return epoch


def choose_ce_loss(n_parts: int):
    """Measured decision rule for CE-style training on the OOC trainer
    (VERDICT r4 / NEXT.md round-4 item): 'ce' (resident-candidate full
    CE) at P <= 2, 'sampled_ce' at P >= 4.

    From the round-4 matched-budget A/B (`scripts/ooc_ce_ab.py`;
    RESULTS.md "OOC resident-CE approximation", RECIPES.md): at P=2 the
    resident-candidate restriction behaves like negative-subsampling
    regularization and BEATS exact full CE (0.2162 vs 0.2047 MRR), so
    full resident CE is both the quality and the simplicity choice; at
    P=4 the resident gap opens (0.2014) and the importance-corrected
    sampled softmax recovers it (0.2115) with less logit work (its
    k-entity pool is redrawn per batch — stochastic negatives — instead
    of the same fixed resident block every step, and per-step logit work
    is O(B*k*d) vs O(B*(n_e/P)*d)). P=3 sits between the measured
    points; the sampled side is the safe default there (stochasticity
    only helps, and it is never slower).

    Returns (loss_name, report) — the report records the rule and the
    measured numbers so a run's choice is auditable.
    """
    rule = "resident CE at P<=2; sampled-CE at P>=3 (measured A/B)"
    report = {
        "n_parts": int(n_parts),
        "rule": rule,
        "ab_mrr": {"full_ce_single": 0.2047, "resident_ce_P2": 0.2162,
                   "resident_ce_P4": 0.2014, "sampled_ce_P4": 0.2115},
    }
    return ("ce" if n_parts <= 2 else "sampled_ce"), report


class OutOfCoreTrainer:
    """PBG-style bucketed trainer over a host-resident entity table.

    Parameters
    ----------
    model : the KGE model at FULL size (n_entities = total entities).
    opt : row-sparse optimizer (AdaGrad/SGD).
    n_parts : number of entity partitions P (device must fit 2*ceil(n_e/P)
        entity rows plus the relation table).
    k : shared-negative-pool size per step.
    aggregate : gradient aggregation mode for the device step.
    """

    def __init__(
        self,
        model: KGEModel,
        opt: Optimizer,
        triples: np.ndarray,
        n_parts: int,
        margin: float = 1.0,
        k: int = 1024,
        nbatches: int = 100,
        aggregate: str = "dense",
        seed: int = 0,
        cache_parts: int = 2,
        pairwise: bool = True,
        prefetch: bool = True,
        loss: str = "margin",
        adv_alpha: float = 1.0,
        ce_directions=("o", "s"),
        label_smoothing: float = 0.0,
        host_buckets: bool = False,
    ):
        """`pairwise=False` trains with the pointwise logistic loss
        (StochasticTrainer semantics, skge/base.py ~180) over the same
        bucket scheme — negatives still drawn from the resident parts.
        `prefetch` (needs `cache_parts` > 2 to have a free slot) starts the
        NEXT bucket's missing part upload right after the current bucket's
        epoch is dispatched, hiding host->device transfer behind compute
        (dispatch is async; H2D copies run on the transfer engine)."""
        assert cache_parts >= 2, "off-diagonal buckets need 2 resident parts"
        self.full_model = model
        self.opt = opt
        self.margin = margin
        self.aggregate = aggregate
        self.pairwise = pairwise
        self.loss_report = None
        if loss == "auto_ce":
            # measured P-crossover rule — see choose_ce_loss
            loss, self.loss_report = choose_ce_loss(n_parts)
        if loss not in ("margin", "selfadv", "ce", "sampled_ce"):
            raise ValueError(f"unknown out-of-core loss {loss!r}")
        self.loss = loss
        self.adv_alpha = adv_alpha
        # loss='ce': full cross-entropy against the RESIDENT partitions'
        # candidate rows (the bucket's 1-2 parts) — the streamed/bucketed
        # approximation of full-table CE (exact at n_parts=1, where the
        # whole table is resident; pinned in tests/test_outofcore.py).
        # For n_parts>1 the partition function runs over n_e/P (diagonal)
        # or 2*n_e/P (off-diagonal) candidates per step, every one of them
        # resident — no host<->device traffic beyond the usual part swaps.
        #
        # loss='sampled_ce': the importance-corrected exclusion-form
        # sampled softmax (training.sampled_ce_grads_shared) over a
        # k-entity pool drawn UNIFORMLY FROM THE RESIDENT PARTITIONS
        # (BucketPoolSampler), with the proposal correction log q =
        # -log(resident real rows) read dynamically from the bucket's
        # sentinel row. Same resident-proposal bias as loss='ce': the
        # estimator converges (k -> resident count) to the RESIDENT-
        # candidate partition function, not the full-table one — exact
        # full-table sampled CE would need cross-partition candidate
        # uploads every step, defeating the bucket scheme. At n_parts=1
        # the proposal is uniform over the whole real table and the
        # trajectory matches training.make_sampled_ce_step bit-for-bit
        # (tests/test_outofcore.py). This is the practical 10^7+ CE: the
        # per-step logit work is O(B*k*d), independent of both n_e AND
        # the partition size, where loss='ce' pays O(B*(n_e/P)*d).
        self.ce_directions = tuple(ce_directions)
        self.label_smoothing = float(label_smoothing)
        self.prefetch = prefetch
        t = np.asarray(triples, np.int32)

        part = (
            greedy_entity_partition(t, model.n_entities, n_parts, seed=seed)
            if n_parts > 1
            else np.zeros(model.n_entities, np.int32)
        )
        relabeled, self.new_of_old, n_padded = relabel_entities(t, part, n_parts)
        s = n_padded // n_parts
        self.part_size = s            # padded rows per part
        self.n_parts = n_parts
        self.part_counts = np.bincount(part, minlength=n_parts)

        # bucket (pi, pj) -> triple rows (global relabeled ids), plus
        # device-ready slot-local arrays padded to ONE common length so a
        # single compiled program serves all buckets of a kind
        owner_s = relabeled[:, 0] // s
        owner_o = relabeled[:, 1] // s
        self.buckets: Dict[Tuple[int, int], np.ndarray] = {}
        for pi in range(n_parts):
            for pj in range(n_parts):
                rows = relabeled[(owner_s == pi) & (owner_o == pj)]
                if rows.shape[0]:
                    self.buckets[(pi, pj)] = rows
        self.bucket_len = max(r.shape[0] for r in self.buckets.values())
        # ALL buckets stack into three host arrays uploaded in ONE
        # transfer each; buckets then index device-side. Per-bucket
        # jnp.asarray paid a host->device round trip for every bucket —
        # 2*P^2 small transfers that dominated init.
        nb_buckets = len(self.buckets)
        all_local = np.zeros((nb_buckets, self.bucket_len, 3), np.int32)
        all_valid = np.zeros((nb_buckets, self.bucket_len), np.float32)
        all_sizes = np.zeros((nb_buckets, 1, 3), np.int32)
        self._bucket_row: Dict[Tuple[int, int], int] = {}
        for bi, ((pi, pj), rows) in enumerate(self.buckets.items()):
            local = rows.copy()
            local[:, 0] -= pi * s
            local[:, 1] -= pj * s
            if pi != pj:
                local[:, 1] += s
            n = local.shape[0]
            all_local[bi, :n] = local
            if n < self.bucket_len:
                all_local[bi, n:] = local[0]
            all_valid[bi, :n] = 1.0
            all_sizes[bi, 0] = (
                self.part_counts[pi], self.part_counts[pj], 0,
            )
            self._bucket_row[(pi, pj)] = bi
        # bucket triples live on device by default (one upload, no per-
        # bucket transfers — right below ~10^7 triples). `host_buckets`
        # keeps them in host RAM and uploads per bucket visit: at 10^8+
        # relabeled rows the padded (n_buckets, max_len, 3) stack is
        # multiple GB and competes with the resident entity parts for HBM
        # — the transfers then ride the same prefetch overlap as the part
        # uploads.
        self.host_buckets = bool(host_buckets)
        if self.host_buckets:
            self._all_local, self._all_valid, self._all_sizes = (
                all_local, all_valid, all_sizes,
            )
        else:
            self._all_local = jnp.asarray(all_local)
            self._all_valid = jnp.asarray(all_valid)
            self._all_sizes = jnp.asarray(all_sizes)
        self.nbatches = nbatches
        self.k = k

        # host-resident entity table + accumulator (padded to P*S rows);
        # everything else (relations, dense params) is device-resident.
        # PRNG split order matches training.init_state (params from the
        # first subkey, sampling from the second) so the P=1 degenerate
        # case takes the EXACT in-core trajectory.
        #
        # The init runs on the CPU backend: the full table must exist in
        # HOST memory anyway (that is this class's storage), and a default-
        # device init would materialize the whole padded table plus its
        # accumulator in accelerator HBM — an immediate OOM at the
        # 10^8-10^9-entity scale this module exists for. Threefry bit
        # generation and the elementwise init transforms are deterministic
        # integer/float ops, so values are identical across backends (the
        # P=1 bit-exactness test runs through this path).
        init_key, dev_key = jax.random.split(jax.random.PRNGKey(seed))
        padded_model = replace(model, n_entities=n_parts * s)
        try:
            host_dev = jax.devices("cpu")[0]
        except RuntimeError:  # cpu platform masked out (JAX_PLATFORMS)
            host_dev = jax.devices()[0]
        with jax.default_device(host_dev):
            params = padded_model.init_params(init_key)
            ostate = opt.init(params)
            self.e_host = {"param": np.array(params["E"])}
            for name, arr in ostate["E"].items():
                self.e_host[name] = np.array(arr)
        # small tables move to the accelerator; the entity table stays host
        self.dev_params = {
            kk: jnp.asarray(np.asarray(v))
            for kk, v in params.items() if kk != "E"
        }
        self.dev_opt = {
            kk: {n: jnp.asarray(np.asarray(a)) for n, a in v.items()}
            for kk, v in ostate.items() if kk != "E"
        }
        self.key = dev_key
        self.step = jnp.zeros((), jnp.int32)
        self.cache_parts = cache_parts
        self._cache: Dict[int, Dict[str, jnp.ndarray]] = {}
        self._lru: list = []
        self.uploads = 0  # host->device part uploads (cache misses)
        self._epochs: Dict[Tuple[int, int, int, int], callable] = {}
        self._metrics: list = []

    # -- device program cache: ONE jitted epoch per bucket kind (diagonal /
    # off-diagonal) — bucket lengths share one padding and part sizes are
    # dynamic, so P^2 buckets never mean P^2 compilations --
    def _epoch_fn(self, diag: bool):
        if diag not in self._epochs:
            resident_rows = self.part_size * (1 if diag else 2)
            bucket_model = replace(self.full_model, n_entities=resident_rows)
            sampler = BucketPoolSampler(
                slot_stride=0 if diag else self.part_size, k=self.k
            )
            if self.loss == "ce":
                from skge_tpu.training import make_ce_step

                step = make_ce_step(
                    bucket_model, self.opt, directions=self.ce_directions,
                    label_smoothing=self.label_smoothing,
                )
            elif self.loss == "sampled_ce":
                step = self._sampled_ce_step(bucket_model, sampler)
            elif self.loss == "selfadv":
                from skge_tpu.training import make_selfadv_step

                step = make_selfadv_step(
                    bucket_model, self.opt, sampler, self.margin,
                    self.adv_alpha, self.aggregate,
                )
            elif self.pairwise:
                step = make_pairwise_step(
                    bucket_model, self.opt, sampler, self.margin,
                    aggregate=self.aggregate,
                )
            else:
                from skge_tpu.training import make_pointwise_step

                step = make_pointwise_step(
                    bucket_model, self.opt, sampler, self.aggregate
                )
            nb = max(1, min(self.nbatches, self.bucket_len))
            self._epochs[diag] = jax.jit(
                make_bucket_epoch(step, self.bucket_len, nb),
                donate_argnums=(0,),
            )
        return self._epochs[diag]

    def _sampled_ce_step(self, bucket_model: KGEModel,
                         sampler: "BucketPoolSampler"):
        """Sampled-softmax-CE step over the resident-partition pool.

        `training.make_sampled_ce_step`'s structure (same PRNG split
        order, so n_parts=1 is trajectory-exact against it), with the
        proposal domain read DYNAMICALLY from the bucket's sentinel row:
        the pool is uniform over the resident REAL rows, so
        log q = -log(size_i [+ size_j]) — one compiled program per
        bucket kind, like every other OOC loss."""
        from skge_tpu.training import (
            apply_gradients, sampled_ce_grads_shared,
        )

        slot_stride = sampler.slot_stride
        opt, aggregate = self.opt, self.aggregate
        directions, ls = self.ce_directions, self.label_smoothing

        def step(state: TrainState, batch: jnp.ndarray, mask: jnp.ndarray):
            key, sk = jax.random.split(state.key)
            pool_idx = sampler.pool(sk, batch, mask)
            n_res = batch[-1, 0] + (batch[-1, 1] if slot_stride else 0)
            loss, occ, g_dense = sampled_ce_grads_shared(
                bucket_model, state.params, batch, pool_idx, mask,
                directions=directions, label_smoothing=ls,
                n_domain=n_res,
            )
            params, opt_state = apply_gradients(
                bucket_model, opt, state.params, state.opt_state, occ,
                g_dense, aggregate, premasked=True, step=state.step,
                combine="sum",
            )
            new_state = TrainState(params, opt_state, key, state.step + 1)
            return new_state, StepMetrics(
                loss=loss, nviolations=jnp.zeros((), loss.dtype)
            )

        return step

    # -- device part cache: up to `cache_parts` partitions stay on device
    # between buckets. The chained bucket order (_bucket_order) shares a
    # part between consecutive buckets whenever the bucket graph allows,
    # so each transition costs at most one upload (bound pinned in
    # tests/test_outofcore.py); downloads only happen on eviction and at
    # fit()/params() boundaries.
    def _fetch_part(self, p: int):
        if p in self._cache:
            self._lru.remove(p)
            self._lru.append(p)
            return self._cache[p]
        while len(self._cache) >= self.cache_parts:
            self._evict(self._lru.pop(0))
        s = self.part_size
        dev = {
            kk: jnp.asarray(v[p * s : (p + 1) * s])
            for kk, v in self.e_host.items()
        }
        self.uploads += 1
        self._cache[p] = dev
        self._lru.append(p)
        return dev

    def _evict(self, p: int) -> None:
        dev = self._cache.pop(p)
        s = self.part_size
        for kk, v in dev.items():
            self.e_host[kk][p * s : (p + 1) * s] = np.asarray(v)

    def flush(self) -> None:
        """Write every cached partition back to the host table."""
        for p in list(self._cache):
            self._evict(p)
        self._lru.clear()

    def _bucket_epoch(self, pi: int, pj: int):
        s = self.part_size
        diag = pi == pj
        bi = self._bucket_row[(pi, pj)]
        if self.host_buckets:
            local = jnp.asarray(self._all_local[bi])
            valid = jnp.asarray(self._all_valid[bi])
            sizes_row = jnp.asarray(self._all_sizes[bi])
        else:
            local = self._all_local[bi]
            valid = self._all_valid[bi]
            sizes_row = self._all_sizes[bi]

        # resident rows from the device cache (host upload only on miss).
        # Refresh the LRU slot of already-resident parts FIRST: otherwise a
        # bucket (new, shared) whose shared part sits at the LRU front would
        # evict it while uploading the new part, then immediately re-upload
        # it — a double upload the chained bucket order exists to avoid.
        for p in dict.fromkeys((pi, pj)):
            if p in self._cache:
                self._fetch_part(p)
        di = self._fetch_part(pi)
        dj = di if diag else self._fetch_part(pj)
        e_dev = (
            di
            if diag
            else {
                kk: jnp.concatenate([di[kk], dj[kk]]) for kk in di
            }
        )
        params = dict(self.dev_params)
        params["E"] = e_dev["param"]
        ostate = dict(self.dev_opt)
        ostate["E"] = {kk: v for kk, v in e_dev.items() if kk != "param"}

        state = TrainState(
            params=params,
            opt_state=ostate,
            key=self.key,
            step=self.step,
        )
        epoch = self._epoch_fn(diag)
        state, m = epoch(state, local, valid, sizes_row)
        # key/step stay device-resident: no host sync inside the bucket loop
        self.key = state.key
        self.step = state.step

        # updated rows stay on device (sliced views re-enter the cache)
        e_new = dict(state.opt_state["E"])
        e_new["param"] = state.params["E"]
        if diag:
            self._cache[pi] = e_new
        else:
            self._cache[pi] = {kk: v[:s] for kk, v in e_new.items()}
            self._cache[pj] = {kk: v[s:] for kk, v in e_new.items()}
        self.dev_params = {
            kk: v for kk, v in state.params.items() if kk != "E"
        }
        self.dev_opt = {
            kk: v for kk, v in state.opt_state.items() if kk != "E"
        }
        # device scalars; fit() syncs them ONCE per epoch (each host sync is
        # a full host-device roundtrip)
        return jnp.sum(m.loss), jnp.sum(m.nviolations)

    def _bucket_order(self):
        """Greedy chained order: each bucket shares a resident partition
        with its predecessor whenever the bucket graph allows it (PBG's
        ordering goal), so the 2-slot device cache hits on at least one
        part per transition. Deterministic (sorted tie-breaks)."""
        remaining = sorted(self.buckets, key=lambda ij: (min(ij), max(ij), ij[0]))
        order = [remaining.pop(0)]
        while remaining:
            prev = set(order[-1])
            nxt = next(
                (b for b in remaining if prev & set(b)), remaining[0]
            )
            remaining.remove(nxt)
            order.append(nxt)
        return order

    def fit(self, epochs: int = 1, verbose: bool = False):
        """Run `epochs` passes; each pass visits every bucket once, in the
        chained order from `_bucket_order` (consecutive buckets share a
        resident partition whenever possible, so the device part cache
        converts most transitions into at most one upload)."""
        order = self._bucket_order()
        for ep in range(epochs):
            tot_loss = tot_viol = 0.0
            for b, (pi, pj) in enumerate(order):
                loss, nviol = self._bucket_epoch(pi, pj)
                # epoch dispatch is async: start the next bucket's missing
                # part upload NOW so the H2D copy rides the transfer engine
                # while this bucket computes. Only into a FREE cache slot —
                # evicting would device_get rows the running epoch still
                # owns, forcing a sync.
                if self.prefetch:
                    nxt = order[(b + 1) % len(order)]
                    for p in dict.fromkeys(nxt):
                        if (
                            p not in self._cache
                            and len(self._cache) < self.cache_parts
                        ):
                            self._fetch_part(p)
                tot_loss = tot_loss + loss
                tot_viol = tot_viol + nviol
            self._metrics.append(
                {
                    "epoch": ep,
                    "loss": float(np.asarray(tot_loss)),
                    "nviolations": float(np.asarray(tot_viol)),
                }
            )
            if verbose:
                print(self._metrics[-1], flush=True)
        self.flush()
        return self

    @property
    def metrics(self):
        return list(self._metrics)

    def save(self, dirpath: str) -> "OutOfCoreTrainer":
        """Checkpoint without ever building a full-table copy: the
        host-resident entity slots write one npz PER PARTITION (the
        natural sharded layout); device-resident relation/dense state,
        RNG key, step and metric history go to a replicated file."""
        import json

        from skge_tpu.utils.checkpoint import _atomic_savez

        self.flush()
        os.makedirs(dirpath, exist_ok=True)
        s = self.part_size
        for p in range(self.n_parts):
            _atomic_savez(
                os.path.join(dirpath, f"part_{p:05d}.npz"),
                {kk: v[p * s: (p + 1) * s] for kk, v in self.e_host.items()},
            )
        rep = {f"params::{kk}": np.asarray(v)
               for kk, v in self.dev_params.items()}
        for kk, slots in self.dev_opt.items():
            for sn, v in slots.items():
                rep[f"opt::{kk}::{sn}"] = np.asarray(v)
        rep["key"] = np.asarray(jax.random.key_data(self.key)) if hasattr(
            self.key, "dtype"
        ) and jnp.issubdtype(self.key.dtype, jax.dtypes.prng_key) else (
            np.asarray(self.key)
        )
        rep["step"] = np.asarray(self.step)
        _atomic_savez(os.path.join(dirpath, "replicated.npz"), rep)
        import zlib

        meta = {"n_parts": self.n_parts, "part_size": s,
                "partition_crc": int(
                    zlib.crc32(np.ascontiguousarray(self.new_of_old))
                ),
                "metrics": self._metrics}
        tmp = os.path.join(dirpath, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(dirpath, "manifest.json"))
        return self

    def restore(self, dirpath: str) -> "OutOfCoreTrainer":
        """Resume from `save`: part files stream straight into the host
        table slots; trainer geometry (n_parts, part_size) must match."""
        import json

        with open(os.path.join(dirpath, "manifest.json")) as f:
            meta = json.load(f)
        if (meta["n_parts"], meta["part_size"]) != (
            self.n_parts, self.part_size,
        ):
            raise ValueError(
                f"checkpoint geometry {meta['n_parts']}x{meta['part_size']} "
                f"!= trainer {self.n_parts}x{self.part_size}"
            )
        import zlib

        crc = int(zlib.crc32(np.ascontiguousarray(self.new_of_old)))
        if meta.get("partition_crc", crc) != crc:
            raise ValueError(
                "checkpoint was saved with a DIFFERENT entity partition "
                "(other triples/seed): restoring would map rows to wrong "
                "entities; rebuild the trainer with the saving run's "
                "triples and seed"
            )
        self._cache.clear()
        self._lru.clear()
        s = self.part_size
        for p in range(self.n_parts):
            with np.load(
                os.path.join(dirpath, f"part_{p:05d}.npz")
            ) as z:
                for kk in z.files:
                    self.e_host[kk][p * s: (p + 1) * s] = z[kk]
        with np.load(os.path.join(dirpath, "replicated.npz")) as z:
            self.dev_params = {
                k.split("::", 1)[1]: jnp.asarray(z[k])
                for k in z.files if k.startswith("params::")
            }
            self.dev_opt = {}
            for k in z.files:
                if k.startswith("opt::"):
                    _, pname, sn = k.split("::")
                    self.dev_opt.setdefault(pname, {})[sn] = jnp.asarray(z[k])
            key = z["key"]
            self.key = (
                jax.random.wrap_key_data(jnp.asarray(key))
                if hasattr(self.key, "dtype") and jnp.issubdtype(
                    self.key.dtype, jax.dtypes.prng_key
                )
                else jnp.asarray(key)
            )
            self.step = jnp.asarray(z["step"])
        self._metrics = list(meta.get("metrics", []))
        return self

    def evaluate(
        self,
        test: np.ndarray,
        known: Optional[np.ndarray] = None,
        batch_size: int = 512,
        hits_at: Tuple[int, ...] = (1, 3, 10),
        ties: str = "mean",
        reciprocal: bool = False,
    ):
        """Streamed filtered ranking over the HOST-resident table — the
        beyond-HBM evaluation the bucketed trainer needs: candidate
        entities arrive one PARTITION at a time (device holds one (S, d)
        slice plus a (B, S) score block; never the full table), and ranks
        accumulate as running greater/equal counts against the target's
        score. Known-true filtering subtracts the counts of the filter
        pairs' own scores — no (B, n_e) matrix, no -inf scatter.

        Rank integers are EXACTLY the in-core `evaluation.evaluate`
        values (same comparisons, partitioned only in the counting), see
        tests/test_outofcore.py. Mirrors the reference protocol
        (SURVEY.md §3.4) incl. mean/optimistic tie-breaking.

        `reciprocal=True` applies the canonical reciprocal protocol for
        models trained on `data.add_reciprocal_relations` output with
        object-direction CE (evaluation.ReciprocalEvalWrapper's streamed
        twin): the subject-direction pass rewrites each query (s, o, p)
        to (o, s, inv(p)) and ranks it as an OBJECT query — same filter
        set (known subjects of (o, p) == known objects of (o, inv p)),
        identical ranks to the in-core wrapper
        (tests/test_outofcore.py).
        """
        import jax
        from functools import partial

        from skge_tpu.data import true_triple_index
        from skge_tpu.evaluation import RankingResult, ranking_scores

        if ties not in ("mean", "optimistic"):
            raise ValueError(f"ties must be 'mean'/'optimistic': {ties!r}")
        self.flush()
        model = self.full_model
        epname = next(pn for _, pn, r in model.slot_spec() if r == "s")
        e_tab = self.e_host["param"]
        s_rows = self.part_size
        nmap = self.new_of_old

        def remap(t):
            t = np.asarray(t, np.int64)
            return np.stack(
                [nmap[t[:, 0]], nmap[t[:, 1]], t[:, 2]], axis=1
            ).astype(np.int64)

        test_rel = remap(test)
        known_rel = remap(test if known is None else known)
        sp_o, op_s = true_triple_index(known_rel)
        index = {"o": sp_o, "s": op_s}

        if reciprocal:
            if model.n_relations % 2 != 0:
                raise ValueError(
                    "reciprocal eval expects the DOUBLED relation count "
                    "(data.add_reciprocal_relations)"
                )
            half = model.n_relations // 2

            def inv(t):
                out = t.copy()
                out[:, 0], out[:, 1] = t[:, 1], t[:, 0]
                out[:, 2] = np.where(
                    t[:, 2] < half, t[:, 2] + half, t[:, 2] - half
                )
                return out

            # head queries rank as OBJECT queries through the inverse
            # relation; their filter set {(o, inv p) -> objects} over the
            # inverse-rewritten known triples equals the native
            # {(o, p) -> subjects}
            index["s"] = true_triple_index(inv(known_rel))[0]

        n = len(test_rel)
        bs = int(min(batch_size, max(1, n)))
        nb = -(-n // bs)
        pad = nb * bs - n
        batches = np.concatenate(
            [test_rel, np.tile(test_rel[:1], (pad, 1))]
        ).reshape(nb, bs, 3)
        # per-direction effective query triples: identical unless
        # reciprocal, where the subject pass uses the inverse rewrite
        eff = {"o": batches, "s": batches}
        if reciprocal:
            eff["s"] = inv(batches.reshape(-1, 3)).reshape(nb, bs, 3)

        dense = {k: self.dev_params[k] for k in model.dense_param_names}

        def rows_of(b, batches):
            s_, o_, p_ = batches[b, :, 0], batches[b, :, 1], batches[b, :, 2]
            out = {}
            for slot, pname, role in model.slot_spec():
                ids = {"s": s_, "o": o_, "p": p_}[role]
                if pname == epname:
                    out[slot] = jnp.asarray(e_tab[ids])
                else:
                    out[slot] = self.dev_params[pname][jnp.asarray(ids)]
            return out

        @partial(jax.jit, static_argnames=("mode",))
        def part_counts(rows, cand, tgt, n_valid, mode, frow, floc):
            sc = model.score_pool(rows, cand, dense, mode)     # (B, S)
            valid = (
                jnp.arange(sc.shape[1]) < n_valid
            )[None, :]
            g = jnp.sum(
                jnp.logical_and(sc > tgt[:, None], valid), axis=1
            )
            e = jnp.sum(
                jnp.logical_and(sc == tgt[:, None], valid), axis=1
            )
            # filter-pair corrections: scores of known-true candidates in
            # THIS part (padding pairs use row == B -> dropped by clip +
            # zero weight)
            b = sc.shape[0]
            ok = frow < b
            fr = jnp.clip(frow, 0, b - 1)
            sf = sc[fr, floc]
            tf = tgt[fr]
            w = ok.astype(g.dtype)
            fg = jnp.zeros((b,), g.dtype).at[fr].add((sf > tf) * w)
            fe = jnp.zeros((b,), g.dtype).at[fr].add((sf == tf) * w)
            return g, e, fg, fe

        @partial(jax.jit, static_argnames=("mode",))
        def target_from_part(rows, cand, tids, mode, off):
            # extract the target's score from the SAME streamed score
            # matrix used for counting — a separately-computed
            # score_from_rows target can differ by an ulp from the pool
            # path and flip >/== comparisons on exact ties. `off` is the
            # part's row offset as a TRACED scalar: a static part index
            # would compile one variant per partition (P compiles per
            # mode — measured as the dominant cost of the first streamed
            # evaluate at the 1M flagship shape).
            sc = model.score_pool(rows, cand, dense, mode)     # (B, S)
            loc = tids - off
            inp = jnp.logical_and(loc >= 0, loc < sc.shape[1])
            got = sc[jnp.arange(sc.shape[0]), jnp.clip(loc, 0, sc.shape[1] - 1)]
            return jnp.where(inp, got, 0)

        # candidate-part uploads dominate streamed-eval cost (a part is
        # s_rows*d floats crossing the host link) — so BOTH passes run
        # part-major with each partition uploaded ONCE per pass for BOTH
        # directions: 2*P uploads per evaluate() instead of the
        # direction-major 2*P*(nb+1). Same arithmetic, same order of adds
        # per (batch, part) accumulator — rank integers are unchanged.
        dir_specs = {}
        for direction, mode in (("o", 1), ("s", 0)):
            if reciprocal and direction == "s":
                mode = 1  # inverse-rewritten head queries are object queries
            dir_specs[direction] = (eff[direction], mode, 1 if mode == 1 else 0)

        # query rows depend only on (direction, batch) — gather/upload
        # them ONCE and reuse across all P parts in both passes (the old
        # per-(batch, part) rows_of re-upload was the remaining streamed
        # host->device tax after the candidate uploads went part-major;
        # NEXT.md round-4 item). Footprint: n_queries x slots x d floats.
        qrows = {d: [rows_of(b, qb) for b in range(nb)]
                 for d, (qb, _, _) in dir_specs.items()}

        # pass 1: target scores from the streamed part matrices
        tdtype = jnp.asarray(e_tab[:1]).dtype
        tgts = {d: [jnp.zeros((bs,), tdtype) for _ in range(nb)]
                for d in dir_specs}
        for p in range(self.n_parts):
            cand = jnp.asarray(e_tab[p * s_rows: (p + 1) * s_rows])
            for direction, (qb, mode, tcol) in dir_specs.items():
                for b in range(nb):
                    tids = jnp.asarray(qb[b, :, tcol])
                    tgts[direction][b] = tgts[direction][b] + target_from_part(
                        qrows[direction][b], cand, tids, mode=mode,
                        off=jnp.int32(p * s_rows),
                    )

        # per (direction, batch, part) filter pairs, pow2-padded (row=bs pads)
        fpairs = {d: [] for d in dir_specs}
        for direction, (qb, mode, tcol) in dir_specs.items():
            for b in range(nb):
                per_part: Dict[int, list] = {}
                for i, (s_, o_, p_) in enumerate(qb[b]):
                    if b * bs + i >= n:
                        continue  # padding test rows filter nothing
                    key = (
                        (int(s_), int(p_)) if mode == 1
                        else (int(o_), int(p_))
                    )
                    ents = index[direction].get(key)
                    if ents is None:
                        continue
                    # dedupe: the in-core path's -inf scatter is
                    # idempotent on duplicate known triples; the count
                    # subtraction here must see each pair once
                    for ent in np.unique(ents).tolist():
                        per_part.setdefault(ent // s_rows, []).append(
                            (i, ent % s_rows)
                        )
                fpairs[direction].append(per_part)

        # pass 2: greater/equal counts vs the assembled targets. One
        # GLOBAL pow2 filter-pad width for the whole evaluate: per-call
        # widths would recompile part_counts once per distinct width
        # (compile tax measured dominant on first streamed evals); the
        # cost of the shared width is only the max batch's pair count.
        wmax = max(
            [len(pl) for d in dir_specs for pp in fpairs[d]
             for pl in pp.values()] or [0]
        )
        width = 1 if wmax <= 1 else 1 << (wmax - 1).bit_length()
        zeros = jnp.zeros((bs,), jnp.int32)
        acc = {d: {b: [zeros, zeros, zeros, zeros] for b in range(nb)}
               for d in dir_specs}
        for p in range(self.n_parts):
            cand = jnp.asarray(e_tab[p * s_rows: (p + 1) * s_rows])
            n_valid = int(self.part_counts[p])
            for direction, (qb, mode, tcol) in dir_specs.items():
                for b in range(nb):
                    pl = fpairs[direction][b].get(p, [])
                    frow = np.full((width,), bs, np.int32)
                    floc = np.zeros((width,), np.int32)
                    if pl:
                        arr = np.asarray(pl, np.int32)
                        frow[: len(pl)] = arr[:, 0]
                        floc[: len(pl)] = arr[:, 1]
                    g, e, fg, fe = part_counts(
                        qrows[direction][b], cand, tgts[direction][b], n_valid,
                        mode=mode,
                        frow=jnp.asarray(frow), floc=jnp.asarray(floc),
                    )
                    a = acc[direction][b]
                    acc[direction][b] = [
                        a[0] + g, a[1] + e, a[2] + fg, a[3] + fe
                    ]

        results = {}
        for direction in dir_specs:
            ranks = np.zeros((n,), np.float64)
            ranks_raw = np.zeros((n,), np.float64)
            for b in range(nb):
                g, e, fg, fe = (
                    np.asarray(x, np.int64) for x in acc[direction][b]
                )
                if ties == "optimistic":
                    raw = 1.0 + g
                    filt = 1.0 + (g - fg)
                else:
                    raw = 1.0 + g + np.maximum(e - 1, 0) * 0.5
                    filt = 1.0 + (g - fg) + np.maximum(e - fe, 0) * 0.5
                lo, hi = b * bs, min((b + 1) * bs, n)
                ranks_raw[lo:hi] = raw[: hi - lo]
                ranks[lo:hi] = filt[: hi - lo]
            results[direction] = (ranks, ranks_raw)

        all_filt = np.stack([results["o"][0], results["s"][0]])
        all_raw = np.stack([results["o"][1], results["s"][1]])
        mrr, mr, hits = ranking_scores(all_filt, hits_at)
        mrr_r, mr_r, hits_r = ranking_scores(all_raw, hits_at)
        return RankingResult(
            mrr=mrr, mrr_raw=mrr_r, mean_rank=mr, mean_rank_raw=mr_r,
            hits=hits, hits_raw=hits_r, ranks=all_filt, ranks_raw=all_raw,
        )

    def params(self) -> Params:
        """Full-size host params in ORIGINAL entity ids (for eval/save)."""
        self.flush()
        e = np.empty((self.full_model.n_entities, *self.e_host["param"].shape[1:]),
                     self.e_host["param"].dtype)
        e[:] = self.e_host["param"][self.new_of_old]
        out = {kk: np.asarray(v) for kk, v in self.dev_params.items()}
        out["E"] = e
        return out
