"""Production link-prediction serving: batched top-K entity retrieval.

The reference has no serving path — its only inference surface is the
evaluation harness's all-entity score sweep (companion kg/base.py
`FilteredRankingEval`, SURVEY.md §3.4). This module is the deployment
counterpart (build-scope per BASELINE.md "production deployment and
serving"): given (entity, relation) queries, return the K best completion
entities, exactly, with known-true triples filtered out.

Three engines, one scoring contract:

- `LinkPredictor` — in-HBM, single device: one matmul per batch via
  `KGEModel.score_pool` against the full entity table, `lax.top_k`, all
  inside a single jitted kernel per (batch_size, k, filter_width) shape.
- `LinkPredictor(mesh=...)` — candidate-sharded SPMD: the entity table is
  row-sharded over a mesh axis; each shard scores ONLY its slice (local
  (B, n_e/P) matmul), takes a LOCAL top-k, and one k-row `all_gather`
  merges (B, P*k) -> (B, k). Collective traffic is O(B*k*P), never
  O(B*n_e) — the same no-full-gather discipline as the partitioned
  evaluator.
- `StreamedLinkPredictor` — beyond-HBM tables: candidate chunks upload one
  at a time and fold into a running top-k (`lax.top_k` over the
  concatenated (B, k + chunk) candidates), so the device holds one chunk +
  the (B, k) frontier, never the table.

All three paths score candidates through `KGEModel.score_pool` (the pool
algebra whose exactness against expanded pairs is pinned by
tests/test_shared.py), so their scores are mutually consistent; ties in
`lax.top_k` break toward the lower entity id.

AOT: `LinkPredictor.aot_kernels()` compiles the serving kernels ahead of
time for fixed shapes; `export_serialized()` produces portable serialized
StableHLO artifacts via `jax.export` for deployment without Python model
code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from skge_tpu.data import true_triple_index
from skge_tpu.evaluation import NEG_INF
from skge_tpu.models.base import KGEModel, Params

__all__ = [
    "LinkPredictor",
    "StreamedLinkPredictor",
    "TopKResult",
    "quantize_table_fp8",
    "quantize_table_int8",
    "top_k_candidates",
]


def quantize_table_int8(table) -> Dict[str, np.ndarray]:
    """Symmetric per-row int8 quantization of an embedding table.

    Returns {'q': int8 (n, ...), 'scale': f32 (n, 1...)} with
    dequantization `q * scale`. Per-row absmax/127 scaling: rows are the
    unit of retrieval, so each row keeps its own dynamic range (a single
    hub entity with large norm must not crush everyone else's precision).
    The quantized table is 4x smaller than fp32 — 4x more entities per
    device HBM for the in-HBM engine, 4x fewer host->device bytes per
    chunk for the streamed engine.
    """
    t = np.asarray(table, np.float32)
    absmax = np.max(np.abs(t), axis=tuple(range(1, t.ndim)), keepdims=True)
    scale = (absmax / 127.0 + np.float32(1e-30)).astype(np.float32)
    q = np.clip(np.rint(t / scale), -127, 127).astype(np.int8)
    return {"q": q, "scale": scale}


def quantize_table_fp8(table) -> Dict[str, np.ndarray]:
    """Per-row scaled `float8_e4m3fn` quantization (VERDICT r3 item 9).

    Same 1 byte/element and per-row scale as int8 (scale = absmax/448,
    e4m3fn's max normal), so the A/B against int8 is at EQUAL storage and
    upload bytes. The representational trade: int8 spends its 8 bits on a
    uniform grid (~7 significant bits at full row scale); e4m3 spends them
    on 3 mantissa bits + exponent, so small-magnitude coordinates keep
    relative precision while coordinates near absmax see ~16x coarser
    steps than int8. KGE retrieval ranks by a SUM over coordinates —
    absolute, not relative, error is what perturbs it — so int8 should
    win recall at equal bytes; the measured table in RESULTS.md confirms
    it (the sweep dequantizes to fp32 like int8's). Kept as a supported
    mode because the equal-bytes comparison is the evidence.
    """
    import ml_dtypes

    t = np.asarray(table, np.float32)
    absmax = np.max(np.abs(t), axis=tuple(range(1, t.ndim)), keepdims=True)
    scale = (absmax / 448.0 + np.float32(1e-30)).astype(np.float32)
    q = (t / scale).astype(ml_dtypes.float8_e4m3fn)
    return {"q": q, "scale": scale}


_QUANTIZERS = {"int8": quantize_table_int8, "fp8": quantize_table_fp8}
_QUANT_MODES = ("", "int8", "fp8", "bfloat16")


@dataclass
class TopKResult:
    """Top-K completions for a query batch.

    `entities[b, j]` is the j-th best completion entity for query b (object
    entities for direction 'o', subjects for 's'); `scores[b, j]` its model
    score (descending in j). Filtered-out or candidate-masked slots — only
    possible when k exceeds the number of eligible entities — carry entity
    id -1 and score -inf.
    """

    entities: np.ndarray  # (B, k) int32
    scores: np.ndarray    # (B, k) float32


def _role_slots(model: KGEModel) -> Dict[str, str]:
    return {role: slot for slot, _, role in model.slot_spec()}


def _entity_param(model: KGEModel) -> str:
    by_role = {role: pname for _, pname, role in model.slot_spec()}
    return by_role["o"]


def _deq_table(qe, quantize: str):
    """Full dequantized candidate table (XLA fuses the elementwise dequant
    into the consuming sweep matmul's operand stream)."""
    if quantize in ("int8", "fp8"):
        return qe["q"].astype(jnp.float32) * qe["scale"]
    if quantize == "bfloat16":
        return qe.astype(jnp.float32)
    return qe


def _deq_rows(qe, idx, quantize: str):
    if quantize in ("int8", "fp8"):
        return qe["q"][idx].astype(jnp.float32) * qe["scale"][idx]
    if quantize == "bfloat16":
        return qe[idx].astype(jnp.float32)
    return qe[idx]


def _query_rows(model: KGEModel, params: Params, ent, rel, direction: str,
                quantize: str = ""):
    """Gathered rows for (ent, rel) queries with the predicted slot zeroed.

    direction 'o' predicts objects (query ent is the subject, score_pool
    mode 1); 's' predicts subjects (query ent is the object, mode 0). The
    substituted slot's gathered row is irrelevant — score_pool replaces it
    with each candidate — so index 0 stands in. Entity rows dequantize per
    gather under `quantize`.
    """
    epname = _entity_param(model)
    zeros = jnp.zeros_like(ent)
    s_idx, o_idx = (ent, zeros) if direction == "o" else (zeros, ent)
    idx_by_role = {"s": s_idx, "o": o_idx, "p": rel}
    rows = {}
    for slot, pname, role in model.slot_spec():
        idx = idx_by_role[role]
        if pname == epname:
            rows[slot] = _deq_rows(params[pname], idx, quantize)
        else:
            rows[slot] = params[pname][idx]
    return rows


_MODE = {"o": 1, "s": 0}


def _filter_pairs_for_batch(
    queries: np.ndarray, index: dict, batch_rows: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Flat (row, entity) known-true pairs for one query batch, padded to a
    power of two (same shape discipline as evaluation._filter_pairs: one
    high-degree query must not recompile every batch). Padding rows use
    row id = batch_rows, dropped by the device scatter."""
    rows, ents = [], []
    for i, (e, r) in enumerate(queries):
        true_ents = index.get((int(e), int(r)))
        if true_ents is not None:
            rows.extend([i] * len(true_ents))
            ents.extend(true_ents.tolist())
    width = 1 if len(rows) <= 1 else 1 << (len(rows) - 1).bit_length()
    pad = width - len(rows)
    rows.extend([batch_rows] * pad)
    ents.extend([0] * pad)
    return np.asarray(rows, np.int32), np.asarray(ents, np.int32)


def _mask_invalid(vals, ids):
    """Replace filtered-slot winners (score == NEG_INF sentinel) with
    (-inf, -1): a slot only wins when k exceeds the eligible candidates."""
    bad = vals <= NEG_INF
    return (
        jnp.where(bad, -jnp.inf, vals),
        jnp.where(bad, -1, ids),
    )


class LinkPredictor:
    """Exact top-K link prediction over an in-HBM entity table.

    `known` (optional (N, 3) (s, o, p) triples — typically train ∪ valid)
    enables filtered retrieval: known-true completions are removed before
    the top-k, so results are NEW candidate links (the filtered protocol of
    the reference evaluator, applied to serving). Pass `filtered=False` per
    call to keep them.

    With `mesh`, the entity table must be row-sharded over `axis` (the
    layout produced by `parallel.shard_state`); scoring, filtering, and the
    local top-k then run shard-locally under `shard_map`, and only (B, k)
    frontiers cross the interconnect.
    """

    def __init__(
        self,
        model: KGEModel,
        params: Params,
        known: Optional[np.ndarray] = None,
        batch_size: int = 1024,
        mesh=None,
        axis: str = "model",
        quantize: str = "",
    ):
        """`quantize` compresses the (dominant) entity table in HBM:
        'int8' — per-row symmetric int8 (4x capacity; approximate scores,
        measure recall with scripts/serving_bench.py --recall), 'fp8' —
        per-row-scaled float8_e4m3fn (same 4x; see quantize_table_fp8 for
        the equal-bytes trade vs int8), 'bfloat16' — plain cast (2x).
        Other params stay fp32; queries dequantize per gather and
        candidates per sweep, inside the jitted kernel."""
        self.model = model
        self.quantize = quantize
        if quantize not in _QUANT_MODES:
            raise ValueError(f"unknown quantize mode {quantize!r}")
        if quantize:
            epname = _entity_param(model)
            params = dict(params)
            if quantize in _QUANTIZERS:
                qt = _QUANTIZERS[quantize](params[epname])
                params[epname] = {
                    "q": jnp.asarray(qt["q"]),
                    "scale": jnp.asarray(qt["scale"]),
                }
            else:
                params[epname] = jnp.asarray(
                    params[epname], jnp.bfloat16
                )
        self.params = params
        self.batch_size = int(batch_size)
        self.mesh = mesh
        self.axis = axis
        if mesh is not None:
            m = int(mesh.shape[axis])
            if model.n_entities % m != 0:
                raise ValueError(
                    f"n_entities={model.n_entities} not divisible by mesh "
                    f"axis {axis}={m}; pad the entity count"
                )
        sp_o, op_s = (
            true_triple_index(np.asarray(known))
            if known is not None
            else ({}, {})
        )
        self._index = {"o": sp_o, "s": op_s}
        self._kernels: Dict[tuple, callable] = {}

    # --- kernels -----------------------------------------------------------
    def _kernel(self, direction: str, k: int):
        key = (direction, k)
        kern = self._kernels.get(key)
        if kern is None:
            kern = (
                self._build_sharded(direction, k)
                if self.mesh is not None
                else self._build_single(direction, k)
            )
            self._kernels[key] = kern
        return kern

    def _build_single(self, direction: str, k: int):
        model = self.model
        mode = _MODE[direction]
        epname = _entity_param(model)
        quant = self.quantize

        def kernel(params, ent, rel, frows, fents):
            rows = _query_rows(model, params, ent, rel, direction, quant)
            scores = model.score_pool(
                rows, _deq_table(params[epname], quant),
                model.dense_params(params), mode
            )  # (B, n_e)
            scores = scores.at[frows, fents].set(NEG_INF, mode="drop")
            vals, ids = jax.lax.top_k(scores, k)
            return _mask_invalid(vals, ids.astype(jnp.int32))

        return jax.jit(kernel)

    def _build_sharded(self, direction: str, k: int):
        from jax.sharding import PartitionSpec as P

        model = self.model
        mode = _MODE[direction]
        epname = _entity_param(model)
        quant = self.quantize
        mesh, axis = self.mesh, self.axis
        m_size = int(mesh.shape[axis])
        shard_rows = model.n_entities // m_size
        # E sharded over `axis`; every other param replicated (matches
        # parallel.shard_state / shardmap_step._param_specs layout).
        pspecs = {}
        for _, pname, _ in model.slot_spec():
            pspecs[pname] = P(axis) if pname == epname else P()
        for pname in model.dense_param_names:
            pspecs[pname] = P()
        other_axes = tuple(a for a in mesh.axis_names if a != axis)

        def local(params, ent, rel, frows, fents):
            off = jax.lax.axis_index(axis) * shard_rows
            # masked-local gather + psum assembles full query rows from the
            # row-sharded table (shardmap_step.py discipline)
            zeros = jnp.zeros_like(ent)
            s_idx, o_idx = (ent, zeros) if direction == "o" else (zeros, ent)
            idx_by_role = {"s": s_idx, "o": o_idx, "p": rel}
            rows = {}
            for slot, pname, role in model.slot_spec():
                idx = idx_by_role[role]
                if pname != epname:
                    rows[slot] = params[pname][idx]
                    continue
                loc = idx - off
                own = jnp.logical_and(loc >= 0, loc < shard_rows)
                r = _deq_rows(
                    params[pname], jnp.clip(loc, 0, shard_rows - 1), quant
                )
                r = jnp.where(
                    own.reshape(own.shape + (1,) * (r.ndim - 1)), r, 0
                )
                rows[slot] = jax.lax.psum(r, axis)
            scores = model.score_pool(
                rows, _deq_table(params[epname], quant),
                model.dense_params(params), mode
            )  # (B, shard_rows) — this shard's candidate slice
            # filter: global entity ids -> local; foreign rows routed to an
            # always-dropped positive index (negative ids would wrap)
            loc = fents - off
            loc = jnp.where(
                jnp.logical_and(loc >= 0, loc < shard_rows), loc, shard_rows
            )
            scores = scores.at[frows, loc].set(NEG_INF, mode="drop")
            lvals, lids = jax.lax.top_k(scores, min(k, shard_rows))
            gids = lids.astype(jnp.int32) + off
            # (B, P*k) frontier merge — the only cross-shard traffic
            avals = jax.lax.all_gather(lvals, axis, axis=1)  # (B, P, k)
            aids = jax.lax.all_gather(gids, axis, axis=1)
            b = avals.shape[0]
            vals, pick = jax.lax.top_k(avals.reshape(b, -1), k)
            ids = jnp.take_along_axis(aids.reshape(b, -1), pick, axis=1)
            return _mask_invalid(vals, ids)

        del other_axes  # queries replicate over them; results match by determinism
        smapped = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(pspecs, P(), P(), P(), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )
        return jax.jit(smapped)

    # --- public API --------------------------------------------------------
    def top_k(
        self,
        queries: np.ndarray,
        k: int,
        direction: str = "o",
        filtered: bool = True,
    ) -> TopKResult:
        """Top-k completions for `queries` ((N, 2) int array of
        (entity, relation): (s, p) rows for direction 'o', (o, p) for 's').
        """
        if direction not in ("o", "s"):
            raise ValueError(f"direction must be 'o' or 's', got {direction!r}")
        q = np.asarray(queries, np.int32).reshape(-1, 2)
        n = q.shape[0]
        k = int(min(k, self.model.n_entities))
        kern = self._kernel(direction, k)
        index = self._index[direction] if filtered else {}
        bs = min(self.batch_size, max(1, n))
        out_ids = np.empty((n, k), np.int32)
        out_vals = np.empty((n, k), np.float32)
        for start in range(0, n, bs):
            batch = q[start : start + bs]
            nvalid = batch.shape[0]
            if nvalid < bs:  # pad the tail batch (rows dropped after)
                batch = np.concatenate(
                    [batch, np.zeros((bs - nvalid, 2), np.int32)]
                )
            frows, fents = _filter_pairs_for_batch(batch[:nvalid], index, bs)
            vals, ids = kern(
                self.params,
                jnp.asarray(batch[:, 0]),
                jnp.asarray(batch[:, 1]),
                jnp.asarray(frows),
                jnp.asarray(fents),
            )
            out_ids[start : start + nvalid] = np.asarray(ids)[:nvalid]
            out_vals[start : start + nvalid] = np.asarray(
                vals, np.float32
            )[:nvalid]
        return TopKResult(entities=out_ids, scores=out_vals)

    def score_triples(self, triples: np.ndarray) -> np.ndarray:
        """Model scores for explicit (s, o, p) triples (link plausibility)."""
        t = jnp.asarray(np.asarray(triples, np.int32).reshape(-1, 3))
        return np.asarray(self.model.score_triples(self.params, t))

    # --- AOT / export ------------------------------------------------------
    def aot_kernels(self, k: int, directions=("o", "s"), filter_width: int = 1):
        """Ahead-of-time compile the serving kernels for this predictor's
        batch size and the given k: returns {direction: compiled_executable}.
        Call before taking traffic so no query pays the compile."""
        out = {}
        for d in directions:
            args = self._example_args(k, filter_width)
            out[d] = self._kernel(d, k).lower(self.params, *args).compile()
        return out

    def export_serialized(self, k: int, direction: str = "o",
                          filter_width: int = 1) -> bytes:
        """Portable serialized StableHLO of the serving kernel
        (jax.export): deployable by any JAX runtime without this package."""
        from jax import export as jexport

        args = self._example_args(k, filter_width)
        exported = jexport.export(self._kernel(direction, k))(
            self.params, *args
        )
        return bytes(exported.serialize())

    def _example_args(self, k: int, filter_width: int):
        bs = self.batch_size
        return (
            jnp.zeros(bs, jnp.int32),
            jnp.zeros(bs, jnp.int32),
            jnp.full((filter_width,), bs, jnp.int32),
            jnp.zeros(filter_width, jnp.int32),
        )


class StreamedLinkPredictor:
    """Top-K retrieval when the entity table exceeds device memory.

    `entity_table` stays a host array (numpy); candidate chunks stream
    through the device and fold into a running (B, k) frontier. Query
    entity rows are host-gathered per batch. Relation/dense parameters are
    device-resident (they are small). Scores ride the same
    `KGEModel.score_pool` algebra as the in-HBM engines.

    The per-chunk fold is `top_k(concat([frontier, chunk_scores]))`; all
    chunks use one compiled kernel (the tail chunk pads with dropped
    filter slots and a candidate validity mask).
    """

    def __init__(
        self,
        model: KGEModel,
        params_host: Dict[str, np.ndarray],
        known: Optional[np.ndarray] = None,
        batch_size: int = 256,
        chunk: int = 65536,
        quantize: str = "",
    ):
        """`quantize='int8'` stores the HOST table quantized (4x less host
        RAM) and — the real win here — uploads each candidate chunk as
        int8 + per-row scales: 4x fewer host->device bytes on the
        streaming path, which is upload-bound by construction. 'fp8' is
        the same bytes with e4m3 rounding (see quantize_table_fp8);
        'bfloat16' halves both. Scores are approximate; query rows
        dequantize from the same representation so the engine is
        self-consistent."""
        self.model = model
        self.quantize = quantize
        if quantize not in _QUANT_MODES:
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.batch_size = int(batch_size)
        self.chunk = int(min(chunk, model.n_entities))
        epname = _entity_param(model)
        self._epname = epname
        self._E = np.asarray(params_host[epname])
        if quantize in _QUANTIZERS:
            self._Eq = _QUANTIZERS[quantize](self._E)
            # host query gathers read the dequantized values so the engine
            # is consistent with what the device sweep sees
            self._E = self._Eq["q"].astype(np.float32) * self._Eq["scale"]
        elif quantize == "bfloat16":
            import jax.numpy as _jnp  # bf16 rounding via jnp, stored as np

            self._Eq = None
            self._E = np.asarray(
                _jnp.asarray(self._E, _jnp.bfloat16)
            )  # bf16-typed numpy array (uploads at 2 bytes/elem)
        # non-entity params live on device
        self._small = {
            kname: jnp.asarray(v)
            for kname, v in params_host.items()
            if kname != epname
        }
        sp_o, op_s = (
            true_triple_index(np.asarray(known))
            if known is not None
            else ({}, {})
        )
        self._index = {"o": sp_o, "s": op_s}
        self._kernels: Dict[tuple, callable] = {}

    def _kernel(self, direction: str, k: int):
        key = (direction, k)
        kern = self._kernels.get(key)
        if kern is not None:
            return kern
        model = self.model
        mode = _MODE[direction]
        slots = _role_slots(model)
        qslot = slots["s"] if direction == "o" else slots["o"]
        quant = self.quantize

        def fold(small, qrows_bundle, chunk_payload, base, valid,
                 frows, fents, best_vals, best_ids):
            # rebuild the rows dict: query-entity rows came from the host,
            # relation rows gather from the resident table. The chunk
            # payload dequantizes here — int8 uploads 4x fewer bytes on
            # the (upload-bound) streaming path.
            rows = dict(qrows_bundle)
            chunk_rows = _deq_table(chunk_payload, quant)
            params = dict(small)
            params[self._epname] = chunk_rows  # only for dense_params safety
            scores = model.score_pool(
                rows, chunk_rows, model.dense_params(params), mode
            )  # (B, C)
            scores = jnp.where(valid[None, :], scores, NEG_INF)
            loc = fents - base
            loc = jnp.where(
                jnp.logical_and(loc >= 0, loc < chunk_rows.shape[0]),
                loc, chunk_rows.shape[0],
            )
            scores = scores.at[frows, loc].set(NEG_INF, mode="drop")
            ids = base + jnp.arange(chunk_rows.shape[0], dtype=jnp.int32)
            cat_vals = jnp.concatenate([best_vals, scores], axis=1)
            cat_ids = jnp.concatenate(
                [best_ids, jnp.broadcast_to(ids, scores.shape)], axis=1
            )
            vals, pick = jax.lax.top_k(cat_vals, k)
            out_ids = jnp.take_along_axis(cat_ids, pick, axis=1)
            return vals, out_ids

        kern = jax.jit(fold)
        self._kernels[key] = kern
        return kern

    def top_k(
        self,
        queries: np.ndarray,
        k: int,
        direction: str = "o",
        filtered: bool = True,
    ) -> TopKResult:
        if direction not in ("o", "s"):
            raise ValueError(f"direction must be 'o' or 's', got {direction!r}")
        model = self.model
        q = np.asarray(queries, np.int32).reshape(-1, 2)
        n = q.shape[0]
        n_e = model.n_entities
        k = int(min(k, n_e))
        kern = self._kernel(direction, k)
        index = self._index[direction] if filtered else {}
        slots = _role_slots(model)
        bs = min(self.batch_size, max(1, n))
        C = self.chunk
        out_ids = np.empty((n, k), np.int32)
        out_vals = np.empty((n, k), np.float32)
        for start in range(0, n, bs):
            batch = q[start : start + bs]
            nvalid = batch.shape[0]
            if nvalid < bs:
                batch = np.concatenate(
                    [batch, np.zeros((bs - nvalid, 2), np.int32)]
                )
            ent, rel = batch[:, 0], batch[:, 1]
            # host-gather the query rows; the substituted slot gets zeros
            qrows = {}
            for slot, pname, role in model.slot_spec():
                if pname == self._epname:
                    src_idx = {
                        "s": ent if direction == "o" else np.zeros_like(ent),
                        "o": ent if direction == "s" else np.zeros_like(ent),
                    }[role]
                    qrows[slot] = jnp.asarray(
                        self._E[src_idx],
                        jnp.float32 if self.quantize else None,
                    )
                else:
                    qrows[slot] = self._small[pname][jnp.asarray(
                        rel if role == "p" else np.zeros_like(rel)
                    )]
            # drop the substituted slot's content (replaced per candidate)
            qrows[slots["o" if direction == "o" else "s"]] = jnp.zeros_like(
                qrows[slots["o" if direction == "o" else "s"]]
            )
            pair_rows, pair_ents = _filter_pairs_for_batch(
                batch[:nvalid], index, bs
            )
            fdt = jnp.float32 if self.quantize else self._E.dtype
            best_vals = jnp.full((bs, k), -jnp.inf, fdt)
            best_ids = jnp.full((bs, k), -1, jnp.int32)

            def _pad(a, nrows):
                if nrows < C:
                    a = np.concatenate(
                        [a, np.zeros((C - nrows, *a.shape[1:]), a.dtype)]
                    )
                return a

            for cbase in range(0, n_e, C):
                nrows = min(C, n_e - cbase)
                if self.quantize in _QUANTIZERS:
                    payload = {
                        "q": jnp.asarray(_pad(
                            self._Eq["q"][cbase : cbase + C], nrows)),
                        "scale": jnp.asarray(_pad(
                            self._Eq["scale"][cbase : cbase + C], nrows)),
                    }
                else:
                    payload = jnp.asarray(
                        _pad(self._E[cbase : cbase + C], nrows)
                    )
                valid = np.zeros(C, bool)
                valid[:nrows] = True
                best_vals, best_ids = kern(
                    self._small, qrows, payload,
                    jnp.int32(cbase), jnp.asarray(valid),
                    jnp.asarray(pair_rows), jnp.asarray(pair_ents),
                    best_vals, best_ids,
                )
            vals = np.asarray(best_vals, np.float32)[:nvalid]
            ids = np.asarray(best_ids)[:nvalid]
            bad = vals <= NEG_INF
            vals = np.where(bad, -np.inf, vals)
            ids = np.where(bad, -1, ids)
            out_vals[start : start + nvalid] = vals
            out_ids[start : start + nvalid] = ids
        return TopKResult(entities=out_ids, scores=out_vals)


def top_k_candidates(
    model: KGEModel,
    params: Params,
    queries: np.ndarray,
    k: int,
    direction: str = "o",
    known: Optional[np.ndarray] = None,
) -> TopKResult:
    """One-shot convenience wrapper around LinkPredictor."""
    pred = LinkPredictor(model, params, known=known)
    return pred.top_k(queries, k, direction=direction, filtered=known is not None)
