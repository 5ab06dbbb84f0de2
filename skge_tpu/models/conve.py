"""ConvE — 2D-convolutional scoring (Dettmers et al., AAAI 2018).

Beyond the reference's model roster (SURVEY.md §2.1): the standard
parameter-efficient neural scorer, and the model whose training scheme
(reciprocal relations + 1-vs-all cross entropy with label smoothing) the
`make_ce_step` loss implements.

    hidden(s, p) = ReLU( W · vec( ReLU( Conv2D([ē_s ; r̄_p]) ) ) )
    score(s, o, p) = hidden(s, p) · e_o + b_o

where ē_s, r̄_p are the d-dim embeddings reshaped to (eh, ew) grids and
stacked into one (2·eh, ew) image. The original also applies batch-norm
and three dropouts — training-scheme choices (like TuckER's), not part of
the scoring function, and omitted here (AdaGrad + optional `rparam` L2
take their place).

Design:
- The convolution lowers to XLA's convolution; the FC projection and
  both candidate sweeps are single (B, ·) x (·, N) matmuls. All shapes
  are static.
- The per-entity output bias is FOLDED into the entity table as an extra
  trailing column: `E` is (n_e, d+1), subjects read columns [:d],
  objects contribute e_o = E[o, :d] and b_o = E[o, d] via one gather.
  One row table means the generic gather/scatter/AdaGrad/occurrence
  machinery (one fused scatter, one accumulator row per entity) applies
  unchanged — no second bias table to plumb through samplers, shards, or
  checkpoints. The candidate sweep appends a constant 1 to the query so
  score = [hidden, 1] · E^T in ONE matmul.
- ConvE is inherently DIRECTIONAL: hidden() sees only (s, p), so scoring
  all candidate SUBJECTS would need one convolution per candidate. The
  standard fix is reciprocal relations (`reciprocal=True`, the paper's
  protocol): train on `data.add_reciprocal_relations(ds)` (which doubles
  n_relations) with object-side corruption only — sampler `modes=(1,)`
  or `make_ce_step(directions=('o',))` — and subject-direction queries
  route through the inverse relation id: score_all_s(o, p) =
  score_all_o(o, inv(p)). Filtered-ranking evaluation then works
  unmodified in both directions.
- With `reciprocal=False`, `score_all_s` is still available through a
  per-relation candidate-hidden-table sweep over the batch's DISTINCT
  relations (cost independent of n_relations — see the method; the old
  256-relation gate is gone) so non-reciprocal ConvE evaluates under
  the full two-direction protocol like every other model.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from skge_tpu.models.base import INITIALIZERS, KGEModel, Params


def _auto_grid(d: int) -> int:
    """Largest divisor of d that is <= sqrt(d) (near-square reshape)."""
    best = 1
    for h in range(1, int(math.isqrt(d)) + 1):
        if d % h == 0:
            best = h
    return best


@dataclass(frozen=True)
class ConvE(KGEModel):
    """`ncomp` is the embedding dim d (must factor as eh * ew); entity rows
    are d+1 wide (trailing column = the per-entity output bias)."""

    nfilters: int = 32
    ksize: int = 3
    eh: int = 0          # grid height; 0 = auto (largest divisor <= sqrt d)
    reciprocal: bool = True
    rparam: float = 0.0

    name = "conve"
    dense_param_names = ("F", "bF", "W", "bW")
    reg_row_params = ("E", "R")

    def __post_init__(self):
        h, w = self.grid
        if h * w != self.ncomp:
            raise ValueError(
                f"ncomp={self.ncomp} does not factor as eh*ew with eh={h}"
            )
        if 2 * h < self.ksize or w < self.ksize:
            raise ValueError(
                f"conv kernel {self.ksize}x{self.ksize} larger than the "
                f"stacked {2 * h}x{w} image — pick a smaller ksize or "
                f"different eh"
            )
        if self.reciprocal and self.n_relations % 2 != 0:
            raise ValueError(
                "reciprocal=True expects n_relations to be the DOUBLED "
                "count (use data.add_reciprocal_relations)"
            )

    def reg_grad_rows(self, pname, rows):
        """The paper leaves output biases unregularized: E's trailing column
        (the per-entity output bias b_o) is masked out of the rparam row-L2
        gradient so rparam>0 decays embeddings only, not biases."""
        if pname != "E":
            return rows
        return rows.at[..., -1].set(0.0)

    @property
    def grid(self):
        h = self.eh or _auto_grid(self.ncomp)
        return h, self.ncomp // h

    @property
    def conv_out(self):
        h, w = self.grid
        return 2 * h - self.ksize + 1, w - self.ksize + 1

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"), ("rp", "R", "p"))

    def init_params(self, key: jax.Array) -> Params:
        init = INITIALIZERS[self.init]
        ke, kr, kf, kw = jax.random.split(key, 4)
        d, c, k = self.ncomp, self.nfilters, self.ksize
        oh, ow = self.conv_out
        emb = init(ke, (self.n_entities, d), self.jdtype)
        return {
            # trailing zero column = output bias b_o
            "E": jnp.concatenate(
                [emb, jnp.zeros((self.n_entities, 1), self.jdtype)], axis=1
            ),
            "R": init(kr, (self.n_relations, d), self.jdtype),
            "F": init(kf, (c, k * k), self.jdtype).reshape(c, 1, k, k),
            "bF": jnp.zeros((c,), self.jdtype),
            "W": init(kw, (c * oh * ow, d), self.jdtype),
            "bW": jnp.zeros((d,), self.jdtype),
        }

    def _hidden(self, es_emb: jnp.ndarray, rp: jnp.ndarray, dense: Params):
        """(B, d) ConvE feature: conv over the stacked (2eh, ew) image,
        ReLU, flatten, FC, ReLU."""
        b = es_emb.shape[0]
        h, w = self.grid
        img = jnp.concatenate(
            [es_emb.reshape(b, 1, h, w), rp.reshape(b, 1, h, w)], axis=2
        )
        out = jax.lax.conv_general_dilated(
            img, dense["F"].astype(img.dtype),
            window_strides=(1, 1), padding="VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            preferred_element_type=jnp.promote_types(img.dtype, jnp.float32),
        ).astype(img.dtype)
        out = jnp.maximum(out + dense["bF"][None, :, None, None], 0.0)
        flat = out.reshape(b, -1)
        return jnp.maximum(self.mxu(flat, dense["W"]) + dense["bW"], 0.0)

    def score_from_rows(self, rows, dense):
        d = self.ncomp
        hidden = self._hidden(rows["es"][:, :d], rows["rp"], dense)
        return jnp.sum(hidden * rows["eo"][:, :d], axis=-1) + rows["eo"][:, d]

    def _query1(self, hidden: jnp.ndarray) -> jnp.ndarray:
        """Append the constant-1 bias lane: score = q · [e_o | b_o]."""
        one = jnp.ones((hidden.shape[0], 1), hidden.dtype)
        return jnp.concatenate([hidden, one], axis=-1)

    def score_pool(self, rows, pool_rows, dense, mode):
        if mode != 1:
            raise ValueError(
                "ConvE scores candidate OBJECTS only (hidden() is a "
                "function of (s, p)); train with reciprocal relations and "
                "object-side corruption (sampler modes=(1,) or "
                "make_ce_step(directions=('o',)))"
            )
        d = self.ncomp
        hidden = self._hidden(rows["es"][:, :d], rows["rp"], dense)
        return self.mxu(self._query1(hidden), pool_rows.T)

    def _inv(self, p: jnp.ndarray) -> jnp.ndarray:
        half = self.n_relations // 2
        return jnp.where(p < half, p + half, p - half)

    def score_all_o(self, params: Params, s, p):
        d = self.ncomp
        hidden = self._hidden(
            params["E"][s, :d], params["R"][p], self.dense_params(params)
        )
        return self.mxu(self._query1(hidden), params["E"].T)

    def score_all_s(self, params: Params, o, p):
        if self.reciprocal:
            return self.score_all_o(params, o, self._inv(p))
        # Non-reciprocal subject sweep (round 4, de-gated round 5):
        # hidden() is a function of (candidate, p), so candidates cannot
        # ride one matmul the way score_all_o's do. The matmul-shaped
        # factoring is BY RELATION: build the candidate hidden table
        # H_r = hidden(E, r) (n_e, d) once per DISTINCT batch relation —
        # entity-chunked lax.scan keeps the conv activations bounded at
        # (chunk, nfilters, oh, ow) — then every query row with relation r
        # is one (B, d) x (d, n_e) dot against H_r. The scan iterates
        # the batch's unique relations (sort + first-occurrence compaction,
        # static trip count min(B, n_r); padding slots carry sentinel -1
        # and lax.cond skips them at runtime), so cost is
        # distinct_rels_in_batch * (n_e hidden evals + B*n_e*d dot FLOPs)
        # — independent of n_relations. FB15k's 1,345 relations (the old
        # 256 gate's cliff) now pay only for relations a batch touches;
        # the inherent worst case (B distinct relations per batch) is why
        # the reciprocal protocol (the paper's own) stays the recommended
        # route: score_all_s there is ONE score_all_o call.
        d = self.ncomp
        n_e = self.n_entities
        dense = self.dense_params(params)
        eo = params["E"][o, :d]                      # (B, d)
        bo = params["E"][o, d]                       # (B,)
        chunk = min(4096, n_e)
        n_pad = -(-n_e // chunk) * chunk
        e_all = params["E"][:, :d]
        e_chunks = jnp.concatenate(
            [e_all, jnp.zeros((n_pad - n_e, d), e_all.dtype)]
        ).reshape(-1, chunk, d)

        def hidden_table(rvec):
            def c_body(_, e_chunk):
                rp = jnp.broadcast_to(rvec, (chunk, d))
                return None, self._hidden(e_chunk, rp, dense)

            _, h = jax.lax.scan(c_body, None, e_chunks)
            return h.reshape(n_pad, d)[:n_e]         # (n_e, d)

        # unique relations of THIS batch, compacted to the front (stable
        # argsort keeps first occurrences), padded with sentinel -1
        b = o.shape[0]
        sp = jnp.sort(p)
        first = jnp.concatenate(
            [jnp.ones((1,), bool), sp[1:] != sp[:-1]]
        )
        order = jnp.argsort(~first, stable=True)
        uniq = jnp.where(first[order], sp[order], -1)
        trips = min(b, self.n_relations)
        uniq = uniq[:trips]

        def rel_body(acc, r):
            def live(acc):
                rvec = params["R"][jnp.maximum(r, 0)]
                sc = self.mxu(eo, hidden_table(rvec).T)      # (B, n_e)
                return acc + jnp.where((p == r)[:, None], sc, 0.0)

            acc = jax.lax.cond(r >= 0, live, lambda a: a, acc)
            return acc, None

        acc = jnp.zeros((o.shape[0], n_e), eo.dtype)
        acc, _ = jax.lax.scan(rel_body, acc, uniq)
        return acc + bo[:, None]
