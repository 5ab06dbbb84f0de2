"""PairRE — paired relation vectors scaling both endpoints (Chao et al.,
ACL 2021).

Beyond the reference's model roster (SURVEY.md §2.1). Each relation gets
a HEAD scale and a TAIL scale; scoring translates nothing — it stretches
both endpoints per-dimension and measures the residual:

    score(s, o, p) = -|| e_s ∘ r^H_p  -  e_o ∘ r^T_p ||^2

The pair (r^H, r^T) encodes symmetric (r^H = r^T), antisymmetric,
inverse, compositional AND subrelation patterns while keeping entity
rows on the unit ball (the reference's `normless1` constraint, applied
to touched rows post-update like TransE).

Design: the two scales live in ONE (n_r, 2d) row table `R` (halves
[r^H | r^T]) — one gather, one fused scatter, one AdaGrad accumulator.
The squared-L2 form (the paper uses L1; same trade documented for
RotatE) expands so both corruption directions are TWO matmuls
against the candidate table: with fixed query a = e_s ∘ r^H (mode 1),

    ||a - e ∘ r^T||^2 = |a|^2 - 2 (a ∘ r^T) . e + (r^T ∘ r^T) . (e ∘ e)

— the candidate-norm term depends on the relation, so it is itself a
matmul of the squared scale against the squared candidate table (cheap:
same (B, d) x (d, N) shape as the cross term; contrast TransH, which
needs a second matmul for its hyperplane component).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from skge_tpu.models.base import INITIALIZERS, KGEModel, Params


@dataclass(frozen=True)
class PairRE(KGEModel):
    """`ncomp` is the entity dim; relation rows are [r^H | r^T] = 2*ncomp."""

    name = "pairre"
    post_constraints = {"E": "normless1"}

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"), ("rp", "R", "p"))

    def init_params(self, key: jax.Array) -> Params:
        init = INITIALIZERS[self.init]
        ke, kr = jax.random.split(key)
        return {
            "E": init(ke, (self.n_entities, self.ncomp), self.jdtype),
            "R": init(kr, (self.n_relations, 2 * self.ncomp), self.jdtype),
        }

    @staticmethod
    def _split(r):
        d = r.shape[-1] // 2
        return r[..., :d], r[..., d:]

    def score_from_rows(self, rows, dense):
        rh, rt = self._split(rows["rp"])
        d = rows["es"] * rh - rows["eo"] * rt
        return -jnp.sum(d * d, axis=-1)

    def _sweep(self, q, scale, cand):
        """-||q - e ∘ scale||^2 for every candidate row e."""
        qn = jnp.sum(q * q, axis=-1, keepdims=True)          # (B, 1)
        cross = self.mxu(q * scale, cand.T)                  # (B, N)
        en = self.mxu(scale * scale, (cand * cand).T)        # (B, N)
        return -(qn - 2.0 * cross + en)

    def _query(self, rows, mode):
        rh, rt = self._split(rows["rp"])
        if mode == 1:
            return rows["es"] * rh, rt
        return rows["eo"] * rt, rh

    def score_pool(self, rows, pool_rows, dense, mode):
        q, scale = self._query(rows, mode)
        return self._sweep(q, scale, pool_rows)

    def score_all_o(self, params: Params, s, p):
        rows = {"es": params["E"][s], "rp": params["R"][p]}
        q, scale = self._query(rows, 1)
        return self._sweep(q, scale, params["E"])

    def score_all_s(self, params: Params, o, p):
        rows = {"eo": params["E"][o], "rp": params["R"][p]}
        q, scale = self._query(rows, 0)
        return self._sweep(q, scale, params["E"])
