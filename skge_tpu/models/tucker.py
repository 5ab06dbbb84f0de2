"""TuckER — Tucker-decomposition bilinear model (Balazevic et al., EMNLP
2019).

Beyond the reference's roster (SURVEY.md §2.1). A shared core tensor W
(rcomp, ncomp, ncomp) mixes every relation's embedding into a full
bilinear form:

    score = e_s^T ( W x_1 r_p ) e_o      with  M_p = sum_k r_pk W[k]

RESCAL with its per-relation (d, d) matrices factorized through a shared
core: n_r * rcomp parameters per relation instead of d^2, which is what
makes the bilinear family tractable at large n_r. The core is a DENSE
parameter (dense_param_names — same machinery as ER-MLP's W/C: masked
mean batch gradient); entity/relation rows support `rparam` L2 like
RESCAL. The original trains with batch-norm + dropout + Adam; those are
training-scheme choices, not part of the scoring function — here it rides
the same AdaGrad/pairwise/pointwise harness as every other model.

Design: the mixed bilinear form contracts core-first — one (B, rcomp)
x (rcomp, ncomp^2) matmul builds all per-triple M_p, then two batched
matmuls score. Pool and all-entity sweeps contract the query side first
(q = e^T M_p, a batched matvec), so the sweep is ONE (B, d) x (d, N)
matmul — same shape as RESCAL's eval path. The (B, d, d) M transient is
the dominant memory term: ~B * ncomp^2 * 4 bytes (368 MB at B=4096,
d=150).

Init: rows use the model's `init` (nunif default); the core uses nunif
over its (rcomp, ncomp^2) flattening (the paper's U(-1, 1) core assumes
batch-norm; unnormalized AdaGrad training wants the small fan-scaled
init).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from skge_tpu.models.base import INITIALIZERS, KGEModel, Params, acc_dtype


@dataclass(frozen=True)
class TuckER(KGEModel):
    rcomp: int = 0  # relation dim; 0 = same as ncomp
    rparam: float = 0.0
    n3: float = 0.0

    name = "tucker"
    dense_param_names = ("W",)
    reg_row_params = ("E", "R")

    @property
    def rdim(self) -> int:
        return self.rcomp or self.ncomp

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"), ("rp", "R", "p"))

    def init_params(self, key: jax.Array) -> Params:
        init = INITIALIZERS[self.init]
        ke, kr, kw = jax.random.split(key, 3)
        d = self.ncomp
        core = INITIALIZERS["nunif"](kw, (self.rdim, d * d), self.jdtype)
        return {
            "E": init(ke, (self.n_entities, d), self.jdtype),
            "R": init(kr, (self.n_relations, self.rdim), self.jdtype),
            "W": core.reshape(self.rdim, d, d),
        }

    def _mix(self, rp, core):
        """(B, d, d) per-triple bilinear forms M_p = sum_k r_pk W[k]."""
        d = self.ncomp
        m = self.mxu(rp, core.reshape(self.rdim, d * d))
        return m.reshape(rp.shape[0], d, d)

    def score_from_rows(self, rows, dense):
        m = self._mix(rows["rp"], dense["W"])
        return jnp.einsum(
            "bi,bij,bj->b", rows["es"], m, rows["eo"],
            preferred_element_type=acc_dtype(rows["es"]),
        ).astype(rows["es"].dtype)

    def _query(self, rows, dense, mode):
        """Contract the fixed side into a (B, d) query."""
        m = self._mix(rows["rp"], dense["W"])
        if mode == 1:
            return jnp.einsum(
                "bi,bij->bj", rows["es"], m,
                preferred_element_type=acc_dtype(m),
            ).astype(m.dtype)
        return jnp.einsum(
            "bij,bj->bi", m, rows["eo"],
            preferred_element_type=acc_dtype(m),
        ).astype(m.dtype)

    def score_pool(self, rows, pool_rows, dense, mode):
        return self.mxu(self._query(rows, dense, mode), pool_rows.T)

    def score_all_o(self, params: Params, s, p):
        rows = {"es": params["E"][s], "rp": params["R"][p]}
        q = self._query(rows, params, 1)
        return self.mxu(q, params["E"].T)

    def score_all_s(self, params: Params, o, p):
        rows = {"eo": params["E"][o], "rp": params["R"][p]}
        q = self._query(rows, params, 0)
        return self.mxu(q, params["E"].T)
