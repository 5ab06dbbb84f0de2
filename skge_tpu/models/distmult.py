"""DistMult — diagonal bilinear factorization (Yang et al., ICLR 2015).

Beyond the reference's model roster (skge/ has TransE/RESCAL/HolE/ER-MLP —
SURVEY.md §2.1), added because production KGE frameworks (DGL-KE, PBG —
PAPERS.md) treat it as a baseline family. score = sum(E[s] * R[p] * E[o]):
RESCAL with W_p restricted to a diagonal, so everything stays a vector op.

Design: training scores are one fused elementwise-reduce; pool
and all-entity sweeps contract to a (B, d) query followed by one
matmul — identical structure to HolE's adjoint-identity path.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from skge_tpu.models.base import INITIALIZERS, KGEModel, Params


@dataclass(frozen=True)
class DistMult(KGEModel):
    rparam: float = 0.0
    n3: float = 0.0

    name = "distmult"
    reg_row_params = ("E", "R")

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"), ("rp", "R", "p"))

    def init_params(self, key: jax.Array) -> Params:
        init = INITIALIZERS[self.init]
        ke, kr = jax.random.split(key)
        return {
            "E": init(ke, (self.n_entities, self.ncomp), self.jdtype),
            "R": init(kr, (self.n_relations, self.ncomp), self.jdtype),
        }

    def score_from_rows(self, rows, dense):
        return jnp.sum(rows["es"] * rows["rp"] * rows["eo"], axis=-1)

    def score_pool(self, rows, pool_rows, dense, mode):
        # symmetric in (s, o): both modes contract to q = e * r
        q = (rows["es"] if mode == 1 else rows["eo"]) * rows["rp"]
        return self.mxu(q, pool_rows.T)

    def score_all_o(self, params: Params, s, p):
        q = params["E"][s] * params["R"][p]
        return self.mxu(q, params["E"].T)

    def score_all_s(self, params: Params, o, p):
        q = params["E"][o] * params["R"][p]
        return self.mxu(q, params["E"].T)
