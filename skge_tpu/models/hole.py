"""HolE — holographic embeddings (Nickel, Rosasco, Poggio, AAAI 2016).

Reference: skge/hole.py (SURVEY.md §2.1 #8). score = sum(R[p] * ccorr(E[s],
E[o])). Pairwise training applies sigmoid to scores BEFORE the margin test.
L2 regularization `rparam` added per touched unique row.

Design: ccorr via batched rfft/irfft (half-spectrum, fused elementwise
product). All-entity eval scoring uses the adjoint identities
    score(s, p, .) = E @ cconv(e_s, r_p)      (object side)
    score(., o, p) = E @ ccorr(r_p, e_o)      (subject side)
turning the n_test x n_e sweep into a single matmul (SURVEY.md §3.4).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from skge_tpu.models.base import INITIALIZERS, KGEModel, Params, mxu_dot
from skge_tpu.ops.circulant import cconv, ccorr


@dataclass(frozen=True)
class HolE(KGEModel):
    rparam: float = 0.0
    af: str = "sigmoid"  # pairwise score transform (skge/hole.py ~70)

    name = "hole"
    reg_row_params = ("E", "R")

    @property
    def pairwise_af(self) -> str:
        return self.af

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
        return jnp.sum(rows["rp"] * ccorr(rows["es"], rows["eo"]), axis=-1)

    def score_pool(self, rows, pool_rows, dense, mode):
        """(B, K) pool scores via the adjoint identities — one matmul.

        mode 1: score(s, e_k, p) = e_k . cconv(es, rp);
        mode 0: score(e_k, o, p) = e_k . ccorr(rp, eo).
        """
        q = (
            cconv(rows["es"], rows["rp"])
            if mode == 1
            else ccorr(rows["rp"], rows["eo"])
        )
        return self.mxu(q, pool_rows.T)

    def score_all_o(self, params: Params, s, p):
        q = cconv(params["E"][s], params["R"][p])  # (B, d)
        return self.mxu(q, params["E"].T)

    def score_all_s(self, params: Params, o, p):
        q = ccorr(params["R"][p], params["E"][o])  # (B, d)
        return self.mxu(q, params["E"].T)
