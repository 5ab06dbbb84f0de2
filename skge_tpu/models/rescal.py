"""RESCAL — bilinear tensor factorization (Nickel et al. 2011).

Reference: skge/rescal.py (SURVEY.md §2.1 #7). score = e_s^T W_p e_o with W a
(n_r, d, d) 3-D parameter; `rparam` L2 regularization; both trainers
supported. Pairwise margin test on raw scores ([M] — documented sigmoid only
for HolE; mirrors tests/oracle/oracle_numpy.py).

Design: the batched bilinear form is one einsum -> two batched
matmuls; the reference's per-unique-relation Python loop disappears into the
duplicate-index segment averaging shared by all models. All-entity eval
scoring: q = e_s @ W_p (batched matmul), then q @ E^T (one big matmul).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from skge_tpu.models.base import INITIALIZERS, KGEModel, Params, acc_dtype, mxu_dot


@dataclass(frozen=True)
class RESCAL(KGEModel):
    rparam: float = 0.0

    name = "rescal"
    reg_row_params = ("E", "W")
    # shared-pool W cotangents are rank-1 per pair: training dispatches to
    # the hand-derived factored gradient path (training.py
    # pairwise_grads_shared_bilinear + aggregate.segment_outer_mean_dense)
    factored_pool_grads = True

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"), ("wp", "W", "p"))

    def init_params(self, key: jax.Array) -> Params:
        init = INITIALIZERS[self.init]
        ke, kw = jax.random.split(key)
        return {
            "E": init(ke, (self.n_entities, self.ncomp), self.jdtype),
            "W": init(kw, (self.n_relations, self.ncomp, self.ncomp), self.jdtype),
        }

    def score_from_rows(self, rows, dense):
        return jnp.einsum(
            "bi,bij,bj->b",
            rows["es"],
            rows["wp"],
            rows["eo"],
            preferred_element_type=acc_dtype(rows["es"]),
        )

    def score_pool(self, rows, pool_rows, dense, mode):
        """(B, K) pool scores: contract the bilinear form down to a (B, d)
        query (es^T W_p for mode 1, W_p e_o for mode 0), then one matmul
        against the pool."""
        if mode == 1:
            q = jnp.einsum(
                "bi,bij->bj", rows["es"], rows["wp"],
                preferred_element_type=acc_dtype(rows["es"]),
            )
        else:
            q = jnp.einsum(
                "bij,bj->bi", rows["wp"], rows["eo"],
                preferred_element_type=acc_dtype(rows["eo"]),
            )
        return self.mxu(q, pool_rows.T)

    def score_all_o(self, params: Params, s, p):
        q = jnp.einsum(
            "bi,bij->bj",
            params["E"][s],
            params["W"][p],
            preferred_element_type=acc_dtype(params["E"]),
        )
        return self.mxu(q, params["E"].T)

    def score_all_s(self, params: Params, o, p):
        q = jnp.einsum(
            "bij,bj->bi",
            params["W"][p],
            params["E"][o],
            preferred_element_type=acc_dtype(params["E"]),
        )
        return self.mxu(q, params["E"].T)
