"""SimplE — fully-expressive CP factorization with inverse relations
(Kazemi & Poole, NeurIPS 2018).

Beyond the reference's model roster (skge/ has TransE/RESCAL/HolE/ER-MLP —
SURVEY.md §2.1). Canonical-Polyadic factorization fixes its head/tail
independence problem by giving every relation an inverse and averaging the
two directions:

    score(s, o, p) = 0.5 * ( <h_s, r_p, t_o> + <h_o, r~_p, t_s> )

where each entity has a HEAD and a TAIL embedding and each relation a
forward and an inverse vector. SimplE is fully expressive (any ±1 tensor
is representable at large enough rank) while keeping DistMult's
multiplicative cost.

Design: head/tail live in ONE (n_e, 2d) row table `E` (first half
head, second half tail) and forward/inverse in one (n_r, 2d) table `R`
— a single fp32 row per entity/relation keeps the gather/scatter/AdaGrad
machinery identical to every other model (one fused table scatter, one
accumulator). Both corruption directions reduce to ONE matmul
against the candidate table: the two trilinear terms are linear in the
candidate's (head|tail) halves, so a (B, 2d) query contracts them in a
single dot —

    mode 1 (corrupt o): q = 0.5 * [ t_s ∘ r~ | h_s ∘ r ],  score = q . [h_c | t_c]
    mode 0 (corrupt s): q = 0.5 * [ r ∘ t_o | r~ ∘ h_o ],  score = q . [h_c | t_c]

(the paper clips scores to [-20, 20] during its logistic training; that
is a training-scheme choice like TuckER's batch-norm, not part of the
scoring function, and is omitted here.)
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from skge_tpu.models.base import INITIALIZERS, KGEModel, Params


@dataclass(frozen=True)
class SimplE(KGEModel):
    """`ncomp` is the CP rank: entity rows are [head | tail] = 2*ncomp wide,
    relation rows [forward | inverse] = 2*ncomp wide."""

    rparam: float = 0.0
    n3: float = 0.0

    name = "simple"
    reg_row_params = ("E", "R")

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"), ("rp", "R", "p"))

    def init_params(self, key: jax.Array) -> Params:
        init = INITIALIZERS[self.init]
        ke, kr = jax.random.split(key)
        return {
            "E": init(ke, (self.n_entities, 2 * self.ncomp), self.jdtype),
            "R": init(kr, (self.n_relations, 2 * self.ncomp), self.jdtype),
        }

    @staticmethod
    def _split(x):
        d = x.shape[-1] // 2
        return x[..., :d], x[..., d:]

    def score_from_rows(self, rows, dense):
        hs, ts = self._split(rows["es"])
        ho, to = self._split(rows["eo"])
        r, rinv = self._split(rows["rp"])
        fwd = jnp.sum(hs * r * to, axis=-1)
        inv = jnp.sum(ho * rinv * ts, axis=-1)
        return 0.5 * (fwd + inv)

    def _query(self, rows, mode):
        """(B, 2d) query whose dot with a candidate's [head | tail] row is
        the triple score."""
        r, rinv = self._split(rows["rp"])
        if mode == 1:
            hs, ts = self._split(rows["es"])
            return 0.5 * jnp.concatenate([ts * rinv, hs * r], axis=-1)
        ho, to = self._split(rows["eo"])
        return 0.5 * jnp.concatenate([r * to, rinv * ho], axis=-1)

    def score_pool(self, rows, pool_rows, dense, mode):
        return self.mxu(self._query(rows, mode), pool_rows.T)

    def score_all_o(self, params: Params, s, p):
        rows = {"es": params["E"][s], "rp": params["R"][p]}
        return self.mxu(self._query(rows, 1), params["E"].T)

    def score_all_s(self, params: Params, o, p):
        rows = {"eo": params["E"][o], "rp": params["R"][p]}
        return self.mxu(self._query(rows, 0), params["E"].T)
