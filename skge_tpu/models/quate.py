"""QuatE — quaternion embeddings with relational rotation (Zhang et al.,
NeurIPS 2019).

Beyond the reference's model roster (SURVEY.md §2.1). Entities and
relations are quaternion vectors; a relation acts by Hamilton product
with its unit-normalized quaternion — a 4-D rotation with two rotation
planes, strictly more expressive per dimension than ComplEx's single
plane (which it contains as the b=c=0 special case):

    score(s, o, p) = < q_s ⊗ r̂_p , q_o >        r̂ = r / |r| per component

Design: quaternion rows live in ONE real (n, 4d) table (component
blocks [a | b | c | d]) so the gather/scatter/AdaGrad row machinery is
identical to every other model; the relation is normalized INSIDE scoring
(differentiable, exactly unit at every use — same device as TransH's
hyperplane normal). The Hamilton product is 16 fused elementwise multiplies; both
corruption directions then reduce to ONE matmul against the candidate
table via the quaternion inner-product adjoint

    < p ⊗ q , s > = < p , s ⊗ q̄ >

so mode 1 uses query q_s ⊗ r̂ and mode 0 uses query q_o ⊗ conj(r̂) — the
right-rotation is an isometry, exactly like RotatE's complex rotation.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from skge_tpu.models.base import INITIALIZERS, KGEModel, Params

_EPS = 1e-12


@dataclass(frozen=True)
class QuatE(KGEModel):
    """`ncomp` is the QUATERNION rank: rows are 4*ncomp reals wide."""

    rparam: float = 0.0
    n3: float = 0.0

    name = "quate"
    reg_row_params = ("E", "R")

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"), ("rp", "R", "p"))

    def n3_grad_rows(self, pname, rows):
        """Canonical quaternion N3 (Lacroix-style, mirroring ComplEx): the
        per-dimension factor is the quaternion MODULUS
        m_j = sqrt(a_j² + b_j² + c_j² + d_j²) over the [a|b|c|d] blocks, so
        ∂(Σ m³)/∂(a,b,c,d) / 3 = m · (a, b, c, d)."""
        a, b, c, d = self._split(rows)
        m = jnp.sqrt(a * a + b * b + c * c + d * d)
        return self._join(m * a, m * b, m * c, m * d)

    def init_params(self, key: jax.Array) -> Params:
        init = INITIALIZERS[self.init]
        ke, kr = jax.random.split(key)
        return {
            "E": init(ke, (self.n_entities, 4 * self.ncomp), self.jdtype),
            "R": init(kr, (self.n_relations, 4 * self.ncomp), self.jdtype),
        }

    @staticmethod
    def _split(x):
        d = x.shape[-1] // 4
        return x[..., :d], x[..., d:2 * d], x[..., 2 * d:3 * d], x[..., 3 * d:]

    @staticmethod
    def _join(a, b, c, d):
        return jnp.concatenate([a, b, c, d], axis=-1)

    @classmethod
    def _hamilton(cls, x, y):
        """Componentwise Hamilton product of quaternion-block rows."""
        a1, b1, c1, d1 = cls._split(x)
        a2, b2, c2, d2 = cls._split(y)
        return cls._join(
            a1 * a2 - b1 * b2 - c1 * c2 - d1 * d2,
            a1 * b2 + b1 * a2 + c1 * d2 - d1 * c2,
            a1 * c2 - b1 * d2 + c1 * a2 + d1 * b2,
            a1 * d2 + b1 * c2 - c1 * b2 + d1 * a2,
        )

    @classmethod
    def _conj(cls, x):
        a, b, c, d = cls._split(x)
        return cls._join(a, -b, -c, -d)

    @classmethod
    def _unit(cls, r):
        a, b, c, d = cls._split(r)
        n = jnp.sqrt(a * a + b * b + c * c + d * d)
        n = jnp.maximum(n, _EPS)
        return cls._join(a / n, b / n, c / n, d / n)

    def score_from_rows(self, rows, dense):
        rot = self._hamilton(rows["es"], self._unit(rows["rp"]))
        return jnp.sum(rot * rows["eo"], axis=-1)

    def _query(self, rows, mode):
        rhat = self._unit(rows["rp"])
        if mode == 1:
            return self._hamilton(rows["es"], rhat)
        # <c ⊗ r̂, o> = <c, o ⊗ conj(r̂)>
        return self._hamilton(rows["eo"], self._conj(rhat))

    def score_pool(self, rows, pool_rows, dense, mode):
        return self.mxu(self._query(rows, mode), pool_rows.T)

    def score_all_o(self, params: Params, s, p):
        rows = {"es": params["E"][s], "rp": params["R"][p]}
        return self.mxu(self._query(rows, 1), params["E"].T)

    def score_all_s(self, params: Params, o, p):
        rows = {"eo": params["E"][o], "rp": params["R"][p]}
        return self.mxu(self._query(rows, 0), params["E"].T)
