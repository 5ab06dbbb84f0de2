"""ComplEx — complex-valued bilinear factorization (Trouillon et al. 2016).

Beyond the reference's model roster (SURVEY.md §2.1), added alongside
DistMult: it is the asymmetric-relation completion of DistMult and the
standard strong baseline in production KGE systems (DGL-KE, PBG —
PAPERS.md). score = Re(<R[p], E[s], conj(E[o])>) over C^d.

Design: complex rows are stored as REAL (n, 2d) tables — first half
real part, second half imaginary — so gathers, the sparse optimizer, and
the gradient scatters reuse the same fp32 row machinery as every other
model (no complex dtype on the scatter/AdaGrad path). Writing
es = (a, b), rp = (c, d), eo = (e, f):

    score = sum[ (ca - db) e + (cb + da) f ]
          = q(mode=1) . eo_real,   q = (ca - db, cb + da)
          = q(mode=0) . es_real,   q = (ce + df, cf - de)

so pool scoring and the all-entity eval sweep are a (B, 2d) query times one
matmul against the real-layout table, exactly like DistMult/HolE.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from skge_tpu.models.base import INITIALIZERS, KGEModel, Params


@dataclass(frozen=True)
class ComplEx(KGEModel):
    """`ncomp` is the COMPLEX rank; real row width is 2*ncomp."""

    rparam: float = 0.0
    n3: float = 0.0

    name = "complex"
    reg_row_params = ("E", "R")

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"), ("rp", "R", "p"))

    def n3_grad_rows(self, pname, rows):
        """Canonical ComplEx N3 (Lacroix et al. 2018): the per-dimension
        factor is the complex MODULUS m_j = sqrt(a_j² + b_j²), so
        ∂(Σ m³)/∂(a, b) / 3 = m · (a, b) over the [real | imag] halves."""
        a, b = self._split(rows)
        m = jnp.sqrt(a * a + b * b)
        return jnp.concatenate([m * a, m * b], axis=-1)

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

    def _query_o(self, es, rp):
        """q with score(s, e, p) = q . e_real for every entity e."""
        a, b = self._split(es)
        c, d = self._split(rp)
        return jnp.concatenate([c * a - d * b, c * b + d * a], axis=-1)

    def _query_s(self, eo, rp):
        """q with score(e, o, p) = q . e_real for every entity e."""
        e, f = self._split(eo)
        c, d = self._split(rp)
        return jnp.concatenate([c * e + d * f, c * f - d * e], axis=-1)

    def score_from_rows(self, rows, dense):
        return jnp.sum(
            self._query_o(rows["es"], rows["rp"]) * rows["eo"], axis=-1
        )

    def score_pool(self, rows, pool_rows, dense, mode):
        q = (
            self._query_o(rows["es"], rows["rp"])
            if mode == 1
            else self._query_s(rows["eo"], rows["rp"])
        )
        return self.mxu(q, pool_rows.T)

    def score_all_o(self, params: Params, s, p):
        q = self._query_o(params["E"][s], params["R"][p])
        return self.mxu(q, params["E"].T)

    def score_all_s(self, params: Params, o, p):
        q = self._query_s(params["E"][o], params["R"][p])
        return self.mxu(q, params["E"].T)
