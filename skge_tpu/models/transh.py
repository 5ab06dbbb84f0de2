"""TransH — translation on relation-specific hyperplanes (Wang et al.,
AAAI 2014).

Beyond the reference's roster (skge/ has TransE/RESCAL/HolE/ER-MLP —
SURVEY.md §2.1); added as the first of the classic TransE refinements:
entities are projected onto a per-relation hyperplane before translating,
so an entity can hold different representations per relation (fixes
TransE's 1-N/N-1 collapse). With w_p the relation's unit normal and
proj(e) = e - (w_p.e) w_p:

    score = -|| proj(e_s) + r_p - proj(e_o) ||^2

The normal is normalized INSIDE scoring (w / max(|w|, eps)) rather than by
a post-update projection — differentiable, and exactly unit at every use.
Entity rows keep TransE's `normless1` ball constraint.

Design: the training score is a fused elementwise reduce. Pool
and all-entity sweeps expand the square: with q the projected query and
|w| = 1,

    ||q -/+ proj(e)||^2 = |q|^2 -/+ 2 (q.e - (w.e)(q.w)) + |e|^2 - (w.e)^2

so a sweep is exactly TWO matmuls against the candidate table (q.E^T
and w.E^T) plus rank-1 broadcasts — same structure as TransE-L2's single
matmul, one extra for the hyperplane component.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from skge_tpu.models.base import INITIALIZERS, KGEModel, Params

_EPS = 1e-12


def _unit(w: jnp.ndarray) -> jnp.ndarray:
    n = jnp.sqrt(jnp.sum(w * w, axis=-1, keepdims=True))
    return w / jnp.maximum(n, _EPS)


@dataclass(frozen=True)
class TransH(KGEModel):
    name = "transh"
    post_constraints = {"E": "normless1"}

    def slot_spec(self):
        return (
            ("es", "E", "s"), ("eo", "E", "o"),
            ("rp", "R", "p"), ("wp", "W", "p"),
        )

    def init_params(self, key: jax.Array) -> Params:
        init = INITIALIZERS[self.init]
        ke, kr, kw = jax.random.split(key, 3)
        return {
            "E": init(ke, (self.n_entities, self.ncomp), self.jdtype),
            "R": init(kr, (self.n_relations, self.ncomp), self.jdtype),
            "W": init(kw, (self.n_relations, self.ncomp), self.jdtype),
        }

    def score_from_rows(self, rows, dense):
        w = _unit(rows["wp"])

        def proj(e):
            return e - jnp.sum(e * w, axis=-1, keepdims=True) * w

        d = proj(rows["es"]) + rows["rp"] - proj(rows["eo"])
        return -jnp.sum(d * d, axis=-1)

    def _sweep(self, q, w, cand):
        """-||q - proj(e)||^2 for every candidate row e (the mode-1 form;
        mode 0 negates q before the call, since ||proj(e) + v||^2 =
        ||(-v) - proj(e)||^2)."""
        qe = self.mxu(q, cand.T)                       # (B, N)
        we = self.mxu(w, cand.T)                       # (B, N)
        qw = jnp.sum(q * w, axis=-1, keepdims=True)    # (B, 1)
        qn = jnp.sum(q * q, axis=-1, keepdims=True)
        en = jnp.sum(cand * cand, axis=-1)[None, :]
        return -(qn - 2.0 * (qe - we * qw) + en - we * we)

    def score_pool(self, rows, pool_rows, dense, mode):
        w = _unit(rows["wp"])

        def proj(e):
            return e - jnp.sum(e * w, axis=-1, keepdims=True) * w

        if mode == 1:
            q = proj(rows["es"]) + rows["rp"]
        else:
            q = proj(rows["eo"]) - rows["rp"]
        return self._sweep(q, w, pool_rows)

    def score_all_o(self, params: Params, s, p):
        w = _unit(params["W"][p])
        es = params["E"][s]
        q = es - jnp.sum(es * w, axis=-1, keepdims=True) * w + params["R"][p]
        return self._sweep(q, w, params["E"])

    def score_all_s(self, params: Params, o, p):
        w = _unit(params["W"][p])
        eo = params["E"][o]
        q = eo - jnp.sum(eo * w, axis=-1, keepdims=True) * w - params["R"][p]
        return self._sweep(q, w, params["E"])
