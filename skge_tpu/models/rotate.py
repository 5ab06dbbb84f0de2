"""RotatE — relations as rotations in the complex plane (Sun et al.,
ICLR 2019, arXiv:1902.10197).

Beyond the reference's model roster (SURVEY.md §2.1), added alongside
DistMult/ComplEx: the standard strong baseline for ANTI-symmetric,
inverse, and compositional relation patterns that translations (TransE)
and bilinear forms (DistMult) cannot all express at once.

    score(s, o, p) = -|| E[s] ∘ r_p - E[o] ||^2,   r_p = exp(i * theta_p)

Design: entity rows are REAL (n_e, 2d) complex-layout tables (first
half real, second half imaginary — same fp32 row machinery as ComplEx
for gathers/scatters/AdaGrad); relations store the (n_r, d) PHASES
theta, so |r_p| = 1 holds by construction (no post-constraint needed)
and the phase gradient flows through cos/sin under the same generic
`jax.grad` pipeline as every other model. Because rotation is an
isometry, both corruption directions reduce to a squared distance
between a rotated (B, 2d) query and the candidate table:

    mode 1 (corrupt o):  -|| rot(e_s, +theta) - cand ||^2
    mode 0 (corrupt s):  -|| rot(e_o, -theta) - cand ||^2

and the norm expansion ||q - e||^2 = |q|^2 - 2 q.e + |e|^2 turns pool
scoring and the all-entity eval sweep into ONE matmul (identical
algebra to TransE-L2's eval trick). The squared-L2 form is chosen for
that (the paper's modulus-L1 variant would broadcast a (B, K, d)
complex-modulus tensor like TransE-L1).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from skge_tpu.models.base import INITIALIZERS, KGEModel, Params


@dataclass(frozen=True)
class RotatE(KGEModel):
    """`ncomp` is the COMPLEX rank: entity rows are 2*ncomp wide,
    relation rows hold ncomp phases.

    `gamma_init` > 0 selects the PAPER's coupled initialization (Sun et
    al. 2019, official code `model.py`): entity components U(-b, b) with
    b = (gamma_init + 2) / ncomp so initial pair distances land on the
    margin scale, and phases U(-pi, pi) so the 18 relations start as
    DISTINCT rotations. The default nunif init draws phases in
    (-0.42, 0.42) — every relation a near-identity rotation — and
    entities at b ~ sqrt(6/n_e) ~ 0.012, putting initial squared
    distances ~1e-4 under selfadv gammas of 1.5-6; the round-4 probe on
    the exactly-RotatE-realizable rotational latent KG measures what
    that mismatch costs (RESULTS.md)."""

    rparam: float = 0.0
    gamma_init: float = 0.0
    # Phase distribution at init. "uniform" (DEFAULT) draws phases from
    # U(-pi, pi) — the paper's distribution — while entities keep the
    # standard `init`. The round-4 mechanism probe measured why this
    # matters: nunif phases start in (-0.42, 0.42) (every relation a
    # near-identity rotation) and AdaGrad's accumulator freezes them
    # before they spread (final sd 1.2-1.4 vs the 1.81 a uniform
    # distribution has), costing 4.2x MRR on the exactly-realizable
    # rotational latent KG (0.0106 -> 0.0446, RESULTS.md round 4).
    # "nunif" restores the old behavior. The FULL paper init
    # (gamma-coupled entity range, `gamma_init`) measured WORSE than
    # nunif entities here — only the phase half of it is right for
    # AdaGrad.
    phase_init: str = "uniform"

    name = "rotate"
    reg_row_params = ("E",)  # phases are scale-free; regularizing them
    #                          would bias rotations toward identity

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"), ("rp", "R", "p"))

    def init_params(self, key: jax.Array) -> Params:
        ke, kr = jax.random.split(key)
        if self.gamma_init > 0.0:
            b = (self.gamma_init + 2.0) / self.ncomp
            return {
                "E": jax.random.uniform(
                    ke, (self.n_entities, 2 * self.ncomp), self.jdtype,
                    minval=-b, maxval=b,
                ),
                "R": jax.random.uniform(
                    kr, (self.n_relations, self.ncomp), self.jdtype,
                    minval=-math.pi, maxval=math.pi,
                ),
            }
        init = INITIALIZERS[self.init]
        if self.phase_init == "uniform":
            phases = jax.random.uniform(
                kr, (self.n_relations, self.ncomp), self.jdtype,
                minval=-math.pi, maxval=math.pi,
            )
        elif self.phase_init == "nunif":
            # legacy: phases start near identity rotations; AdaGrad tends
            # to freeze them under-spread (see class docstring)
            phases = init(kr, (self.n_relations, self.ncomp), self.jdtype)
        else:
            raise ValueError(f"unknown phase_init {self.phase_init!r}")
        return {
            "E": init(ke, (self.n_entities, 2 * self.ncomp), self.jdtype),
            "R": phases,
        }

    @staticmethod
    def _split(x):
        d = x.shape[-1] // 2
        return x[..., :d], x[..., d:]

    @staticmethod
    def _rotate(x, theta, sign=1.0):
        """Complex-layout rows rotated by `sign * theta` per dimension."""
        a, b = RotatE._split(x)
        c, s = jnp.cos(theta), sign * jnp.sin(theta)
        return jnp.concatenate([a * c - b * s, a * s + b * c], axis=-1)

    def score_from_rows(self, rows, dense):
        d = self._rotate(rows["es"], rows["rp"]) - rows["eo"]
        return -jnp.sum(d * d, axis=-1)

    def _query(self, rows, mode):
        if mode == 1:
            return self._rotate(rows["es"], rows["rp"])
        return self._rotate(rows["eo"], rows["rp"], sign=-1.0)

    @staticmethod
    def _dist_matmul(mxu, q, cand):
        qn = jnp.sum(q * q, axis=-1, keepdims=True)
        cn = jnp.sum(cand * cand, axis=-1)[None, :]
        return -(qn - 2.0 * mxu(q, cand.T) + cn)

    def score_pool(self, rows, pool_rows, dense, mode):
        return self._dist_matmul(self.mxu, self._query(rows, mode), pool_rows)

    def score_all_o(self, params: Params, s, p):
        q = self._rotate(params["E"][s], params["R"][p])
        return self._dist_matmul(self.mxu, q, params["E"])

    def score_all_s(self, params: Params, o, p):
        q = self._rotate(params["E"][o], params["R"][p], sign=-1.0)
        return self._dist_matmul(self.mxu, q, params["E"])
