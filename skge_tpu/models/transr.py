"""TransR — translation in relation-specific spaces (Lin et al., AAAI 2015).

Beyond the reference's roster (SURVEY.md §2.1). Each relation carries a
projection matrix M_p mapping entity space (ncomp) into its own relation
space (rcomp):

    score = -|| M_p e_s + r_p - M_p e_o ||^2

Parameters: E (n_e, ncomp), R (n_r, rcomp), M (n_r, rcomp, ncomp) — a 3-D
row-indexed parameter like RESCAL's W. M initializes to the identity (the
paper's choice: start as TransE), entity and relation rows keep the
`normless1` ball constraint.

Design: training scores are two batched matmuls (project s and o)
plus an elementwise reduce. Candidate sweeps (pool / all-entity) are
inherently O(B * N * rcomp * ncomp) FLOPs — every candidate must pass
through every query's per-relation projection; that FLOP count is intrinsic
to TransR's form. What is NOT intrinsic is the shape those FLOPs take, and
the default sweep (`sweep='quadratic'`) reshapes them into large matmuls
by expanding the square:

    -||q_b - M_b e_k||^2
        = -( ||q_b||^2  -  2 (M_b^T q_b) . e_k  +  vec(M_b^T M_b) . vec(e_k e_k^T) )

so the whole (B, N) sweep becomes ONE (B, d) x (d, N) matmul (cross term)
plus ONE (B, d^2) x (d^2, N) matmul (quadratic term) — large, statically
shaped, contraction dim d^2 — instead of B independent (rcomp, ncomp)
matvecs per candidate chunk. Same FLOPs, in the shape matrix units run
fastest (`sweep='direct'` preserves the definitional per-triple form for
fp64 parity pinning). What remains of the full-rank step's cost is the
per-triple (B, d, d) projection-row traffic — gather, dM transposes,
duplicate-averaged aggregation — which is intrinsic to full-rank
per-relation projections under reference gradient semantics.

`factored=True` removes that intrinsic cost by construction: M_p = I +
u_p v_p^T (rank-1 perturbation of the identity, the TransD (Ji et al.,
ACL 2015) parameterization restricted to one shared projection per
relation). Projection rows are two (d,) vectors instead of one (d, d)
matrix, every sweep term is a rank-1-corrected (B, d) x (d, N) matmul,
and the step does TransH-class work. u initializes to 0 (M = I:
exactly the paper's identity start), v to `init`.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from skge_tpu.models.base import INITIALIZERS, KGEModel, Params, acc_dtype


@dataclass(frozen=True)
class TransR(KGEModel):
    rcomp: int = 0  # relation-space dim; 0 = same as ncomp
    # candidate-sweep algorithm: 'quadratic' (default — expanded-square
    # matmuls, see module docstring) or 'direct' (per-triple batched
    # projections; the definitional form kept for fp64 parity pinning).
    sweep: str = "quadratic"
    # rank-1 projection M_p = I + u_p v_p^T (TransD-style) instead of a
    # full (rcomp, ncomp) matrix — the production-speed variant.
    factored: bool = False

    name = "transr"
    post_constraints = {"E": "normless1", "R": "normless1"}

    def __post_init__(self):
        if self.factored and self.rcomp not in (0, self.ncomp):
            raise ValueError(
                "factored TransR requires rcomp == ncomp (the rank-1 "
                "perturbation is of the identity)"
            )

    @property
    def rdim(self) -> int:
        return self.rcomp or self.ncomp

    def slot_spec(self):
        if self.factored:
            return (
                ("es", "E", "s"), ("eo", "E", "o"),
                ("rp", "R", "p"), ("up", "U", "p"), ("vp", "V", "p"),
            )
        return (
            ("es", "E", "s"), ("eo", "E", "o"),
            ("rp", "R", "p"), ("mp", "M", "p"),
        )

    def init_params(self, key: jax.Array) -> Params:
        init = INITIALIZERS[self.init]
        if self.factored:
            ke, kr, kv = jax.random.split(key, 3)
            return {
                "E": init(ke, (self.n_entities, self.ncomp), self.jdtype),
                "R": init(kr, (self.n_relations, self.ncomp), self.jdtype),
                # u = 0 => M = I exactly (the paper's identity start);
                # v random so dL/du = (v.x) * (...) is non-degenerate
                "U": jnp.zeros((self.n_relations, self.ncomp), self.jdtype),
                "V": init(kv, (self.n_relations, self.ncomp), self.jdtype),
            }
        ke, kr = jax.random.split(key)
        eye = jnp.eye(self.rdim, self.ncomp, dtype=self.jdtype)
        return {
            "E": init(ke, (self.n_entities, self.ncomp), self.jdtype),
            "R": init(kr, (self.n_relations, self.rdim), self.jdtype),
            "M": jnp.broadcast_to(
                eye, (self.n_relations, self.rdim, self.ncomp)
            ).copy(),
        }

    def _project(self, m, e):
        """(B, rcomp) = batched M_p @ e."""
        return jnp.einsum(
            "bij,bj->bi", m, e, preferred_element_type=acc_dtype(e)
        ).astype(e.dtype)

    def _project_f(self, u, v, x):
        """(I + u v^T) x = x + u (v . x) — the factored projection, O(d)."""
        return x + u * jnp.sum(v * x, axis=-1, keepdims=True)

    def _sweep_factored(self, qs, u, v, cand):
        """-||q - (I + u v^T) c||^2 for every candidate c, per query.

        Expansion (t = v . c): q2 + c2 + t^2 u2 - 2 q.c - 2 t q.u + 2 t c.u
        — three (B, d) x (d, N) matmuls (vc, uc shared across modes)
        plus rank-1 elementwise assembly. No (d, d) anything anywhere.
        """
        vc = self.mxu(v, cand.T)                     # (B, N)
        uc = self.mxu(u, cand.T)                     # (B, N)
        c2 = jnp.sum(cand * cand, axis=-1)           # (N,)
        u2 = jnp.sum(u * u, axis=-1)                 # (B,)
        outs = []
        for q in qs:
            qc = self.mxu(q, cand.T)                 # (B, N)
            q2 = jnp.sum(q * q, axis=-1)
            qu = jnp.sum(q * u, axis=-1)
            outs.append(-(
                q2[:, None] - 2.0 * qc + c2[None, :]
                + vc * (vc * u2[:, None] + 2.0 * (uc - qu[:, None]))
            ))
        return tuple(outs)

    def score_from_rows(self, rows, dense):
        if self.factored:
            d = self._project_f(
                rows["up"], rows["vp"], rows["es"] - rows["eo"]
            ) + rows["rp"]
            return -jnp.sum(d * d, axis=-1)
        # ONE projection of the difference, not two: M(e_s - e_o) + r ==
        # (M e_s + r) - M e_o exactly in real arithmetic, and the batched
        # (d, d) matvecs here are small and overhead-bound, so halving
        # their count matters more than any FLOP accounting. fp64 parity
        # tests bound the reassociation difference (~1e-13).
        d = self._project(rows["mp"], rows["es"] - rows["eo"]) + rows["rp"]
        return -jnp.sum(d * d, axis=-1)

    def _sweep(self, q, m, cand):
        """-||q - M_b e||^2 for every candidate e, chunked over candidates."""
        if self.sweep == "quadratic":
            return self._sweep_quadratic(q, m, cand)
        return self._sweep_direct(q, m, cand)

    def _sweep_direct(self, q, m, cand):
        """Definitional form: per-triple batched projections (slow — B
        independent (rcomp, ncomp) x (ncomp, chunk) matvec-ish tiles)."""
        n = cand.shape[0]
        chunk = max(1, min(n, 128))
        pad = (-n) % chunk
        cpad = jnp.pad(cand, ((0, pad), (0, 0)))
        cc = cpad.reshape(-1, chunk, cand.shape[1])

        @jax.checkpoint
        def body(cblk):
            proj = jnp.einsum(
                "bij,kj->bki", m, cblk, preferred_element_type=acc_dtype(q)
            ).astype(q.dtype)                        # (B, chunk, rcomp)
            diff = q[:, None, :] - proj
            return -jnp.sum(diff * diff, axis=-1)    # (B, chunk)

        out = jax.lax.map(body, cc)                  # (n_chunks, B, chunk)
        out = jnp.moveaxis(out, 0, 1).reshape(q.shape[0], -1)
        return out[:, :n]

    def _sweep_quadratic(self, q, m, cand):
        return self._sweep_quadratic_multi((q,), m, cand)[0]

    def _sweep_quadratic_multi(self, qs, m, cand):
        """Expanded-square form: the (B, N) sweep as two large matmuls.

        -||q - Me||^2 = 2 (M^T q).e - vec(M^T M).vec(e e^T) - ||q||^2.
        The Gram tensor G_b = M_b^T M_b (B, ncomp, ncomp) flattens to a
        (B, d^2) matrix so the quadratic term is one statically-shaped
        (B, d^2) x (d^2, chunk) matmul against candidate self-outer-products
        — contraction dim d^2, a large dense matmul. (A d(d+1)/2 symmetric
        packing was tried and was far slower: the triu gathers defeat
        fusion and tile alignment; the 2x FLOP saving never materializes.
        Keep the dense d^2 form.)

        The quadratic term is independent of the query — identical for every
        corruption mode — so this multi-query form computes it (and, via
        autodiff cotangent accumulation, its two backward matmuls) ONCE for
        all `qs`; only the cheap O(d) cross terms are per-mode.

        Large candidate sets (all-entity eval) chunk through `lax.map` with
        `jax.checkpoint` to bound the (chunk, d^2) outer transient in both
        passes; the single-chunk shared-pool training shape skips both (a
        rematerialized body would double the dominant matmul).
        """
        n, d = cand.shape
        acc = acc_dtype(qs[0])
        dt = qs[0].dtype
        # M^T q: (B, ncomp) query in entity space (cross term), per mode.
        ts = [
            jnp.einsum("bri,br->bi", m, q, preferred_element_type=acc
                       ).astype(dt)
            for q in qs
        ]
        q2s = [jnp.sum(q * q, axis=-1) for q in qs]
        # Gram: (B, ncomp, ncomp) -> (B, d^2), shared by every mode.
        g = jnp.einsum("bri,brj->bij", m, m, preferred_element_type=acc)
        gflat = g.astype(dt).reshape(qs[0].shape[0], d * d)

        chunk = max(1, min(n, 2048))
        pad = (-n) % chunk
        cpad = jnp.pad(cand, ((0, pad), (0, 0)))
        cc = cpad.reshape(-1, chunk, d)

        def body(cblk):
            outer = (cblk[:, :, None] * cblk[:, None, :]).reshape(
                cblk.shape[0], d * d
            )
            quad = self.mxu(gflat, outer.T)              # (B, chunk)
            return tuple(
                2.0 * self.mxu(t, cblk.T) - quad for t in ts
            )

        if cc.shape[0] == 1:
            outs = body(cc[0])
        else:
            outs = jax.lax.map(jax.checkpoint(body), cc)
            outs = tuple(
                jnp.moveaxis(o, 0, 1).reshape(qs[0].shape[0], -1)
                for o in outs
            )
        return tuple(
            o[:, :n] - q2[:, None] for o, q2 in zip(outs, q2s)
        )

    def _pool_query(self, rows, mode):
        if self.factored:
            u, v = rows["up"], rows["vp"]
            if mode == 1:
                return self._project_f(u, v, rows["es"]) + rows["rp"]
            return self._project_f(u, v, rows["eo"]) - rows["rp"]
        m = rows["mp"]
        if mode == 1:
            return self._project(m, rows["es"]) + rows["rp"]
        return self._project(m, rows["eo"]) - rows["rp"]

    def score_pool(self, rows, pool_rows, dense, mode):
        q = self._pool_query(rows, mode)
        if self.factored:
            return self._sweep_factored(
                (q,), rows["up"], rows["vp"], pool_rows
            )[0]
        return self._sweep(q, rows["mp"], pool_rows)

    def score_pool_modes(self, rows, pool_rows, dense, modes):
        """Both corruption modes share the dominant sweep terms (full-rank:
        the Gram/quadratic matmul; factored: the vc/uc matmuls) and their
        backward passes."""
        qs = tuple(self._pool_query(rows, mode) for mode in modes)
        if self.factored:
            return self._sweep_factored(qs, rows["up"], rows["vp"], pool_rows)
        if self.sweep != "quadratic":
            return tuple(
                self.score_pool(rows, pool_rows, dense, m) for m in modes
            )
        return self._sweep_quadratic_multi(qs, rows["mp"], pool_rows)

    def _all_query(self, params, ent_idx, p, sign):
        if self.factored:
            u, v = params["U"][p], params["V"][p]
            q = self._project_f(u, v, params["E"][ent_idx]) + sign * params["R"][p]
            return q, (u, v)
        m = params["M"][p]
        return self._project(m, params["E"][ent_idx]) + sign * params["R"][p], m

    def score_all_o(self, params: Params, s, p):
        q, proj = self._all_query(params, s, p, 1.0)
        if self.factored:
            return self._sweep_factored((q,), *proj, params["E"])[0]
        return self._sweep(q, proj, params["E"])

    def score_all_s(self, params: Params, o, p):
        q, proj = self._all_query(params, o, p, -1.0)
        if self.factored:
            return self._sweep_factored((q,), *proj, params["E"])[0]
        return self._sweep(q, proj, params["E"])
