"""TransE — translational embeddings (Bordes et al. 2013).

Reference: skge/transe.py (SURVEY.md §2.1 #6). score = -||E[s] + R[p] -
E[o]||, L1 by default (`l1=True`); the L2 variant is the SQUARED distance
[M]. Entity rows carry the `normless1` unit-ball constraint applied after
each update to touched rows only. Pairwise-only in the reference (no
pointwise `_gradients`); here the generic logistic path works too but the
compat layer mirrors the reference restriction.

Design: training scores are a fused gather + elementwise reduce;
all-entity eval scoring uses the |q - E| trick — for L2 it is a single
matmul via ||q-e||^2 = |q|^2 - 2 q.e + |e|^2; for L1 it is an entity-chunked
broadcast reduce to bound memory.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from skge_tpu.models.base import INITIALIZERS, KGEModel, Params, mxu_dot


@dataclass(frozen=True)
class TransE(KGEModel):
    l1: bool = True

    name = "transe"
    post_constraints = {"E": "normless1"}

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
        d = rows["es"] + rows["rp"] - rows["eo"]
        if self.l1:
            return -jnp.sum(jnp.abs(d), axis=-1)
        return -jnp.sum(d * d, axis=-1)

    # --- all-entity scoring (eval) ---
    def _score_all(self, E: jnp.ndarray, q: jnp.ndarray, sign: float) -> jnp.ndarray:
        """Scores -||q[b] + sign*E[e]|| for all e; q: (B, d)."""
        if not self.l1:
            # ||q + s*e||^2 = |q|^2 + 2 s q.e + |e|^2 -> one matmul.
            qn = jnp.sum(q * q, axis=-1, keepdims=True)
            en = jnp.sum(E * E, axis=-1)[None, :]
            cross = 2.0 * sign * self.mxu(q, E.T)
            return -(qn + cross + en)
        # L1: chunk over entities to bound the (B, chunk, d) broadcast.
        chunk = max(1, min(E.shape[0], 4096))
        n_e = E.shape[0]
        pad = (-n_e) % chunk
        Epad = jnp.pad(E, ((0, pad), (0, 0)))
        Ec = Epad.reshape(-1, chunk, E.shape[1])

        def body(Eblk):
            return -jnp.sum(
                jnp.abs(q[:, None, :] + sign * Eblk[None, :, :]), axis=-1
            )

        out = jax.lax.map(body, Ec)  # (n_chunks, B, chunk)
        out = jnp.moveaxis(out, 0, 1).reshape(q.shape[0], -1)
        return out[:, :n_e]

    def score_pool(self, rows, pool_rows, dense, mode):
        """(B, K) distances to the shared negative pool.

        mode 1: -||(es + rp) - e_k||; mode 0: -||e_k - (eo - rp)|| — both are
        distances between a (B, d) query and the pool. L2 is a matmul via
        the norm expansion; L1 chunks the pool to bound the (B, Kc, d)
        broadcast and recomputes it in the backward pass (jax.checkpoint) so
        the full (B, K, d) sign tensor is never materialized.
        """
        q = rows["es"] + rows["rp"] if mode == 1 else rows["eo"] - rows["rp"]
        if not self.l1:
            qn = jnp.sum(q * q, axis=-1, keepdims=True)
            pn = jnp.sum(pool_rows * pool_rows, axis=-1)[None, :]
            return -(qn - 2.0 * self.mxu(q, pool_rows.T) + pn)
        k = pool_rows.shape[0]
        chunk = max(1, min(k, 512))
        pad = (-k) % chunk
        pp = jnp.pad(pool_rows, ((0, pad), (0, 0)))
        pc = pp.reshape(-1, chunk, pool_rows.shape[1])

        @jax.checkpoint
        def body(pblk):
            return -jnp.sum(
                jnp.abs(q[:, None, :] - pblk[None, :, :]), axis=-1
            )

        out = jax.lax.map(body, pc)  # (n_chunks, B, chunk)
        out = jnp.moveaxis(out, 0, 1).reshape(q.shape[0], -1)
        return out[:, :k]

    def score_all_o(self, params: Params, s, p):
        q = params["E"][s] + params["R"][p]
        return self._score_all(params["E"], q, -1.0)

    def score_all_s(self, params: Params, o, p):
        q = params["R"][p] - params["E"][o]
        return self._score_all(params["E"], q, 1.0)
