"""ER-MLP — neural triple scoring (Dong et al. 2014, Knowledge Vault).

Reference: skge/ermlp.py (SURVEY.md §2.1 #9, param names/concat order [M]):
score = C . af(W^T [e_s; e_o; r_p]) with W (3d, nhidden), C (nhidden,),
af=sigmoid by default. Dense params W/C take the masked mean batch gradient
(choice documented in tests/oracle/oracle_numpy.py).

Design: the hidden layer is one (B, 3d) x (3d, nh) matmul. For
all-entity eval the concat structure is exploited: W splits into row blocks
(W_s, W_o, W_r), the (n_e, nh) product E @ W_o is computed ONCE per call, and
per-query pre-activations are a rank-1 broadcast add, chunked over entities.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from skge_tpu.models.base import INITIALIZERS, ACTIVATIONS, KGEModel, Params, mxu_dot


@dataclass(frozen=True)
class ERMLP(KGEModel):
    nhidden: int = 10
    af: str = "sigmoid"

    name = "ermlp"
    dense_param_names = ("W", "C")

    def slot_spec(self):
        return (("es", "E", "s"), ("eo", "E", "o"), ("rp", "R", "p"))

    def init_params(self, key: jax.Array) -> Params:
        init = INITIALIZERS[self.init]
        ke, kr, kw, kc = jax.random.split(key, 4)
        return {
            "E": init(ke, (self.n_entities, self.ncomp), self.jdtype),
            "R": init(kr, (self.n_relations, self.ncomp), self.jdtype),
            "W": init(kw, (3 * self.ncomp, self.nhidden), self.jdtype),
            "C": init(kc, (self.nhidden, 1), self.jdtype)[:, 0],
        }

    def score_from_rows(self, rows, dense):
        f = ACTIVATIONS[self.af][0]
        x = jnp.concatenate([rows["es"], rows["eo"], rows["rp"]], axis=-1)
        h = f(mxu_dot(x, dense["W"]))
        return mxu_dot(h, dense["C"])

    def score_pool(self, rows, pool_rows, dense, mode):
        """(B, K) pool scores via the concat split: x@W = es@W_s + eo@W_o +
        rp@W_r, so only the substituted role varies with k — the fixed-role
        pre-activation is computed once per positive, the pool's once per
        pool row, and the cross term is a (B, K, nh) broadcast (nh is small)
        instead of the generic fallback's (K, B, 3d) concat."""
        f = ACTIVATIONS[self.af][0]
        d = self.ncomp
        Ws, Wo, Wr = dense["W"][:d], dense["W"][d:2 * d], dense["W"][2 * d:]
        if mode == 1:
            fixed = mxu_dot(rows["es"], Ws) + mxu_dot(rows["rp"], Wr)
            ppre = mxu_dot(pool_rows, Wo)
        else:
            fixed = mxu_dot(rows["eo"], Wo) + mxu_dot(rows["rp"], Wr)
            ppre = mxu_dot(pool_rows, Ws)
        h = f(fixed[:, None, :] + ppre[None, :, :])  # (B, K, nh)
        return mxu_dot(h, dense["C"])

    # --- all-entity scoring ---
    def _score_all(self, params: Params, fixed_pre: jnp.ndarray, ent_block: str):
        """fixed_pre: (B, nh) pre-activation from the fixed roles."""
        f = ACTIVATIONS[self.af][0]
        d = self.ncomp
        blocks = {"s": (0, d), "o": (d, 2 * d)}
        lo, hi = blocks[ent_block]
        Went = params["W"][lo:hi]                       # (d, nh)
        epre = mxu_dot(params["E"], Went)                                               # (n_e, nh) once
        n_e = epre.shape[0]
        chunk = max(1, min(n_e, 8192))
        pad = (-n_e) % chunk
        epad = jnp.pad(epre, ((0, pad), (0, 0))).reshape(-1, chunk, self.nhidden)

        def body(eblk):
            h = f(fixed_pre[:, None, :] + eblk[None, :, :])  # (B, chunk, nh)
            return mxu_dot(h, params["C"])

        out = jax.lax.map(body, epad)                   # (n_chunks, B, chunk)
        out = jnp.moveaxis(out, 0, 1).reshape(fixed_pre.shape[0], -1)
        return out[:, :n_e]

    def score_all_o(self, params: Params, s, p):
        d = self.ncomp
        Ws, Wr = params["W"][:d], params["W"][2 * d:]
        fixed = (
            mxu_dot(params["E"][s], Ws)
            + mxu_dot(params["R"][p], Wr)
        )
        return self._score_all(params, fixed, "o")

    def score_all_s(self, params: Params, o, p):
        d = self.ncomp
        Wo, Wr = params["W"][d:2 * d], params["W"][2 * d:]
        fixed = (
            mxu_dot(params["E"][o], Wo)
            + mxu_dot(params["R"][p], Wr)
        )
        return self._score_all(params, fixed, "s")
