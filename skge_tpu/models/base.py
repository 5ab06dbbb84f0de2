"""Model abstraction for KGE models.

Unlike the reference's mutable `Model` class with in-place NumPy parameters
(skge/base.py ~30), models here are FROZEN hyperparameter dataclasses;
parameters live in a plain dict-of-arrays pytree that flows through jitted,
functional train steps. A model contributes:

- `init_params(key)` — parameter pytree construction.
- `slot_spec()` — which parameter table is gathered by which triple role.
  This single declaration drives generic gather -> score -> per-occurrence
  autodiff -> duplicate-index averaging in `skge_tpu.training`, replacing
  every hand-written `_gradients`/`_pairwise_gradients` in the reference with
  `jax.grad` over the gathered rows (mathematically identical, verified
  against tests/oracle/oracle_numpy.py).
- `score_from_rows(rows, dense)` — pure scoring from gathered rows; the ONLY
  model-specific compute in the training hot path.
- `score_all_o` / `score_all_s` — all-entity scoring for filtered ranking
  evaluation, written as matmuls (SURVEY.md §3.4).

Triple role convention everywhere: columns (s, o, p) — subject, object,
predicate — matching the reference's unzip_triples order (skge/util.py ~50).

Static metadata (slot spec, dense param names, post-update constraints,
regularized row params, pairwise score transform) are CLASS attributes, not
dataclass fields, so frozen-dataclass init never fights descriptors and the
model stays hashable/static under jit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Tuple

import jax
import jax.numpy as jnp

Params = Dict[str, jnp.ndarray]
Rows = Dict[str, jnp.ndarray]

# (slot_name, param_name, role) where role in {'s', 'o', 'p'}
SlotSpec = Tuple[Tuple[str, str, str], ...]


# ---------------------------------------------------------------------------
# Activations (skge/actfun.py): static f plus derivative-given-forward-value.
# Kept as a string registry so models stay hashable/static under jit.
# ---------------------------------------------------------------------------

def _sigmoid_g(fx):
    return fx * (1.0 - fx)


ACTIVATIONS: Mapping[str, Tuple[Callable, Callable]] = {
    "linear": (lambda x: x, jnp.ones_like),
    "sigmoid": (jax.nn.sigmoid, _sigmoid_g),
    "tanh": (jnp.tanh, lambda fx: 1.0 - fx * fx),
    "relu": (lambda x: jnp.maximum(x, 0.0), lambda fx: (fx > 0).astype(fx.dtype)),
}


def activation(name: str) -> Callable[[jnp.ndarray], jnp.ndarray]:
    return ACTIVATIONS[name][0]


def acc_dtype(x: jnp.ndarray):
    """Matmul accumulation dtype: at least float32, but never truncate float64
    (parity tests run in x64)."""
    return jnp.promote_types(x.dtype, jnp.float32)


def mxu_dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Matmul with explicit fp32+ accumulation."""
    return jnp.dot(a, b, preferred_element_type=acc_dtype(a))


# ---------------------------------------------------------------------------
# Initializers (skge/param.py ~95 `nunif`, `normal`; exact forms [M]).
# ---------------------------------------------------------------------------

def nunif(key: jax.Array, shape: Tuple[int, ...], dtype=jnp.float32) -> jnp.ndarray:
    """Normalized-uniform (Glorot-style) init: U(-b, b), b=sqrt(6/(d0+d1))."""
    bnd = math.sqrt(6.0) / math.sqrt(shape[0] + shape[1])
    return jax.random.uniform(key, shape, dtype, minval=-bnd, maxval=bnd)


def normal(key: jax.Array, shape: Tuple[int, ...], dtype=jnp.float32) -> jnp.ndarray:
    return jax.random.normal(key, shape, dtype)


INITIALIZERS = {"nunif": nunif, "normal": normal}


@dataclass(frozen=True)
class KGEModel:
    """Base class: frozen hyperparams + pure scoring functions.

    sz convention matches the reference: (n_entities, n_entities,
    n_relations) — SURVEY.md §1.

    `compute_dtype` (default: same as `dtype`) sets the input precision of
    the batched scoring matmuls (pool/all-entity sweeps): parameters and
    the optimizer stay in `dtype`, only the dot inputs are cast, and
    accumulation is always >= fp32. 'bfloat16' trades ~3 decimal digits of
    score precision for half the operand bytes — an opt-in production
    mode. With the float32 default, the GPU may still run the dots in
    TF32 (~3 decimal digits) unless `jax.default_matmul_precision(
    'highest')` is set; parity tests and references set it.
    """

    n_entities: int
    n_relations: int
    ncomp: int
    dtype: str = "float32"
    init: str = "nunif"
    compute_dtype: str = ""

    # --- static metadata (plain class attributes — deliberately
    # un-annotated so the dataclass machinery does not treat them as
    # fields; overridden per model) ---
    name = "base"
    # dense (non-row-indexed) parameter names, e.g. ER-MLP's W/C.
    dense_param_names = ()
    # param -> post-update constraint name ('normless1').
    post_constraints = {}
    # row params receiving `rparam * row` regularization on touched rows.
    reg_row_params = ()

    @property
    def pairwise_af(self) -> str:
        """Activation applied to scores before the pairwise margin test.

        'linear' = raw scores (TransE, RESCAL); HolE overrides with its `af`
        hyperparam ('sigmoid' by default — SURVEY.md §2.1 #8).
        """
        return "linear"

    @property
    def regularization(self) -> float:
        """L2 coefficient applied per touched row (`rparam`); 0 when absent."""
        return float(getattr(self, "rparam", 0.0))

    @property
    def regularization_n3(self) -> float:
        """Nuclear-3-norm coefficient (`n3`, Lacroix et al. 2018); 0 when
        absent. Applied to the same touched rows as `rparam` (the
        reference's row-regularization convention), via `n3_grad_rows`."""
        return float(getattr(self, "n3", 0.0))

    def n3_grad_rows(self, pname: str, rows: jnp.ndarray) -> jnp.ndarray:
        """∂(Σ_j w(x)_j³)/∂x divided by 3, elementwise per row.

        Default factor weight is |x| per entry → gradient x·|x|. Models
        whose per-dimension factor is NOT a single entry override this
        (ComplEx: the complex modulus over its [real | imag] halves —
        Lacroix et al.'s canonical form; QuatE: the quaternion modulus)."""
        return rows * jnp.abs(rows)

    def reg_grad_rows(self, pname: str, rows: jnp.ndarray) -> jnp.ndarray:
        """Row-L2 (`rparam`) gradient contribution for `pname` rows —
        identity by default. Models that pack non-embedding values into a
        row param override this to exempt them (ConvE masks its output-bias
        column of E: the paper leaves output biases unregularized)."""
        return rows

    @property
    def sz(self) -> Tuple[int, int, int]:
        return (self.n_entities, self.n_entities, self.n_relations)

    @property
    def jdtype(self):
        return jnp.dtype(self.dtype)

    def mxu(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """Scoring matmul in `compute_dtype` with >= fp32 accumulation,
        cast back to the parameter dtype."""
        if not self.compute_dtype or self.compute_dtype == self.dtype:
            return mxu_dot(a, b)
        cd = jnp.dtype(self.compute_dtype)
        out = jnp.dot(
            a.astype(cd), b.astype(cd),
            preferred_element_type=acc_dtype(a),
        )
        return out.astype(a.dtype)

    # --- interface ---
    def slot_spec(self) -> SlotSpec:
        raise NotImplementedError

    def init_params(self, key: jax.Array) -> Params:
        raise NotImplementedError

    def score_from_rows(self, rows: Rows, dense: Params) -> jnp.ndarray:
        raise NotImplementedError

    def score_pool(
        self, rows: Rows, pool_rows: jnp.ndarray, dense: Params, mode: int
    ) -> jnp.ndarray:
        """Scores of every positive against every pool entity: (B, K).

        Pool row k is substituted into role `mode` (0 = subject, 1 = object)
        of each positive — the shared-negative-pool training scheme
        (PBG/DGL-KE style; no reference counterpart, build-scope per
        BASELINE.md). This generic fallback vmaps `score_from_rows` over the
        pool; TransE/HolE/RESCAL override it with an matmul against a
        (B, d) query (the same algebra as their `score_all_*` eval paths).
        """
        role = {0: "s", 1: "o"}[mode]
        slot = next(sl for sl, _, r in self.slot_spec() if r == role)

        def one(prow):
            r = dict(rows)
            r[slot] = jnp.broadcast_to(prow, rows[slot].shape)
            return self.score_from_rows(r, dense)

        return jax.vmap(one, out_axes=1)(pool_rows)

    def score_pool_modes(
        self, rows: Rows, pool_rows: jnp.ndarray, dense: Params, modes
    ) -> Tuple[jnp.ndarray, ...]:
        """`score_pool` for several corruption modes at once: tuple of (B, K).

        Default just loops — for most models the modes share no work. Models
        whose pool sweep has a mode-independent dominant term override this
        so that term (and, through autodiff cotangent accumulation, its
        backward matmuls) is computed ONCE per step instead of once per mode
        (TransR: the (B, d^2) x (d^2, K) quadratic-form matmul)."""
        return tuple(
            self.score_pool(rows, pool_rows, dense, m) for m in modes
        )

    def score_all_o(self, params: Params, s, p) -> jnp.ndarray:
        """Scores of (s, e, p) for every entity e: shape (B, n_entities)."""
        raise NotImplementedError

    def score_all_s(self, params: Params, o, p) -> jnp.ndarray:
        """Scores of (e, o, p) for every entity e: shape (B, n_entities)."""
        raise NotImplementedError

    # --- generic helpers ---
    def gather_rows(self, params: Params, s, o, p) -> Rows:
        idx = {"s": s, "o": o, "p": p}
        return {
            slot: params[pname][idx[role]]
            for slot, pname, role in self.slot_spec()
        }

    def dense_params(self, params: Params) -> Params:
        return {k: params[k] for k in self.dense_param_names}

    def num_rows(self, pname: str) -> int:
        """Table length for a row-indexed parameter (via its slot role)."""
        for _, name, role in self.slot_spec():
            if name == pname:
                return self.n_entities if role in ("s", "o") else self.n_relations
        raise KeyError(pname)

    def score(self, params: Params, s, o, p) -> jnp.ndarray:
        """Batched triple scores; (s, o, p) are (B,) int arrays."""
        return self.score_from_rows(
            self.gather_rows(params, s, o, p), self.dense_params(params)
        )

    def score_triples(self, params: Params, triples: jnp.ndarray) -> jnp.ndarray:
        """triples: (B, 3) int array in (s, o, p) column order."""
        return self.score(params, triples[:, 0], triples[:, 1], triples[:, 2])
