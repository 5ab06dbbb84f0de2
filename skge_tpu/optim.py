"""Sparse row optimizers — the skge/param.py equivalent, in JAX.

Reference semantics (skge/param.py, SURVEY.md §2.1 #2):

- AdaGrad (~75): ``p2[idx] += g*g; param[idx] -= lr * g / max(sqrt(p2[idx]),
  EPS)`` — the accumulator is updated FIRST and only at touched rows.
- SGD (~65): ``param[idx] -= lr * g``.
- Post-constraint (~110): ``normless1`` renormalizes ONLY the touched rows
  whose L2 norm exceeds 1, applied after the update.

Design: instead of in-place NumPy fancy-index mutation, updates are
functional gather -> compute -> scatter over the unique touched rows produced
by `skge_tpu.ops.aggregate`. Rows whose occurrence count is zero (padding,
or touched only by non-violating pairs) are written back unchanged and the
unique-list padding slots (id == num_rows) are dropped by the scatter, so a
batch with zero violations is a perfect no-op — matching the reference's
"return None, skip `_batch_step`" behavior (skge/base.py ~265). With
`jax.jit` donation the gather/scatter pair updates the HBM-resident table in
place.

A dense variant (full-table gradients + touched mask) serves the SPMD
multi-chip path where the table is row-sharded over the mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from skge_tpu.ops.aggregate import DenseGrads, UniqueGrads

OptState = Dict[str, Dict[str, jnp.ndarray]]

EPS = 1e-6  # skge/param.py _EPS ([M] exact value; mirrored in the oracle)


def _bcast(v: jnp.ndarray, ndim: int) -> jnp.ndarray:
    return v.reshape(v.shape + (1,) * (ndim - 1))


def normless1_rows(rows: jnp.ndarray) -> jnp.ndarray:
    """Project rows with L2 norm > 1 onto the unit ball (skge/param.py ~110).

    For 3-D parameters the norm is over all trailing axes.
    """
    axes = tuple(range(1, rows.ndim))
    sq = jnp.sum(rows * rows, axis=axes, keepdims=True)
    norm = jnp.sqrt(sq)
    return jnp.where(norm > 1.0, rows / jnp.maximum(norm, 1e-30), rows)


POST_CONSTRAINTS = {"normless1": normless1_rows}


# ---------------------------------------------------------------------------
# Learning-rate schedules (build-scope; no reference counterpart — the
# reference's optimizers are constant-lr). Step-count driven and therefore
# checkpoint-safe: the position in the schedule is exactly TrainState.step,
# which every checkpoint already saves/restores (utils/checkpoint.py), so
# resume continues the decay mid-curve with no extra state. The scale is
# computed from a TRACED step inside the jitted training step (pure jnp
# math, no Python control flow), so one compiled executable serves the
# whole schedule.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Schedule:
    """lr multiplier as a function of the global step (traced-safe)."""

    def __call__(self, step) -> jnp.ndarray:
        raise NotImplementedError


@dataclass(frozen=True)
class WarmupLinear(Schedule):
    """Linear warmup over `warmup` steps, then linear decay to
    `min_scale` * lr at `total` steps (constant afterwards)."""

    warmup: int = 0
    total: int = 10_000
    min_scale: float = 0.0

    def __call__(self, step) -> jnp.ndarray:
        # default float dtype (fp64 under x64) so fp64 parity tests see the
        # schedule as a pure lr multiplier, not an fp32 rounding source
        s = jnp.asarray(step, jnp.result_type(0.0))
        w = jnp.minimum(s / jnp.maximum(float(self.warmup), 1.0), 1.0)
        w = jnp.where(self.warmup > 0, w, 1.0)
        span = max(float(self.total - self.warmup), 1.0)
        frac = jnp.clip((s - float(self.warmup)) / span, 0.0, 1.0)
        return w * (1.0 - (1.0 - self.min_scale) * frac)


@dataclass(frozen=True)
class WarmupCosine(Schedule):
    """Linear warmup over `warmup` steps, then cosine decay to
    `min_scale` * lr at `total` steps (constant afterwards)."""

    warmup: int = 0
    total: int = 10_000
    min_scale: float = 0.0

    def __call__(self, step) -> jnp.ndarray:
        # default float dtype (fp64 under x64) so fp64 parity tests see the
        # schedule as a pure lr multiplier, not an fp32 rounding source
        s = jnp.asarray(step, jnp.result_type(0.0))
        w = jnp.minimum(s / jnp.maximum(float(self.warmup), 1.0), 1.0)
        w = jnp.where(self.warmup > 0, w, 1.0)
        span = max(float(self.total - self.warmup), 1.0)
        frac = jnp.clip((s - float(self.warmup)) / span, 0.0, 1.0)
        cos = 0.5 * (1.0 + jnp.cos(jnp.pi * frac))
        return w * (self.min_scale + (1.0 - self.min_scale) * cos)


SCHEDULES = {"linear": WarmupLinear, "cosine": WarmupCosine}


def make_schedule(name: Optional[str], warmup: int = 0, total: int = 10_000,
                  min_scale: float = 0.0) -> Optional[Schedule]:
    """CLI helper: None/'constant' -> None, else SCHEDULES[name](...)."""
    if name is None or name == "constant":
        return None
    return SCHEDULES[name](warmup=warmup, total=total, min_scale=min_scale)


@dataclass(frozen=True)
class Optimizer:
    """Base for sparse row optimizers. `lr` matches _DEF_LEARNING_RATE=0.1.

    `schedule` (optional) multiplies lr by `schedule(step)`; the apply
    methods accept the traced global step for this. When `schedule` is set
    but a caller doesn't pass `step`, the scale silently defaults to 1.0 —
    every in-tree step factory threads TrainState.step through.
    """

    lr: float = 0.1
    schedule: Optional[Schedule] = None

    def lr_at(self, step=None):
        if self.schedule is None or step is None:
            return self.lr
        return self.lr * self.schedule(step)

    def init(self, params) -> OptState:
        raise NotImplementedError

    def _step(
        self, rows: jnp.ndarray, g: jnp.ndarray,
        slots: Dict[str, jnp.ndarray], lr=None,
    ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
        """Return (new_rows, new_state_slots) for touched rows."""
        raise NotImplementedError

    # --- unique-row (batch-local) sparse update ---
    def apply_unique(
        self,
        param: jnp.ndarray,
        state: Dict[str, jnp.ndarray],
        ug: UniqueGrads,
        post: Optional[str] = None,
        step=None,
    ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
        old_rows = param[ug.uidx]
        old_state = {k: v[ug.uidx] for k, v in state.items()}
        new_rows, new_state = self._step(
            old_rows, ug.grads, old_state, self.lr_at(step)
        )
        if post is not None:
            new_rows = POST_CONSTRAINTS[post](new_rows)
        valid = ug.count > 0
        new_rows = jnp.where(_bcast(valid, new_rows.ndim), new_rows, old_rows)
        param = param.at[ug.uidx].set(new_rows, mode="drop")
        out_state = {}
        for k in state:
            ns = jnp.where(
                _bcast(valid, new_state[k].ndim), new_state[k], old_state[k]
            )
            out_state[k] = state[k].at[ug.uidx].set(ns, mode="drop")
        return param, out_state

    # --- dense (full-table) sparse update for SPMD sharded tables ---
    def apply_dense_masked(
        self,
        param: jnp.ndarray,
        state: Dict[str, jnp.ndarray],
        dg: DenseGrads,
        post: Optional[str] = None,
        step=None,
    ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
        new_rows, new_state = self._step(
            param, dg.grads, state, self.lr_at(step)
        )
        if post is not None:
            new_rows = POST_CONSTRAINTS[post](new_rows)
        valid = dg.count > 0
        param = jnp.where(_bcast(valid, param.ndim), new_rows, param)
        out_state = {
            k: jnp.where(_bcast(valid, state[k].ndim), new_state[k], state[k])
            for k in state
        }
        return param, out_state

    # --- dense unconditional update (ER-MLP W/C) ---
    def apply_full(
        self, param: jnp.ndarray, state: Dict[str, jnp.ndarray],
        g: jnp.ndarray, step=None,
    ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
        return self._step(param, g, state, self.lr_at(step))


@dataclass(frozen=True)
class AdaGrad(Optimizer):
    """Row-sparse AdaGrad (skge/param.py ~75)."""

    eps: float = EPS

    def init(self, params) -> OptState:
        return {k: {"p2": jnp.zeros_like(v)} for k, v in params.items()}

    def _step(self, rows, g, slots, lr=None):
        lr = self.lr if lr is None else lr
        p2 = slots["p2"] + g * g
        h = jnp.maximum(jnp.sqrt(p2), self.eps)
        return rows - lr * g / h, {"p2": p2}


@dataclass(frozen=True)
class SGD(Optimizer):
    """Plain SGD (skge/param.py ~65). Stateless."""

    def init(self, params) -> OptState:
        return {k: {} for k in params}

    def _step(self, rows, g, slots, lr=None):
        lr = self.lr if lr is None else lr
        return rows - lr * g, {}


@dataclass(frozen=True)
class Adam(Optimizer):
    """Row-sparse (lazy) Adam — beyond the reference's roster (build-scope;
    the optimizer the TuckER/ConvE training schemes actually use).

    Lazy semantics (TF LazyAdam / DGL-KE sparse-Adam convention): moments
    decay and update ONLY at touched rows, and bias correction uses a
    PER-ROW step count `t` (incremented on touch) — an embedding row
    touched for the 10th time gets the t=10 correction regardless of the
    global step, which is what makes sparse Adam trajectories independent
    of how many batches skipped the row. Zero-count rows are exact no-ops
    (same guarantee as AdaGrad/SGD via the masked apply paths), so the
    no-violation batch remains a perfect no-op.
    """

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params) -> OptState:
        # the step counter must never live in a low-precision param dtype:
        # bf16 saturates at t + 1 == t after 256 touches, silently freezing
        # the bias correction — keep it at >= fp32 (fp64 under x64 so the
        # correction matches the param precision in parity tests)
        return {
            k: {
                "m": jnp.zeros_like(v),
                "v": jnp.zeros_like(v),
                "t": jnp.zeros(
                    v.shape[0], jnp.promote_types(v.dtype, jnp.float32)
                ),
            }
            for k, v in params.items()
        }

    def _step(self, rows, g, slots, lr=None):
        lr = self.lr if lr is None else lr
        t = slots["t"] + 1.0
        m = self.b1 * slots["m"] + (1.0 - self.b1) * g
        v = self.b2 * slots["v"] + (1.0 - self.b2) * g * g
        tb = _bcast(t, rows.ndim)
        mhat = m / (1.0 - self.b1 ** tb)
        vhat = v / (1.0 - self.b2 ** tb)
        new = rows - lr * mhat / (jnp.sqrt(vhat) + self.eps)
        return new, {"m": m, "v": v, "t": t}


OPTIMIZERS = {"adagrad": AdaGrad, "sgd": SGD, "adam": Adam}
