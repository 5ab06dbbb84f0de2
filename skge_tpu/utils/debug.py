"""Runtime sanitizers — SURVEY.md §5 'race detection / sanitizers' mapping.

The reference is single-threaded NumPy and has nothing here; this build's
equivalents are jittable runtime checks, off by default (they cost a few
percent and block donation), enabled per call site:

- `checked_step(step_fn)` wraps any (state, batch, mask) train step with
  `jax.experimental.checkify` NaN/Inf + division checks. The wrapped step
  returns (error, (state, metrics)); call `error.throw()` (or `.get()`) on
  host to surface the first failure with its source location. NOTE:
  `checkify.index_checks` is deliberately NOT in the default set — the
  aggregation layer's padding convention intentionally indexes with
  id == num_rows (dropped by `mode='drop'` scatters, clamped by gathers
  whose rows are masked out; see ops/aggregate.py), which index_checks
  would flag on every clean step. Pass `checks=` explicitly to add them
  when auditing code without that convention.
- `validate_triples(triples, n_entities, n_relations)` — host-side hard
  bounds check for ingested data (the native loader already interns ids
  densely; this guards hand-built arrays).
- `assert_finite_state(state)` — host-side post-epoch audit of every
  parameter / accumulator table (use in a `post_epoch` callback).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import checkify

from skge_tpu.training import TrainState

_CHECKS = checkify.float_checks | checkify.div_checks


def checked_step(step_fn: Callable, checks=_CHECKS) -> Callable:
    """Wrap a train step with checkify sanitizers.

    Returns a jitted callable (state, batch, mask) -> (error, (state,
    metrics)). Keep the unchecked step for production — checks disable
    buffer donation and add guard code.
    """
    return jax.jit(checkify.checkify(step_fn, errors=checks))


def validate_triples(triples, n_entities: int, n_relations: int) -> None:
    """Raise ValueError on any out-of-range id in an (N, 3) (s, o, p) array."""
    t = np.asarray(triples)
    if t.ndim != 2 or t.shape[1] != 3:
        raise ValueError(f"triples must be (N, 3), got {t.shape}")
    bad_e = (t[:, :2] < 0) | (t[:, :2] >= n_entities)
    bad_r = (t[:, 2] < 0) | (t[:, 2] >= n_relations)
    if bad_e.any() or bad_r.any():
        i = int(np.argmax(bad_e.any(axis=1) | bad_r))
        raise ValueError(
            f"triple {i} = {tuple(t[i])} out of range for "
            f"n_entities={n_entities}, n_relations={n_relations}"
        )


def assert_finite_state(state: TrainState) -> None:
    """Raise FloatingPointError naming the first non-finite table."""
    for name, v in state.params.items():
        if not bool(jnp.all(jnp.isfinite(v))):
            raise FloatingPointError(f"param {name!r} contains NaN/Inf")
    for name, slots in state.opt_state.items():
        for sn, v in slots.items():
            if not bool(jnp.all(jnp.isfinite(v))):
                raise FloatingPointError(
                    f"optimizer slot {name!r}/{sn!r} contains NaN/Inf"
                )
