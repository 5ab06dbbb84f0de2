"""Device mesh construction and parameter PartitionSpecs.

Parallelism layout (SURVEY.md §2.3 / §5 "long-context equivalent"):

- axis 'data'  — batch (edge-partitioned triples): pure data parallelism.
- axis 'model' — entity-table rows: the entity dimension is this domain's
  long axis (up to millions of rows), so `E` (and its AdaGrad accumulator)
  is row-sharded across 'model'. Gathers of remote rows and the scatter-add
  of their gradients become XLA collectives over the interconnect; relation tables are
  replicated and their gradients psum-ed implicitly by SPMD.

Everything is expressed once as NamedSharding; `jax.jit` inserts the
collectives (GSPMD). A (1, 1) mesh degenerates to the single-chip program.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from skge_tpu.models.base import KGEModel
from skge_tpu.training import TrainState

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    devices: Optional[Sequence] = None,
    shape: Optional[Tuple[int, int]] = None,
) -> Mesh:
    """2-D ('data', 'model') mesh. Default shape: model axis gets 2 when the
    device count is even, else 1."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        model = 2 if n % 2 == 0 and n >= 2 else 1
        shape = (n // model, model)
    assert shape[0] * shape[1] == n, f"mesh {shape} != {n} devices"
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def param_specs(model: KGEModel) -> Dict[str, P]:
    """Entity tables row-sharded over 'model'; everything else replicated."""
    specs: Dict[str, P] = {}
    for _, pname, role in model.slot_spec():
        if role in ("s", "o"):
            nd = 2  # entity tables are (n_e, d)
            specs[pname] = P(MODEL_AXIS, *([None] * (nd - 1)))
        else:
            specs.setdefault(pname, P())  # relation tables replicated
    for pname in model.dense_param_names:
        specs[pname] = P()
    return specs


def adapt_spec(spec: P, ndim: int) -> P:
    """Fit a parameter's row-sharding spec to a different array rank —
    optimizer slots need not match the parameter's rank (Adam's per-row
    step count `t` is 1-D while the table is 2-D): axis 0 keeps the row
    sharding, trailing axes are replicated."""
    if len(spec) == 0 or spec[0] is None:
        return P()
    return P(spec[0], *([None] * (ndim - 1)))


def opt_slot_specs(
    opt, model: KGEModel, specs: Dict[str, P]
) -> Dict[str, Dict[str, P]]:
    """Per-slot PartitionSpecs for an optimizer's state, rank-adapted per
    slot (abstractly, via eval_shape — no arrays are materialized)."""
    shapes = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    slot_shapes = jax.eval_shape(opt.init, shapes)
    return {
        k: {sn: adapt_spec(specs[k], v.ndim) for sn, v in slots.items()}
        for k, slots in slot_shapes.items()
    }


def state_shardings(model: KGEModel, mesh: Mesh, opt=None) -> TrainState:
    """NamedShardings pytree matching a TrainState for this model (and
    optimizer — defaults to AdaGrad's single like-param slot)."""
    from skge_tpu.optim import AdaGrad

    specs = param_specs(model)

    def ns(spec):
        return NamedSharding(mesh, spec)

    params_sh = {k: ns(specs[k]) for k in specs}
    slot_specs = opt_slot_specs(opt or AdaGrad(), model, specs)
    opt_sh = {
        k: {sn: ns(sp) for sn, sp in slots.items()}
        for k, slots in slot_specs.items()
    }
    return TrainState(
        params=params_sh,
        opt_state=opt_sh,
        key=ns(P()),
        step=ns(P()),
    )


def shard_state(state: TrainState, model: KGEModel, mesh: Mesh) -> TrainState:
    """Place an existing state onto the mesh with the canonical shardings.
    Optimizer slots are rank-adapted from their actual arrays."""
    specs = param_specs(model)

    def ns(spec):
        return NamedSharding(mesh, spec)

    return TrainState(
        params={
            k: jax.device_put(v, ns(specs[k])) for k, v in state.params.items()
        },
        opt_state={
            k: {
                kk: jax.device_put(vv, ns(adapt_spec(specs[k], vv.ndim)))
                for kk, vv in state.opt_state[k].items()
            }
            for k in state.opt_state
        },
        key=jax.device_put(state.key, ns(P())),
        step=jax.device_put(state.step, ns(P())),
    )


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(DATA_AXIS, None))


def mask_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(DATA_AXIS))
