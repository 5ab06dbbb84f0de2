"""Multi-host / multi-process execution (SURVEY.md §2.3 "Communication
backend", §5 "Distributed communication backend" — reference: none;
build-scope from BASELINE's north star).

The single-process SPMD paths (parallel/{sharded,shardmap_step,
partitioned}.py) already express all math over a `Mesh` + collectives;
JAX's runtime makes the SAME compiled program span processes once
`jax.distributed.initialize` has run and the mesh is built over the
GLOBAL device list. What multi-host adds is purely host-side plumbing,
and that is what this module provides:

- `initialize()` — idempotent bootstrap around
  `jax.distributed.initialize`, driven by explicit arguments or the
  `SKGE_COORDINATOR` / `SKGE_NUM_PROCESSES` / `SKGE_PROCESS_ID` env vars.
  On CPU it rides JAX's Gloo cross-process collectives; on GPUs the same
  call wires NCCL.
- `local_shard_ids(mesh)` — which rows of a ('shard',)-sharded leading
  axis this process's devices own (mesh order == global device order,
  processes contiguous).
- `make_global_batches(batches, mask, mesh)` — assemble the (P, L, 3) /
  (P, L) global arrays for the partitioned epoch from PER-PROCESS data:
  each host feeds only its own shards' triples
  (`jax.make_array_from_process_local_data`); no host ever holds every
  shard's batch. Single-process it degrades to a plain device_put.
- `host_replicate(x)` / `fetch(x)` — bring (possibly non-addressable)
  global arrays back to every host (`multihost_utils.process_allgather`)
  or no-op locally.

Per-process feeding contract for the partitioned trainer: every process
computes the SAME deterministic partition (greedy_entity_partition +
relabel_entities are pure NumPy with a fixed seed), then keeps only
`batches[local_shard_ids(mesh)]`. Model/optimizer state is initialized
directly into its sharded placement with `init_state_partitioned`
(jit + out_shardings) — `jax.device_put` cannot place onto
non-addressable devices, and a full-table host init would defeat the
partitioned path's memory bound anyway.

Tested without a cluster in tests/test_multiprocess.py: two OS processes
x two virtual CPU devices each (Gloo collectives) reproduce the
single-process four-device fp64 trajectory bit-exactly.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from skge_tpu.parallel.partitioned import SHARD_AXIS

_ENV_COORD = "SKGE_COORDINATOR"
_ENV_NPROC = "SKGE_NUM_PROCESSES"
_ENV_PID = "SKGE_PROCESS_ID"

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> bool:
    """Bootstrap multi-process JAX. Returns True if distributed mode is on.

    Priority: explicit args > SKGE_* env vars. With no configuration at
    all this is a no-op and the process stays single-host — every code
    path still works on the local mesh. Idempotent: a second call returns
    the current mode.
    """
    global _initialized
    if _initialized:
        return jax.process_count() > 1
    # NB: must not touch the backend (jax.devices/process_count) before
    # jax.distributed.initialize — that would pin single-process mode.

    coord = coordinator_address or os.environ.get(_ENV_COORD)
    nproc = num_processes if num_processes is not None else (
        int(os.environ[_ENV_NPROC]) if _ENV_NPROC in os.environ else None
    )
    pid = process_id if process_id is not None else (
        int(os.environ[_ENV_PID]) if _ENV_PID in os.environ else None
    )
    if coord is None and nproc is None and pid is None:
        return False  # single-host; nothing to wire
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=nproc,
        process_id=pid,
        local_device_ids=local_device_ids,
    )
    _initialized = True
    return jax.process_count() > 1


def is_distributed() -> bool:
    return jax.process_count() > 1


def local_shard_ids(mesh: Mesh) -> list:
    """Global shard indices owned by this process, in mesh order.

    The partitioned mesh is 1-D over the GLOBAL device list; JAX orders
    `jax.devices()` with each process's devices contiguous, so a
    process's shards are a contiguous run — the layout
    `make_array_from_process_local_data` requires.
    """
    me = jax.process_index()
    return [
        i for i, d in enumerate(mesh.devices.flat) if d.process_index == me
    ]


def make_global_batches(
    local_batches: np.ndarray,
    local_mask: np.ndarray,
    mesh: Mesh,
) -> Tuple[jax.Array, jax.Array]:
    """Build the global (P, L, 3) batches + (P, L) mask from THIS process's
    shards only (rows in `local_shard_ids(mesh)` order).

    Single-process, this is a plain sharded device_put of the full arrays.
    """
    n_shards = mesh.devices.size
    bsh = NamedSharding(mesh, P(SHARD_AXIS, None, None))
    msh = NamedSharding(mesh, P(SHARD_AXIS, None))
    if jax.process_count() == 1:
        return (
            jax.device_put(local_batches, bsh),
            jax.device_put(local_mask, msh),
        )
    gb = (n_shards,) + tuple(local_batches.shape[1:])
    gm = (n_shards,) + tuple(local_mask.shape[1:])
    return (
        jax.make_array_from_process_local_data(bsh, local_batches, gb),
        jax.make_array_from_process_local_data(msh, local_mask, gm),
    )


def host_replicate(x) -> np.ndarray:
    """Full host copy of a (possibly cross-process-sharded) array."""
    if jax.process_count() == 1:
        return np.asarray(jax.device_get(x))
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def sync_global_devices(tag: str = "skge") -> None:
    """Barrier across processes (no-op single-process)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(tag)
