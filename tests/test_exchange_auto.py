"""Boundary-exchange selection: PartitionedTrainer(exchange=...) takes
'dense' or 'ragged'; 'ragged' runs the real ragged_all_to_all except on
the CPU, whose XLA has no lowering for it, where the bit-identical dense
emulation runs instead."""

import numpy as np
import pytest

import jax

from skge_tpu import AdaGrad, TransE
from skge_tpu.parallel import partitioned
from skge_tpu.parallel.partitioned import (
    SHARD_AXIS,
    PartitionedTrainer,
    ragged_mode,
)
from jax.sharding import Mesh


def _mesh():
    return Mesh(np.asarray(jax.devices()[:8]), (SHARD_AXIS,))


def _toy(n_e=4000, n_r=8, n=6000, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([
        rng.integers(0, n_e, n), rng.integers(0, n_e, n),
        rng.integers(0, n_r, n),
    ], axis=1).astype(np.int32)


def test_trainer_exchange_modes_agree():
    """'dense' and 'ragged' (emulated on CPU) produce identical fp64
    trajectories — the exchange implementation is a pure transport choice."""
    triples = _toy(seed=3)
    states = {}
    for mode in ("dense", "ragged"):
        model = TransE(4000, 8, 16, dtype="float64")
        tr = PartitionedTrainer(
            model, AdaGrad(lr=0.1), triples, _mesh(), k=64, nbatches=10,
            exchange=mode,
        )
        tr.fit(2)
        states[mode] = tr.params()
    for k in states["dense"]:
        np.testing.assert_array_equal(
            np.asarray(states["dense"][k]), np.asarray(states["ragged"][k]),
            err_msg=k,
        )


def test_exchange_and_legacy_ragged_are_exclusive():
    with pytest.raises(ValueError):
        PartitionedTrainer(
            TransE(4000, 8, 16), AdaGrad(lr=0.1), _toy(), _mesh(),
            k=64, nbatches=10, exchange="dense", ragged="emulate",
        )


@pytest.mark.parametrize("mode", ["auto", "emulate", "bogus"])
def test_unknown_exchange_modes_raise(mode):
    """Only 'dense' and 'ragged' remain; the cost-model 'auto' is gone."""
    with pytest.raises(ValueError, match="unknown exchange mode"):
        PartitionedTrainer(
            TransE(4000, 8, 16), AdaGrad(lr=0.1), _toy(), _mesh(),
            k=64, nbatches=10, exchange=mode,
        )


@pytest.mark.parametrize("platform,want", [
    ("cpu", "emulate"), ("gpu", True), ("cuda", True),
])
def test_ragged_mode_per_platform(platform, want):
    assert ragged_mode(platform) == want


def test_trainer_ragged_on_cpu_takes_emulation(monkeypatch):
    """exchange='ragged' asks `ragged_mode` with the mesh's platform and
    hands its answer to the epoch builder."""
    seen = {}
    build = partitioned.make_partitioned_epoch

    def spy(*args, **kw):
        seen["ragged"] = kw["ragged"]
        return build(*args, **kw)

    monkeypatch.setattr(partitioned, "make_partitioned_epoch", spy)
    PartitionedTrainer(
        TransE(4000, 8, 16), AdaGrad(lr=0.1), _toy(), _mesh(),
        k=64, nbatches=10, exchange="ragged",
    )
    assert seen["ragged"] == "emulate"
