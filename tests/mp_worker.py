"""Standalone worker for tests/test_multiprocess.py (NOT a pytest module).

Runs a small PartitionedTrainer fit — optionally as one rank of a
multi-process gang wired by `skge_tpu.parallel.distributed.initialize`
(Gloo collectives on CPU) — and has rank 0 dump the fp64 metrics +
final parameters to an npz. The test compares the 2-process x 2-device
output against the 1-process x 4-device output bit-exactly: the
trajectory depends only on the GLOBAL shard count, never on how shards
map to processes (SURVEY.md §4 item 5).

Env/platform setup must happen before jax's backend initializes, hence
a script rather than a fixture.
"""

import argparse
import os
import sys

# self-sufficient import path: the repo is not necessarily pip-installed in
# the interpreter this subprocess runs under (pytest's rootdir trick does not
# propagate through subprocess.run)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--devices", type=int, required=True,
                    help="virtual CPU devices in THIS process")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--nproc", type=int, default=1)
    ap.add_argument("--pid", type=int, default=0)
    args = ap.parse_args()

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={args.devices}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from skge_tpu.parallel import distributed as dist

    if args.nproc > 1:
        on = dist.initialize(args.coordinator, args.nproc, args.pid)
        assert on and jax.process_count() == args.nproc
    else:
        # env-driven path (scripts/launch_distributed.py sets SKGE_*)
        dist.initialize()

    import numpy as np

    from skge_tpu import AdaGrad, TransE
    from skge_tpu.data import synthetic_kg
    from skge_tpu.parallel.partitioned import (
        PartitionedTrainer,
        make_shard_mesh,
    )

    ds = synthetic_kg(60, 4, n_train=400, n_test=50, seed=7, clustered=True)
    model = TransE(
        n_entities=ds.n_entities, n_relations=ds.n_relations,
        ncomp=16, dtype="float64",
    )
    mesh = make_shard_mesh()  # global device list: P = nproc * devices
    tr = PartitionedTrainer(
        model, AdaGrad(lr=0.1), ds.train, mesh,
        margin=1.0, k=32, nbatches=5, seed=3,
    )
    tr.fit(epochs=3)
    # sharded checkpoint: every process writes ONLY the shards its devices
    # own; the test loads both the 1-process- and 2-process-written
    # directories and pins them equal
    tr.save(args.out + ".ckpt")
    # multi-process RESTORE + resume: load_sharded_checkpoint's collective
    # array construction must issue leaves in the same order on every
    # process; a fresh trainer resumes one epoch from the checkpoint
    tr2 = PartitionedTrainer(
        model, AdaGrad(lr=0.1), ds.train, mesh,
        margin=1.0, k=32, nbatches=5, seed=3,
    ).restore(args.out + ".ckpt")
    assert [m["loss"] for m in tr2.metrics] == [
        m["loss"] for m in tr.metrics
    ], "metric history must survive restore"
    tr2.fit(epochs=1)
    # sharded evaluation under the gang: each score element is computed
    # entirely on one device (columns sharded, contraction local), so
    # ranks must be identical across process topologies
    ev = tr2.evaluate(ds.test, ds.all_triples(), batch_size=16)
    params = tr.params()  # allgathers across processes
    resumed = tr2.params()
    if jax.process_index() == 0:
        np.savez(
            args.out,
            loss=np.asarray([m["loss"] for m in tr.metrics]),
            nviolations=np.asarray([m["nviolations"] for m in tr.metrics]),
            resumed_E=resumed["E"],
            resumed_R=resumed["R"],
            eval_ranks=ev.ranks,
            eval_ranks_raw=ev.ranks_raw,
            **params,
        )
    dist.sync_global_devices("mp_worker_done")
    sys.exit(0)


if __name__ == "__main__":
    main()
