"""Resumable 10^7 flagship driver: per-epoch sharded checkpoints +
exact resume, so a killed process costs at most one epoch of a
multi-hour run:

- build/load the lattice KG from the same /tmp npz cache as
  scripts/flagship_10m.py;
- construct OutOfCoreTrainer deterministically (seed 0 => identical
  partition; restore() verifies the partition CRC);
- if a checkpoint exists: restore, skip the epochs it already holds
  (len(metrics));
- per epoch: fit(1) -> save(ckpt) (atomic per-partition npz);
- when all epochs are in the checkpoint, run the streamed 500-query
  eval and append the final report line to --out. A kill during EVAL
  is also retryable: the restart restores the fully-trained state and
  goes straight to eval.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--entities", type=int, default=11_390_625)
    ap.add_argument("--relations", type=int, default=64)
    ap.add_argument("--ntrain", type=int, default=45_562_500)
    ap.add_argument("--nheld", type=int, default=5000)
    ap.add_argument("--latent-dim", type=int, default=6)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--cache-parts", type=int, default=3)
    ap.add_argument("--k", type=int, default=65536)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--nbatches", type=int, default=800)
    ap.add_argument("--eval-batch", type=int, default=512)
    ap.add_argument("--eval-n", type=int, default=500)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--model", default="transe-l2",
                    choices=["transe-l2", "distmult"])
    ap.add_argument("--ckpt", default="/tmp/flagship_r5_ckpt")
    ap.add_argument("--out", default=".flagship_r5.jsonl")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from skge_tpu import Adam
    from skge_tpu.data import Dataset, add_reciprocal_relations, latent_kg
    from skge_tpu.models import DistMult, TransE
    from skge_tpu.outofcore import OutOfCoreTrainer

    def log(**kw):
        print(json.dumps(kw), flush=True)

    cache = os.path.join(
        "/tmp",
        f"latent_kg_lattice-e{args.entities}-r{args.relations}"
        f"-t{args.ntrain}-h{args.nheld}-l{args.latent_dim}-s0.npz",
    )
    t0 = time.perf_counter()
    if os.path.exists(cache):
        z = np.load(cache)
        ds = Dataset(train=z["train"], valid=z["valid"], test=z["test"],
                     n_entities=args.entities, n_relations=args.relations)
    else:
        ds = latent_kg(
            n_entities=args.entities, n_relations=args.relations,
            n_train=args.ntrain, n_valid=args.nheld, n_test=args.nheld,
            latent_dim=args.latent_dim, seed=0, kind="lattice",
        )
        np.savez(cache, train=ds.train, valid=ds.valid, test=ds.test)
    build_s = round(time.perf_counter() - t0, 1)
    log(phase="build", build_s=build_s)

    t0 = time.perf_counter()
    aug = add_reciprocal_relations(ds)
    if args.model == "transe-l2":
        model = TransE(aug.n_entities, aug.n_relations, args.dim, l1=False)
    else:
        model = DistMult(aug.n_entities, aug.n_relations, args.dim)
    tr = OutOfCoreTrainer(
        model, Adam(lr=args.lr), aug.train, n_parts=args.parts, k=args.k,
        nbatches=args.nbatches, seed=0, loss="sampled_ce",
        label_smoothing=0.1, ce_directions=("o",),
        host_buckets=args.entities > 2_000_000,
        cache_parts=min(args.cache_parts, args.parts),
    )
    init_s = round(time.perf_counter() - t0, 1)

    done = 0
    if os.path.exists(os.path.join(args.ckpt, "manifest.json")):
        t0 = time.perf_counter()
        tr.restore(args.ckpt)
        done = len(tr.metrics)
        log(phase="restore", restore_s=round(time.perf_counter() - t0, 1),
            epochs_done=done)
    log(phase="init", init_s=init_s,
        host_table_gb=round(
            sum(v.nbytes for v in tr.e_host.values()) / 1e9, 2
        ),
        part_size=tr.part_size, buckets=len(tr.buckets), epochs_done=done)

    epoch_times = []
    for e in range(done, args.epochs):
        t0 = time.perf_counter()
        tr.fit(epochs=1)
        epoch_s = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
        tr.save(args.ckpt)
        save_s = round(time.perf_counter() - t0, 1)
        epoch_times.append(epoch_s)
        log(phase="train", epoch=e, loss=round(tr.metrics[-1]["loss"], 2),
            epoch_s=epoch_s, ckpt_save_s=save_s, uploads=tr.uploads)

    t0 = time.perf_counter()
    res = tr.evaluate(
        ds.test[: args.eval_n], aug.all_triples(),
        batch_size=args.eval_batch, reciprocal=True,
    )
    eval_s = round(time.perf_counter() - t0, 1)
    report = {
        "config": {
            "entities": args.entities, "relations": args.relations,
            "ntrain": args.ntrain, "dim": args.dim, "parts": args.parts,
            "k": args.k, "epochs": args.epochs, "nbatches": args.nbatches,
            "lr": args.lr, "model": args.model, "eval_n": args.eval_n,
        },
        "build_s": build_s, "init_s": init_s,
        "host_table_gb": round(
            sum(v.nbytes for v in tr.e_host.values()) / 1e9, 2
        ),
        "device_rows_resident": min(args.cache_parts, args.parts)
        * tr.part_size,
        "buckets": len(tr.buckets),
        "epoch_s": epoch_times,
        "eval_s": eval_s,
        "mrr": round(res.mrr, 6),
        "hits10": round(res.hits[10], 4),
        "mr": round(res.mean_rank, 1),
        "random_mrr": round(
            float(np.log(args.entities) / args.entities), 9
        ),
        "ckpt_gb": round(sum(
            os.path.getsize(os.path.join(args.ckpt, f))
            for f in os.listdir(args.ckpt)
        ) / 1e9, 2),
    }
    log(phase="eval", eval_s=eval_s, mrr=report["mrr"],
        hits10=report["hits10"], mr=report["mr"])
    print(json.dumps(report), flush=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(report) + "\n")


if __name__ == "__main__":
    main()
