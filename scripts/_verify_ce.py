"""Verify driver: full cross-entropy loss end-to-end through the public API.

Usage: python -u scripts/_verify_ce.py [cpu|gpu] [--sweep]
Trains TransE with Trainer(loss='ce') on the selfadv A/B latent KG and
prints per-config filtered MRR (same dataset/protocol as
scripts/_verify_selfadv.py so the RESULTS.md loss A/B table is comparable).
"""
import sys

import jax

if len(sys.argv) > 1 and sys.argv[1] == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from skge_tpu import TransE
from skge_tpu.data import latent_kg
from skge_tpu.evaluation import FilteredRankingEval
from skge_tpu.trainer import TrainConfig, Trainer

print("backend:", jax.devices()[0].platform, flush=True)
ds = latent_kg(n_entities=500, n_relations=16, n_train=4000,
               n_valid=0, n_test=100, latent_dim=10, seed=0)


def run(lr, ls, seed):
    model = TransE(ds.n_entities, ds.n_relations, 32, l1=False)
    cfg = TrainConfig(max_epochs=40, nbatches=16, learning_rate=lr,
                      loss="ce", label_smoothing=ls, seed=seed)
    tr = Trainer(model, sampler=None, config=cfg)
    tr.fit(ds.train)
    r = FilteredRankingEval(model, ds.test, ds.all_triples(),
                            batch_size=100)(tr.state.params)
    return float(r.mrr), float(r.hits[10])


if "--sweep" in sys.argv:
    for lr in (0.1, 0.3, 0.5, 1.0):
        for ls in (0.0, 0.1):
            mrr, h10 = run(lr, ls, 0)
            print(f"lr={lr} ls={ls}: MRR {mrr:.4f} hits@10 {h10:.4f}",
                  flush=True)
else:
    for ls in (0.0, 0.1):
        ms = [run(0.3, ls, s)[0] for s in (0, 1, 2)]
        print(f"ls={ls}: MRR {np.mean(ms):.4f} +- {np.std(ms):.4f}",
              flush=True)
    print("OK", flush=True)
