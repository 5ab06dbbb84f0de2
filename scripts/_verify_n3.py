"""Verify driver: N3 regularization A/B through the public API.

Usage: python -u scripts/_verify_n3.py [cpu|gpu] [--sweep]
Trains ComplEx with the full-CE loss (its canonical pairing — Lacroix et
al. 2018) on the same latent KG / protocol as scripts/_verify_ce.py, at
several n3 strengths, and prints filtered MRR per config (3 seeds).
"""
import sys

import jax

if len(sys.argv) > 1 and sys.argv[1] == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from skge_tpu import ComplEx
from skge_tpu.data import latent_kg
from skge_tpu.evaluation import FilteredRankingEval
from skge_tpu.trainer import TrainConfig, Trainer

print("backend:", jax.devices()[0].platform, flush=True)
ds = latent_kg(n_entities=500, n_relations=16, n_train=4000,
               n_valid=0, n_test=100, latent_dim=10, seed=0)


def run(n3, seed, lr=0.3):
    model = ComplEx(ds.n_entities, ds.n_relations, 16, n3=n3)
    cfg = TrainConfig(max_epochs=40, nbatches=16, learning_rate=lr,
                      loss="ce", label_smoothing=0.1, seed=seed)
    tr = Trainer(model, sampler=None, config=cfg)
    tr.fit(ds.train)
    r = FilteredRankingEval(model, ds.test, ds.all_triples(),
                            batch_size=100)(tr.state.params)
    return float(r.mrr), float(r.hits[10])


if "--sweep" in sys.argv:
    for n3 in (0.0, 1e-4, 1e-3, 1e-2, 3e-2):
        for lr in (0.3, 1.0):
            mrr, h10 = run(n3, 0, lr)
            print(f"n3={n3} lr={lr}: MRR {mrr:.4f} hits@10 {h10:.4f}",
                  flush=True)
else:
    # lr=1.0 from the --sweep (CE on this KG prefers hot AdaGrad rates)
    for n3 in (0.0, 1e-4, 1e-3):
        ms = [run(n3, s, lr=1.0)[0] for s in (0, 1, 2)]
        print(f"n3={n3}: MRR {np.mean(ms):.4f} +- {np.std(ms):.4f}",
              flush=True)
    print("OK", flush=True)
