"""Verify driver: self-adversarial loss end-to-end through the public API.

Usage: python -u scripts/_verify_selfadv.py [cpu|gpu]
Trains TransE with Trainer(loss='selfadv') on a latent KG, prints per-epoch
loss and the final filtered MRR.
"""
import sys

import jax

if len(sys.argv) > 1 and sys.argv[1] == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from skge_tpu import SharedNegativeSampler, TransE
from skge_tpu.data import latent_kg
from skge_tpu.evaluation import FilteredRankingEval
from skge_tpu.trainer import TrainConfig, Trainer

print("backend:", jax.devices()[0].platform, flush=True)
ds = latent_kg(n_entities=500, n_relations=16, n_train=4000,
               n_valid=0, n_test=100, latent_dim=10, seed=0)
model = TransE(ds.n_entities, ds.n_relations, 32, l1=False)
cfg = TrainConfig(max_epochs=40, nbatches=16, learning_rate=0.3,
                  margin=3.0, loss="selfadv", adv_alpha=1.0)
tr = Trainer(model, SharedNegativeSampler(ds.n_entities, k=64), cfg)
tr.fit(ds.train)
losses = [m["loss"] for m in tr.metrics.history]
print("loss first/last:", round(losses[0], 3), round(losses[-1], 3), flush=True)
r = FilteredRankingEval(model, ds.test, ds.all_triples(), batch_size=100)(
    tr.state.params)
print("final filtered MRR:", round(float(r.mrr), 4),
      "hits@10:", round(float(r.hits[10]), 4), flush=True)
assert losses[-1] < losses[0] * 0.6, "loss did not drop 40%"
assert r.mrr > 0.05, "MRR degenerate"
print("OK", flush=True)
