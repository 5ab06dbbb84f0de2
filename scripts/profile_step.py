"""Train-step profiler: phase ablation + optional jax.profiler trace.

SURVEY.md §5 tracing/profiling mapping. Two tools in one:

1. **Phase ablation** (always): times progressively larger fragments of the
   pairwise train step — negative sampling only, +forward/backward
   gradients, +optimizer apply — isolating where step time goes. This is
   the measurement that led to the shared-pool scheme.
2. **XLA trace** (--trace DIR): wraps the timed run in `jax.profiler.trace`
   for TensorBoard/Perfetto inspection (failures are reported, not fatal).

Usage:
    python scripts/profile_step.py                    # GPU, shared sampler
    python scripts/profile_step.py --sampler random-mode --negatives 8
    python scripts/profile_step.py --cpu --trace /tmp/trace
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--model", default="transe")
    ap.add_argument("--ncomp", type=int, default=150)
    ap.add_argument("--entities", type=int, default=14951)
    ap.add_argument("--relations", type=int, default=1345)
    ap.add_argument("--ntrain", type=int, default=483142)
    ap.add_argument("--nbatches", type=int, default=100)
    ap.add_argument("--sampler", default="shared",
                    choices=["shared", "random-mode"])
    ap.add_argument("--k", type=int, default=1024)
    ap.add_argument("--negatives", type=int, default=8)
    ap.add_argument("--aggregate", default="dense",
                    choices=["unique", "dense", "dense_sorted"])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="capture a jax.profiler trace into DIR")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from skge_tpu import (
        AdaGrad, MODELS, RandomModeSampler, SharedNegativeSampler,
        init_state, make_epoch_fn,
    )
    from skge_tpu.data import synthetic_kg
    from skge_tpu.ops.aggregate import FactoredOcc
    from skge_tpu.training import (
        StepMetrics, TrainState, apply_gradients,
        pairwise_grads_fused, select_shared_pairwise_fn,
    )

    ds = synthetic_kg(args.entities, args.relations, args.ntrain,
                      seed=0, clustered=False)
    model = MODELS[args.model](ds.n_entities, ds.n_relations, args.ncomp)
    opt = AdaGrad(lr=0.1)
    shared = args.sampler == "shared"
    if shared:
        sampler = SharedNegativeSampler(ds.n_entities, k=args.k)
    else:
        sampler = RandomModeSampler(
            ds.n_entities, modes=(0, 1) * args.negatives
        )
    xs = jnp.asarray(ds.train)
    n = ds.train.shape[0]

    def grads_of(state, batch, mask, sk):
        if shared:
            shared_fn = select_shared_pairwise_fn(model)
            pool = sampler.pool(sk, batch, mask)
            return shared_fn(
                model, state.params, batch, pool, mask, 1.0,
                modes=sampler.modes,
            )
        corr = sampler.corruptions(sk, batch, mask)
        return pairwise_grads_fused(
            model, state.params, batch, corr, mask, 1.0
        )

    def make_variant(phase):
        def step(state, batch, mask):
            key, sk = jax.random.split(state.key)
            if phase == "sample":
                if shared:
                    probe = jnp.sum(sampler.pool(sk, batch, mask))
                else:
                    probe = sum(
                        jnp.sum(r)
                        for _, r, _ in sampler.corruptions(sk, batch, mask)
                    )
                loss = probe.astype(jnp.float32)
                return (
                    TrainState(state.params, state.opt_state, key,
                               state.step + 1),
                    StepMetrics(loss=loss, nviolations=loss),
                )
            loss, nviol, occ, g_dense = grads_of(state, batch, mask, sk)
            if phase == "grads":
                probe = 0.0
                for entry in occ.values():
                    if isinstance(entry, FactoredOcc):
                        probe += sum(jnp.sum(u) for u in entry.us)
                        probe += sum(jnp.sum(v) for v in entry.vs)
                    else:
                        probe += jnp.sum(entry[1])
                loss = loss + probe
                return (
                    TrainState(state.params, state.opt_state, key,
                               state.step + 1),
                    StepMetrics(loss=loss, nviolations=nviol),
                )
            params, opt_state = apply_gradients(
                model, opt, state.params, state.opt_state, occ, g_dense,
                args.aggregate, premasked=True,
            )
            return (
                TrainState(params, opt_state, key, state.step + 1),
                StepMetrics(loss=loss, nviolations=nviol),
            )
        return jax.jit(make_epoch_fn(step, n, args.nbatches),
                       donate_argnums=(0,))

    def timed(fn):
        state = init_state(model, opt, jax.random.PRNGKey(0))
        state, m = fn(state, xs)
        np.asarray(m.loss)  # sync
        t0 = time.perf_counter()
        for _ in range(args.epochs):
            state, m = fn(state, xs)
        np.asarray(m.loss)
        return (time.perf_counter() - t0) / args.epochs

    phases = ["sample", "grads", "full"]
    times = {}
    for ph in phases:
        times[ph] = timed(make_variant(ph))
    report = {
        "config": {
            "model": args.model, "sampler": args.sampler,
            "aggregate": args.aggregate,
            "k": args.k if shared else None,
            "negatives": None if shared else args.negatives,
        },
        "epoch_ms": {ph: round(t * 1e3, 1) for ph, t in times.items()},
        "breakdown_ms": {
            "sampling": round(times["sample"] * 1e3, 1),
            "fwd+bwd": round((times["grads"] - times["sample"]) * 1e3, 1),
            "apply": round((times["full"] - times["grads"]) * 1e3, 1),
        },
    }
    print(json.dumps(report, indent=2))

    if args.trace:
        try:
            fn = make_variant("full")
            state = init_state(model, opt, jax.random.PRNGKey(0))
            state, m = fn(state, xs)
            np.asarray(m.loss)
            with jax.profiler.trace(args.trace):
                state, m = fn(state, xs)
                np.asarray(m.loss)
            print(f"trace written to {args.trace}")
        except Exception as e:  # a backend without profiler support
            print(f"trace capture failed (non-fatal): {e}")


if __name__ == "__main__":
    main()
