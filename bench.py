"""Benchmark: TransE pairwise training throughput on FB15k-shaped data.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "triples/s", "device": {...}}

`value` counts REFERENCE-EQUIVALENT scored triples per second in the full
training step (gather -> score -> margin ranking -> duplicate-averaged
gradients -> sparse AdaGrad + normless1 -> on-device negative sampling):
the reference evaluates 2 scores per margin-ranked pair, so work units =
2 * (pairs ranked per epoch). Every ranked pair performs the reference's
full per-pair training math (violation test, averaged gradients, update).

The default config is the flagship: a shared negative pool of K entities
per step (`--sampler shared`, PBG/DGL-KE scheme — skge_tpu/sampling.py
SharedNegativeSampler), which ranks each positive against K pool entities
per corruption mode => 2*K pairs per positive, 4*K*n_train work units per
epoch. Pool scoring is a matmul for dot-style models and the gradient
scatter touches only base + pool rows, unlike iid corruption
(`--sampler random-mode`, the reference-exact scheme: 2*negatives pairs
per positive). Exact per-pair semantic parity of both paths is pinned by
tests/test_fused.py and tests/test_shared.py.

`device` names what the row ran on (platform, device_kind, count).

`--all` (VERDICT r3 item 8) machine-generates the RESULTS.md training-
throughput matrix: one JSON line per curated (model, loss, k) row — the
whole model zoo under the shared-pool flagship scheme plus the selfadv /
full-CE / sampled-CE loss rows — so a per-round perf regression anywhere
in the matrix is one `python bench.py --all` away. The driver's default
single-row invocation is unchanged.

Runs on the GPU and exits non-zero when JAX's default backend is not
'gpu'; `--cpu` for a smoke run on the host.
"""

from __future__ import annotations

import argparse
import json
import time

# The curated --all matrix: argv fragments over this parser (the iid
# sampler rows stay hand-run: they measure the aggregation, not the
# models).
ALL_ROWS = [
    ["--model", "transe"],                                  # flagship L1
    ["--model", "transe", "--l2"],
    ["--model", "transe", "--l2", "--k", "4096"],
    ["--model", "hole", "--k", "4096"],
    ["--model", "rescal", "--ncomp", "100"],
    ["--model", "ermlp"],
    ["--model", "distmult"],
    ["--model", "complex", "--ncomp", "75"],
    ["--model", "rotate"],
    ["--model", "transh"],
    ["--model", "transr", "--factored"],
    ["--model", "pairre"],
    ["--model", "tucker", "--ncomp", "100"],
    ["--model", "simple"],
    ["--model", "quate"],
    ["--model", "conve", "--ncomp", "128"],
    ["--model", "transe", "--selfadv"],
    ["--model", "distmult", "--ce"],
    ["--model", "distmult", "--sampled-ce", "--k", "8192"],
    ["--model", "conve", "--ncomp", "128", "--ce"],
]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run the curated model x loss matrix (ALL_ROWS); "
                    "one JSON line per row")
    ap.add_argument("--l2", action="store_true",
                    help="[transe] squared-L2 score instead of L1")
    ap.add_argument(
        "--model", default="transe",
        choices=["transe", "hole", "rescal", "ermlp", "distmult", "complex",
                 "rotate", "transh", "transr", "tucker", "simple", "quate",
                 "pairre", "conve"],
    )
    ap.add_argument("--ncomp", type=int, default=150)
    ap.add_argument("--nbatches", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=3, help="timed epochs")
    ap.add_argument("--entities", type=int, default=14951)  # FB15k
    ap.add_argument("--relations", type=int, default=1345)
    ap.add_argument("--ntrain", type=int, default=483142)
    ap.add_argument(
        "--aggregate", default="dense",
        choices=["unique", "dense", "dense_sorted"],
        help="gradient aggregation path. 'dense' = fused XLA table scatter; "
        "'dense_sorted' = sort + banded one-hot matmul "
        "(ops/sorted_segment.py)",
    )
    ap.add_argument(
        "--sampler", default="shared", choices=["shared", "random-mode"],
        help="'shared': K-entity shared negative pool per step (flagship; "
        "PBG/DGL-KE scheme). 'random-mode': reference-exact iid "
        "corruption per positive.",
    )
    ap.add_argument(
        "--k", type=int, default=1024,
        help="shared-pool size (pairs per positive = 2*k).",
    )
    ap.add_argument(
        "--negatives", type=int, default=8,
        help="[random-mode] negatives per (positive, mode); the reference "
        "Sampler's `n` (skge/sample.py). 8 => 16 ranked pairs per positive — "
        "a standard production KGE setting (DGL-KE defaults to far more). "
        "More negatives amortize the positive's gather/scatter rows.",
    )
    ap.add_argument(
        "--ce", action="store_true",
        help="full 1-vs-all cross-entropy loss instead of pairwise margin "
        "(no sampler; every positive scored against ALL entities — work "
        "units = n_entities per positive per direction)",
    )
    ap.add_argument(
        "--compute-dtype", default="", choices=["", "bfloat16", "float32"],
        help="input precision for the batched scoring matmuls "
        "(KGEModel.compute_dtype). Parameters/optimizer/updates stay fp32; "
        "'' (default) keeps fp32 inputs, whose dots the GPU may run in "
        "TF32 unless jax.default_matmul_precision('highest') is set. "
        "'bfloat16' halves the bytes of matmul-bound models (TransR's "
        "quadratic sweep).",
    )
    ap.add_argument(
        "--factored", action="store_true",
        help="[transr] rank-1 factored projections M_p = I + u_p v_p^T "
        "(TransD-style) instead of full (d, d) matrices — removes the "
        "per-triple projection-row traffic entirely (models/transr.py).",
    )
    ap.add_argument(
        "--selfadv", action="store_true",
        help="self-adversarial loss (Sun et al. 2019) over the shared pool "
        "instead of pairwise margin (same work units: 2 scores per "
        "(positive, pool, mode) element)",
    )
    ap.add_argument(
        "--sampled-ce", action="store_true",
        help="importance-corrected sampled-softmax CE over the shared pool "
        "(training.sampled_ce_grads_shared) — full-CE quality scheme at "
        "O(B*k*d) instead of O(B*n_e*d) work; work units = (k+1) candidate "
        "scorings per positive per direction",
    )
    args = ap.parse_args()
    if args.negatives < 1:
        ap.error("--negatives must be >= 1")
    if args.k < 1:
        ap.error("--k must be >= 1")
    if sum((args.ce, args.selfadv, args.sampled_ce)) > 1:
        ap.error("--ce / --selfadv / --sampled-ce are mutually exclusive")

    if args.all:
        base = []
        if args.cpu:
            base += ["--cpu"]
        for flag in ("--epochs", "--nbatches", "--entities", "--relations",
                     "--ntrain"):
            base += [flag, str(getattr(args, flag.strip("-")))]
        for row in ALL_ROWS:
            row_args = ap.parse_args(base + row)
            rec = run(row_args)
            rec["config"] = " ".join(row)
            print(json.dumps(rec), flush=True)
        return

    print(json.dumps(run(args)))


def run(args) -> dict:
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        raise SystemExit(
            f"bench: JAX's default backend is {jax.default_backend()!r}, "
            "not 'gpu' (pass --cpu for a host smoke run)"
        )
    from skge_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from skge_tpu import (
        AdaGrad,
        MODELS,
        RandomModeSampler,
        SharedNegativeSampler,
        init_state,
        make_epoch_fn,
        make_pairwise_step,
    )
    from skge_tpu.data import synthetic_kg

    ds = synthetic_kg(
        n_entities=args.entities,
        n_relations=args.relations,
        n_train=args.ntrain,
        seed=0,
        clustered=False,
    )
    # ConvE is directional: reciprocal relation ids + object-side corruption
    # only (models/conve.py docstring); each positive still ranks against the
    # pool in ONE mode, so pairs_per_positive halves.
    modes = (1,) if args.model == "conve" else (0, 1)
    n_rel = 2 * ds.n_relations if args.model == "conve" else ds.n_relations
    mkw = {"compute_dtype": args.compute_dtype}
    if args.l2:
        if args.model != "transe":
            raise SystemExit("--l2 is a TransE option")
        mkw["l1"] = False
    if args.factored:
        if args.model != "transr":
            raise SystemExit("--factored is a TransR option")
        mkw["factored"] = True
    model = MODELS[args.model](ds.n_entities, n_rel, args.ncomp, **mkw)
    opt = AdaGrad(lr=0.1)
    if args.ce:
        from skge_tpu import make_ce_step

        directions = ("o",) if args.model == "conve" else ("o", "s")
        step = make_ce_step(model, opt, directions=directions)
        # CE scores every positive against ALL entities per direction;
        # work units = reference-equivalent candidate scorings
        pairs_per_positive = len(directions) * ds.n_entities
    elif args.selfadv:
        from skge_tpu import make_selfadv_step

        sampler = SharedNegativeSampler(ds.n_entities, k=args.k, modes=modes)
        step = make_selfadv_step(
            model, opt, sampler, margin=1.0, alpha=1.0, aggregate="dense"
        )
        pairs_per_positive = len(modes) * args.k
    elif args.sampled_ce:
        from skge_tpu import make_sampled_ce_step

        directions = ("o",) if args.model == "conve" else ("o", "s")
        sampler = SharedNegativeSampler(ds.n_entities, k=args.k, modes=modes)
        step = make_sampled_ce_step(model, opt, sampler,
                                    directions=directions)
        # each positive scores itself + the k-candidate pool per direction
        pairs_per_positive = len(directions) * (args.k + 1)
    elif args.sampler == "shared":
        sampler = SharedNegativeSampler(ds.n_entities, k=args.k, modes=modes)
        pairs_per_positive = len(modes) * args.k
    else:
        sampler = RandomModeSampler(ds.n_entities, modes=modes * args.negatives)
        pairs_per_positive = len(modes) * args.negatives
    if not args.ce and not args.selfadv and not args.sampled_ce:
        step = make_pairwise_step(
            model, opt, sampler, margin=1.0, aggregate=args.aggregate
        )
    epoch = jax.jit(
        make_epoch_fn(step, ds.train.shape[0], args.nbatches),
        donate_argnums=(0,),
    )

    state = init_state(model, opt, jax.random.PRNGKey(0))
    xs = jnp.asarray(ds.train)

    # warm-up epoch compiles; the timed window ends when the device does
    state, m = epoch(state, xs)
    jax.block_until_ready((state, m))

    t0 = time.perf_counter()
    for _ in range(args.epochs):
        state, m = epoch(state, xs)
    jax.block_until_ready((state, m))
    dt = time.perf_counter() - t0

    # 2 reference-equivalent scores (pos+neg) per margin-ranked pair;
    # CE / sampled-CE work units are single candidate scorings (no pairing)
    per_pair = 1 if (args.ce or args.sampled_ce) else 2
    scored_per_epoch = per_pair * pairs_per_positive * ds.train.shape[0]
    value = scored_per_epoch * args.epochs / dt
    return {
        "metric": (
            f"{args.model}"
            f"{'_l2' if args.l2 else ''}"
            f"{'_ce' if args.ce else ''}"
            f"{'_selfadv' if args.selfadv else ''}"
            f"{'_sampled_ce' if args.sampled_ce else ''}"
            "_fb15k_scored_triples_per_s_per_chip"
        ),
        "value": round(value, 1),
        "unit": "triples/s",
        "device": {
            "platform": jax.devices()[0].platform,
            "kind": jax.devices()[0].device_kind,
            "count": len(jax.devices()),
        },
    }


if __name__ == "__main__":
    main()
