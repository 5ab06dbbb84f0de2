"""Reference-scale quality suite: the model zoo on a WN18-sized learnable
synthetic KG (data.latent_kg), trained with the flagship shared-negative-pool
scheme (or the reference iid scheme, selfadv, or CE) and evaluated with the
filtered ranking protocol. Writes a markdown table to RESULTS.md.

Real WN18/FB15k files are not available in this offline environment; this
suite demonstrates the complete train -> validate -> evaluate pipeline at
the reference's scale (40,943 entities / 141k train triples) on the real
chip. Absolute MRR is dataset-specific and NOT comparable to the paper's
WN18 numbers; the default latent KG is TransE-realizable by construction
(--kg bilinear / rotational give the multiplicative and rotational families
their own realizable geometry).

Methodology (VERDICT r2 items 4 & 6 — no more hand-picked epoch counts or
hand-run lever sweeps):

- `--eval-every N` + `--patience P`: filtered-MRR validation every N epochs,
  keep the best-validation parameters, stop after P consecutive
  non-improving validations, report TEST metrics of the BEST checkpoint
  (with its epoch) — the CE family's "peaks around 100 epochs" is now found
  by the suite, not by a human.
- `--sweep`: per-model successive halving over the loss-specific lever grid
  (margin: gamma x lr; selfadv: gamma x alpha; ce: lr x label-smoothing).
  Rung 0 trains every config for a short budget and scores VALIDATION MRR;
  each rung keeps the top half and doubles the budget; the surviving config
  gets the full early-stopped run and the table row (its grid choice is
  printed as JSON). Tested on CPU with a tiny grid in
  tests/test_quality_suite_sweep.py.

Usage:
    python scripts/quality_suite.py [--epochs 100] [--out RESULTS.md]
    python scripts/quality_suite.py --loss selfadv --sweep --eval-every 10
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--k", type=int, default=None,
                    help="pool size (default 1024; 8192 for --loss selfadv)")
    ap.add_argument("--nbatches", type=int, default=100)
    ap.add_argument("--entities", type=int, default=40943)   # WN18 shape
    ap.add_argument("--relations", type=int, default=18)
    ap.add_argument("--ntrain", type=int, default=141442)
    ap.add_argument("--latent-dim", type=int, default=32)
    ap.add_argument("--dim", type=int, default=None,
                    help="override the model embedding dim d0 (default 150 "
                    "at WN18 scale / 32 below 2k entities); matched-capacity "
                    "runs on the geometry KGs avoid the overparam overfit "
                    "that WN18-tuned dims show at 3.5 triples/entity")
    ap.add_argument("--kg", default="translational",
                    choices=["translational", "bilinear", "rotational"],
                    help="latent-KG geometry (data.latent_kg kind)")
    ap.add_argument("--out", default=None, help="append results to this md file")
    ap.add_argument("--models", default=None,
                    help="comma-separated subset, e.g. 'TransE-L1,HolE'")
    ap.add_argument(
        "--sampler", default="shared", choices=["shared", "random-mode"],
        help="'random-mode' = the REFERENCE scheme (iid corruption per "
        "positive) at the reference hyperparams margin=0.2 lr=0.1 — the "
        "decoupling run from VERDICT r1 ask 4: shared-pool hyperparameter "
        "sensitivity vs reference-semantics correctness",
    )
    ap.add_argument("--negatives", type=int, default=2,
                    help="[random-mode] negatives per (positive, mode)")
    ap.add_argument(
        "--loss", default="margin",
        choices=["margin", "selfadv", "ce", "sampled_ce"],
        help="'selfadv' = Sun et al. 2019 self-adversarial loss over the "
        "shared pool (the strongest measured loss — RESULTS.md); uses the "
        "per-model selfadv margins (gamma) with lr 0.3 and k 8192 unless "
        "--k overrides. 'ce' = the canonical multiplicative-era scheme for "
        "EVERY model: reciprocal relations + object-direction 1-vs-all "
        "cross entropy (ls=0.1) + Adam lr=1e-3 (no sampler) — the recipe "
        "that rescues DistMult/ComplEx/TuckER on this KG (RESULTS.md). "
        "'sampled_ce' = the same reciprocal+Adam protocol with the "
        "importance-corrected sampled softmax over a shared k-entity pool "
        "(O(B*k*d) work instead of O(B*n_e*d); "
        "training.sampled_ce_grads_shared) — the direct A/B against full "
        "CE at a fraction of the compute",
    )
    ap.add_argument("--adv-alpha", type=float, default=1.0,
                    help="[--loss selfadv] softmax temperature; the "
                    "recorded tables use 1.0, the tuned best is 2.0 "
                    "(RESULTS.md lever sweep; --sweep searches it)")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="validate (filtered MRR) every N epochs and keep "
                    "the best parameters; 0 = train the full --epochs")
    ap.add_argument("--patience", type=int, default=3,
                    help="[--eval-every] stop after P consecutive "
                    "non-improving validations")
    ap.add_argument("--sweep", action="store_true",
                    help="successive-halving lever sweep per model "
                    "(validation-MRR selection), then one full run of the "
                    "winning config")
    ap.add_argument("--sweep-rung0", type=int, default=0,
                    help="[--sweep] rung-0 epoch budget (default "
                    "max(epochs//8, 5))")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--train-seed", type=int, default=0,
                    help="training PRNG seed (init + sampling); the KG "
                    "split stays seed=0 so N-seed replication measures "
                    "TRAINING variance on a fixed dataset (VERDICT r3 "
                    "item 2c)")
    args = ap.parse_args(argv)
    if args.loss == "selfadv" and args.sampler != "shared":
        ap.error("--loss selfadv needs the shared-pool sampler")
    if args.k is None:
        args.k = 8192 if args.loss in ("selfadv", "sampled_ce") else 1024
    if args.sweep and not args.eval_every:
        args.eval_every = 10  # sweep selection needs validation evals
    return args


def successive_halving(grid, run_fn, rung0, full_epochs):
    """Generic successive halving: `grid` is a list of config dicts,
    `run_fn(cfg, epochs) -> score` (higher better). Each rung keeps the
    top half (by score) and doubles the budget until one survives or the
    budget reaches `full_epochs`. Returns (best_cfg, history)."""
    alive = list(grid)
    budget = max(1, rung0)
    history = []
    while len(alive) > 1 and budget < full_epochs:
        scored = [(run_fn(cfg, budget), i, cfg) for i, cfg in enumerate(alive)]
        scored.sort(key=lambda x: (-x[0], x[1]))
        keep = max(1, math.ceil(len(alive) / 2))
        history.append({
            "budget": budget,
            "scores": [
                {"cfg": c, "score": round(s, 4)} for s, _, c in scored
            ],
        })
        alive = [c for _, _, c in scored[:keep]]
        budget *= 2
    return alive[0], history


def main(argv=None) -> None:
    args = parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from skge_tpu import (
        AdaGrad, RandomModeSampler, SharedNegativeSampler, init_state,
        make_epoch_fn, make_pairwise_step,
    )
    from skge_tpu.data import latent_kg
    from skge_tpu.evaluation import FilteredRankingEval
    from skge_tpu.models import (
        ComplEx, DistMult, ERMLP, HolE, PairRE, QuatE, RESCAL, RotatE,
        SimplE, TransE, TransH, TransR, TuckER,
    )

    print("building latent KG...", flush=True)
    t0 = time.perf_counter()
    n_held = min(5000, max(50, args.ntrain // 10))  # scales to tiny test KGs
    # disk cache: latent_kg is deterministic per its arguments but the
    # WN18-scale on-device argmax sweep is slow to rebuild; repeated suite
    # invocations (probes, sweeps, per-loss tables) reuse it
    key = (f"{args.kg}-e{args.entities}-r{args.relations}-t{args.ntrain}"
           f"-h{n_held}-l{args.latent_dim}-s0")
    cache = os.path.join("/tmp", f"latent_kg_{key}.npz")
    if os.path.exists(cache):
        from skge_tpu.data import Dataset

        z = np.load(cache)
        ds = Dataset(train=z["train"], valid=z["valid"], test=z["test"],
                     n_entities=args.entities, n_relations=args.relations)
        print(f"  loaded from cache in {time.perf_counter() - t0:.0f}s",
              flush=True)
    else:
        ds = latent_kg(
            n_entities=args.entities, n_relations=args.relations,
            n_train=args.ntrain, n_valid=n_held, n_test=n_held,
            latent_dim=args.latent_dim, seed=0, kind=args.kg,
        )
        np.savez(cache, train=ds.train, valid=ds.valid, test=ds.test)
        print(f"  built in {time.perf_counter() - t0:.0f}s", flush=True)
    xs = jnp.asarray(ds.train)
    all_triples = ds.all_triples()

    # (name, model, margin, lr, k or None=args.k). HolE's sigmoid score
    # transform caps the gradient prefactor at 0.25 and AdaGrad's accumulator
    # then freezes the run at the reference's lr=0.1 under the shared-pool
    # loss; very large pools (k=8192) additionally destabilize it (nearly
    # every pool pair violates a sigmoid margin early on, so the pool term
    # swamps the positives). Sweep on the real chip: margin 0.5 / lr 0.3 /
    # k 2048 measured ~8x better MRR than the reference hyperparams here.
    d0 = args.dim or (150 if args.entities > 2000 else 32)
    configs = [
        ("TransE-L1", TransE(ds.n_entities, ds.n_relations, d0), 2.0, 0.1, None),
        ("TransE-L2", TransE(ds.n_entities, ds.n_relations, d0, l1=False), 1.0, 0.1, None),
        ("HolE", HolE(ds.n_entities, ds.n_relations, d0, rparam=0.0), 0.5, 0.3, 2048),
        ("RESCAL", RESCAL(ds.n_entities, ds.n_relations, args.dim or (100 if d0 == 150 else 16), rparam=0.01), 1.0, 0.1, None),
        ("ER-MLP", ERMLP(ds.n_entities, ds.n_relations, d0, nhidden=10), 1.0, 0.1, None),
        # multiplicative models: rparam collapses embeddings on this KG
        # (all-equal scores => random MRR under the mean tie-break), and the
        # translation-generated latent KG structurally favors TransE —
        # DistMult is symmetric, so these are expected to trail here
        ("DistMult", DistMult(ds.n_entities, ds.n_relations, d0), 0.5, 0.3, 2048),
        ("ComplEx", ComplEx(ds.n_entities, ds.n_relations, d0 // 2), 0.5, 0.3, 2048),
        ("RotatE", RotatE(ds.n_entities, ds.n_relations, d0 // 2), 0.5, 0.3, 2048),
        # round-2 families: TransH/TransR/PairRE are translational refinements
        # (should track TransE on this KG); TuckER rides RESCAL's config;
        # SimplE/QuatE are multiplicative (DistMult-family caveats apply)
        ("TransH", TransH(ds.n_entities, ds.n_relations, d0), 1.0, 0.1, None),
        ("TransR", TransR(ds.n_entities, ds.n_relations, args.dim or (64 if d0 == 150 else 16)), 1.0, 0.1, None),
        ("PairRE", PairRE(ds.n_entities, ds.n_relations, d0), 1.0, 0.1, None),
        ("TuckER", TuckER(ds.n_entities, ds.n_relations, args.dim or (100 if d0 == 150 else 16), rparam=0.01), 1.0, 0.1, None),
        ("SimplE", SimplE(ds.n_entities, ds.n_relations, d0 // 2), 0.5, 0.3, 2048),
        ("QuatE", QuatE(ds.n_entities, ds.n_relations, 38 if d0 == 150 else max(d0 // 4, 4)), 0.5, 0.3, 2048),
        # ConvE runs its canonical scheme instead of the pairwise pool:
        # reciprocal relations + object-direction 1-vs-all CE (ls=0.1) +
        # Adam (its paper optimizer — measured +36% over AdaGrad here)
        ("ConvE", None, 0.0, 1e-3, None),
    ]

    if args.sampler == "random-mode":
        # reference operating point: iid corruption, margin 0.2, lr 0.1
        configs = [(n, m, 0.2, 0.1, None) for n, m, _, _, _ in configs
                   if n != "ConvE"]
    if args.loss in ("ce", "sampled_ce"):
        # every model trains through its score_all_o eval kernel. rparam is
        # STRIPPED: under CE the optimizer applies full-table updates, so
        # row L2 decays every row every step and collapses the embeddings
        # (measured: TuckER rparam=0.01 -> MRR 0.0003). ComplEx gets its
        # canonical N3 (measured n3=1e-3); TuckER uses the measured
        # d=150 / rcomp=30 shape.
        from dataclasses import replace as _rp

        def _ce_model(n, m):
            if n == "ConvE":
                return None
            if n == "TuckER":
                return TuckER(ds.n_entities, 2 * ds.n_relations, d0,
                              rcomp=30 if d0 == 150 else 8)
            kw = {"n3": 1e-3} if n == "ComplEx" else {}
            if hasattr(m, "rparam"):
                kw["rparam"] = 0.0
            return _rp(m, n_relations=2 * ds.n_relations, **kw)

        configs = [
            (n, _ce_model(n, m), 0.0, 1e-3, None)
            for n, m, _, _, _ in configs
            # ConvE's canonical scheme IS full CE; under --loss sampled_ce
            # it would not be an A/B row, so it sits this one out
            if not (args.loss == "sampled_ce" and n == "ConvE")
        ]
    if args.loss == "selfadv":
        # per-family selfadv gammas measured in RESULTS.md ("selfadv sweep
        # across families"); lr 0.3, k 8192 unless --k overrides. rparam is
        # stripped for the bilinear family: round 2 measured it as the
        # selfadv collapse trigger (RESCAL g=0.5 rparam=0 -> 0.108 vs
        # collapse with rparam=0.01).
        from dataclasses import replace as _rps

        gammas = {"TransE-L1": 6.0, "TransE-L2": 3.0, "TransH": 3.0,
                  "PairRE": 3.0, "HolE": 1.0, "RESCAL": 0.5, "TuckER": 0.5}
        configs = [
            (n,
             _rps(m, rparam=0.0) if hasattr(m, "rparam") else m,
             gammas.get(n, 3.0), 0.3, args.k)
            for n, m, _, _, _ in configs if n != "ConvE"
        ]
    if args.models:
        want = {m.strip() for m in args.models.split(",")}
        configs = [c for c in configs if c[0] in want]

    needs_recip = args.loss in ("ce", "sampled_ce") or any(
        c[0] == "ConvE" for c in configs
    )
    if needs_recip:
        from skge_tpu.data import add_reciprocal_relations

        aug = add_reciprocal_relations(ds)
        aug_xs = jnp.asarray(aug.train)

    def build(name, model, margin, lr, k, alpha, ls):
        """-> (trainable model, step fn, train_xs, opt, eval_model)."""
        eval_model = None
        if name == "ConvE" or args.loss in ("ce", "sampled_ce"):
            from skge_tpu import Adam, make_ce_step
            from skge_tpu.evaluation import ReciprocalEvalWrapper
            from skge_tpu.models import ConvE

            opt = Adam(lr=lr)
            if name == "ConvE":
                model = ConvE(aug.n_entities, aug.n_relations, d0)
            else:
                # canonical reciprocal protocol: head queries rank through
                # the inverse relation (the direction CE actually trained),
                # exactly as ConvE does internally
                eval_model = ReciprocalEvalWrapper(model)
            if args.loss == "sampled_ce" and name != "ConvE":
                from skge_tpu import (
                    SharedNegativeSampler as _SNS, make_sampled_ce_step,
                )

                sampler = _SNS(ds.n_entities, k=k or args.k)
                step = make_sampled_ce_step(
                    model, opt, sampler, directions=("o",),
                    label_smoothing=ls,
                )
            else:
                step = make_ce_step(model, opt, directions=("o",),
                                    label_smoothing=ls)
            return model, step, aug_xs, opt, eval_model
        opt = AdaGrad(lr=lr)
        if args.sampler == "random-mode":
            sampler = RandomModeSampler(
                ds.n_entities, modes=(0, 1) * args.negatives
            )
        else:
            sampler = SharedNegativeSampler(ds.n_entities, k=k or args.k)
        if args.loss == "selfadv":
            from skge_tpu import make_selfadv_step

            step = make_selfadv_step(
                model, opt, sampler, margin=margin,
                alpha=alpha, aggregate="dense",
            )
        else:
            step = make_pairwise_step(
                model, opt, sampler, margin=margin, aggregate="dense"
            )
        return model, step, xs, opt, eval_model

    # evaluator cache: the sweep / early-stopping loops call train_eval many
    # times with value-equal (eval_model or model); FilteredRankingEval's
    # filter-index precompute is pure-Python over ~3x the train set and its
    # jitted kernels are cached by model VALUE (evaluation._KERNEL_CACHE),
    # so reusing the instance drops ~10 s of host work per validation pass.
    ev_cache: dict = {}

    def _get_eval(eval_model, which):
        data = ds.valid if which == "valid" else ds.test
        try:
            key = (eval_model, which)
            hash(key)
        except TypeError:
            key = None
        if key is not None and key in ev_cache:
            return ev_cache[key]
        ev = FilteredRankingEval(eval_model, data, all_triples,
                                 batch_size=1024)
        if key is not None:
            ev_cache[key] = ev
        return ev

    def train_eval(name, model, margin, lr, k, alpha, ls, epochs,
                   eval_on="test", eval_every=0, patience=0):
        """Train and return (metrics row dict, RankingResult). With
        eval_every > 0, validates on ds.valid, keeps the best params, and
        early-stops after `patience` non-improving validations; the
        reported row is the BEST checkpoint's TEST evaluation."""
        model, step, train_xs, opt, eval_model = build(
            name, model, margin, lr, k, alpha, ls
        )
        epoch = jax.jit(
            make_epoch_fn(step, int(train_xs.shape[0]), args.nbatches),
            donate_argnums=(0,),
        )
        state = init_state(model, opt, jax.random.PRNGKey(args.train_seed))
        val_ev = _get_eval(eval_model or model, "valid") if eval_every else None
        best = (-1.0, 0, None)  # (valid mrr, epoch, params)
        bad = 0
        t0 = time.perf_counter()
        e = 0
        m = None
        while e < epochs:
            state, m = epoch(state, train_xs)
            e += 1
            if eval_every and (e % eval_every == 0 or e == epochs):
                vm = val_ev(state.params).mrr
                if vm > best[0]:
                    # copy OUT of the donated buffers before the next epoch
                    best = (vm, e, jax.tree.map(jnp.copy, state.params))
                    bad = 0
                else:
                    bad += 1
                    if patience and bad >= patience:
                        break
        np.asarray(m.loss)
        t_train = time.perf_counter() - t0
        params = best[2] if best[2] is not None else state.params
        best_epoch = best[1] if best[2] is not None else e
        r = _get_eval(eval_model or model, eval_on)(params)
        row = {
            "model": name, "epochs": best_epoch, "epochs_run": e,
            "train_s": round(t_train, 1),
            "mrr": round(r.mrr, 4), "mrr_raw": round(r.mrr_raw, 4),
            "hits1": round(r.hits[1], 3), "hits3": round(r.hits[3], 3),
            "hits10": round(r.hits[10], 3), "mr": round(r.mean_rank, 1),
        }
        return row, r

    def sweep_grid(name, margin, lr, k, ls):
        """Loss-specific lever grid for --sweep (VERDICT r2 item 6)."""
        if args.loss == "selfadv":
            return [
                {"margin": g, "alpha": a, "lr": lr, "k": k, "ls": ls}
                for g in (margin * 0.5, margin, margin * 2.0)
                for a in (1.0, 2.0)
            ]
        if args.loss in ("ce", "sampled_ce") or name == "ConvE":
            return [
                {"margin": margin, "alpha": args.adv_alpha, "lr": r,
                 "k": k, "ls": s}
                for r in (5e-4, 1e-3, 2e-3)
                for s in (0.0, 0.1)
            ]
        return [
            {"margin": g, "alpha": args.adv_alpha, "lr": r, "k": k, "ls": ls}
            for g in (margin * 0.5, margin, margin * 2.0)
            for r in (0.1, 0.3)
        ]

    rows = []
    for name, model, margin, lr, k in configs:
        ls = 0.1 if (args.loss in ("ce", "sampled_ce")
                     or name == "ConvE") else 0.0
        cfg = {"margin": margin, "alpha": args.adv_alpha, "lr": lr,
               "k": k, "ls": ls}
        if args.sweep:
            grid = sweep_grid(name, margin, lr, k, ls)
            rung0 = args.sweep_rung0 or max(args.epochs // 8, 5)

            def run_fn(c, epochs, _name=name, _model=model):
                row, _ = train_eval(
                    _name, _model, c["margin"], c["lr"], c["k"],
                    c["alpha"], c["ls"], epochs, eval_on="valid",
                )
                print(json.dumps({"sweep": _name, "budget": epochs,
                                  "cfg": c, "valid_mrr": row["mrr"]}),
                      flush=True)
                return row["mrr"]

            cfg, _hist = successive_halving(
                grid, run_fn, rung0, args.epochs
            )
            print(json.dumps({"sweep_winner": name, "cfg": cfg}), flush=True)
        row, _ = train_eval(
            name, model, cfg["margin"], cfg["lr"], cfg["k"], cfg["alpha"],
            cfg["ls"], args.epochs,
            eval_every=args.eval_every, patience=args.patience,
        )
        if args.sweep:
            row["cfg"] = cfg
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:  # append incrementally so timeouts lose nothing
            tag = (
                f"iid x{args.negatives} m=0.2 lr=0.1"
                if args.sampler == "random-mode"
                else f"k={cfg['k'] or args.k}"
            )
            if args.loss == "selfadv":
                tag = (f"selfadv g={cfg['margin']} a={cfg['alpha']} "
                       f"lr={cfg['lr']} {tag}")
            elif args.loss == "sampled_ce" and name != "ConvE":
                tag = (f"sampledCE+Adam reciprocal k={cfg['k'] or args.k} "
                       f"lr={cfg['lr']} ls={cfg['ls']}")
            elif args.loss == "ce" or name == "ConvE":
                tag = f"CE+Adam reciprocal lr={cfg['lr']} ls={cfg['ls']}"
            elif args.sweep:
                tag = f"m={cfg['margin']} lr={cfg['lr']} {tag}"
            if args.eval_every:
                tag += f" best@{row['epochs']}"
            if args.train_seed:
                tag += f" seed={args.train_seed}"
            header = (
                f"| {name} {tag} ep={args.epochs} | {row['mrr']} | "
                f"{row['mrr_raw']} | {row['hits1']} | {row['hits3']} | "
                f"{row['hits10']} | {row['mr']} | {row['train_s']} |\n"
            )
            with open(args.out, "a") as f:
                f.write(header)
    if args.out:
        print(f"appended to {args.out}")


if __name__ == "__main__":
    main()
