"""Experiment harness — the companion `kg/base.py` Experiment equivalent
(SURVEY.md §2.2): argparse CLI, train/eval/checkpoint loop, filtered ranking
with periodic validation, best-model retention and early stopping.

Flags mirror the reference harness: --fin, --fout, --test-all N, --me
(max epochs), --nb (nbatches), --lr, --ncomp, --margin, --sampler, --mode,
--no-pairwise; plus build-scope additions (--model to select the family from
one binary, --rparam/--nhidden/--af, --synthetic for offline smoke runs,
--metrics JSONL, --ckpt full-state checkpoints).

Early stopping [M]: the reference tracks best validation MRR and pickles the
best model; the exact stop rule is unverifiable (empty reference mount), so
this harness stops after `--patience` consecutive non-improving validations
(default 3) and always keeps the best-MRR parameters.
"""

from __future__ import annotations

import argparse
import logging
import sys
import timeit
from typing import Optional

import numpy as np

from skge_tpu import sampling
from skge_tpu.data import (
    Dataset,
    bernoulli_probs,
    latent_kg,
    load_dataset,
    sorted_train_keys,
    synthetic_kg,
    type_index_arrays,
)
from skge_tpu.evaluation import FilteredRankingEval
from skge_tpu.models import MODELS
from skge_tpu.trainer import TrainConfig, Trainer
from skge_tpu.utils.checkpoint import save_checkpoint

log = logging.getLogger("skge_tpu.experiment")


def build_sampler(name: str, ds: Dataset, ntries: int = 100, k: int = 1024,
                  modes: tuple = (0, 1)):
    import jax.numpy as jnp

    if name == "shared":
        return sampling.SharedNegativeSampler(ds.n_entities, k=k, modes=modes)
    if name == "random-mode":
        return sampling.RandomModeSampler(ds.n_entities, modes=modes)
    if name == "lcwa":
        return sampling.LCWASampler(
            ds.n_entities,
            ds.n_relations,
            jnp.asarray(sorted_train_keys(ds)),
            ntries=ntries,
        )
    if name == "bernoulli":
        return sampling.BernoulliSampler(
            ds.n_entities, jnp.asarray(bernoulli_probs(ds.train, ds.n_relations))
        )
    if name == "corrupted":
        arrs = type_index_arrays(ds.train, ds.n_relations)
        return sampling.CorruptedSampler(
            ds.n_entities, *(jnp.asarray(a) for a in arrs)
        )
    raise ValueError(f"unknown sampler {name!r}")


class Experiment:
    """Train + periodically validate + keep best params + final test eval."""

    def __init__(self, args: argparse.Namespace):
        self.args = args
        if args.trainer == "partitioned":
            # must run before ANY backend-initializing JAX call (sampler
            # construction below builds device arrays) — otherwise the
            # process is pinned single-host on pods
            from skge_tpu.parallel.distributed import initialize

            initialize()
        if args.tsv:
            from skge_tpu.data import load_tsv

            self.ds = load_tsv(*args.tsv, order=args.tsv_order)
        elif args.fin:
            self.ds = load_dataset(args.fin)
        else:
            gen = synthetic_kg if args.synthetic_kind == "random" else latent_kg
            kw = (
                {"latent_dim": args.latent_dim}
                if args.synthetic_kind == "latent"
                else {}
            )
            self.ds = gen(
                n_entities=args.synthetic_entities,
                n_relations=args.synthetic_relations,
                n_train=args.synthetic_train,
                n_valid=max(50, args.synthetic_train // 20),
                n_test=max(50, args.synthetic_train // 20),
                seed=args.seed,
                **kw,
            )
            log.info("using %s synthetic KG (no --fin given)", args.synthetic_kind)
        reciprocal = args.model == "conve" or args.reciprocal
        if reciprocal:
            # ConvE is directional (models/conve.py); --reciprocal applies
            # the same canonical scheme to ANY model: inverse relation ids +
            # object-direction-only CE (the recipe that rescues the
            # multiplicative family — RESULTS.md)
            from skge_tpu.data import add_reciprocal_relations

            if (args.reciprocal and args.model != "conve"
                    and not (args.ce or args.sampled_ce)):
                raise SystemExit("--reciprocal requires --ce or --sampled-ce")
            self.ds = add_reciprocal_relations(self.ds)
            log.info(
                "reciprocal-relation augmentation (n_relations doubled to "
                "%d, train doubled to %d)",
                self.ds.n_relations, len(self.ds.train),
            )
            if (args.trainer != "single" and args.model == "conve"
                    and not (args.ce or args.sampled_ce)):
                # scale-out pool samplers corrupt BOTH roles; directional
                # ConvE scores candidate objects only, so its scale-out
                # protocols are the (object-direction) CE family — which
                # is also its canonical training scheme
                raise SystemExit(
                    "ConvE on --trainer partitioned/outofcore requires "
                    "--ce or --sampled-ce (its canonical scheme); the "
                    "pairwise pool path is --trainer single"
                )
        model_cls = MODELS[args.model]
        kw = {}
        if args.model in ("hole", "rescal", "distmult", "complex", "tucker",
                          "simple", "quate", "rotate", "conve"):
            kw["rparam"] = args.rparam
        if args.n3:
            if args.model not in ("distmult", "complex", "tucker",
                                  "simple", "quate"):
                raise SystemExit(
                    f"--n3 is not supported for --model {args.model} "
                    "(factorization models only: distmult, complex, "
                    "tucker, simple, quate)"
                )
            kw["n3"] = args.n3
        if args.model == "ermlp":
            kw["nhidden"] = args.nhidden
        if args.model == "hole":
            kw["af"] = args.af
        if args.model == "transe":
            kw["l1"] = not args.l2
        self.model = model_cls(
            self.ds.n_entities, self.ds.n_relations, args.ncomp,
            init=args.init, **kw,
        )
        cfg = TrainConfig(
            max_epochs=args.me,
            nbatches=args.nb,
            learning_rate=args.lr,
            optimizer=args.optimizer,
            schedule=None if args.schedule == "constant" else args.schedule,
            warmup=args.warmup,
            schedule_min=args.schedule_min,
            margin=args.margin,
            pairwise=not args.no_pairwise,
            loss=(
                "ce" if args.ce else
                "sampled_ce" if args.sampled_ce else
                "selfadv" if args.selfadv else "margin"
            ),
            adv_alpha=args.adv_alpha,
            label_smoothing=args.label_smoothing,
            ce_directions=("o",) if reciprocal else ("o", "s"),
            aggregate=args.aggregate,
            seed=args.seed,
            metrics_jsonl=args.metrics,
        )
        if (args.sampled_ce and args.sampler != "shared"
                and args.trainer == "single"):
            # scale-out trainers always pool-sample (the --sampler flag is
            # in their ignored list); only the single path needs the check
            raise SystemExit("--sampled-ce needs --sampler shared")
        if args.trainer == "single":
            sampler = build_sampler(
                args.sampler, self.ds, args.ntries, args.k,
                modes=(1,) if args.model == "conve" else (0, 1),
            )
            self.trainer = Trainer(
                self.model, sampler, cfg, post_epoch=[self._callback]
            )
        else:
            self.trainer = None
            ignored = []
            if args.sampler != "shared":
                ignored.append(f"--sampler {args.sampler} (shared pool only)")
            if args.aggregate != "unique":
                ignored.append(f"--aggregate {args.aggregate}")
            if args.no_pairwise:
                # stated decision (VERDICT r3 weak 6): pointwise logistic
                # ships on single-device, GSPMD and explicit-SPMD shardmap
                # (make_shardmap_pointwise_step) trainers; the partitioned
                # and out-of-core trainers stay margin/selfadv/CE/sampled-CE
                # — every measured KG has CE or selfadv strictly dominating
                # pointwise (RESULTS.md quality tables), so the long-dim
                # exchange machinery doesn't carry a third loss family.
                ignored.append(
                    "--no-pairwise (pointwise: single/mesh trainers only; "
                    "CE/selfadv dominate it everywhere measured)"
                )
            if args.metrics:
                ignored.append("--metrics (use trainer.metrics)")
            if ignored:
                log.warning(
                    "--trainer %s ignores: %s", args.trainer,
                    "; ".join(ignored),
                )
        # head queries of reciprocal-trained non-ConvE models rank through
        # the inverse relation (ConvE routes internally)
        self._eval_model = self.model
        if reciprocal and args.model != "conve":
            from skge_tpu.evaluation import ReciprocalEvalWrapper

            self._eval_model = ReciprocalEvalWrapper(self.model)
        self.best_mrr = -1.0
        self.best_params = None
        self.evals_without_improvement = 0
        self._valid_ev: Optional[FilteredRankingEval] = None

    def _callback(self, trainer: Trainer) -> bool:
        log.info(
            "epoch %d  loss=%.4f  violations=%d  (%.2fs, %.0f triples/s)",
            trainer.epoch,
            trainer.loss,
            trainer.nviolations,
            trainer.metrics.last().get("epoch_seconds", 0.0),
            trainer.metrics.last().get("triples_per_second", 0.0),
        )
        if (
            self.args.test_all <= 0
            or trainer.epoch % self.args.test_all != 0
            or len(self.ds.valid) == 0
        ):
            return True
        if self._valid_ev is None:
            self._valid_ev = FilteredRankingEval(
                self._eval_model,
                self.ds.valid,
                self.ds.all_triples(),
                batch_size=self.args.eval_batch,
            )
        res = self._valid_ev(trainer.state.params)
        log.info(
            "  VALID epoch %d: MRR=%.4f (raw %.4f) Hits@10=%.3f MR=%.1f",
            trainer.epoch, res.mrr, res.mrr_raw, res.hits[10], res.mean_rank,
        )
        if res.mrr > self.best_mrr:
            self.best_mrr = res.mrr
            self.best_params = {
                k: np.asarray(v) for k, v in trainer.state.params.items()
            }
            self.evals_without_improvement = 0
            if self.args.fout:
                save_checkpoint(
                    self.args.fout,
                    trainer.state,
                    meta={
                        "model": self.model.name,
                        "epoch": trainer.epoch,
                        "valid_mrr": res.mrr,
                    },
                )
        else:
            self.evals_without_improvement += 1
            if self.evals_without_improvement >= self.args.patience:
                log.info("early stop: no valid-MRR improvement")
                return False
        return True

    def _run_scaleout(self) -> dict:
        """`--trainer partitioned|outofcore`: the scale-out trainers under
        the same harness protocol — periodic valid eval every `--test-all`
        epochs, best-MRR retention, patience early stop, final test eval.
        Both are shared-pool pairwise paths (their production scheme)."""
        import jax
        import jax.numpy as jnp

        from skge_tpu.optim import OPTIMIZERS, make_schedule

        args = self.args
        # both scale-out steps accept any Optimizer (Adam slot specs are
        # rank-adapted), so --optimizer plumbs straight through; schedules
        # ride the same TrainState.step the scale-out steps maintain
        opt = OPTIMIZERS[args.optimizer](
            lr=args.lr,
            schedule=make_schedule(
                args.schedule, warmup=args.warmup,
                total=args.me * args.nb, min_scale=args.schedule_min,
            ),
        )
        loss = "ce" if args.ce else (
            "sampled_ce" if args.sampled_ce else
            "selfadv" if args.selfadv else "margin"
        )
        # ConvE is implicitly reciprocal (the dataset was augmented above)
        reciprocal = args.reciprocal or args.model == "conve"
        if args.trainer == "partitioned":
            from skge_tpu.parallel.partitioned import (
                PartitionedTrainer, make_shard_mesh,
            )

            tr = PartitionedTrainer(
                self.model, opt, self.ds.train, make_shard_mesh(),
                margin=args.margin, k=args.k, nbatches=args.nb,
                seed=args.seed, loss=loss, adv_alpha=args.adv_alpha,
                reciprocal=reciprocal and loss in ("ce", "sampled_ce"),
                label_smoothing=args.label_smoothing,
            )

            def eval_split(split):
                return tr.evaluate(
                    split, self.ds.all_triples(), batch_size=args.eval_batch
                )
        else:
            from skge_tpu.outofcore import OutOfCoreTrainer

            recip = reciprocal and loss in ("ce", "sampled_ce")
            tr = OutOfCoreTrainer(
                self.model, opt, self.ds.train, n_parts=args.parts,
                margin=args.margin, k=args.k, nbatches=args.nb,
                seed=args.seed, loss=loss, adv_alpha=args.adv_alpha,
                label_smoothing=args.label_smoothing,
                ce_directions=("o",) if recip else ("o", "s"),
            )

            def eval_split(split):
                # streamed: candidates arrive one partition at a time —
                # evaluation works at the same beyond-HBM scale as
                # training (never materializes the full table on device);
                # reciprocal routes head queries through inverse relations
                return tr.evaluate(
                    split, self.ds.all_triples(),
                    batch_size=args.eval_batch, reciprocal=recip,
                )

        best_params = None
        t0 = timeit.default_timer()
        chunk = args.test_all if args.test_all > 0 else args.me
        epoch = 0
        while epoch < args.me:
            n = min(chunk, args.me - epoch)
            tr.fit(epochs=n)
            epoch += n
            m = tr.metrics[-1]
            log.info(
                "epoch %d  loss=%.4f  violations=%d",
                epoch, m["loss"], int(m.get("nviolations", 0)),
            )
            if args.test_all <= 0 or len(self.ds.valid) == 0:
                continue
            res = eval_split(self.ds.valid)
            log.info(
                "  VALID epoch %d: MRR=%.4f Hits@10=%.3f MR=%.1f",
                epoch, res.mrr, res.hits[10], res.mean_rank,
            )
            if res.mrr > self.best_mrr:
                self.best_mrr = res.mrr
                self.evals_without_improvement = 0
                best_params = tr.params()  # host copy in ORIGINAL ids
                if args.fout:
                    tr.save(args.fout + ".sharded")
            else:
                self.evals_without_improvement += 1
                if self.evals_without_improvement >= args.patience:
                    log.info("early stop: no valid-MRR improvement")
                    break
        result = {
            "train_seconds": timeit.default_timer() - t0,
            "epochs": epoch,
        }
        if len(self.ds.test) > 0 and args.mode == "rank":
            if best_params is not None:
                # best-MRR retention (same contract as the single path):
                # test eval on the best validation params, not the
                # possibly-degraded final state
                from skge_tpu.evaluation import evaluate

                res = evaluate(
                    self._eval_model,
                    {k: jnp.asarray(v) for k, v in best_params.items()},
                    self.ds.test, self.ds.all_triples(),
                    batch_size=args.eval_batch,
                )
            else:
                res = eval_split(self.ds.test)
            result.update(res.summary())
            log.info(
                "TEST: MRR=%.4f (raw %.4f)  Hits@10=%.3f  MR=%.1f",
                res.mrr, res.mrr_raw, res.hits[10], res.mean_rank,
            )
        return result

    def run(self) -> dict:
        if self.args.trainer != "single":
            return self._run_scaleout()
        t0 = timeit.default_timer()
        state = self.trainer.fit(self.ds.train)
        train_time = timeit.default_timer() - t0
        params = (
            {k: np.asarray(v) for k, v in state.params.items()}
            if self.best_params is None
            else self.best_params
        )
        import jax.numpy as jnp

        dev_params = {k: jnp.asarray(v) for k, v in params.items()}
        result = {"train_seconds": train_time, "epochs": self.trainer.epoch}
        if len(self.ds.test) > 0 and self.args.mode == "rank":
            ev = FilteredRankingEval(
                self._eval_model,
                self.ds.test,
                self.ds.all_triples(),
                batch_size=self.args.eval_batch,
            )
            res = ev(dev_params)
            result.update(res.summary())
            log.info(
                "TEST: MRR=%.4f (raw %.4f)  Hits@1/3/10=%.3f/%.3f/%.3f  MR=%.1f",
                res.mrr, res.mrr_raw,
                res.hits[1], res.hits[3], res.hits[10], res.mean_rank,
            )
        return result


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="KGE training/evaluation in JAX (scikit-kge capabilities)"
    )
    p.add_argument("--fin", default=None, help="dataset pickle (reference format)")
    p.add_argument("--tsv", nargs=3, default=None,
                   metavar=("TRAIN", "VALID", "TEST"),
                   help="raw triple text files (native C++ loader)")
    p.add_argument("--tsv-order", default="spo",
                   help="column order of the --tsv files over {s,p,o}")
    p.add_argument("--fout", default=None, help="best-model checkpoint path")
    p.add_argument("--model", default="hole", choices=sorted(MODELS))
    p.add_argument("--test-all", dest="test_all", type=int, default=10,
                   help="validate every N epochs (reference --test-all)")
    p.add_argument("--me", type=int, default=500, help="max epochs")
    p.add_argument("--nb", type=int, default=100, help="number of batches")
    p.add_argument("--lr", type=float, default=0.1, help="learning rate")
    p.add_argument("--optimizer", default="adagrad",
                   choices=["adagrad", "sgd", "adam"])
    p.add_argument("--schedule", default="constant",
                   choices=["constant", "linear", "cosine"],
                   help="lr schedule over --me * --nb total steps "
                   "(checkpoint-safe: position = the global step count)")
    p.add_argument("--warmup", type=int, default=0,
                   help="[--schedule] linear warmup steps")
    p.add_argument("--schedule-min", type=float, default=0.0,
                   help="[--schedule] final lr as a fraction of --lr")
    p.add_argument("--ncomp", type=int, default=150, help="embedding dim")
    p.add_argument("--margin", type=float, default=0.2, help="pairwise margin")
    p.add_argument("--sampler", default="random-mode",
                   choices=["random-mode", "lcwa", "corrupted", "bernoulli",
                            "shared"])
    p.add_argument("--k", type=int, default=1024,
                   help="shared-pool size (--sampler shared)")
    p.add_argument("--aggregate", default="unique",
                   choices=["unique", "dense", "dense_sorted"],
                   help="gradient aggregation backend (dense = XLA "
                   "scatter into the full table, dense_sorted = sort + "
                   "banded one-hot matmul)")
    p.add_argument("--mode", default="rank", choices=["rank", "none"])
    p.add_argument("--no-pairwise", action="store_true",
                   help="use pointwise logistic loss")
    p.add_argument("--selfadv", action="store_true",
                   help="self-adversarial loss (Sun et al. 2019; needs "
                   "--sampler shared)")
    p.add_argument("--adv-alpha", type=float, default=1.0,
                   help="self-adversarial softmax temperature")
    p.add_argument("--ce", action="store_true",
                   help="full 1-vs-all cross-entropy loss (no sampler; "
                   "overrides --sampler/--selfadv)")
    p.add_argument("--sampled-ce", dest="sampled_ce", action="store_true",
                   help="SAMPLED softmax cross-entropy over a --k shared "
                   "pool (importance-corrected; converges to --ce as k "
                   "approaches n_entities — the 10^7+-vocabulary "
                   "mid-ground; needs --sampler shared)")
    p.add_argument("--label-smoothing", type=float, default=0.0,
                   help="cross-entropy label smoothing (ConvE uses 0.1)")
    p.add_argument("--rparam", type=float, default=0.0)
    p.add_argument("--n3", type=float, default=0.0,
                   help="nuclear-3-norm coefficient (factorization models)")
    p.add_argument("--reciprocal", action="store_true",
                   help="[with --ce] reciprocal-relation training for ANY "
                   "model: doubled relation ids, object-direction-only CE, "
                   "canonical inverse-routed head evaluation (automatic "
                   "for --model conve)")
    p.add_argument("--nhidden", type=int, default=10)
    p.add_argument("--af", default="sigmoid")
    p.add_argument("--init", default="nunif", choices=["nunif", "normal"])
    p.add_argument("--l2", action="store_true", help="TransE: squared-L2 distance")
    p.add_argument("--ntries", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trainer", default="single",
                   choices=["single", "partitioned", "outofcore"],
                   help="'partitioned': multi-device (and multi-host via "
                   "SKGE_* env) SPMD trainer; 'outofcore': PBG-style "
                   "bucketed trainer for tables beyond HBM (train AND "
                   "evaluate: validation streams candidates one "
                   "partition at a time)")
    p.add_argument("--parts", type=int, default=2,
                   help="[outofcore] number of entity partitions")
    p.add_argument("--patience", type=int, default=3)
    p.add_argument("--eval-batch", dest="eval_batch", type=int, default=1024)
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    p.add_argument("--synthetic-entities", type=int, default=500)
    p.add_argument("--synthetic-relations", type=int, default=10)
    p.add_argument("--synthetic-train", type=int, default=5000)
    p.add_argument("--synthetic-kind", default="random",
                   choices=["random", "latent"],
                   help="'latent' = learnable translational-geometry KG "
                   "(data.latent_kg) for quality experiments")
    p.add_argument("--latent-dim", type=int, default=32)
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    return p


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s"
    )
    args = make_parser().parse_args(argv)
    import jax

    from skge_tpu.utils.compile_cache import enable_compile_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    dev = jax.devices()[0]
    log.info("platform %s (%s), %d device(s)", dev.platform,
             dev.device_kind, len(jax.devices()))
    result = Experiment(args).run()
    print(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
