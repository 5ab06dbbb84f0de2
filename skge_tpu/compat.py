"""scikit-kge-compatible class surface on top of the JAX functional core.

A user of the reference (skge/base.py Model/trainers) can switch with
near-identical code (SURVEY.md §1 data flow):

    from skge_tpu.compat import HolE, PairwiseStochasticTrainer
    from skge_tpu import sample

    model = HolE((n_e, n_e, n_r), ncomp)
    sampler = sample.RandomModeSampler(1, [0, 1], xs, (n_e, n_e, n_r))
    trainer = PairwiseStochasticTrainer(
        model, nbatches=100, max_epochs=500, margin=0.2,
        samplef=sampler.sample, post_epoch=[callback])
    trainer.fit(xs, ys)
    model.save("model.bin")

Differences from the reference (all documented):
- training runs on the accelerator via jitted scans; when `samplef` is one of
  `skge_tpu.sample`'s samplers (or None) the whole epoch runs on-device;
  an arbitrary Python callable falls back to a host loop calling the jitted
  update per batch (slower but fully compatible);
- `Model.save` pickles a plain dict (class name + hyperparams + numpy
  params) instead of the object graph — loadable across versions;
- optimizer state lives on the trainer, and `Config` persists both, like
  the reference (skge/base.py ~15).

Reference constructor conventions: `Model(sz, ncomp, **kwargs)` with
sz=(n_e, n_e, n_r); `_scores(ss, ps, os)` argument order (subjects,
predicates, objects) per SURVEY.md §3.3.
"""

from __future__ import annotations

import pickle
import timeit
from typing import Callable, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from skge_tpu import sample as host_sample
from skge_tpu import sampling as dev_sampling
from skge_tpu.data import bernoulli_probs, encode_keys_np
from skge_tpu.models import ERMLP as FERMLP
from skge_tpu.models import MODELS as FMODELS
from skge_tpu.models import HolE as FHolE
from skge_tpu.models import RESCAL as FRESCAL
from skge_tpu.models import TransE as FTransE
from skge_tpu.optim import AdaGrad as DevAdaGrad
from skge_tpu.optim import SGD as DevSGD
from skge_tpu.training import (
    TrainState,
    make_epoch_fn,
    make_pairwise_update,
    make_pointwise_update,
)

_DEF_MAX_EPOCHS = 500
_DEF_NBATCHES = 100
_DEF_LEARNING_RATE = 0.1
_DEF_MARGIN = 1.0


class Config:
    """Pickle wrapper bundling model + trainer (skge/base.py ~15)."""

    def __init__(self, model, trainer):
        self.model = model
        self.trainer = trainer

    def __getstate__(self):
        return {"model": self.model, "trainer": self.trainer}

    def __setstate__(self, st):
        self.model = st["model"]
        self.trainer = st["trainer"]

    def save(self, fname):
        with open(fname, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(fname):
        with open(fname, "rb") as f:
            return pickle.load(f)


class Model:
    """Mutable parameter-registry model mirroring skge/base.py ~30."""

    functional_cls = None  # set by subclasses

    def __init__(self, *args, **kwargs):
        self.params: Dict[str, np.ndarray] = {}
        self.hyperparams: Dict[str, object] = {}
        self.add_hyperparam("sz", args[0])
        self.add_hyperparam("ncomp", int(args[1]))
        self._init_kwargs(kwargs)
        self._fmodel = self._build_functional()
        self._init_params(kwargs.pop("seed", 0))

    # --- subclass hooks ---
    def _init_kwargs(self, kwargs):
        raise NotImplementedError

    def _build_functional(self):
        raise NotImplementedError

    # --- registry API (reference surface) ---
    def add_hyperparam(self, name, value):
        self.hyperparams[name] = value
        setattr(self, name, value)

    def add_param(self, name, value):
        value = np.asarray(value)
        self.params[name] = value
        setattr(self, name, value)

    def _init_params(self, seed):
        fp = self._fmodel.init_params(jax.random.PRNGKey(seed))
        for k, v in fp.items():
            self.add_param(k, np.asarray(v))

    # --- functional bridge ---
    @property
    def fmodel(self):
        return self._fmodel

    def device_params(self):
        return {k: jnp.asarray(v) for k, v in self.params.items()}

    def set_params(self, params):
        for k, v in params.items():
            self.add_param(k, np.asarray(v))

    # --- scoring (reference `_scores(ss, ps, os)` argument order) ---
    def _scores(self, ss, ps, os):
        return np.asarray(
            self._fmodel.score(
                self.device_params(),
                jnp.asarray(np.asarray(ss)),
                jnp.asarray(np.asarray(os)),
                jnp.asarray(np.asarray(ps)),
            )
        )

    def score_triples(self, triples):
        """triples: (B, 3) in (s, o, p) order."""
        return np.asarray(
            self._fmodel.score_triples(
                self.device_params(), jnp.asarray(np.asarray(triples))
            )
        )

    # --- persistence (skge/base.py ~75-95) ---
    def __getstate__(self):
        return {
            "class": type(self).__name__,
            "hyperparams": self.hyperparams,
            "params": {k: np.asarray(v) for k, v in self.params.items()},
        }

    def __setstate__(self, st):
        self.params = {}
        self.hyperparams = {}
        for k, v in st["hyperparams"].items():
            self.add_hyperparam(k, v)
        self._fmodel = self._build_functional()
        for k, v in st["params"].items():
            self.add_param(k, v)

    def save(self, fname):
        with open(fname, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(fname):
        with open(fname, "rb") as f:
            return pickle.load(f)


def _af_name(af) -> str:
    if af is None:
        return "sigmoid"
    if isinstance(af, str):
        return af
    return getattr(af, "name", getattr(af, "__name__", "sigmoid")).lower()


class TransE(Model):
    def _init_kwargs(self, kwargs):
        self.add_hyperparam("l1", bool(kwargs.pop("l1", True)))
        self.add_hyperparam("init", kwargs.pop("init", "nunif"))

    def _build_functional(self):
        sz, d = self.hyperparams["sz"], self.hyperparams["ncomp"]
        return FTransE(sz[0], sz[2], d, l1=self.l1, init=self.init)


class RESCAL(Model):
    def _init_kwargs(self, kwargs):
        self.add_hyperparam("rparam", float(kwargs.pop("rparam", 0.0)))
        self.add_hyperparam("init", kwargs.pop("init", "nunif"))

    def _build_functional(self):
        sz, d = self.hyperparams["sz"], self.hyperparams["ncomp"]
        return FRESCAL(sz[0], sz[2], d, rparam=self.rparam, init=self.init)


class HolE(Model):
    def _init_kwargs(self, kwargs):
        self.add_hyperparam("rparam", float(kwargs.pop("rparam", 0.0)))
        self.add_hyperparam("af", _af_name(kwargs.pop("af", "sigmoid")))
        self.add_hyperparam("init", kwargs.pop("init", "nunif"))

    def _build_functional(self):
        sz, d = self.hyperparams["sz"], self.hyperparams["ncomp"]
        return FHolE(sz[0], sz[2], d, rparam=self.rparam, af=self.af, init=self.init)


class ERMLP(Model):
    def _init_kwargs(self, kwargs):
        self.add_hyperparam("nhidden", int(kwargs.pop("nhidden", 10)))
        self.add_hyperparam("af", _af_name(kwargs.pop("af", "sigmoid")))
        self.add_hyperparam("init", kwargs.pop("init", "nunif"))

    def _build_functional(self):
        sz, d = self.hyperparams["sz"], self.hyperparams["ncomp"]
        return FERMLP(
            sz[0], sz[2], d, nhidden=self.nhidden, af=self.af, init=self.init
        )


MODELS = {"transe": TransE, "rescal": RESCAL, "hole": HolE, "ermlp": ERMLP}


# ---------------------------------------------------------------------------
# Sampler bridging: recognize skge_tpu.sample host samplers and build the
# equivalent pure on-device sampler for the jitted fast path.
# ---------------------------------------------------------------------------

def _device_sampler(samplef, sz) -> Optional[Callable]:
    owner = getattr(samplef, "__self__", samplef)
    n_e, _, n_r = sz
    if isinstance(owner, host_sample.LCWASampler):
        keys = np.sort(
            encode_keys_np(np.asarray(list(owner.xs), np.int64), n_e, n_r)
        )
        return dev_sampling.LCWASampler(
            n_e, n_r, jnp.asarray(keys),
            modes=tuple(owner.modes) * owner.n, ntries=owner.ntries,
        )
    if isinstance(owner, host_sample.RandomModeSampler):
        return dev_sampling.RandomModeSampler(
            n_e, modes=tuple(owner.modes) * owner.n
        )
    if isinstance(owner, host_sample.BernoulliSampler):
        return dev_sampling.BernoulliSampler(n_e, jnp.asarray(owner.probs))
    if isinstance(owner, host_sample.CorruptedSampler):
        flats = {0: [], 1: []}
        offs = {0: np.zeros(n_r, np.int32), 1: np.zeros(n_r, np.int32)}
        cnts = {0: np.zeros(n_r, np.int32), 1: np.zeros(n_r, np.int32)}
        for mode in (0, 1):
            off = 0
            for p in range(n_r):
                cands = owner.idx.get(p, {}).get(mode, [])
                offs[mode][p] = off
                cnts[mode][p] = len(cands)
                flats[mode].extend(cands)
                off += len(cands)
            if not flats[mode]:
                flats[mode] = [0]
        return dev_sampling.CorruptedSampler(
            n_e,
            jnp.asarray(np.asarray(flats[0], np.int32)),
            jnp.asarray(offs[0]), jnp.asarray(cnts[0]),
            jnp.asarray(np.asarray(flats[1], np.int32)),
            jnp.asarray(offs[1]), jnp.asarray(cnts[1]),
            modes=tuple(owner.modes) * owner.n,
        )
    return None


# ---------------------------------------------------------------------------
# Trainers
# ---------------------------------------------------------------------------

class StochasticTrainer:
    """Pointwise logistic-loss trainer (skge/base.py ~100-195)."""

    pairwise = False

    def __init__(self, model: Model, **kwargs):
        self.model = model
        self.hyperparams = {}
        self.add_hyperparam("max_epochs", int(kwargs.pop("max_epochs", _DEF_MAX_EPOCHS)))
        self.add_hyperparam("nbatches", int(kwargs.pop("nbatches", _DEF_NBATCHES)))
        self.add_hyperparam(
            "learning_rate", float(kwargs.pop("learning_rate", _DEF_LEARNING_RATE))
        )
        self.add_hyperparam("margin", float(kwargs.pop("margin", _DEF_MARGIN)))
        self.add_hyperparam("optimizer", kwargs.pop("optimizer", "adagrad"))
        self.samplef = kwargs.pop("samplef", None)
        self.post_epoch = list(kwargs.pop("post_epoch", []))
        self.seed = int(kwargs.pop("seed", 0))
        self.aggregate = kwargs.pop("aggregate", "unique")
        self.loss = float("nan")
        self.nviolations = 0
        self.epoch = 0
        self.epoch_start = None

    def add_hyperparam(self, name, value):
        self.hyperparams[name] = value
        setattr(self, name, value)

    def __getstate__(self):
        """Picklable trainer state (for Config): hyperparams + progress.

        Device state, callbacks and samplef (possibly unpicklable closures)
        are dropped; `fit` rebuilds them.
        """
        return {
            "hyperparams": self.hyperparams,
            "seed": self.seed,
            "aggregate": self.aggregate,
            "epoch": self.epoch,
            "loss": self.loss,
            "nviolations": self.nviolations,
            "model": self.model,
        }

    def __setstate__(self, st):
        self.model = st["model"]
        self.hyperparams = {}
        for k, v in st["hyperparams"].items():
            self.add_hyperparam(k, v)
        self.seed = st["seed"]
        self.aggregate = st["aggregate"]
        self.epoch = st["epoch"]
        self.loss = st["loss"]
        self.nviolations = st["nviolations"]
        self.samplef = None
        self.post_epoch = []
        self.epoch_start = None

    def _opt(self):
        cls = {"adagrad": DevAdaGrad, "sgd": DevSGD}[str(self.optimizer).lower()]
        return cls(lr=self.learning_rate)

    # -- shared epoch plumbing --
    def _run_epochs(self, run_one_epoch, n_epochs):
        for _ in range(n_epochs):
            self.epoch += 1
            self.epoch_start = timeit.default_timer()
            run_one_epoch()
            stop = False
            for f in self.post_epoch:
                if not f(self):
                    stop = True
            if stop:
                break

    def fit(self, xs, ys):
        xs = np.asarray(list(xs), np.int32).reshape(-1, 3)
        ys = np.asarray(list(ys), np.float32).reshape(-1)
        fmodel, opt = self.model.fmodel, self._opt()
        state = TrainState(
            params=self.model.device_params(),
            opt_state=opt.init(self.model.device_params()),
            key=jax.random.PRNGKey(self.seed),
            step=jnp.zeros((), jnp.int32),
        )
        dev = None if self.samplef is None else _device_sampler(
            self.samplef, self.model.sz
        )
        if self.samplef is None or dev is not None:
            state = self._fit_device(fmodel, opt, state, xs, ys, dev)
        else:
            state = self._fit_host(fmodel, opt, state, xs, ys)
        self.model.set_params(jax.device_get(state.params))
        self._state = state
        return self

    # -- fully on-device path --
    def _fit_device(self, fmodel, opt, state, xs, ys, dev_sampler):
        update = make_pointwise_update(fmodel, opt, self.aggregate)
        n = xs.shape[0]
        nb = min(self.nbatches, n)

        def step(st, batch, mask, ys_b):
            if dev_sampler is None:
                return update(st, batch, ys_b, mask)
            key, sk = jax.random.split(st.key)
            pos_rep, neg, pm = dev_sampler(sk, batch, mask)
            st = st._replace(key=key)
            triples = jnp.concatenate([batch, neg])
            yy = jnp.concatenate([ys_b, -jnp.ones(neg.shape[0], ys_b.dtype)])
            mm = jnp.concatenate([mask, pm])
            return update(st, triples, yy, mm)

        epoch_fn = jax.jit(_make_epoch_with_ys(step, n, nb))
        xs_d, ys_d = jnp.asarray(xs), jnp.asarray(ys)
        holder = {"state": state}

        def one_epoch():
            holder["state"], m = epoch_fn(holder["state"], xs_d, ys_d)
            self.loss = float(jnp.sum(m.loss))
            self.nviolations = int(jnp.sum(m.nviolations))

        self._run_epochs(one_epoch, self.max_epochs)
        return holder["state"]

    # -- host samplef fallback (arbitrary callables) --
    def _fit_host(self, fmodel, opt, state, xs, ys):
        update = jax.jit(make_pointwise_update(fmodel, opt, self.aggregate))
        n = xs.shape[0]
        nb = min(self.nbatches, n)
        bs = -(-n // nb)
        rng = np.random.default_rng(self.seed)
        holder = {"state": state}

        def one_epoch():
            perm = rng.permutation(n)
            total_loss = 0.0
            for b in range(nb):
                sel = perm[b * bs : (b + 1) * bs]
                if sel.size == 0:
                    continue
                bx, by = xs[sel], ys[sel]
                xys = [((int(s), int(o), int(p)), float(y)) for (s, o, p), y in zip(bx, by)]
                negs = self.samplef(xys)
                if negs:
                    nx = np.asarray([t for t, _ in negs], np.int32)
                    ny = np.asarray([y for _, y in negs], np.float32)
                    bx = np.concatenate([bx, nx])
                    by = np.concatenate([by, ny])
                width = _round_up(bx.shape[0], bs)
                pad = width - bx.shape[0]
                mask = np.concatenate([np.ones(bx.shape[0]), np.zeros(pad)]).astype(np.float32)
                bx = np.concatenate([bx, np.zeros((pad, 3), np.int32)])
                by = np.concatenate([by, np.zeros(pad, np.float32)])
                holder["state"], m = update(
                    holder["state"], jnp.asarray(bx), jnp.asarray(by), jnp.asarray(mask)
                )
                total_loss += float(m.loss)
            self.loss = total_loss

        self._run_epochs(one_epoch, self.max_epochs)
        return holder["state"]


class PairwiseStochasticTrainer(StochasticTrainer):
    """Margin-ranking trainer (skge/base.py ~210-265)."""

    pairwise = True

    def fit(self, xs, ys):
        xs = np.asarray(list(xs), np.int32).reshape(-1, 3)
        ys = np.asarray(list(ys), np.float32).reshape(-1)
        fmodel, opt = self.model.fmodel, self._opt()
        state = TrainState(
            params=self.model.device_params(),
            opt_state=opt.init(self.model.device_params()),
            key=jax.random.PRNGKey(self.seed),
            step=jnp.zeros((), jnp.int32),
        )
        if self.samplef is None:
            # reference pre-splits by label and pairs pos[i] with neg[i % n]
            pos = xs[ys > 0]
            neg = xs[ys <= 0]
            if len(neg) == 0:
                raise ValueError(
                    "pairwise training without samplef needs negative-labeled triples"
                )
            rep = neg[np.arange(len(pos)) % len(neg)]
            state = self._fit_device_pairs(fmodel, opt, state, pos, rep)
        else:
            dev = _device_sampler(self.samplef, self.model.sz)
            if dev is not None:
                state = self._fit_device_sampled(fmodel, opt, state, xs[ys > 0], dev)
            else:
                state = self._fit_host_pairwise(fmodel, opt, state, xs[ys > 0])
        self.model.set_params(jax.device_get(state.params))
        self._state = state
        return self

    def _fit_device_sampled(self, fmodel, opt, state, xs, dev_sampler):
        update = make_pairwise_update(fmodel, opt, self.margin, self.aggregate)
        n = xs.shape[0]
        nb = min(self.nbatches, n)

        def step(st, batch, mask):
            key, sk = jax.random.split(st.key)
            pos_rep, neg, pm = dev_sampler(sk, batch, mask)
            st = st._replace(key=key)
            return update(st, pos_rep, neg, pm)

        epoch_fn = jax.jit(make_epoch_fn(step, n, nb))
        xs_d = jnp.asarray(xs)
        holder = {"state": state}

        def one_epoch():
            holder["state"], m = epoch_fn(holder["state"], xs_d)
            self.loss = float(jnp.sum(m.loss))
            self.nviolations = int(jnp.sum(m.nviolations))

        self._run_epochs(one_epoch, self.max_epochs)
        return holder["state"]

    def _fit_device_pairs(self, fmodel, opt, state, pos, neg):
        """Pre-paired (samplef=None) path: scan fixed pairs each epoch."""
        update = make_pairwise_update(fmodel, opt, self.margin, self.aggregate)
        n = pos.shape[0]
        nb = min(self.nbatches, n)

        def step(st, batch6, mask):
            return update(st, batch6[:, :3], batch6[:, 3:], mask)

        epoch_fn = jax.jit(make_epoch_fn(step, n, nb))
        pairs = jnp.asarray(np.concatenate([pos, neg], axis=1))
        holder = {"state": state}

        def one_epoch():
            holder["state"], m = epoch_fn(holder["state"], pairs)
            self.loss = float(jnp.sum(m.loss))
            self.nviolations = int(jnp.sum(m.nviolations))

        self._run_epochs(one_epoch, self.max_epochs)
        return holder["state"]

    def _fit_host_pairwise(self, fmodel, opt, state, xs):
        """Arbitrary samplef: reference pairs each positive with each of its
        sampled negatives (skge/base.py ~265)."""
        update = jax.jit(make_pairwise_update(fmodel, opt, self.margin, self.aggregate))
        n = xs.shape[0]
        nb = min(self.nbatches, n)
        bs = -(-n // nb)
        rng = np.random.default_rng(self.seed)
        holder = {"state": state}

        def one_epoch():
            perm = rng.permutation(n)
            nviol = 0
            total_loss = 0.0
            for b in range(nb):
                sel = perm[b * bs : (b + 1) * bs]
                if sel.size == 0:
                    continue
                pxs, nxs = [], []
                for row in xs[sel]:
                    xy = ((int(row[0]), int(row[1]), int(row[2])), 1.0)
                    for t, _ in self.samplef([xy]):
                        pxs.append(tuple(row))
                        nxs.append(t)
                if not pxs:
                    continue
                pa = np.asarray(pxs, np.int32)
                na = np.asarray(nxs, np.int32)
                width = _round_up(pa.shape[0], bs)
                pad = width - pa.shape[0]
                mask = np.concatenate([np.ones(pa.shape[0]), np.zeros(pad)]).astype(np.float32)
                pa = np.concatenate([pa, np.zeros((pad, 3), np.int32)])
                na = np.concatenate([na, np.zeros((pad, 3), np.int32)])
                holder["state"], m = update(
                    holder["state"], jnp.asarray(pa), jnp.asarray(na), jnp.asarray(mask)
                )
                nviol += int(m.nviolations)
                total_loss += float(m.loss)
            self.nviolations = nviol
            self.loss = total_loss

        self._run_epochs(one_epoch, self.max_epochs)
        return holder["state"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _make_epoch_with_ys(step_fn, n_triples: int, nbatches: int):
    """Epoch scan that threads per-triple labels alongside the triples."""
    batch_size = -(-n_triples // nbatches)
    padded = nbatches * batch_size

    def epoch(state, xs, ys):
        key, pk = jax.random.split(state.key)
        state = state._replace(key=key)
        perm = jax.random.permutation(pk, n_triples)
        pad_idx = jnp.concatenate(
            [perm, jnp.zeros((padded - n_triples,), perm.dtype)]
        )
        mask_flat = (jnp.arange(padded) < n_triples).astype(jnp.float32)
        batches = xs[pad_idx].reshape(nbatches, batch_size, 3)
        ybatches = ys[pad_idx].reshape(nbatches, batch_size)
        masks = mask_flat.reshape(nbatches, batch_size)

        def body(st, bmy):
            b, m, y = bmy
            return step_fn(st, b, m, y)

        return jax.lax.scan(body, state, (batches, masks, ybatches))

    return epoch
