#!/usr/bin/env python3
"""Drive the main path once on the GPU and check it against the host CPU.

    python chip_smoke.py           # one card
    python chip_smoke.py --multi   # four cards: the multi-device paths only

One card, in this order; any failed check raises, and the exit code is then
not 0:

1. device    JAX's default backend must be 'gpu'.
2. train     the flagship (TransE-L1, d=150, shared pool k=1024,
             aggregate='dense') at the FB15k shape, 2 epochs through
             `Trainer`: finite loss, falling violations, unit-ball rows.
3. compare   one step from one init on the card and on the CPU for three
             paths: the flagship, the iid reference-exact sampler and RESCAL
             d=100 with the factored W gradient.
4. evaluate  filtered ranking of 1,000 test triples, card vs CPU.
5. serve     `LinkPredictor.top_k(k=10)` for 1,024 queries, card vs CPU.

`--multi` runs, on four cards: the shard_map pairwise step on a (2, 2)
mesh against one card; `PartitionedTrainer` with exchange='dense' and
'ragged' against each other; filtered evaluation on the partitioned state
against the gathered table on one card.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from dataclasses import dataclass

import jax
import numpy as np

from skge_tpu import (RESCAL, AdaGrad, RandomModeSampler,
                      SharedNegativeSampler, TransE, init_state,
                      make_pairwise_step)
from skge_tpu.data import synthetic_kg
from skge_tpu.evaluation import FilteredRankingEval, evaluate
from skge_tpu.parallel.mesh import make_mesh
from skge_tpu.parallel.partitioned import PartitionedTrainer, make_shard_mesh
from skge_tpu.parallel.shardmap_step import (make_shardmap_pairwise_step,
                                             shard_state_shardmap)
from skge_tpu.serving import LinkPredictor
from skge_tpu.trainer import TrainConfig, Trainer
from skge_tpu.utils.compile_cache import enable_compile_cache

LR = 0.1        # Trainer defaults (the reference's module constants)
MARGIN = 1.0

# One step at 'highest' on both sides. The sum order differs between the
# backends and GPU scatters add with atomics, so float32 results differ in
# the last bits: values must agree within ATOL + RTOL * |reference|.
ATOL = RTOL = 1e-5
# AdaGrad's first step moves a coordinate by lr * g / max(|g|, 1e-6): by
# exactly +-lr wherever |g| > 1e-6, however g was rounded, but with slope
# lr / 1e-6 = 1e5 below it, where a rounding difference in g is amplified
# a hundred-thousandfold. Coordinates with 0 < |g| < FLAT_GRAD on either
# side are held only to the step's reach (2 * lr), and |g| itself, read
# back from the optimizer state, to ATOL + RTOL * |g|.
FLAT_GRAD = 1e-5
# At the default precision the card may run float32 dots in TF32 (a 10-bit
# mantissa, ~1e-3 relative), so a matmul-scored pair near the margin can
# flip. Each flip moves its rows by up to 2 * lr. The violation count may
# then differ by TF32_VIOL of the pairs, and TF32_FRAC of the coordinates
# may leave the 'highest' tolerance.
TF32_VIOL = 1e-4
TF32_FRAC = 1e-2
# Evaluation and serving: scores are L1 distances over d=150, whose sums
# differ in the last bits between backends, so a candidate within that of
# the target may swap sides. Filtered MRR must agree within EVAL_MRR_ATOL,
# and at least EVAL_SAME of the ranks must be identical. Top-10 lists may
# differ only at positions whose scores agree within TOPK_ATOL.
EVAL_MRR_ATOL = 1e-4
EVAL_SAME = 0.95
TOPK_ATOL = 1e-4


@dataclass(frozen=True)
class Shape:
    entities: int
    relations: int
    train: int
    test: int
    queries: int
    nbatches: int
    k: int
    d: int
    rescal_d: int
    negatives: int


# FB15k's counts, as bench.py uses them (synthetic_kg, clustered=False)
FB15K = Shape(entities=14951, relations=1345, train=483142, test=1000,
              queries=1024, nbatches=100, k=1024, d=150, rescal_d=100,
              negatives=8)


# --------------------------------------------------------------------------
# Helpers
# --------------------------------------------------------------------------

def check_backend(backend: str) -> None:
    """Refuse to run anywhere but on a GPU: no fallback to the CPU."""
    if backend != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX's default backend is {backend!r}, not 'gpu'"
        )


def gpu_info() -> list:
    """`nvidia-smi` name and power limit of each card, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def watch_compile_cache() -> dict:
    """Count persistent compile-cache hits and misses in this process."""
    counts = {"hits": 0, "misses": 0}
    names = {"/jax/compilation_cache/cache_hits": "hits",
             "/jax/compilation_cache/cache_misses": "misses"}

    def listen(event, **kwargs):
        if event in names:
            counts[names[event]] += 1

    jax.monitoring.register_event_listener(listen)
    return counts


def check_close(name, got, want, atol, rtol, skip=None) -> float:
    """Assert |got - want| <= atol + rtol * |want| outside `skip`; returns
    the worst |got - want| there."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    diff = np.abs(got - want)
    keep = np.ones(diff.shape, bool) if skip is None else ~skip
    bad = (diff > atol + rtol * np.abs(want)) & keep
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.size} values differ by more "
            f"than atol={atol} rtol={rtol}; worst {diff[bad].max():.3e}"
        )
    return float(diff[keep].max()) if keep.any() else 0.0


def _grad_norms(state, p):
    """|g| of the first step, read back from AdaGrad's accumulator."""
    return np.sqrt(np.asarray(state.opt_state[p]["p2"], np.float64))


def _flat(g_got, g_want):
    """Coordinates whose gradient sits in AdaGrad's amplifying range."""
    hi = np.maximum(g_got, g_want)
    return (hi > 0) & (hi < FLAT_GRAD)


def step_diff(got, want) -> dict:
    """How far one training step on the card is from the reference.
    `got`/`want`: (state, nviolations) on host."""
    (gs, gv), (ws, wv) = got, want
    out = {"viol": wv, "dviol": gv - wv, "worst": 0.0, "worst_all": 0.0,
           "worst_grad": 0.0, "n_out": 0, "n_flat": 0, "size": 0}
    for p in ws.params:
        g_got, g_want = _grad_norms(gs, p), _grad_norms(ws, p)
        flat = _flat(g_got, g_want)
        want_p = np.asarray(ws.params[p], np.float64)
        diff = np.abs(np.asarray(gs.params[p], np.float64) - want_p)
        out["worst"] = max(out["worst"],
                           float(diff.max(initial=0.0, where=~flat)))
        out["worst_all"] = max(out["worst_all"], float(diff.max()))
        out["worst_grad"] = max(out["worst_grad"],
                                float(np.abs(g_got - g_want).max()))
        out["n_out"] += int(((diff > ATOL + RTOL * np.abs(want_p))
                             & ~flat).sum())
        out["n_flat"] += int(flat.sum())
        out["size"] += diff.size
    return out


def check_step(name, got, want) -> dict:
    """One step at 'highest': identical violations, params within
    ATOL/RTOL (flat coordinates within the step's reach), |g| within
    ATOL/RTOL."""
    (gs, gv), (ws, wv) = got, want
    if gv != wv:
        raise AssertionError(f"{name}: {gv} violations on the card, {wv} "
                             "on the CPU")
    for p in ws.params:
        g_got, g_want = _grad_norms(gs, p), _grad_norms(ws, p)
        check_close(f"{name} {p}", gs.params[p], ws.params[p], ATOL, RTOL,
                    skip=_flat(g_got, g_want))
        check_close(f"{name} {p} (flat)", gs.params[p], ws.params[p],
                    2 * LR, 0.0)
        check_close(f"{name} |grad {p}|", g_got, g_want, ATOL, RTOL)
    return step_diff(got, want)


def check_step_tf32(name, got, want) -> dict:
    """One step at the card's default precision (see TF32_VIOL)."""
    d = step_diff(got, want)
    if abs(d["dviol"]) > TF32_VIOL * max(d["viol"], 1):
        raise AssertionError(f"{name}: violations differ by {d['dviol']} "
                             f"of {d['viol']}")
    if d["n_out"] > TF32_FRAC * d["size"]:
        raise AssertionError(f"{name}: {d['n_out']} of {d['size']} values "
                             "outside tolerance")
    for p in want[0].params:
        check_close(f"{name} {p}", got[0].params[p], want[0].params[p],
                    2 * LR, 0.0)
    return d


def check_ranks(name, got, want) -> dict:
    """Filtered ranks of two evaluations (RankingResult) agree up to
    near-ties (EVAL_MRR_ATOL, EVAL_SAME)."""
    same = float(np.mean(got.ranks == want.ranks))
    dmrr = abs(got.mrr - want.mrr)
    if dmrr > EVAL_MRR_ATOL or same < EVAL_SAME:
        raise AssertionError(f"{name}: MRR {got.mrr} vs {want.mrr}, "
                             f"{same:.4f} of ranks identical")
    return {"mrr": want.mrr, "dmrr": dmrr, "same": same,
            "max_drank": float(np.abs(got.ranks - want.ranks).max())}


def check_topk(name, got, want) -> dict:
    """Top-k lists agree; ids may differ only where the scores tie."""
    if not np.isfinite(got.scores).all():
        raise AssertionError(f"{name}: non-finite scores")
    check_close(f"{name} scores", got.scores, want.scores, TOPK_ATOL, 0.0)
    differ = got.entities != want.entities
    return {"positions_swapped": int(differ.sum()),
            "worst_score": float(np.abs(got.scores - want.scores).max())}


def precision(level):
    if level is None:
        return contextlib.nullcontext()
    return jax.default_matmul_precision(level)


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def timed(laps, name, fn, *args):
    """fn(*args), with its wall time recorded in laps[name]."""
    t = time.perf_counter()
    out = fn(*args)
    laps[name] = time.perf_counter() - t
    return out


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def make_dataset(shape: Shape):
    return synthetic_kg(
        n_entities=shape.entities, n_relations=shape.relations,
        n_train=shape.train, n_test=shape.test, seed=0, clustered=False,
    )


def phase_train(shape: Shape, ds, device):
    """The flagship through Trainer on `device`; returns (model, params)."""
    model = TransE(ds.n_entities, ds.n_relations, shape.d)
    sampler = SharedNegativeSampler(ds.n_entities, k=shape.k)
    seconds, viol, loss = [], [], []
    clock = [time.perf_counter()]

    def record(tr):
        jax.block_until_ready(tr.state)
        now = time.perf_counter()
        seconds.append(now - clock[0])
        clock[0] = now
        viol.append(tr.nviolations)
        loss.append(tr.loss)
        return True

    cfg = TrainConfig(max_epochs=2, nbatches=shape.nbatches,
                      learning_rate=LR, margin=MARGIN, aggregate="dense")
    with jax.default_device(device):
        trainer = Trainer(model, sampler, cfg, post_epoch=[record])
        state = trainer.fit(ds.train)
    norms = np.linalg.norm(np.asarray(state.params["E"]), axis=1)
    if not np.isfinite(loss).all():
        raise AssertionError(f"train: loss not finite: {loss}")
    if not viol[1] < viol[0]:
        raise AssertionError(f"train: violations did not fall: {viol}")
    if norms.max() > 1 + 1e-5:
        raise AssertionError(f"train: max row norm {norms.max()} > 1")
    pairs = 2 * shape.k * ds.train.shape[0]
    log("train", f"violations per epoch {viol}, loss {loss}, max |E| row "
        f"{norms.max():.6f}")
    log("train", f"epoch seconds {seconds} (first compiles); steady epoch "
        f"{seconds[-1]:.4f} s = {2 * pairs / seconds[-1]:.4e} scored "
        "triples/s")
    return model, jax.device_get(state.params)


def compare_paths(shape: Shape, ds):
    """(name, model, sampler) of the three compared step paths."""
    n_e, n_r = ds.n_entities, ds.n_relations
    return [
        ("flagship", TransE(n_e, n_r, shape.d),
         SharedNegativeSampler(n_e, k=shape.k)),
        ("iid", TransE(n_e, n_r, shape.d),
         RandomModeSampler(n_e, modes=(0, 1) * shape.negatives)),
        ("rescal", RESCAL(n_e, n_r, shape.rescal_d),
         SharedNegativeSampler(n_e, k=shape.k)),
    ]


def run_step(model, sampler, state0, batch, device, level):
    """One `make_pairwise_step` (aggregate='dense') on `device`."""
    step = jax.jit(make_pairwise_step(model, AdaGrad(lr=LR), sampler,
                                      MARGIN, "dense"))
    mask = np.ones(batch.shape[0], np.float32)
    with precision(level):
        state, m = step(*jax.device_put((state0, batch, mask), device))
    return jax.device_get(state), int(m.nviolations)


def first_batch(shape: Shape, ds):
    bs = -(-ds.train.shape[0] // shape.nbatches)
    return ds.train[:bs]


def phase_compare(shape: Shape, ds, device, ref):
    batch = first_batch(shape, ds)
    out = {}
    for name, model, sampler in compare_paths(shape, ds):
        with jax.default_device(ref):
            state0 = jax.device_get(init_state(model, AdaGrad(lr=LR),
                                               jax.random.PRNGKey(0)))
        want = run_step(model, sampler, state0, batch, ref, "highest")
        got = run_step(model, sampler, state0, batch, device, "highest")
        d = check_step(name, got, want)
        log("compare", f"{name} highest: violations {want[1]} on both; "
            f"worst |dparam| {d['worst']:.3e} (tol {ATOL} + {RTOL}*|ref|), "
            f"worst |d|g|| {d['worst_grad']:.3e}, {d['n_flat']} flat "
            f"coordinates, worst |dparam| over all {d['worst_all']:.3e}")
        got = run_step(model, sampler, state0, batch, device, None)
        d = check_step_tf32(name, got, want)
        log("compare", f"{name} default precision: violations {got[1]} vs "
            f"{want[1]}; {d['n_out']} of {d['size']} values outside "
            f"tolerance, worst |dparam| {d['worst']:.3e}")
        out[name] = d
    return out


def phase_evaluate(model, params, ds, device, ref):
    known = np.concatenate([ds.train, ds.test])
    ev = FilteredRankingEval(model, ds.test, known)
    res = {}
    for dev in (ref, device):
        with jax.default_device(dev), precision("highest"):
            t0 = time.perf_counter()
            res[dev] = ev(jax.device_put(params, dev))
            dt = time.perf_counter() - t0
        log("evaluate", f"{dev.platform}: MRR {res[dev].mrr:.6f} "
            f"hits@10 {res[dev].hits[10]:.4f} in {dt:.3f} s (with compile)")
    d = check_ranks("evaluate", res[device], res[ref])
    log("evaluate", f"card vs CPU: dMRR {d['dmrr']:.3e} (tol "
        f"{EVAL_MRR_ATOL}), {d['same']:.4f} of ranks identical, max "
        f"|drank| {d['max_drank']}")
    return d


def phase_serve(shape: Shape, model, params, ds, device, ref):
    queries = ds.train[: shape.queries][:, [0, 2]]
    res = {}
    for dev in (ref, device):
        with jax.default_device(dev), precision("highest"):
            lp = LinkPredictor(model, jax.device_put(params, dev),
                               known=ds.train)
            t0 = time.perf_counter()
            res[dev] = lp.top_k(queries, k=10)
            dt = time.perf_counter() - t0
        log("serve", f"{dev.platform}: {len(queries)} queries in {dt:.3f} s "
            "(with compile)")
    d = check_topk("serve", res[device], res[ref])
    log("serve", f"card vs CPU: worst top-10 score diff {d['worst_score']:.3e}"
        f" (tol {TOPK_ATOL}), {d['positions_swapped']} tied positions "
        "swapped")
    return d


def phase_mesh_step(shape: Shape, ds, devices):
    """shard_map pairwise step on a (2, 2) mesh vs one card, one step."""
    # the model axis must divide the entity table: pad one row (row count
    # is free; the sampler draws only real entities)
    n_e = ds.n_entities + ds.n_entities % 2
    model = TransE(n_e, ds.n_relations, shape.d)
    sampler = SharedNegativeSampler(ds.n_entities, k=shape.k)
    opt = AdaGrad(lr=LR)
    with jax.default_device(devices[0]):
        state0 = jax.device_get(init_state(model, opt, jax.random.PRNGKey(0)))
    batch = first_batch(shape, ds)
    want = run_step(model, sampler, state0, batch, devices[0], "highest")
    mesh = make_mesh(devices[:4], shape=(2, 2))
    step = make_shardmap_pairwise_step(model, opt, sampler, MARGIN, mesh)
    mask = np.ones(batch.shape[0], np.float32)
    with precision("highest"):
        state, m = step(shard_state_shardmap(state0, model, mesh), batch, mask)
    got = jax.device_get(state), int(m.nviolations)
    d = check_step("mesh step", got, want)
    log("mesh", f"(2, 2) shard_map step vs one card: violations {want[1]} on "
        f"both, worst |dparam| {d['worst']:.3e}")
    return d


def phase_partitioned(shape: Shape, ds, devices):
    """PartitionedTrainer, exchange 'dense' vs 'ragged'; then filtered
    evaluation on the partitioned state vs the gathered table."""
    model = TransE(ds.n_entities, ds.n_relations, shape.d)
    mesh = make_shard_mesh(devices[:4])
    known = np.concatenate([ds.train, ds.test])
    params, trainers = {}, {}
    for exchange in ("dense", "ragged"):
        t0 = time.perf_counter()
        with precision("highest"):
            tr = PartitionedTrainer(
                model, AdaGrad(lr=LR), ds.train, mesh, margin=MARGIN,
                k=shape.k, nbatches=shape.nbatches, seed=0,
                exchange=exchange,
            ).fit(1)
        params[exchange] = tr.params()
        t1 = time.perf_counter()
        with precision("highest"):
            tr.fit(1)  # ends with a host read of the epoch's loss
        t2 = time.perf_counter()
        trainers[exchange] = tr
        log("partitioned", f"exchange={exchange}: set-up + first epoch "
            f"{t1 - t0:.3f} s, second epoch {t2 - t1:.4f} s, violations "
            f"{[m['nviolations'] for m in tr.metrics]}")
    worst = 0.0
    for p in params["dense"]:
        worst = max(worst, check_close(
            f"partitioned {p}", params["ragged"][p], params["dense"][p],
            ATOL, RTOL))
    log("partitioned", f"ragged vs dense after one epoch: worst |dparam| "
        f"{worst:.3e}")
    tr = trainers["dense"]
    with precision("highest"):
        got = tr.evaluate(ds.test, known)
        with jax.default_device(devices[0]):
            want = evaluate(model, jax.device_put(tr.params(), devices[0]),
                            ds.test, known)
    d = check_ranks("partitioned evaluate", got, want)
    log("partitioned", f"sharded vs gathered evaluation: MRR {want.mrr:.6f}, "
        f"dMRR {d['dmrr']:.3e}, {d['same']:.4f} of ranks identical")
    return worst, d


# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: mesh step and partitioned trainer only")
    args = ap.parse_args(argv)
    check_backend(jax.default_backend())
    cache = enable_compile_cache()
    cache_counts = watch_compile_cache()
    devices = jax.devices()
    log("device", f"{devices}; kind {devices[0].device_kind}; jax "
        f"{jax.__version__}; compile cache {cache}")
    for line in gpu_info():
        print(line, flush=True)
    t0 = time.perf_counter()
    ds = make_dataset(FB15K)
    log("data", f"{ds.train.shape[0]} train / {ds.test.shape[0]} test "
        f"triples, {ds.n_entities} entities, {ds.n_relations} relations in "
        f"{time.perf_counter() - t0:.2f} s")
    if args.multi:
        if len(devices) < 4:
            raise SystemExit(f"--multi needs 4 cards, found {len(devices)}")
        devices = devices[:4]
        phase_mesh_step(FB15K, ds, devices)
        phase_partitioned(FB15K, ds, devices)
    else:
        devices = devices[:1]
        dev, cpu = devices[0], jax.devices("cpu")[0]
        laps = {}
        model, params = timed(laps, "train", phase_train, FB15K, ds, dev)
        timed(laps, "compare", phase_compare, FB15K, ds, dev, cpu)
        timed(laps, "evaluate", phase_evaluate, model, params, ds, dev, cpu)
        timed(laps, "serve", phase_serve, FB15K, model, params, ds, dev, cpu)
        log("time", " ".join(f"{k} {v:.1f} s" for k, v in laps.items()))
    log("cache", f"{cache}: {cache_counts['hits']} hits, "
        f"{cache_counts['misses']} misses")
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
