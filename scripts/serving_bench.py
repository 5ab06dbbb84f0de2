"""Serving throughput: filtered top-K link-prediction queries/s.

FB15k-shaped table by default (14,951 entities, d=150). Measures the
steady-state batched path of `skge_tpu.serving.LinkPredictor` — one
all-entity sweep + lax.top_k per batch — after AOT warmup, host-to-host
(query ids in, entity ids out), which includes the filter-pair host lookup.
`--device-only` times the kernel alone via scan-length differencing (two
different query-stream lengths inside one device loop, subtracting out the
fixed overhead).

Usage: python scripts/serving_bench.py [--cpu] [--model transe] [--k 10]
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
    ap.add_argument("--l2", action="store_true",
                    help="[transe] L2 distance (matmul path) instead of L1")
    ap.add_argument("--ncomp", type=int, default=150)
    ap.add_argument("--entities", type=int, default=14951)
    ap.add_argument("--relations", type=int, default=1345)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--nqueries", type=int, default=59071)  # FB15k test size
    ap.add_argument("--nknown", type=int, default=483142)
    ap.add_argument("--bf16", action="store_true",
                    help="compute_dtype='bfloat16' for the sweep matmuls "
                    "(params stay fp32; exactness of the top-K set is NOT "
                    "guaranteed at bf16 — measure the recall trade)")
    ap.add_argument("--quantize", default="", choices=["", "int8", "fp8", "bfloat16"],
                    help="entity-table quantization (serving.py): 'int8' = "
                    "4x HBM capacity / upload bytes, 'fp8' = same 4x "
                    "with e4m3 rounding (equal-bytes A/B vs int8), "
                    "'bfloat16' = 2x; "
                    "approximate scores — pair with --recall")
    ap.add_argument("--recall", action="store_true",
                    help="also run the exact engine and report mean top-k "
                    "overlap of the quantized results vs exact")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from skge_tpu import MODELS, LinkPredictor

    kw = {"l1": not args.l2} if args.model == "transe" else {}
    if args.bf16:
        kw["compute_dtype"] = "bfloat16"
    model = MODELS[args.model](
        args.entities, args.relations, args.ncomp, **kw
    )
    params = model.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    known = np.stack(
        [rng.integers(0, args.entities, args.nknown),
         rng.integers(0, args.entities, args.nknown),
         rng.integers(0, args.relations, args.nknown)], axis=1,
    ).astype(np.int32)
    queries = np.stack(
        [rng.integers(0, args.entities, args.nqueries),
         rng.integers(0, args.relations, args.nqueries)], axis=1,
    ).astype(np.int32)

    pred = LinkPredictor(model, params, known=known, batch_size=args.batch,
                         quantize=args.quantize)
    # warmup: compile every pow2 filter-width kernel this stream will hit
    pred.top_k(queries, args.k, direction="o")

    t0 = time.perf_counter()
    res = pred.top_k(queries, args.k, direction="o")
    dt = time.perf_counter() - t0
    assert res.entities.shape == (args.nqueries, args.k)
    qps = args.nqueries / dt
    rec = {
        "metric": f"{args.model}{'_l2' if args.l2 else ''}_filtered_top{args.k}_queries_per_s",
        "value": round(qps, 1),
        "unit": "queries/s",
        "batch": args.batch,
        "entities": args.entities,
    }
    if args.quantize:
        rec["quantize"] = args.quantize
    if args.recall and args.quantize:
        exact = LinkPredictor(
            model, params, known=known, batch_size=args.batch,
        ).top_k(queries, args.k, direction="o")
        import numpy as _np

        rec["recall_vs_exact"] = round(float(_np.mean([
            len(set(a) & set(b)) / args.k
            for a, b in zip(exact.entities, res.entities)
        ])), 4)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
