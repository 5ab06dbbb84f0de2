"""Density-vs-learnability curve per latent-KG geometry (VERDICT r3 item 2d).

Round 3's most interesting quality finding was qualitative: at WN18's own
3.45 train triples/entity only the TRANSLATIONAL geometry is learnable by
any family (translations displace every entity in a common direction,
creating relation-level hub objects that a ranking loss picks up from few
observations); the bilinear and rotational geometries — being hub-free
(isometric / full-rank maps) — need observation density, and become
learnable somewhere below 8 triples/entity. This script turns that into a
measured curve: filtered test MRR as a function of train-triples-per-entity
for each geometry, for the geometry's MATCHED family and a translational
CONTRAST model, under the shared CE protocol (reciprocal + object-direction
full CE ls=0.1 + Adam 1e-3 — the protocol that separates families at full
scale, RESULTS.md).

Each point calls scripts/quality_suite.py's `main` IN-PROCESS (later
points reuse the warm jit caches) and parses the JSON row lines.
Defaults: 10,000 entities (4x cheaper per CE epoch than the 40,943 full
scale; the density axis, not the entity count, is the variable under
study), densities {2, 3.45, 5, 8, 12}.

Usage:
    python scripts/density_curve.py [--out /tmp/density_curve.jsonl]
    python scripts/density_curve.py --cpu --entities 300 --densities 2,8 \
        --epochs 4 --eval-every 2     # smoke
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import quality_suite  # noqa: E402  (sibling script)

# geometry -> (latent_dim, matched model, contrast model). latent dims match
# the round-3 full-scale tables (RESULTS.md): translational 32, bilinear 8
# (rank-4 relations), rotational 16.
GEOMETRIES = {
    "translational": (32, "TransE-L2", "ComplEx"),
    "bilinear": (8, "RESCAL", "TransE-L2"),
    "rotational": (16, "RotatE", "TransE-L2"),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--entities", type=int, default=10000)
    ap.add_argument("--relations", type=int, default=18)
    ap.add_argument("--densities", default="2,3.45,5,8,12")
    ap.add_argument("--geometries", default="translational,bilinear,rotational")
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--eval-every", type=int, default=15)
    ap.add_argument("--patience", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default="/tmp/density_curve.jsonl")
    args = ap.parse_args(argv)

    densities = [float(d) for d in args.densities.split(",")]
    geometries = args.geometries.split(",")
    for kg in geometries:
        if kg not in GEOMETRIES:
            ap.error(f"unknown geometry {kg!r}; choices: "
                     f"{', '.join(sorted(GEOMETRIES))}")
    rows = []
    for kg in geometries:
        latent, matched, contrast = GEOMETRIES[kg]
        for dens in densities:
            ntrain = int(round(dens * args.entities))
            qs_argv = [
                "--kg", kg, "--entities", str(args.entities),
                "--relations", str(args.relations),
                "--ntrain", str(ntrain), "--latent-dim", str(latent),
                "--dim", str(args.dim), "--loss", "ce",
                "--epochs", str(args.epochs),
                "--eval-every", str(args.eval_every),
                "--patience", str(args.patience),
                "--models", f"{matched},{contrast}",
            ]
            if args.cpu:
                qs_argv.append("--cpu")
            t0 = time.perf_counter()
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    quality_suite.main(qs_argv)
            except SystemExit as e:
                if e.code not in (0, None):
                    print(buf.getvalue()[-2000:], file=sys.stderr)
                    raise SystemExit(f"point failed: {kg} density={dens}")
            except Exception as e:
                print(buf.getvalue()[-2000:], file=sys.stderr)
                raise SystemExit(
                    f"point failed: {kg} density={dens}: {e!r}"
                )
            for line in buf.getvalue().splitlines():
                try:
                    r = json.loads(line)
                except (json.JSONDecodeError, ValueError):
                    continue
                if "model" not in r or "mrr" not in r:
                    continue
                r.update({
                    "kg": kg, "density": dens, "ntrain": ntrain,
                    "role": "matched" if r["model"] == matched
                            else "contrast",
                    "point_s": round(time.perf_counter() - t0, 1),
                })
                rows.append(r)
                print(json.dumps(r), flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(r) + "\n")

    # markdown summary: one table per geometry, densities as rows
    for kg in geometries:
        latent, matched, contrast = GEOMETRIES[kg]
        print(f"\n**{kg}** (latent {latent}, d={args.dim}, CE protocol):\n")
        print(f"| triples/entity | {matched} MRR (best@) | "
              f"{contrast} MRR (best@) |")
        print("|---|---|---|")
        for dens in densities:
            cells = []
            for name in (matched, contrast):
                hit = [r for r in rows
                       if r["kg"] == kg and r["density"] == dens
                       and r["model"] == name]
                cells.append(
                    f"{hit[0]['mrr']:.4f} ({hit[0]['epochs']})"
                    if hit else "—"
                )
            print(f"| {dens} | {cells[0]} | {cells[1]} |")


if __name__ == "__main__":
    main()
