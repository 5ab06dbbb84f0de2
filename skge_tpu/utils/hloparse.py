"""Compiled-HLO collective inventory — the hardware-independent half of the
scaling-regression story.

Wall-clock SPMD-overhead gates on virtual CPU devices drift with host
scheduling noise. What IS deterministic is the compiled program
itself: the set of collectives XLA inserted and their payload bytes. This
module parses a compiled module's text (`compiled.as_text()`) and returns
that inventory, so tests can pin "collective bytes per step" budgets that a
sharding regression would actually trip — independent of backend, load, or
clock (tests/test_collective_budget.py).

Byte counts are the collective ops' OUTPUT buffer sizes — the stable,
comparable quantity across backends. For `ragged-all-to-all` that is the
static buffer bound, not the (dynamic, data-dependent) transferred bytes;
callers compare like against like.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

_SHAPE_RE = re.compile(r"(f64|f32|bf16|s64|s32|u64|u32|pred)\[([\d,]*)\]")
_DTYPE_BYTES = {"f64": 8, "s64": 8, "u64": 8,
                "f32": 4, "s32": 4, "u32": 4, "bf16": 2, "pred": 1}


def bytes_of(line: str) -> int:
    """Output-buffer bytes of an HLO instruction line (first shape on the
    RHS; tuple-shaped async starts report the payload operand shape)."""
    m = _SHAPE_RE.search(line.split("=", 1)[-1])
    if not m:
        return 0
    dt, dims = m.groups()
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES[dt]


def cycles_of(line: str) -> int:
    m = re.search(r'"estimated_cycles":"(\d+)"', line)
    return int(m.group(1)) if m else 0


COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
              "ragged-all-to-all", "all-to-all", "collective-permute")
START_RE = re.compile(
    r"= .*?(?:async-collective-start|(?:%s)-start)\(" % "|".join(COLL_KINDS)
)
DONE_RE = re.compile(
    r"= .*?(?:async-collective-done|(?:%s)-done)\((%%[\w.\-]+)\)"
    % "|".join(COLL_KINDS)
)
SYNC_RE = re.compile(r"= .*? (%s)\(" % "|".join(COLL_KINDS))


def analyze(hlo: str) -> Tuple[List[dict], List[dict]]:
    """Parse a scheduled ENTRY computation; return (async_records, sync).

    Async records carry overlap evidence: every op issued between a
    collective's `-start` and its `-done` executes while the transfer is in
    flight, so summing those ops' `estimated_cycles` measures the overlap
    the scheduler achieved (where the compiler attaches no estimates the
    cycle fields are simply 0).
    """
    entry = hlo.split("ENTRY")[-1].splitlines()
    open_starts: Dict[str, dict] = {}
    records: List[dict] = []
    sync_colls: List[dict] = []
    for line in entry:
        line = line.strip()
        if not (line.startswith("%") or line.startswith("ROOT")):
            continue
        name = line.lstrip("ROOT ").split(" = ")[0].strip()
        if START_RE.search(line):
            kind = "collective"
            for k in COLL_KINDS:
                if k in line:
                    kind = k
                    break
            open_starts[name] = {
                "start": name, "kind": kind, "bytes": bytes_of(line),
                "overlap_cycles": 0, "ops_between": 0,
            }
        elif (m := DONE_RE.search(line)):
            src = m.group(1)
            rec = None
            if src in open_starts:
                rec = open_starts.pop(src)
            elif open_starts:  # done consumes a GTE of the start tuple
                for k in list(open_starts):
                    if k.split(".")[-1] in line:
                        rec = open_starts.pop(k)
                        break
                if rec is None:
                    rec = open_starts.popitem()[1]
            if rec:
                records.append(rec)
        elif (sm := SYNC_RE.search(line)):
            sync_colls.append({"kind": sm.group(1), "bytes": bytes_of(line)})
        else:
            cyc = cycles_of(line)
            if cyc:
                for rec in open_starts.values():
                    rec["overlap_cycles"] += cyc
                    rec["ops_between"] += 1
    return records, sync_colls


def collective_bytes(hlo: str) -> Dict[str, int]:
    """Total collective payload bytes per kind across the whole module
    (async starts + sync forms), for budget pinning. Unlike `analyze` this
    scans ALL computations — GSPMD-partitioned programs put collectives
    inside fusions/while bodies, not just ENTRY."""
    out: Dict[str, int] = {}
    for line in hlo.splitlines():
        line = line.strip()
        if not (line.startswith("%") or line.startswith("ROOT")
                or " = " in line):
            continue
        if DONE_RE.search(line):
            continue  # counted at the start
        matched = None
        if START_RE.search(line):
            for k in COLL_KINDS:
                if k in line:
                    matched = k
                    break
            matched = matched or "collective"
        elif (sm := SYNC_RE.search(line)):
            matched = sm.group(1)
        if matched:
            out[matched] = out.get(matched, 0) + bytes_of(line)
    return out
